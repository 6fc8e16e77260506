#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA card, end to end.

  python3 chip_smoke.py                    # one CUDA card, nvcc, ~minutes
  python3 chip_smoke.py --out run.json     # also write the full record

Phases, each of which exits non-zero on failure (nothing is caught):
  1. device: requires a CUDA card; prints its name and power limit;
  2. build: compiles the CUDA kernels from src/repro_torch/kernels/csrc
     with nvcc for sm_90a into build/ (ptxas register / smem lines shown),
     and counts the HGMMA (wgmma) instructions in the SASS of every
     instance of the bf16 forward kernel and of the two backward kernels
     (one instance per hd) and of the SSD scan's state and output
     kernels: an instance without one is a failure; the hd-120 instances'
     HGMMA counts and ptxas lines are printed apart;
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     card, at the serving path's shapes (12 q heads over 2 KV heads,
     hd 128), at zamba2's (32 heads, g 1, hd 80), at h2o-danube-3-4b's
     (32 q heads over 8 KV heads, hd 120: its training microbatch under
     the 4096 window, a binding window of 200, ragged S, an offset chunk
     under a window, f32 queries; the backward at windows 128 and 200 and
     every split of the group of 4; decode at its 8 x 2048 serving step,
     a full 4096 ring, split edges with an empty slot, a window, f32
     queries; one paged case), at the MoE slice's hd-128 groupings
     (moonshot's g 1, 16 / 16 heads; qwen2.5-32b's g 5, 40 / 8: forward
     at an offset and in training, dq, dk/dv at every split of the group,
     decode, paged decode) and at the reduced configs' hd 16;
     The forward (FWD_CASES): the prefill chunk at offsets 0 to 1900
     (past the cache end), the training shapes (the dense step's
     microbatch and phase 5's row among them), ragged S = 1000 / 1089,
     g 1 / 6 / 8, hd 16 / 64 / 80 / 128, windows, and two f32-query cases
     (the f32 kernel); every case twice, bit for bit;
     The SSD chunk scan against the sequential recurrence (ref.ssd_ref)
     at the training shape (xh [2,1024,80,64], N 64, chunk 256, inputs
     drawn as the model draws them, so the clip at -60 is active), the
     reduced shape (P 8, N 8, chunk 8), chunk == S, chunk 128, and S = 96
     with chunk 64 through the dispatcher's pad; the training shape,
     chunk 128, chunk == S and the pad again for a long-memory head
     (A = 0.01), where every key tile and the carried state show in y;
     for that head also S = 4096 at chunk 256 (16 chunks carried), H = 3
     (a lone head in the last pair), chunk 96 (a ragged second query
     tile), P 6 / N 10 (the wrapper's pad to whole 16-byte rows); every
     case twice, bit for bit;
     The backward kernels (dq, dk/dv) are held the same way at the edges
     of their 64-row tiles: causal and not, ragged S = 1000 and 1089,
     windows of 128 and 200, GQA groups 1, 2, 4, 6 and 8, hd 16 / 64 / 80
     / 128, the training shape, and f32 queries (the f32 kernels); every
     case twice, bit for bit, and dk/dv at every split of the group; SDPA's
     backward (each pinned backend) against the same plain version on the
     training shape's inputs, for comparison;
     The decode kernel (DEC_CASES): the serving step (16 slots x 2048),
     windows, hd 16 / 64 / 80 / 128, lengths at the edges of the splits,
     a window straddling two splits, g 16, an S that no split divides,
     f32 queries, a slot of length 0 (exact zeros); every case at the
     default split and at each split phase 5 times (DEC_SPLITS), twice,
     bit for bit; 16 rows alone and among 64
     (a draft step, a verify re-score) bit for bit, on both kernels;
     The paged decode kernel at the serving shape (16 slots, ~1000 tokens
     each, shuffled blocks, one block shared by two rows), the re-score's
     64-row grid, hd 16, 48-token blocks (rows running into the second
     split and past it), ragged and empty rows: within O_TOL of its plain
     version, bit-equal to flash_decode on the view the table spells at
     every split, and unmoved by 1e9 / NaN poison in unowned blocks;
  4. serve: qwen2-1.5b at full width (28 layers, d 1536, vocab 151936,
     bf16, random weights from torch.Generator(0)), 16 slots x 2048,
     prefill chunk 256, 32 requests of 256-1536 prompt tokens, 32 greedy
     tokens each, through launch.serve.run_workload; every launch counter
     must match the dispatch counts and the plain versions must not run;
  4c. paged serve on the same weights, 16-token blocks: P1, 16 slots on a
     740-block pool with the prefix cache, phase 4's prompts, must preempt;
     P2, 16 slots with spec_k 4; both must give phase 4's streams token
     for token.  P3, 32 slots on 2049 blocks (phase 4's cache bytes), 32
     requests sharing a 512-token prefix: at least 31 x 512 prompt tokens
     re-linked, and the streams of a run without the prefix cache.  Exact
     launch identities (paged decode = 28 x (decode steps + re-scores),
     flash_fwd = 28 x parallel prefill chunks, flash_decode = 0), no plain
     call, no non-finite logit; then the reduced model on the card against
     the same model on the CPU;
  4e. plan: a world-1 NCCL group (TCP store on 127.0.0.1) and a (1, 1)
     ("data", "model") DeviceMesh, up until phase 4i is done; the port's
     solver (H100 constants)
     solves qwen2-1.5b's 16 x 2048 decode shape for the (1, 1), (4, 2)
     and (2, 4) meshes and prints each plan and its solve time (the last
     two solved only); phase 4's first 8 requests on phase 4's weights
     under the (1, 1) plan (params and cache as DTensors, attention
     through local_map): phase 4's streams token for token, flash_fwd and
     flash_decode launched 28 a chunk and a step, no plan fallback, no
     plain call, no non-finite logit; a decode step's host and device ms
     with and without the plan; then the gathered route (the cache's cut
     on seq_kv, which has no local-shard rule) on 2 requests: the
     kernels launched on the gathered cache, every call counted in
     plan_fallbacks, the streams of the same requests with no plan;
  4b. train: qwen2-1.5b at full width, f32 master weights, global batch
     4 x 1024 in 2 microbatches, AdamW lr 3e-4 with 2 warmup steps, 12
     steps through launch.train's runner; every loss finite, the last
     below the first, launches per step exactly flash_fwd 112 (forward and
     remat recompute) and flash_bwd_dq / flash_bwd_dkv 56 each, no plain
     call; then the reduced model's loss and grads on the card against the
     CPU, and 3 compressed-sync engine steps on both;
  4h. train under a plan: a world-1 NCCL group and a (1, 1) ("data",
     "model") DeviceMesh; the port's solver solves the qwen2-1.5b train
     cell (4 x 1024, f32 master state in the graph) for it; phase 4b's
     run with --mesh 1x1
     --plan auto through launch.train's runner (params, moments and
     master as DTensors, the attention's kernels inside local_map): phase
     4b's launches exactly, no plan fallback, no plain call, finite losses
     falling, each within 1e-3 relative of phase 4b's (bit-equality
     printed); tok/s, step ms, host and device ms a step with and without
     the plan, peak memory and the model-FLOPs share; the group is torn
     down after;
  4f. danube serve: h2o-danube-3-4b at full width (24 layers, d 3840,
     32 heads of hd 120 on 8 KV heads, window 4096, untied vocab 32000,
     bf16, random weights from torch.Generator(0)), 8 slots x 2048 (a ring
     of 2048 positions), 1 request of 128-512 prompt tokens, 32 greedy
     tokens, through launch.serve.run_workload; every prompt token is
     a batch-1 scan step, so flash_decode launches exactly 24 x (decode
     dispatches + prompt tokens), flash_fwd and the paged kernel never,
     no plain call, no non-finite logit; then the reduced danube (window
     16) on the card against the CPU, 40 decode steps past the window;
  4i. serving's remaining tiers under a plan, on 4e's group and mesh:
     4c's P1 (preemption, resume, prefix cache) and P2 (spec_k 4: drafts
     and re-scores) on phase 4's weights under the solved (1, 1) decode
     plan (pool, block table and params as DTensors; the paged decode,
     offset forward and re-score kernels inside local_map): 4c's streams,
     counters and launches of flash_paged_decode / flash_fwd /
     flash_decode exactly, no plan fallback, no plain call, no non-finite
     logit; a paged decode step's host and device ms with and without the
     plan; then the pool's cut moved to blocks on 2 requests: every
     paged call gathered, counted in plan_fallbacks, its kernel launched,
     the unplanned streams; then danube at full width under its solved
     (1, 1) decode plan and with no plan, 1 request of 64 tokens and
     32 greedy tokens on 8 slots x 2048 through the scan prefill: equal
     streams, flash_decode exactly 24 x (decode dispatches + prompt
     tokens) on both, flash_fwd never; the reduced danube under the plan
     against the CPU past its window; the phase's seconds and peak
     memory; the group is torn down after;
  4d. hybrid train: zamba2-2.7b at full width (54 Mamba2 layers, d 2560,
     80 SSM heads of P 64 / N 64, chunk 256; the shared attention+MLP
     block, 32 heads of hd 80, after every 6 layers), f32 master weights,
     global batch 4 x 1024 in 2 microbatches, AdamW lr 3e-4 with 2 warmup
     steps, 3 steps through launch.train's runner; every loss finite, the
     last below the first, launches per step exactly ssd_chunk_scan 216
     (54 layers x 2 microbatches x forward and remat recompute), flash_fwd
     36, flash_bwd_dq / flash_bwd_dkv 18 each, no decode kernel, 108 SSD
     backward recomputes, no plain call; then the reduced zamba2's loss
     and grads on the card against the CPU;
  4g. danube train: h2o-danube-3-4b at full width cut to 12 of its 24
     layers (full depth does not fit one card's 80 GB with f32 master
     weights and moments), the 4d batch and optimizer, 8 steps through
     launch.train's runner; losses finite and falling, launches per step
     exactly flash_fwd 48, flash_bwd_dq / flash_bwd_dkv 24 each, no f32
     or decode kernel, no plain call; then the reduced danube's loss and
     grads on the card against the CPU;
  4j. hybrid serve: zamba2-2.7b at full width (4d's weights' shapes,
     from torch.Generator(0)), 16 slots x 2048 (the shared block's rings
     hold all 2048 positions; the rings take 3.0 GB and the Mamba state
     1.16 GB), 2 requests of 32-96 prompt tokens, 32 greedy tokens each,
     through launch.serve.run_workload; every prompt token is a batch-1
     scan step (54 mamba_steps, 9 shared blocks), so flash_decode
     launches exactly 9 x (decode dispatches + prompt tokens), flash_fwd
     and ssd_chunk_scan never, no plain call, no non-finite logit; then
     the reduced zamba2 on the card against the CPU, 40 decode steps
     after two scan prefills;
  4k. the hybrid family under the solved (1, 1) plans, on a world-1 NCCL
     group and a (1, 1) DeviceMesh of its own (torn down after): 4j's
     first request under the decode plan (state and rings as
     DTensors, the state update, ring write and flash_decode in
     local_map): 4j's streams, launches 9 x (decode dispatches + prompt
     tokens) exactly, no fallback, no plain call; a decode step's and a
     scan step's host and device ms with and without the plan; the
     reduced zamba2 under the plan against the CPU; then 4d's run (its
     3 steps and schedule) under the solved train plan through
     launch.train --mesh 1x1 --plan auto: 4d's launches exactly, 0
     fallbacks, 0 plain calls, each loss within 1e-3 relative of 4d's;
     the peak memory, and (with --profile) a step's host and device ms
     with and without
     the plan;
  4l. MoE serve: moonshot-v1-16b-a3b at full width (48 layers, d 2048,
     16 / 16 heads of hd 128, 64 experts top-6 of d_ff 1408, vocab
     163840 untied; 28.06 B params = 56.1 GB bf16, random weights from
     torch.Generator(0); weights drawn slice by slice past 4 GiB of f32),
     8 slots x 2048 (a linear cache of 48 x 2 x 8 x 2048 x 16 x 128 x 2 B
     = 6.44 GB), 4 requests of 128-512 prompt tokens (default_rng(0)),
     chunks of 256, 32 greedy tokens each, through run_workload; then the
     same requests on the paged tier (16-token blocks, no speculation),
     whose streams must equal the linear tier's token for token.  Exact
     launches: flash_fwd 48 a prefill chunk, flash_decode (linear) or
     flash_paged_decode (paged) 48 a decode step; no plain call, no
     non-finite logit; the prefill chunks' share of routed choices
     dropped at capacity printed; then the reduced moonshot on the card
     against the CPU (0.25 band) with the count of routing decisions that
     differ;
  4m. on a world-1 NCCL group of its own: 4l's first request under
     the solved (1, 1) decode plan pinned by normalize_moe_plan (4l's
     streams, launches exact, no fallback, no all-to-all, the reduced
     moonshot under the plan against the CPU); moonshot cut to 4 of its 48
     layers (widths kept: 2.95 B params, ~53 GB of bf16 params, f32
     master, moments and grads; full depth would hold ~505 GB) trained
     through launch.train's runner with 4b's batch and optimizer, 4
     steps: losses finite and falling, the aux printed, launches per
     step exactly flash_fwd 16, flash_bwd_dq / flash_bwd_dkv 8 each, the
     model-FLOPs share of the active experts (moe_train_flops); then the
     same run with --mesh 1x1 --plan auto: launches exact, 0 fallbacks,
     each loss within 1e-3 relative of the unplanned run's;
  4n. qwen2.5-32b at full width (64 layers, d 5120, 40 / 8 heads of hd
     128, d_ff 27648, vocab 152064, QKV bias; 32.76 B params = 65.5 GB
     bf16), every earlier tensor freed: 8 slots x 2048 (a cache of 4.29
     GB), 4 requests of 256-1024 prompt tokens, 16 greedy tokens each;
     launches exactly flash_fwd 64 a chunk and flash_decode 64 a step, the
     peak memory under the card's;
  4o. xLSTM serve: xlstm-125m at full width (6 sLSTM + 6 mLSTM blocks,
     d 768, 4 heads, vocab 50304, 0.14 B params bf16, random weights from
     torch.Generator(0)), 16 slots x 2048 (each slot's state: C 6 x 4 x
     384 x 384 f32 = 14.2 MB, h / c / n), 2 requests of 64-192 prompt
     tokens, 32 greedy tokens each, through run_workload; every prompt
     token a batch-1 scan step; no kernel launches (the family runs none:
     mLSTM's scan is the chunked PyTorch scan, as repro's is XLA's), no
     plain call, no non-finite logit; TTFT and ITL p50 / p95, a scan
     step's and a decode step's host and device ms, the peak memory; the
     reduced xlstm on the card against the CPU; then, on a world-1 NCCL
     group, its first request under the solved (1, 1) decode plan: 4o's
     stream token for token, 0 fallbacks, 0 plain calls, the step times
     under the plan, the reduced xlstm under the plan against the CPU;
  4p. xLSTM train: xlstm-125m at full width, 4 x 512 tokens a step in one
     microbatch, f32 master, AdamW, 2 steps through launch.train's
     runner (the sLSTM recurrence a Python loop of 512 steps a block, as
     repro's lax.scan); losses finite and falling, no launch, no plain
     call; tok/s, step ms, the model-FLOPs share, the peak memory; then
     the same run with --mesh 1x1 --plan auto on the same group: each
     loss within 1e-3 relative of the unplanned run's, 0 fallbacks;
  4q. the pure-Mamba branch (no config has it: zamba2-2.7b's widths with
     family "ssm" and no shared block, 8 of 54 layers): one engine step
     of 4 x 1024 in 2 microbatches and 8 decode steps of 4 rows;
     ssd_chunk_scan exactly 8 x 2 x 2 = 32 (forward and remat), 16
     backward recomputes, no other kernel, no plain call; the kernel
     route against the chunked route on the same weights: the bf16 loss
     within 0.05, an f32 copy's logits within 0.25; the reduced branch on
     the card against the CPU;
  4r. the embedding-stub backbones, musicgen-large at full width and
     depth (48 layers, d 2048, 32 / 32 heads of hd 64, d_ff 8192, vocab
     2048; 3.23 B params bf16, random weights from torch.Generator(0)),
     served from token ids through its embed table (as repro's Server
     feeds it) on both tiers: 8 slots x 2048, 4 requests of 256-1024
     prompt tokens in chunks of 256, 32 greedy tokens each; launches
     exactly 48 a chunk and 48 a decode step, the paged streams equal to
     the linear ones; one decode step of 8 rows fed the embed table's rows
     as [B, D] embeds bit-equal to the step fed the token ids; on a
     world-1 NCCL group of its own (up until 4s is done) the first
     request again under the solved (1, 1) decode plan (the same stream,
     0 fallbacks); then trained by the engine from audio_frame_embeds
     batches (4 x 512 in one microbatch, the same batch every step, f32
     master, AdamW), 3 steps, and again under the solved (1, 1) train plan:
     launches per step exactly flash_fwd 96 and flash_bwd_dq /
     flash_bwd_dkv 48 each, losses finite and falling, the planned losses
     bit-equal to the unplanned; the peak memory (~58 GB of state);
  4s. internvl2-76b at full width (d 8192, 64 / 8 heads of hd 128, d_ff
     28672, vocab 128256, rope 1e6) cut to 32 of its 80 layers (60 GB of
     bf16 weights) served on the linear tier, 2 requests of 256-1024
     tokens, 16 greedy tokens each, and its first request again under the
     (1, 1) plan; cut to 1 layer (the embed and head are 38 GB of
     training state) trained from vision_patch_embeds batches, 2 steps,
     with and without the (1, 1) train plan (losses within 1e-3
     relative, bit-equality printed); the reduced musicgen-large and
     internvl2-76b on the card against the CPU (the forward from embeds,
     decode steps on [B, D] embeds, the loss);
  4t. the pipeline runner (runtime/pipeline_parallel.py) at S = 1 over 4
     of the port's dense decoder blocks at qwen2-1.5b's widths (4 x 1024
     bf16 activations in 2 microbatches, 3 steps): PipelineTrainer's
     losses and gnorms equal TrainEngine's on the same stack bit for bit,
     each run launching flash_fwd, flash_bwd_dq and flash_bwd_dkv exactly
     4 x 2 a step, no plain call;
  4u. the observed engines (run after 4c on phase 4's weights, and after
     4b): phase 4's first 8 requests served with the tracer, a metrics
     registry and a monitor (ITL and TTFT SLOs, a flight recorder) on the
     linear tier and on the paged tier (spec_k 4): streams equal phase
     4's, launches exactly L a chunk and a step (and a re-score), span
     counts equal the dispatch counters, the registry's token count the
     tokens served, no plain call; the monitor's host cost per observed
     token; then launch.serve's main with --arrivals poisson --rate 4, 8
     requests of 128 tokens, --slo-itl-ms 150 and 200 ms stalls injected
     after 6 decode steps once all have arrived: the ITL SLO breaches, the
     flight file, trace and metrics validate, the spans agree with the
     launches; then launch.train's run of 4b for 3 steps with
     --slo-step-ms and a stall at step 1: the straggler event fires for
     step 1, the losses are 4b's first 3 bit for bit, the launches
     exact;
  4v. the dry run (launch/dryrun.py; after 4u) in a subprocess, where
     torch's fake process group is the default group: llama3.2-3b
     train_4k on the fake (16, 16) mesh under its solved plan, and 4b's
     cell (qwen2-1.5b, 4 x 1024 in 2 microbatches) on one device with no
     plan, both traced on meta tensors; each record must be complete,
     finite and positive; the one-device cell's predicted FLOPs, peak
     bytes and modeled step are printed beside train_flops and 4b's
     measured peak and mean step, as ratios (not gated);
  4w. conformance (repro_torch.verify; beside 4v): in a process of its own
     on a world-1 NCCL group and the (1, 1) mesh, plans solved on the
     verification mesh's axes: (a) the dense-train and gqa-prefill cells
     at qwen2-1.5b's full width and depth, serial against planned at
     LOSS_ATOL / LOGITS_ATOL; (b) repro's nine reduced cells the same
     way, in one leg, each cell's gap printed and gated; (c)
     serve-paged's one-device bit-equality leg for both families and
     train-engine's 5-step trajectory; (d) the trace frontend: (a)'s
     qwen2-1.5b weights, its ``LM.forward`` at 4 x 1024 captured on meta
     tensors (the kernel counters left as they were), solved on the
     verification axes at beam 1024 and run by ``autoshard`` on the
     (1, 1) card mesh (flash_fwd exactly 28 launches, the logits within
     LOGITS_ATOL of the unplanned forward, bit-equality printed), and the
     MLP fixture's ``autoshard`` within the fuzz band; each leg's
     launches printed, each leg launching what it must, all seven kernels
     together (the forward at an offset counted apart), no plain call;
     beside it ``python -m repro_torch.verify --device cpu`` (2 cells, 10
     graphs, with the fuzz's trace and autoshard legs) on this machine's
     CPU, whose "pass" must be true and whose fuzz must count trace round
     trips;
  5. times: each kernel's time (CUDA events, L2 flushed before every
     launch, the stream held by a spin kernel so the interval is device
     time; the forward and both decode kernels also without the hold,
     enqueue-inclusive), its bound, the plain version's time and SDPA's
     (forward or backward under each backend pinned in turn, the fastest
     as the yardstick, all printed; for the paged kernel an index_select
     gather, then SDPA) as the library yardstick; the forward's and the
     backward kernels' TFLOP/s and share of their bound, dk/dv at every
     split of the group, both decode kernels at each of DEC_SPLITS; the
     attention kernels also at hd 80 (zamba2's shared block);
     ssd_chunk_scan at the training shape (device and enqueue-inclusive
     time; three CUDA launches a call), with the chunked PyTorch scan
     (kernels/ssd.ssd_scan) as its yardstick, as no single PyTorch call
     computes the scan; the forward, backward and decode at danube's
     shapes (hd 120); the decode kernel at zamba2's serving step (q
     [16,32,80] against [16,2048,32,80], the lengths 4j reached);
  6. the kernels line (the hd-120 instances as entries of their own) and
     the contract's last line.
With --profile, also torch.profiler over one admission and 8 decode
steps on each tier, and 2 full-width training steps of each model.
Imports nothing of JAX and nothing of the repro (JAX) package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# Tolerances of kernel vs plain version.
# O is bf16: both sides compute the same f32 result in a different
# summation order, then round to bf16, whose ulp is 2^-7 relative; they
# can land one ulp apart and no more, so |err| <= 1e-2 * max(1, |o|).
O_TOL = 1e-2
# lse is f32 on both sides: a logsumexp over at most 2048 terms in another
# order moves it by ~1e-6 relative of values below ~20; 1e-3 is ample
# and still catches any masking or offset error (those move it by O(1)).
LSE_TOL = 1e-3
# Reduced model on the card vs on the CPU, bf16 weights: the repro band
# for bf16 logits (verify/numerics.py LOGITS_ATOL).
LOGITS_ATOL = 0.25
# The backward's dq, dk and dv are bf16: the same f32 sums (dk/dv also
# over the g query heads and the q tiles) in another order, rounded to
# bf16, so the same one-ulp band as O_TOL: |err| <= 1e-2 * max(1, |ref|).
# P and dS enter the tensor cores as hi + lo bf16 pairs (~16 bits): a
# single bf16 rounding of them moves dv by up to two ulps, past this band,
# as SDPA's backward does (phase 3 prints its gap).
GRAD_TOL = 1e-2
# Reduced model's loss on the card vs the CPU, bf16: repro's LOSS_ATOL
# (verify/numerics.py).  Its param grads: each bf16 computation lies
# within 2.5% of max|g| of the f32 grads (reduced qwen2-1.5b on the CPU),
# so two of them within 5%; the band is 0.1 x max|g| per param.
LOSS_ATOL = 0.05
PARAM_GRAD_REL = 0.1
# Compressed-sync engine, 3 steps, card vs CPU: repro's TRAIN_LOSS_ATOL
# (verify/train_cell.py), drift compounding over optimizer steps.
TRAIN_LOSS_ATOL = 0.08
# the full-width training run: 12 steps, 2 of them warmup
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 12, 4, 1024, 2
# 4h: phase 4b's run under the solved (1, 1) train plan, all 12 steps (the
# same cosine schedule, so its losses are comparable step by step), each
# loss within 1e-3 relative of phase 4b's; the train cell the solver is
# given for (1, 1)
TRAIN_PLAN_LOSS_REL = 1e-3
TRAIN_PLAN_SHAPE = ("train4x1024", 1024, 4, "train")
# host and device ms a step, with and without the plan: steps timed after
# one warm step (host: each step()'s enqueue; wall: the steps ended by a
# sync), and steps under torch.profiler (device: its kernels' time)
STEP_TIMED, STEP_PROFILED = 2, 1
# the hybrid (zamba2-2.7b) run: 3 steps of the same batch, 2 of them warmup
# (4k trains it again under the plan, on the same cosine schedule; 4 steps
# until the embedding-stub phases needed the time)
HYBRID_ARCH, HYBRID_STEPS = "zamba2-2.7b", 3
# zamba2-2.7b served at full width (4j): 16 slots x 2048 (the shared
# block's ring holds all 2048 positions), 2 requests of 32-96 prompt
# tokens (each a batch-1 scan step: no parallel prefill for a recurrent
# state), 32 greedy tokens each; 4k serves the first under the solved
# (1, 1) decode plan and with none, and trains 4d's run under the (1, 1)
# train plan, each loss within TRAIN_PLAN_LOSS_REL of 4d's (8 and 2
# requests until the MoE phases needed the time, 4 and 1 of 64-192
# tokens until the SSM phases did)
HYBRID_SLOTS, HYBRID_MAX_LEN, HYBRID_REQUESTS = 16, 2048, 2
HYBRID_PROMPT, HYBRID_GEN, HYBRID_PLAN_REQS = (32, 96), 32, 1
HYBRID_PLAN_SHAPE = ("serve16x2048", HYBRID_MAX_LEN, HYBRID_SLOTS, "decode")
# 4k's training steps timed with and without the plan, with --profile
# only (a zamba2 step takes seconds): one warm step, 1 timed, 1 under the
# profiler
HYBRID_STEP_TIMED, HYBRID_STEP_PROFILED = 1, 1
# h2o-danube-3-4b (hd 120, window 4096): served at full width, 8 slots x
# 2048 (a ring of min(2048, 4096) positions), 1 request of 128-512
# prompt tokens (each a batch-1 scan step; 4 until the SSM phases needed
# the time, 2 until the embedding-stub phases did), 32 greedy tokens;
# trained
# at full width cut to 12 of its 24 layers (full depth holds ~71 GB of
# params, master weights, moments and grads before activations), 8 steps
# of the dense run's batch, 2 of them warmup
DANUBE = "h2o-danube-3-4b"
DANUBE_SLOTS, DANUBE_MAX_LEN, DANUBE_REQUESTS = 8, 2048, 1
DANUBE_PROMPT, DANUBE_GEN = (128, 512), 32
DANUBE_TRAIN_LAYERS, DANUBE_STEPS = 12, 8
HD120 = "(hd 120, danube)"     # the suffix of its rows in phase 5 and 6
# the MoE family, moonshot-v1-16b-a3b (48 layers, d 2048, 16 / 16 heads of
# hd 128, 64 experts top-6 of d_ff 1408, vocab 163840; 28.06 B params =
# 56.1 GB bf16): 4l serves it at full width, 8 slots x 2048 (a linear cache
# of 48 x 2 x 8 x 2048 x 16 x 128 x 2 B = 6.44 GB), 4 requests of 128-512
# prompt tokens in chunks of 256 (8 until the observed engines needed the
# time), 32 greedy tokens each, on both tiers; 4m
# serves the first under the solved (1, 1) decode plan (2 until the
# embedding-stub phases needed the time), and trains it
# cut to 4 of its 48 layers (2.95 B params: ~53 GB of bf16 params, f32
# master, moments and grads at 18 B a param; full depth would hold ~505
# GB), 4 steps of the dense run's batch, 2 of them warmup, and the same
# run under the (1, 1) train plan
MOE_ARCH, MOE_SLOTS, MOE_MAX_LEN, MOE_REQUESTS = ("moonshot-v1-16b-a3b", 8,
                                                  2048, 4)
MOE_PROMPT, MOE_GEN, MOE_CHUNK, MOE_PLAN_REQS = (128, 512), 32, 256, 1
MOE_TRAIN_LAYERS, MOE_STEPS = 4, 4
MOE_PLAN_SHAPE = ("serve8x2048", MOE_MAX_LEN, MOE_SLOTS, "decode")
# qwen2.5-32b (64 layers, d 5120, 40 / 8 heads of hd 128, d_ff 27648,
# vocab 152064, QKV bias; 32.76 B params = 65.5 GB bf16) served at full
# width (4n): 8 slots x 2048 (a cache of 64 x 2 x 8 x 2048 x 8 x 128 x 2 B
# = 4.29 GB), 4 requests of 256-1024 prompt tokens, 16 greedy tokens each
QWEN32, QWEN32_REQUESTS, QWEN32_PROMPT, QWEN32_GEN = ("qwen2.5-32b", 4,
                                                      (256, 1024), 16)
# xlstm-125m (arXiv:2405.04517; 6 sLSTM + 6 mLSTM blocks, d 768, 4 heads,
# vocab 50304, 0.14 B params): 4o serves it at full width, 16 slots x 2048
# (an mLSTM state of 6 x 4 x 384 x 384 f32 = 14.2 MB a slot), 2 requests of
# 64-192 prompt tokens (each a batch-1 scan step: a recurrent state has no
# parallel prefill), 32 greedy tokens each, and its first request again
# under the solved (1, 1) decode plan; 4p trains it at full width (the
# model is small: no depth cut), 4 x 512 tokens a step in one microbatch
# (mLSTM's scan over two chunks of 256), 2 steps (4 requests and 3 steps
# until the embedding-stub phases needed the time; the first a warmup: the
# sLSTM recurrence is a Python loop of 512 steps a block and a
# microbatch, ~11 s of host time a step), then the same run under the (1, 1)
# train plan, each loss within TRAIN_PLAN_LOSS_REL of the unplanned run's
XLSTM = "xlstm-125m"
XLSTM_SLOTS, XLSTM_MAX_LEN, XLSTM_REQUESTS = 16, 2048, 2
XLSTM_PROMPT, XLSTM_GEN, XLSTM_PLAN_REQS = (64, 192), 32, 1
XLSTM_PLAN_SHAPE = ("serve16x2048", XLSTM_MAX_LEN, XLSTM_SLOTS, "decode")
XLSTM_STEPS, XLSTM_BATCH, XLSTM_SEQ, XLSTM_MICRO = 2, 4, 512, 1
# the pure-Mamba branch of LM (4q): no config has it, so a test-built one,
# zamba2-2.7b's widths with family "ssm" and no shared block, cut to 8 of
# its 54 layers; one training step of the dense run's batch (4 x 1024 in 2
# microbatches) and 8 decode steps of 4 rows
SSM_LAYERS, SSM_DECODE_STEPS, SSM_ROWS = 8, 8, 4
# the embedding-stub backbones (PR 27): musicgen-large (arXiv:2306.05284;
# 48 layers, d 2048, 32 / 32 heads of hd 64, d_ff 8192, vocab 2048; 3.23 B
# params = 6.46 GB bf16) in 4r at full width and depth: served on both
# tiers, 8 slots x 2048, 4 requests of 256-1024 prompt tokens in chunks of
# 256, 32 greedy tokens each, the first again under the solved (1, 1)
# decode plan; trained from audio_frame_embeds batches of 4 x 512 in one
# microbatch, 3 steps with and without the (1, 1) train plan (18 B a
# param of bf16 params, f32 master, moments and grads: ~58 GB before
# activations, so no depth cut).  internvl2-76b (arXiv:2404.16821; 80
# layers, d 8192, 64 / 8 heads of hd 128, d_ff 28672, vocab 128256, rope
# 1e6; 70.55 B params) in 4s at full width cut in depth: served with 32 of
# its 80 layers (55.8 GB of layers + 4.2 GB of embed and head), 2
# requests of 256-1024 tokens, 16 greedy tokens each, the first again
# under the (1, 1) plan; trained from vision_patch_embeds batches with 1
# layer (the embed and head alone are 2.1 B params, 38 GB of training
# state; a second layer's 15.7 GB and the optimizer's per-leaf f32
# temporaries would pass the card's 80 GB), 2 steps with and without the
# (1, 1) train plan
MUSICGEN, INTERNVL = "musicgen-large", "internvl2-76b"
STUB_SLOTS, STUB_MAX_LEN, STUB_CHUNK = 8, 2048, 256
STUB_PROMPT, STUB_PLAN_REQS = (256, 1024), 1
MUSICGEN_REQUESTS, MUSICGEN_GEN, MUSICGEN_STEPS = 4, 32, 3
INTERNVL_SERVE_LAYERS, INTERNVL_REQUESTS, INTERNVL_GEN = 32, 2, 16
INTERNVL_TRAIN_LAYERS, INTERNVL_STEPS = 1, 2
STUB_BATCH, STUB_SEQ = 4, 512
STUB_PLAN_SHAPE = ("serve8x2048", STUB_MAX_LEN, STUB_SLOTS, "decode")
STUB_TRAIN_SHAPE = (f"train{STUB_BATCH}x{STUB_SEQ}", STUB_SEQ, STUB_BATCH,
                    "train")
# 4u: the observed engines.  Serving: phase 4's first OBS_REQS requests on
# both tiers with everything observed; then launch.serve's main with
# Poisson arrivals (OBS_RATE requests/s, OBS_REQS requests of OBS_PROMPT
# tokens) under an ITL SLO of OBS_ITL_SLO_MS, OBS_STALL_MS stalls after
# OBS_STALL_STEPS decode steps from OBS_STALL_AT on (all 8 arrive by
# ~1.74 s at seed 0, about 28 steps of ~56 ms at 16 slots).  Training: 4b's
# run cut to OBS_TRAIN_STEPS steps (inside the LR warmup of 2 steps the
# schedule does not depend on --steps, so its losses are 4b's), a step SLO
# of 1.5 x 4b's mean step and a stall of OBS_TRAIN_STALL_MS at step 1
OBS_REQS, OBS_RATE, OBS_PROMPT = 8, 4.0, 128
OBS_ITL_SLO_MS, OBS_STALL_MS, OBS_STALL_AT, OBS_STALL_STEPS = (150.0, 200.0,
                                                               28, 6)
OBS_TRAIN_STEPS, OBS_TRAIN_STALL_MS = 3, 1000.0
# 4t: the pipeline runner at S = 1 over a stack of PIPE_LAYERS of the
# port's dense decoder blocks at qwen2-1.5b's widths, PIPE_BATCH x
# TRAIN_SEQ activations in PIPE_MICRO microbatches, PIPE_STEPS steps
PIPE_LAYERS, PIPE_BATCH, PIPE_MICRO, PIPE_STEPS = 4, 4, 2, 3
# SSD kernel vs its plain version: y is f32 on both sides, the sequential
# recurrence against the chunked form, so the same terms summed in another
# order (up to a chunk of 256 in one sum): |err| <= 2e-4 x max(1, max|ref|).
SSD_TOL = 2e-4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

# cycles of the spin kernel that holds the stream before each timed launch
# (~0.5 ms on an H100): the host enqueues fn()'s kernels meanwhile, so the
# event interval holds their device time and not the wrapper's host time
# (~0.03-0.06 ms a call, which a short kernel would otherwise show)
HOLD_CYCLES = 1_000_000


class Timer:
    """Mean device time of fn() over n launches, with the 50 MB L2
    flushed before each launch (the serving path reads each layer's
    cache cold) and, with ``hold``, the stream held by a spin kernel so
    that the interval starts when fn()'s kernels are already queued.
    Without it the interval also holds whatever host time fn() takes
    beyond the flush (the enqueue-inclusive time)."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, n: int = 20, warm: int = 3,
                 hold: bool = True) -> float:
        for _ in range(warm):
            fn()
        total = 0.0
        pairs = []
        for _ in range(n):
            self.flush.zero_()
            if hold:
                torch.cuda._sleep(HOLD_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        for s, e in pairs:
            total += s.elapsed_time(e)
        return total / n


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fwd_visible(sq, sk, q_off, causal, window):
    """Per query row: number of visible keys, and the key range any row
    needs."""
    qpos = q_off + np.arange(sq)
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, int)
    n = np.maximum(hi - lo, 0)
    return n, int(lo.min()), int(hi.max())


def fwd_work(b, sq, sk, h, kv, hd, q_off, causal, window):
    n, lo, hi = fwd_visible(sq, sk, q_off, causal, window)
    flops = 4.0 * hd * h * b * float(n.sum())
    by = (2 * b * sq * h * hd * 2          # q in, o out (bf16)
          + b * h * sq * 4                 # lse out (f32)
          + 2 * b * max(hi - lo, 0) * kv * hd * 2 + 4)
    return by, flops


def decode_work(lengths, h, kv, hd, window):
    ln = np.asarray(lengths)
    vis = np.minimum(ln, window) if window else ln
    b = len(ln)
    flops = 4.0 * hd * h * float(vis.sum())
    by = 2 * b * h * hd * 2 + b * 4 + 2 * float(vis.sum()) * kv * hd * 2
    return by, flops


def sdpa_fwd(q, k, v, q_off, causal, window, scale):
    """One PyTorch call computing the same attention (yardstick only)."""
    import torch.nn.functional as F
    sq, sk = q.shape[1], k.shape[1]
    qpos = q_off + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)


def sdpa_decode(q, kc, vc, lengths, window, scale):
    import torch.nn.functional as F
    s = kc.shape[1]
    pos = torch.arange(s, device=q.device)[None, :]
    ln = lengths.long()[:, None]
    mask = pos < ln
    if window:
        mask &= pos >= ln - window
    qt = q[:, :, None, :]
    kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[:, None, None, :], scale=scale,
        enable_gqa=True)


SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")


def sdpa_bwd(q, k, v, do):
    """SDPA's whole backward (dq, dk, dv, causal), the yardstick of the two
    backward kernels, under each backend of SDPA_BACKENDS pinned in turn
    that takes the inputs: with enable_gqa or, where that is refused, with
    K/V expanded to the q heads outside the timed call (dk/dv then come
    per q head, and the group sum is left out of the call).  -> [(fn,
    to_port, backend)]: fn() runs the backward; to_port(fn()) gives the
    port's layout, group-summed."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    dot = do.transpose(1, 2).contiguous()
    found = []
    for name in SDPA_BACKENDS:
        for expand in ((False, True) if g > 1 else (False,)):
            kt, vt = (t.transpose(1, 2) for t in (k, v))
            if expand:
                kt, vt = (t.repeat_interleave(g, 1) for t in (kt, vt))
            leaves = (qt,) + tuple(t.contiguous().requires_grad_(True)
                                   for t in (kt, vt))
            try:
                with sdpa_kernel([getattr(SDPBackend, name)]):
                    out = F.scaled_dot_product_attention(
                        *leaves, is_causal=True,
                        enable_gqa=g > 1 and not expand)
                torch.autograd.grad(out, leaves, dot, retain_graph=True)
            except RuntimeError as e:
                print(f"SDPA backward: {name}{' expanded' if expand else ''} "
                      f"refused: {str(e).splitlines()[0][:80]}")
                continue

            def fn(out=out, leaves=leaves):
                return torch.autograd.grad(out, leaves, dot,
                                           retain_graph=True)

            def to_port(grads, expand=expand):
                gq, gk, gv = grads
                if expand:
                    gk, gv = (t.float().reshape(b, kv, g, s, hd).sum(2)
                              .to(k.dtype) for t in (gk, gv))
                return tuple(t.transpose(1, 2) for t in (gq, gk, gv))
            found.append((fn, to_port, name + (" (K/V expanded outside the "
                                               "call)" if expand else "")))
            break
    return found


def sdpa_bwd_gap(q, k, v, do, want, tag):
    """SDPA's backward under each pinned backend (as in phase 5) against
    the same plain version as the kernels, on the same inputs: how far a
    library backward that rounds P and dS to bf16 lands."""
    out = {}
    for fn, to_port, backend in sdpa_bwd(q, k, v, do):
        got = to_port(fn())
        torch.cuda.synchronize()
        errs = {n: rel_err(a, w) for n, a, w in zip(("dq", "dk", "dv"), got,
                                                     want)}
        print(f"check SDPA backward ({backend}) vs the plain version, same "
              f"inputs: " + " ".join(f"max|d{n}|={e:.3g} rel={r:.3g}"
                                     for n, (e, r) in errs.items())
              + f" {tag}")
        out[backend] = {n: r for n, (_, r) in errs.items()}
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

# the kernels on wgmma: one instance per head dim, or (SSD scan) one
WGMMA_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkv_kernel", "ssd_state_kernel",
                 "ssd_output_kernel")


def hgmma_counts(lib_path) -> dict:
    """HGMMA (wgmma) instructions in the SASS of each instance of the
    kernels in WGMMA_KERNELS, from cuobjdump beside nvcc."""
    from repro_torch.kernels import build
    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if not any(kern in fn for kern in WGMMA_KERNELS):
                fn = None
            else:
                counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def rel_err(out, ref):
    """max |out - ref| and max of it over max(1, |ref|), in f32."""
    d = (out.float() - ref.float()).abs()
    return float(d.max()), float((d / ref.float().abs().clamp(min=1.0)).max())


# (b, sq, sk, h, kv, hd, q_off, causal, window, q dtype): the serving
# path's prefill chunk at offsets from 0 to past the cache end (1900), the
# training shapes, ragged S = 1000 / 1089 against the 64-row tiles, GQA
# groups 1, 6 and 8, hd 16 / 64 / 80 / 128, windows starting inside a
# tile, and f32 queries (the f32 kernel)
FWD_CASES = [
    (1, 256, 2048, 12, 2, 128, 0, True, None, "bf16"),
    (1, 256, 2048, 12, 2, 128, 768, True, None, "bf16"),
    (1, 256, 2048, 12, 2, 128, 1792, True, None, "bf16"),
    (1, 256, 2048, 12, 2, 128, 1900, True, None, "bf16"),  # tail past the cache
    (1, 512, 512, 12, 2, 128, 0, True, None, "bf16"),
    (1, 512, 512, 12, 2, 128, 0, True, 128, "bf16"),
    (2, 100, 300, 8, 2, 64, 37, True, 50, "bf16"),
    (1, 40, 64, 4, 1, 16, 30, True, None, "bf16"),
    (2, 33, 70, 4, 2, 16, 0, False, 9, "bf16"),
    (2, 1024, 1024, 32, 32, 80, 0, True, None, "bf16"),   # zamba2, g 1, hd 80
    (1, 256, 1024, 32, 32, 80, 768, True, None, "bf16"),
    (1, 256, 2048, 12, 2, 128, 256, True, None, "bf16"),
    (1, 256, 2048, 12, 2, 128, 1300, True, 512, "bf16"),
    (1, 1000, 1000, 12, 2, 128, 0, True, None, "bf16"),   # ragged S
    (1, 1089, 1089, 8, 1, 64, 0, True, None, "bf16"),     # ragged, g 8
    (1, 1089, 1089, 16, 2, 128, 0, False, None, "bf16"),  # g 8, full
    (1, 600, 600, 6, 1, 80, 0, True, 200, "bf16"),        # hd 80, window
    (2, 70, 150, 12, 2, 80, 80, True, 33, "bf16"),
    (1, 300, 300, 12, 2, 128, 0, True, None, "f32"),      # the f32 kernel
    (2, 77, 150, 8, 2, 80, 40, True, 30, "f32"),
    # the dense training step's microbatch (112 launches a step) and
    # phase 5's training row
    (TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, TRAIN_SEQ, 12, 2, 128, 0, True,
     None, "bf16"),
    (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 12, 2, 128, 0, True, None, "bf16"),
    # hd 120 (danube, 32 q heads on 8): its training microbatch under the
    # 4096 window, a window that binds and starts inside a tile, ragged S,
    # an offset chunk under a window, f32 queries
    (TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, TRAIN_SEQ, 32, 8, 120, 0, True,
     4096, "bf16"),
    (1, 600, 600, 32, 8, 120, 0, True, 200, "bf16"),
    (1, 1089, 1089, 32, 8, 120, 0, True, None, "bf16"),
    (1, 256, 2048, 32, 8, 120, 1300, True, 512, "bf16"),
    (1, 300, 300, 32, 8, 120, 0, True, 200, "f32"),
    # hd 128 at g 1 (moonshot, 16 / 16 heads): its training microbatch and
    # a prefill chunk at an offset; at g 5 (qwen2.5-32b, 40 / 8): prefill
    # chunks at offsets 0 and 768 (past a tile edge) and ragged S = 1000
    (TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, TRAIN_SEQ, 16, 16, 128, 0, True,
     None, "bf16"),
    (1, 256, 2048, 16, 16, 128, 300, True, None, "bf16"),
    (1, 256, 2048, 40, 8, 128, 0, True, None, "bf16"),
    (1, 256, 2048, 40, 8, 128, 768, True, None, "bf16"),
    (1, 1000, 1000, 40, 8, 128, 0, True, None, "bf16"),
    # the embedding-stub backbones: hd 64 at g 1 (musicgen-large, 32 / 32
    # heads) and hd 128 at g 8 (internvl2-76b, 64 / 8): each one's training
    # microbatch and a prefill chunk at an offset
    (STUB_BATCH, STUB_SEQ, STUB_SEQ, 32, 32, 64, 0, True, None, "bf16"),
    (1, STUB_CHUNK, STUB_MAX_LEN, 32, 32, 64, 300, True, None, "bf16"),
    (STUB_BATCH, STUB_SEQ, STUB_SEQ, 64, 8, 128, 0, True, None, "bf16"),
    (1, STUB_CHUNK, STUB_MAX_LEN, 64, 8, 128, 300, True, None, "bf16"),
]


def check_fwd(dev, tag, rnd):
    """Phase 3's forward cases: each against the plain version, launched
    twice and bit-equal.  Rows that see no key have no defined output
    (ref.py) and are skipped."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    rows = {"flash_fwd": [], "flash_fwd_f32": []}
    for i, (b, sq, sk, h, kv, hd, off, causal, window, dt) in enumerate(
            FWD_CASES):
        dtype = torch.float32 if dt == "f32" else torch.bfloat16
        q, k, v = (rnd((b, sq, h, hd), 3 * i, dtype),
                   rnd((b, sk, kv, hd), 3 * i + 1),
                   rnd((b, sk, kv, hd), 3 * i + 2))
        offt = torch.tensor([off], dtype=torch.int32, device=dev)
        kw = dict(causal=causal, window=window)
        o_r, lse_r = ref.flash_attention_fwd_ref(q, k, v, q_offset=off, **kw)
        rows_ok = torch.as_tensor(
            fwd_visible(sq, sk, off, causal, window)[0] > 0, device=dev)
        o_r, lse_r = o_r[:, rows_ok], lse_r[:, :, rows_ok]
        o, lse = fa.flash_attention_fwd(q, k, v, q_offset=offt, **kw)
        o2, lse2 = fa.flash_attention_fwd(q, k, v, q_offset=offt, **kw)
        torch.cuda.synchronize()
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        o, lse = o[:, rows_ok], lse[:, :, rows_ok]
        finite = bool(torch.isfinite(o).all())
        e_o, r_o = rel_err(o, o_r)
        e_l = float((lse - lse_r).abs().max())
        ok = r_o <= O_TOL and e_l <= LSE_TOL and same and finite
        print(f"check flash_fwd{'_f32' if dt == 'f32' else ''} b={b} sq={sq} "
              f"sk={sk} h={h} kv={kv} hd={hd} q_offset={off} causal={causal} "
              f"window={window}: max|dO|={e_o:.3g} rel={r_o:.3g} "
              f"max|dlse|={e_l:.3g} bitwise-repeatable={same} "
              f"{'ok' if ok else 'MISS'} {tag}")
        if not ok:
            fail(f"flash_fwd disagrees with its plain version or is not "
                 f"deterministic (case {i})")
        rows["flash_fwd_f32" if dt == "f32" else "flash_fwd"].append(dict(
            case=i, hd=hd, max_abs_err=e_o, rel_err=r_o, lse_err=e_l))
    return rows


# (b, s, h, kv, hd, window, lengths or None (drawn), q dtype): the serving
# decode step (16 slots x 2048), a window, the reduced configs' hd 16, g 1
# at hd 64 and 80; then lengths at the edges of the splits phase 5 times
# (64 to 512: 128, 129, 1, 256, 257, ...), a window of 200 that starts
# inside a split and spans two, g 16 (MAX_GROUP), an S that is not a
# multiple of any split, f32 queries, and an empty slot (length 0: exact
# zeros from the kernel and, since its repair, from the plain version)
DEC_SPLIT_EDGES = [128, 129, 1, 256, 257, 2048, 64, 65, 192, 1000, 1, 2047,
                   384, 511, 512, 513]
DEC_CASES = [(16, 2048, 12, 2, 128, None, None, "bf16"),
             (16, 2048, 12, 2, 128, 256, None, "bf16"),
             (4, 64, 4, 2, 16, None, None, "bf16"),
             (4, 64, 4, 1, 16, 7, None, "bf16"),
             (3, 200, 8, 8, 64, None, None, "bf16"),
             (4, 1024, 32, 32, 80, None, None, "bf16"),
             (16, 2048, 12, 2, 128, None, DEC_SPLIT_EDGES, "bf16"),
             (16, 2048, 12, 2, 128, 200,
              [300, 129, 1, 256, 2048, 500, 201, 199, 640, 1000, 1, 2047,
               384, 511, 512, 513], "bf16"),
             (4, 512, 16, 1, 64, None, [512, 1, 129, 300], "bf16"),
             (5, 1000, 12, 2, 128, None, [1000, 999, 1, 513, 640], "bf16"),
             (16, 2048, 12, 2, 128, None, None, "f32"),
             (3, 200, 8, 8, 64, 37, None, "f32"),
             (4, 512, 12, 2, 128, 200, [0, 1, 300, 512], "bf16"),
             # hd 120 (danube): the serving step (8 slots x 2048) under the
             # 4096 window, a full 4096-position ring, the split edges with
             # an empty slot, a window of 200, f32 queries
             (DANUBE_SLOTS, DANUBE_MAX_LEN, 32, 8, 120, 4096, None, "bf16"),
             (4, 4096, 32, 8, 120, 4096, [4096, 4095, 1, 2049], "bf16"),
             (8, 2048, 32, 8, 120, None,
              [128, 129, 1, 256, 257, 2048, 0, 1000], "bf16"),
             (8, 2048, 32, 8, 120, 200,
              [300, 129, 1, 256, 2048, 500, 201, 199], "bf16"),
             (DANUBE_SLOTS, DANUBE_MAX_LEN, 32, 8, 120, 4096, None, "f32"),
             # hd 128 at g 1 (moonshot) and g 5 (qwen2.5-32b): their
             # serving steps (8 slots x 2048), g 5 also at the split edges
             (MOE_SLOTS, MOE_MAX_LEN, 16, 16, 128, None, None, "bf16"),
             (MOE_SLOTS, MOE_MAX_LEN, 40, 8, 128, None, None, "bf16"),
             (8, 2048, 40, 8, 128, None,
              [128, 129, 1, 256, 257, 2048, 0, 1000], "bf16"),
             # g 1 at hd 64 (musicgen-large) and g 8 at hd 128
             # (internvl2-76b): their serving steps (8 slots x 2048)
             (STUB_SLOTS, STUB_MAX_LEN, 32, 32, 64, None, None, "bf16"),
             (STUB_SLOTS, STUB_MAX_LEN, 64, 8, 128, None, None, "bf16")]
# the decode kernels' key positions per block that phase 5 times; phase
# 3 runs every decode case at each, twice
DEC_SPLITS = (64, 128, 256, 512)


def check_decode(dev, tag, rnd, i, b, s, h, kv, hd, window, lengths, dt):
    """One decode case against the plain version (O_TOL), at the default
    split and at each of DEC_SPLITS, launched twice and bit-equal."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    q = rnd((b, h, hd), 100 + 3 * i, dtype)
    kc, vc = rnd((b, s, kv, hd), 101 + 3 * i), rnd((b, s, kv, hd),
                                                  102 + 3 * i)
    if lengths is None:
        ln = np.random.default_rng(i).integers(1, s + 1, size=b)
        ln[0], ln[-1] = 1, s
    else:
        ln = np.asarray(lengths)
    lengths = torch.tensor(ln, dtype=torch.int32, device=dev)
    o_r = ref.flash_attention_decode_ref(q, kc, vc, lengths, window=window)
    empty = torch.tensor(ln == 0, device=dev)
    worst, same = (0.0, 0.0), not bool(o_r[empty].any())
    for split in (None,) + DEC_SPLITS:
        o = fa.flash_attention_decode(q, kc, vc, lengths, window=window,
                                      split=split)
        o2 = fa.flash_attention_decode(q, kc, vc, lengths, window=window,
                                       split=split)
        torch.cuda.synchronize()
        same = (same and torch.equal(o, o2) and bool(torch.isfinite(o).all())
                and not bool(o[empty].any()))
        worst = max(worst, rel_err(o, o_r), key=lambda x: x[1])
    e_o, r_o = worst
    ok = r_o <= O_TOL and same
    print(f"check flash_decode{'' if dt == 'bf16' else ' (f32 q)'} b={b} "
          f"s={s} h={h} kv={kv} hd={hd} window={window} lengths in "
          f"[{ln.min()},{ln.max()}], splits default+{DEC_SPLITS}: "
          f"max|dO|={e_o:.3g} rel={r_o:.3g} bitwise-repeatable={same} "
          f"{'ok' if ok else 'MISS'} {tag}")
    if not ok:
        fail(f"flash_decode disagrees with its plain version or is not "
             f"deterministic (case {i})")
    return dict(case=i, hd=hd, max_abs_err=e_o, rel_err=r_o)


def check_decode_batch(dev, tag, rnd):
    """A row's bits do not depend on its batch: 16 slots alone (a draft
    step) and among 64 rows (a verify re-score), on both decode kernels
    (the split follows the position count alone)."""
    from repro_torch.kernels import flash_attention as fa

    b, s, h, kv, hd = 64, 2048, 12, 2, 128
    q, kc, vc = (rnd((b, h, hd), 200), rnd((b, s, kv, hd), 201),
                 rnd((b, s, kv, hd), 202))
    ln = torch.tensor(np.random.default_rng(9).integers(1, s + 1, size=b),
                      dtype=torch.int32, device=dev)
    table = torch.arange(1, b * 128 + 1, dtype=torch.int32,
                         device=dev).reshape(b, 128)
    kp, vp = (torch.cat([torch.zeros_like(c[:1, :16]),     # null block 0
                         c.reshape(b * 128, 16, kv, hd)]) for c in (kc, vc))
    full = fa.flash_attention_decode(q, kc, vc, ln)
    same = [torch.equal(full[:16], fa.flash_attention_decode(
                q[:16].contiguous(), kc[:16].contiguous(),
                vc[:16].contiguous(), ln[:16])),
            torch.equal(full, fa.flash_attention_paged_decode(
                q, kp, vp, table, ln)),
            torch.equal(full[:16], fa.flash_attention_paged_decode(
                q[:16].contiguous(), kp, vp, table[:16].contiguous(),
                ln[:16]))]
    print(f"check decode batch: 16 of 64 rows alone bit-equal (linear, "
          f"paged = linear, paged alone) {same} {tag}")
    if not all(same):
        fail("a decode row's bits depend on its batch")


def check_kernels(dev, tag):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    def rnd(shape, seed, dtype=torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32).to(dtype)

    rows = {"flash_decode": [], "flash_bwd_dq": [], "flash_bwd_dkv": []}
    rows.update(check_fwd(dev, tag, rnd))

    for i, case in enumerate(DEC_CASES):
        rows["flash_decode"].append(check_decode(dev, tag, rnd, i, *case))
    check_decode_batch(dev, tag, rnd)

    rows["flash_paged_decode"] = check_paged(dev, tag)

    rows["flash_bwd_dq_f32"], rows["flash_bwd_dkv_f32"] = [], []
    bf, f32 = torch.bfloat16, torch.float32
    # (b, s, h, kv, hd, causal, window, q/o/do dtype): the backward's 64-row
    # tiles cut S = 1000 and 1089 raggedly, windows of 128 and 200 start
    # inside a tile, g is 1, 2, 4, 6 and 8, hd 16 / 64 / 80 / 128
    bwd_cases = [
        (TRAIN_BATCH, TRAIN_SEQ, 12, 2, 128, True, None, bf),  # training
        (2, 1000, 12, 2, 128, True, None, bf),                # ragged S
        (1, 1089, 8, 1, 64, True, None, bf),                  # ragged, g 8
        (1, 1089, 16, 2, 128, False, None, bf),               # g 8, full
        (1, 512, 12, 12, 128, False, None, bf),               # g = 1
        (1, 512, 12, 2, 128, True, 128, bf),                  # window
        (1, 600, 6, 1, 80, True, 200, bf),                    # window 200
        (2, 100, 8, 2, 64, False, 50, bf),
        (2, 33, 4, 1, 16, True, 9, bf),
        (1, 40, 4, 4, 16, False, None, bf),
        (2, 1024, 32, 32, 80, True, None, bf),               # zamba2's block
        (1, 300, 12, 2, 128, True, None, f32),               # f32 kernels
        (2, 77, 8, 2, 80, False, 30, f32),
        # hd 120 (danube, g 4): the training microbatch under the 4096
        # window, windows of 128 and 200, ragged S, f32 queries
        (TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, 32, 8, 120, True, 4096, bf),
        (1, 600, 32, 8, 120, True, 128, bf),
        (1, 600, 32, 8, 120, True, 200, bf),
        (1, 1089, 32, 8, 120, False, None, bf),
        (1, 300, 32, 8, 120, True, 200, f32),
        # hd 128 at g 1 (moonshot's training microbatch) and at g 5
        # (qwen2.5-32b: dk/dv at splits 1 and 5), ragged S
        (TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, 16, 16, 128, True, None, bf),
        (1, 1000, 40, 8, 128, True, None, bf),
        # the embedding-stub backbones' training microbatches: hd 64 at g
        # 1 (musicgen-large), hd 128 at g 8 (internvl2-76b: dk/dv at splits
        # 1, 2, 4 and 8)
        (STUB_BATCH, STUB_SEQ, 32, 32, 64, True, None, bf),
        (STUB_BATCH, STUB_SEQ, 64, 8, 128, True, None, bf),
    ]
    for i, (b, s, h, kv, hd, causal, window, dt) in enumerate(bwd_cases):
        q, do = (rnd((b, s, h, hd), 200 + 4 * i, dt),
                 rnd((b, s, h, hd), 201 + 4 * i, dt))
        k, v = (rnd((b, s, kv, hd), 202 + 4 * i),
                rnd((b, s, kv, hd), 203 + 4 * i))
        kw = dict(causal=causal, window=window)
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        errs = {n: rel_err(a, w) for n, a, w in zip(("dq", "dk", "dv"), got,
                                                     want)}
        # dk/dv at every split of the group (bf16), each in the band and
        # deterministic
        g, split_errs = h // kv, []
        if dt == bf and g > 1:
            delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)[1]
            for sp in (d for d in range(1, g + 1) if g % d == 0):
                one = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do,
                                                 split=sp, **kw)
                two = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do,
                                                 split=sp, **kw)
                same = same and all(torch.equal(a, c) for a, c in zip(one,
                                                                       two))
                split_errs.append((sp, max(rel_err(one[0], want[1])[1],
                                           rel_err(one[1], want[2])[1])))
        ok = (all(r <= GRAD_TOL for _, r in errs.values())
              and all(r <= GRAD_TOL for _, r in split_errs) and same
              and all(bool(torch.isfinite(a).all()) for a in got))
        print(f"check flash_bwd b={b} s={s} h={h} kv={kv} hd={hd} "
              f"causal={causal} window={window} {str(dt)[6:]}: "
              + " ".join(f"max|d{n}|={e:.3g} rel={r:.3g}"
                         for n, (e, r) in errs.items())
              + (" splits " + " ".join(f"{sp}:{r:.3g}" for sp, r in
                                       split_errs) if split_errs else "")
              + f" bitwise-repeatable={same} {'ok' if ok else 'MISS'} {tag}")
        if not ok:
            fail(f"flash_bwd disagrees with its plain version or is not "
                 f"deterministic (case {i})")
        sfx = "_f32" if dt == f32 else ""
        rows["flash_bwd_dq" + sfx].append(dict(
            case=i, hd=hd, max_abs_err=errs["dq"][0], rel_err=errs["dq"][1]))
        rows["flash_bwd_dkv" + sfx].append(dict(
            case=i, hd=hd, max_abs_err=max(errs["dk"][0], errs["dv"][0]),
            rel_err=max(errs["dk"][1], errs["dv"][1]),
            splits=split_errs))
        if i == 0:
            rows["sdpa_bwd_gap"] = sdpa_bwd_gap(q, k, v, do, want, tag)
        del q, k, v, do, o, lse, got, again, want
    rows["ssd_chunk_scan"] = check_ssd(dev, tag)
    return rows


def ssd_inputs(dev, b, s, h, p, n, seed, a=1.0):
    """SSD scan inputs drawn as mamba_forward draws them at init (dt_bias
    0, identity conv on unit-variance projections) for a head with
    A = exp(A_log) = a: x, B, C = silu(normal), dt = softplus(normal),
    a_log = -a dt, xh = x dt.  At init (a = 1) a_log averages ~ -0.8 a
    step, so cum reaches ~ -200 within a 256-row chunk and the clip at -60
    is active, but key tiles off the diagonal and the carried state add
    exp(-50) or less.  A long-memory head (a = 0.01) keeps cum ~ -2 over a
    chunk, so every key tile and the state carried across chunks show
    in y."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    dt = F.softplus(rnd(b, s, h))
    xh = (F.silu(rnd(b, s, h, p)) * dt[..., None]).contiguous()
    return (xh, (-a * dt).contiguous(), F.silu(rnd(b, s, n)),
            F.silu(rnd(b, s, n)))


def check_ssd(dev, tag):
    """ssd_chunk_scan against the sequential recurrence ref.ssd_ref, each
    case launched twice and bit-equal."""
    from repro_torch.kernels import ref, ssd
    from repro_torch.models import mamba

    # (b, s, h, p, n, chunk, through the dispatcher, A); A = 0.01 is a
    # long-memory head: every key tile and the carried state count
    cases = [(2, TRAIN_SEQ, 80, 64, 64, 256, False, 1.0),  # training shape
             (2, 64, 16, 8, 8, 8, False, 1.0),             # reduced zamba2
             (2, 512, 16, 64, 64, 512, False, 1.0),        # chunk == S
             (2, TRAIN_SEQ, 16, 64, 64, 128, False, 1.0),  # chunk 128
             (2, 96, 80, 64, 64, 64, True, 1.0),           # S = 96: the pad
             (2, TRAIN_SEQ, 80, 64, 64, 256, False, 0.01),
             (2, TRAIN_SEQ, 16, 64, 64, 128, False, 0.01),
             (2, 512, 16, 64, 64, 512, False, 0.01),
             (2, 96, 80, 64, 64, 64, True, 0.01),
             (1, 4096, 16, 64, 64, 256, False, 0.01),  # 16 chunks carried
             (2, TRAIN_SEQ, 3, 64, 64, 256, False, 0.01),  # H = 3
             (2, 960, 8, 64, 64, 96, False, 0.01),     # chunk 96
             (2, 192, 5, 6, 10, 64, False, 0.01)]      # P 6, N 10: padded
    out = []
    for i, (b, s, h, p, n, chunk, via, a) in enumerate(cases):
        xh, al, bb, cc = ssd_inputs(dev, b, s, h, p, n, 500 + i, a)
        before = ssd.launches["ssd_chunk_scan"]
        with torch.no_grad():
            y, y2 = ((mamba.ssd_dispatch(xh, al, bb, cc, chunk, "kernel")
                      if via else ssd.ssd_chunk_scan(xh, al, bb, cc,
                                                     chunk=chunk))
                     for _ in range(2))
        y_r, _ = ref.ssd_ref(xh, al, bb, cc)
        q = min(chunk, s)
        cum_min = float(torch.nn.functional.pad(al, (0, 0, 0, -s % q))
                        .reshape(b, -1, q, h).cumsum(2).min())
        torch.cuda.synchronize()
        err = float((y - y_r).abs().max())
        ref_max = float(y_r.abs().max())
        same = torch.equal(y, y2)
        ok = (err <= SSD_TOL * max(1.0, ref_max) and same
              and bool(torch.isfinite(y).all())
              and ssd.launches["ssd_chunk_scan"] == before + 2)
        print(f"check ssd_chunk_scan b={b} s={s} h={h} p={p} n={n} "
              f"chunk={chunk} A={a}{' (dispatcher pad)' if via else ''}: "
              f"max|dy|={err:.3g} max|y|={ref_max:.3g} (band {SSD_TOL} x "
              f"max(1, max|y|)), min cum {cum_min:.1f} "
              f"bitwise-repeatable={same} {'ok' if ok else 'MISS'} {tag}")
        if not ok:
            fail(f"ssd_chunk_scan disagrees with its plain version (case {i})")
        out.append(dict(case=i, a=a, max_abs_err=err, max_abs_ref=ref_max,
                        min_cum=cum_min))
        del xh, al, bb, cc, y, y2, y_r
    return out


def paged_case(dev, b, h, kv, hd, bl, mb, lengths, seed):
    """q, pools, table and lengths for the paged decode kernel: each row's
    blocks scattered over a shuffled pool, rows 0 and 1 sharing their
    first block, table entries past a row's blocks on the null block 0.
    Returns also the set of blocks some row reads."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    nb = b * mb + 1
    q, kp, vp = rnd(b, h, hd), rnd(nb, bl, kv, hd), rnd(nb, bl, kv, hd)
    perm = np.random.default_rng(seed).permutation(nb - 1) + 1
    table = np.zeros((b, mb), np.int32)
    for r, n in enumerate(lengths):
        owned = -(-int(n) // bl)
        table[r, :owned] = perm[r * mb:r * mb + owned]
    if lengths[0] >= bl and lengths[1] >= bl:
        table[1, 0] = table[0, 0]
    live = {int(table[r, i]) for r, n in enumerate(lengths)
            for i in range(-(-int(n) // bl))}
    return (q, kp, vp, torch.tensor(table, device=dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev), live)


def check_paged(dev, tag):
    """flash_paged_decode against its plain version (O_TOL), bit-equal to
    flash_decode on the view the table spells (at the default split and
    at each of DEC_SPLITS, twice), and blind to poison (1e9,
    then NaN) in every block no row reads (block 0 included) and in the
    dead rows of each row's last block."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    rng = np.random.default_rng(5)
    serving = rng.integers(900, 1101, size=16)
    serving[3], serving[5] = 1001, 0          # ragged, empty
    # (b, h, kv, hd, bl, mb, lengths): the serving decode step (16 slots,
    # ~1000 tokens each, max_len 2048 in 16-token blocks); the verify
    # re-score's grid (16 x 4 rows); the reduced config (hd 16); a block
    # length that is not a divisor of the 64-row tile
    # a block length that is not a divisor of the 64-row tile; rows whose
    # live part runs into the second split and past it, 48-row blocks
    # straddling the splits (2064 positions: the default split is 64)
    cases = [(16, 12, 2, 128, 16, 128, serving.tolist()),
             (64, 12, 2, 128, 16, 128,
              np.repeat(serving, 4).clip(1).tolist()),
             (4, 4, 1, 16, 8, 8, [37, 16, 0, 64]),
             (3, 12, 2, 128, 48, 6, [200, 97, 288]),
             (3, 32, 32, 80, 16, 8, [5, 128, 77]),
             (4, 12, 2, 128, 48, 43, [129, 65, 0, 2064]),
             (4, 32, 8, 120, 16, 8, [5, 128, 0, 77]),     # hd 120
             # g 1 (moonshot) and g 5 (qwen2.5-32b) at hd 128, 8 slots
             (8, 16, 16, 128, 16, 128, serving[:8].tolist()),
             (8, 40, 8, 128, 16, 128, serving[:8].tolist()),
             # g 1 at hd 64 (musicgen-large) and g 8 at hd 128
             # (internvl2-76b), 8 slots
             (8, 32, 32, 64, 16, 128, serving[:8].tolist()),
             (8, 64, 8, 128, 16, 128, serving[:8].tolist())]
    out = []
    for i, (b, h, kv, hd, bl, mb, lengths) in enumerate(cases):
        q, kp, vp, table, ln, live = paged_case(dev, b, h, kv, hd, bl, mb,
                                                lengths, 300 + i)
        o = fa.flash_attention_paged_decode(q, kp, vp, table, ln)
        o_r = ref.flash_attention_paged_decode_ref(q, kp, vp, table, ln)
        view = [p[table.long()].reshape(b, mb * bl, kv, hd)
                for p in (kp, vp)]
        o_d = fa.flash_attention_decode(q, *view, ln)
        # at every split phase 5 times: twice the same bits, and those of
        # flash_decode on the view
        splits_ok = all(
            torch.equal(fa.flash_attention_paged_decode(
                q, kp, vp, table, ln, split=sp), x)
            and torch.equal(x, fa.flash_attention_decode(q, *view, ln,
                                                         split=sp))
            for sp in DEC_SPLITS
            for x in [fa.flash_attention_paged_decode(q, kp, vp, table, ln,
                                                      split=sp)])
        dk, dv = kp.clone(), vp.clone()
        tbl = table.cpu().numpy()
        uses = np.bincount(tbl.ravel(), minlength=kp.shape[0])
        poisoned = []
        for poison in (1e9, float("nan")):
            for blk in range(kp.shape[0]):
                if blk not in live:
                    dk[blk] = poison
                    dv[blk] = poison
            # the dead rows of a row's last block, unless another row
            # reads that block
            for r, n in enumerate(lengths):
                last = int(tbl[r, (n - 1) // bl]) if n else 0
                if n % bl and uses[last] == 1:
                    dk[last, n % bl:] = poison
                    dv[last, n % bl:] = poison
            poisoned.append(fa.flash_attention_paged_decode(q, dk, dv, table,
                                                            ln))
        torch.cuda.synchronize()
        e_o, r_o = rel_err(o, o_r)
        d_view = float((o.float() - o_d.float()).abs().max())
        zero_rows = [r for r, n in enumerate(lengths) if n == 0]
        ok = (r_o <= O_TOL and bool(torch.isfinite(o).all())
              and torch.equal(o, o_d) and splits_ok
              and all(torch.equal(o, x) for x in poisoned)
              and all(float(o[r].float().abs().max()) == 0.0
                      for r in zero_rows))
        print(f"check flash_paged_decode b={b} h={h} kv={kv} hd={hd} bl={bl} "
              f"mb={mb} lengths in [{min(lengths)},{max(lengths)}]: "
              f"max|dO|={e_o:.3g} rel={r_o:.3g}, vs flash_decode on the "
              f"gathered view max|d|={d_view:.3g}, at splits {DEC_SPLITS} "
              f"bit-equal to it and repeatable {splits_ok}, poison 1e9/NaN "
              f"{[torch.equal(o, x) for x in poisoned]} "
              f"{'ok' if ok else 'MISS'} {tag}")
        if not ok:
            fail(f"flash_paged_decode check failed (case {i})")
        out.append(dict(case=i, hd=hd, max_abs_err=e_o, rel_err=r_o,
                        vs_flash_decode=d_view))
    return out


def time_kernels(dev, tag, timer, hybrid_lengths):
    """Times at the main paths' shapes: a 256-row prefill chunk at offset
    768 against a 2048-slot cache (row 2) and a 16-slot decode step (row
    3) of serving; the forward without an offset (row 1) and the two
    backward kernels (rows 5, 6) at the training shape, q [4,1024,12,128]
    against kv [4,1024,2,128], causal, and at zamba2's microbatch through
    its shared block, [2,1024,32,80] (g 1); the SSD scan (row 7) at the
    hybrid training shape; the forward and backward at danube's training
    microbatch, q [2,1024,32,120] against kv [2,1024,8,120], and its decode
    step, q [8,32,120] against [8,2048,8,120] (hd 120); the decode step
    of zamba2's serving (4j), q [16,32,80] against its [16,2048,32,80]
    rings at the lengths 4j reached (``hybrid_lengths``), hd 80, g 1."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    g = torch.Generator(device=dev).manual_seed(7)

    def rnd(shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    h, kv, hd = 12, 2, 128

    def fwd_record(b, sq, sk, off, h=h, kv=kv, hd=hd):
        q, k, v = (rnd((b, sq, h, hd)), rnd((b, sk, kv, hd)),
                   rnd((b, sk, kv, hd)))
        offt = (None if off is None
                else torch.tensor([off], dtype=torch.int32, device=dev))
        by, fl = fwd_work(b, sq, sk, h, kv, hd, off or 0, True, None)
        bms, bby = bound(by, fl)
        ms = timer(lambda: fa.flash_attention_fwd(q, k, v, q_offset=offt))
        rec = dict(
            shape=f"q[{b},{sq},{h},{hd}] kv[{b},{sk},{kv},{hd}] "
                  f"q_offset={off}",
            ms=ms,
            enqueue_ms=timer(lambda: fa.flash_attention_fwd(
                q, k, v, q_offset=offt), hold=False),
            plain_ms=timer(lambda: ref.flash_attention_fwd_ref(
                q, k, v, q_offset=off)),
            bound_ms=bms, bound_by=bby, bytes=by, flops=fl,
            tflops=fl / ms * 1e-9, bound_share=bms / ms)
        print(f"time flash_fwd q[{b},{sq},{h},{hd}] q_offset={off}: "
              f"enqueue-inclusive (no hold) {rec['enqueue_ms']:.4f} ms")
        try:
            rec["library_ms"] = timer(sdpa_fwd(q, k, v, off or 0, True, None,
                                               hd ** -0.5))
        except (TypeError, RuntimeError) as e:  # no enable_gqa in this torch
            print(f"SDPA yardstick unavailable: {e}")
            rec["library_ms"] = None
        return rec

    out = {"flash_fwd": fwd_record(1, 256, 2048, 768),
           "flash_fwd (row 1, training shape)": fwd_record(
               TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, None),
           "flash_fwd (row 1, hd 80, zamba2 microbatch)": fwd_record(
               TRAIN_MICRO, TRAIN_SEQ, TRAIN_SEQ, None, 32, 32, 80)}

    out.update(time_decode(dev, timer, rnd, h, kv, hd))
    out.update(time_bwd(dev, timer, rnd, TRAIN_BATCH, h, kv, hd))
    out.update({f"{k} (hd 80, zamba2 microbatch)": v for k, v in time_bwd(
        dev, timer, rnd, TRAIN_MICRO, 32, 32, 80).items()})
    # hd 120: danube's training microbatch (its 4096 window does not bind
    # at 1024) and its serving decode step, 8 slots x 2048
    out[f"flash_fwd {HD120}"] = fwd_record(TRAIN_MICRO, TRAIN_SEQ, TRAIN_SEQ,
                                           None, 32, 8, 120)
    out.update({f"{k} {HD120}": v for k, v in time_bwd(
        dev, timer, rnd, TRAIN_MICRO, 32, 8, 120).items()})
    out.update({f"{k} {HD120}": v for k, v in time_decode(
        dev, timer, rnd, 32, 8, 120, b=DANUBE_SLOTS, paged=False).items()})
    out.update({f"{k} (hd 80, zamba2 serving)": v for k, v in time_decode(
        dev, timer, rnd, 32, 32, 80, b=HYBRID_SLOTS, paged=False,
        lengths=hybrid_lengths).items()})
    # the control of the hd-120 backward rows: the hd-128 instances at
    # danube's batch and heads (the instance's own cost against the shape's)
    out.update({f"{k} (hd 128 at danube's heads)": v for k, v in time_bwd(
        dev, timer, rnd, TRAIN_MICRO, 32, 8, 128).items()})
    out["ssd_chunk_scan"] = time_ssd(dev, timer)
    for name, r in out.items():
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        bwd = (f", backward (chunked recompute) {r['bwd_ms']:.4f} ms"
               if "bwd_ms" in r else "")
        if "tflops" in r:
            bwd += (f", {r['tflops']:.1f} TFLOP/s, {100 * r['bound_share']:.1f}"
                    f"% of its bound")
        if name == "ssd_chunk_scan":
            bwd += f", enqueue-inclusive (no hold) {r['enqueue_ms']:.4f} ms"
        print(f"time {name} {r['shape']}: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, library {lib}{bwd} {tag}")
    return out


def time_decode(dev, timer, rnd, h, kv, hd, b=16, paged=True,
                lengths=None):
    """Row 3: a ``b``-slot decode step of serving against 2048-slot caches
    (``lengths``, or lengths drawn from default_rng(0)); row 4
    (``paged``): the paged kernel on the same lengths."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    scale = hd ** -0.5
    s = 2048
    q, kc, vc = rnd((b, h, hd)), rnd((b, s, kv, hd)), rnd((b, s, kv, hd))
    if lengths is None:
        ln = np.random.default_rng(0).integers(1, s + 1, size=b)
        ln[0], ln[-1] = 1, s
    else:
        ln = np.asarray(lengths)
    lengths = torch.tensor(ln, dtype=torch.int32, device=dev)
    by, fl = decode_work(ln, h, kv, hd, None)
    bms, bby = bound(by, fl)
    rec = dict(
        shape=f"q[{b},{h},{hd}] cache[{b},{s},{kv},{hd}] "
              f"sum(lengths)={int(ln.sum())}",
        **decode_times("flash_decode", timer,
                       lambda **kw: fa.flash_attention_decode(
                           q, kc, vc, lengths, **kw), b, kv, s, bms),
        plain_ms=timer(lambda: ref.flash_attention_decode_ref(
            q, kc, vc, lengths)),
        bound_ms=bms, bound_by=bby, bytes=by, flops=fl)
    try:
        rec["library_ms"] = timer(sdpa_decode(q, kc, vc, lengths, None,
                                              scale))
    except (TypeError, RuntimeError) as e:
        print(f"SDPA yardstick unavailable: {e}")
        rec["library_ms"] = None
    if not paged:
        return {"flash_decode": rec}
    return {"flash_decode": rec,
            "flash_paged_decode": time_paged(dev, timer, ln, h, kv, hd,
                                             scale)}


def decode_times(name, timer, fn, b, kv, positions, bms):
    """A decode kernel's device time at the default split, its
    enqueue-inclusive time (no hold: the wrapper's host time shows), and
    its device time at each of DEC_SPLITS; printed."""
    from repro_torch.kernels import flash_attention as fa

    split = fa.decode_split(positions)
    rec = dict(ms=timer(fn), enqueue_ms=timer(fn, hold=False), split=split,
               split_ms={sp: timer(lambda sp=sp: fn(split=sp))
                         for sp in DEC_SPLITS})
    rec["bound_share"] = bms / rec["ms"]
    sweep = ", ".join(f"{sp}: {t:.4f}" for sp, t in rec["split_ms"].items())
    print(f"time {name} b={b} kv={kv} "
          f"positions={positions}: default split {split}, device "
          f"{rec['ms']:.4f} ms, enqueue-inclusive (no hold) "
          f"{rec['enqueue_ms']:.4f} ms, {100 * rec['bound_share']:.1f}% of "
          f"its bound; device ms by split {{{sweep}}}")
    return rec


def time_paged(dev, timer, ln, h, kv, hd, scale):
    """The paged decode kernel at the serving shape: 16 rows with row 3's
    lengths (the same as the flash_decode timing), 16-token blocks
    scattered over a pool of 16 x 128 + 1 blocks.  Library yardstick: two
    calls, as no single PyTorch call reads through a table: index_select
    gathers each row's view (K and V), then SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    b, bl, mb = len(ln), 16, 128
    q, kp, vp, table, lengths, _ = paged_case(dev, b, h, kv, hd, bl, mb,
                                              ln.tolist(), 400)
    by, fl = decode_work(ln, h, kv, hd, None)
    by += 4 * float(np.ceil(ln / bl).sum())          # live table entries
    bms, bby = bound(by, fl)
    rec = dict(
        shape=f"q[{b},{h},{hd}] pools[{kp.shape[0]},{bl},{kv},{hd}] table "
              f"[{b},{mb}] sum(lengths)={int(ln.sum())}; library = "
              f"index_select gather + SDPA (two calls)",
        **decode_times("flash_paged_decode", timer,
                       lambda **kw: fa.flash_attention_paged_decode(
                           q, kp, vp, table, lengths, **kw), b, kv, mb * bl,
                       bms),
        plain_ms=timer(lambda: ref.flash_attention_paged_decode_ref(
            q, kp, vp, table, lengths)),
        bound_ms=bms, bound_by=bby, bytes=by, flops=fl)
    flat = table.reshape(-1)
    mask = (torch.arange(mb * bl, device=dev)[None, :]
            < lengths.long()[:, None])[:, None, None, :]
    qt = q[:, :, None, :]

    def gather_sdpa():
        kc = kp.index_select(0, flat).view(b, mb * bl, kv, hd).transpose(1, 2)
        vc = vp.index_select(0, flat).view(b, mb * bl, kv, hd).transpose(1, 2)
        return F.scaled_dot_product_attention(qt, kc, vc, attn_mask=mask,
                                              scale=scale, enable_gqa=True)
    try:
        rec["library_ms"] = timer(gather_sdpa)
    except (TypeError, RuntimeError) as e:   # no enable_gqa in this torch
        print(f"gather + SDPA yardstick unavailable: {e}")
        rec["library_ms"] = None
    return rec


def time_ssd(dev, timer):
    """ssd_chunk_scan at the hybrid training shape (one Mamba layer of a
    2 x 1024 microbatch: xh [2,1024,80,64], N 64, chunk 256).  Plain: the
    sequential recurrence.  Library: no single PyTorch call computes the
    scan, so the yardstick is the chunked PyTorch scan
    (kernels/ssd.ssd_scan: batched matmuls and a carry over 4 chunks).
    The kernel's time also without the stream held (enqueue-inclusive:
    the wrapper's host time shows if it exceeds the two launches).  Also
    the backward of ops.ssd_chunk_scan_diff (the chunked scan recomputed
    under autograd, then its backward), which no kernel carries."""
    from repro_torch.kernels import ops, ref, ssd

    b, s, h, p, n, q = TRAIN_MICRO, TRAIN_SEQ, 80, 64, 64, 256
    xh, al, bb, cc = ssd_inputs(dev, b, s, h, p, n, 600)
    by, fl = ssd_work(b, s, h, p, n, q)
    bms, bby = bound(by, fl)
    ins = [t.clone().requires_grad_(True) for t in (xh, al, bb, cc)]
    y = ops.ssd_chunk_scan_diff(*ins, q)
    dy = torch.randn_like(y)
    bwd_ms = timer(lambda: torch.autograd.grad(y, ins, dy, retain_graph=True),
                   n=5)
    del ins, y, dy
    with torch.no_grad():
        def kernel():
            return ssd.ssd_chunk_scan(xh, al, bb, cc, chunk=q)

        ms = timer(kernel)
        return dict(
            shape=f"xh[{b},{s},{h},{p}] bb/cc[{b},{s},{n}] chunk {q}; "
                  f"library = the chunked PyTorch scan (kernels/ssd."
                  f"ssd_scan), no single call computes it",
            ms=ms, enqueue_ms=timer(kernel, hold=False), bwd_ms=bwd_ms,
            plain_ms=timer(lambda: ref.ssd_ref(xh, al, bb, cc), n=3, warm=1),
            library_ms=timer(lambda: ssd.ssd_scan(xh, al, bb, cc, q), n=5),
            bound_ms=bms, bound_by=bby, bytes=by, flops=fl,
            tflops=fl / ms * 1e-9, bound_share=bms / ms)


def bwd_work(b, s, h, kv, hd, causal, window, which):
    """Bytes (each input read once, each output written once) and FLOPs
    of the dq kernel (3 products over the visible keys: S, dP, dQ) or the
    dk/dv kernel (4: S, dP, dK, dV)."""
    n, _, _ = fwd_visible(s, s, 0, causal, window)
    vis = float(n.sum())
    qsz, kvsz, rows = b * s * h * hd * 2, b * s * kv * hd * 2, b * h * s * 4
    if which == "dq":   # q, o, do, k, v, lse in; dq, delta out
        return 4 * qsz + 2 * kvsz + 2 * rows, 3 * 2.0 * hd * h * b * vis
    # q, do, k, v, lse, delta in; dk, dv out
    return 2 * qsz + 4 * kvsz + 2 * rows, 4 * 2.0 * hd * h * b * vis


def time_bwd(dev, timer, rnd, b, h, kv, hd):
    """The two backward kernels timed apart at a training shape; the
    plain version and SDPA's backward compute dq, dk and dv together, so
    both rows carry the same plain and library time."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    s = TRAIN_SEQ
    q, k, v, do = (rnd((b, s, h, hd)), rnd((b, s, kv, hd)),
                   rnd((b, s, kv, hd)), rnd((b, s, h, hd)))
    o, lse = fa.flash_attention_fwd(q, k, v)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do)
    plain_ms = timer(lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do),
                     n=5)
    # the library time: the fastest pinned SDPA backend
    sdpa_ms = {backend: timer(fn) for fn, _, backend in sdpa_bwd(q, k, v, do)}
    backend = min(sdpa_ms, key=sdpa_ms.get) if sdpa_ms else "none"
    lib_ms = sdpa_ms.get(backend)
    print(f"time SDPA backward by pinned backend: "
          + ", ".join(f"{n}: {t:.4f} ms" for n, t in sdpa_ms.items()))
    shape = (f"q/do [{b},{s},{h},{hd}] kv [{b},{s},{kv},{hd}] causal; plain "
             f"and SDPA times are the whole backward; SDPA backend "
             f"{backend} (the fastest pinned)")
    fns = {"flash_bwd_dq": lambda: fa.flash_attention_bwd_dq(
               q, k, v, o, lse, do),
           "flash_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(
               q, k, v, lse, delta, do)}
    out_rec = {}
    for name, fn in fns.items():
        by, fl = bwd_work(b, s, h, kv, hd, True, None, name[len("flash_bwd_"):])
        bms, bby = bound(by, fl)
        ms = timer(fn)
        out_rec[name] = dict(shape=shape, ms=ms, plain_ms=plain_ms,
                             bound_ms=bms, bound_by=bby, bytes=by, flops=fl,
                             library_ms=lib_ms, sdpa_ms=sdpa_ms,
                             tflops=fl / ms * 1e-9, bound_share=bms / ms)
    # dk/dv at every split of the group (the wrapper picks one)
    g = h // kv
    splits = {sp: timer(lambda sp=sp: fa.flash_attention_bwd_dkv(
        q, k, v, lse, delta, do, split=sp))
        for sp in range(1, g + 1) if g % sp == 0}
    out_rec["flash_bwd_dkv"]["split_ms"] = splits
    print(f"time flash_bwd_dkv by split of the group (g {g}): "
          + ", ".join(f"{sp}: {t:.4f} ms" for sp, t in splits.items()))
    return out_rec


def checked_server():
    """A Server that counts the non-finite logits of every prefill,
    decode step and speculative round (its last draft step)."""
    from repro_torch.runtime.serve import Server

    class CheckedServer(Server):
        nonfinite = 0

        def _admit(self, req, slot, method="chunked"):
            ev = super()._admit(req, slot, method)
            self.nonfinite += int((~np.isfinite(
                self.prefill_logits[slot])).sum())
            return ev

        def decode_once(self, forced_tokens=None):
            ev = super().decode_once(forced_tokens)
            if ev:
                self.nonfinite += int((~torch.isfinite(
                    self.last_logits)).sum())
            return ev

        def spec_once(self):
            ev = super().spec_once()
            if ev:
                self.nonfinite += int((~torch.isfinite(
                    self.last_logits)).sum())
            return ev
    return CheckedServer


def serve_full_width(dev, tag, profile=False):
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_workload
    from repro_torch.models.model import LM
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = get_arch("qwen2-1.5b")
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serve: {cfg.name} full width, {cfg.n_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab}, {n_params / 1e9:.3f} B params "
          f"bf16, init {time.perf_counter() - t0:.1f}s {tag}")
    scfg = ServeConfig(slots=16, max_len=2048, prefill_chunk=256)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab,
                            size=int(rng.integers(256, 1537))).tolist()
               for _ in range(32)]

    CheckedServer = checked_server()
    warm = Server(model, params, scfg)      # first launches, cuBLAS set-up
    warm.admit(prompts[0][:300], 0, max_new_tokens=2)
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    srv = CheckedServer(model, params, scfg)
    fa.reset_launches()
    ops.reset_plain_calls()
    rec = run_workload(srv, [(0.0, p) for p in prompts], gen=32)
    launches = dict(fa.launches)
    plain = dict(ops.plain_calls)
    peak = torch.cuda.max_memory_allocated(dev)

    L = cfg.n_layers
    reasons = set(srv.finished.values())
    print(f"serve: {rec['requests']} requests, {rec['prompt_tokens']} prompt "
          f"tokens, {rec['generated_tokens']} generated, "
          f"{srv.prefill_dispatches} prefill dispatches, "
          f"{srv.decode_dispatches} decode dispatches, retire reasons "
          f"{sorted(reasons)}")
    print(f"serve: launches {launches}, plain calls {plain}")
    if rec["requests"] != 32 or len(srv.finished) != 32 or reasons != {"length"}:
        fail(f"not every request retired by length: {srv.finished}")
    if any(len(srv.outputs[r]) != 32 for r in srv.finished):
        fail("a request did not produce 32 tokens")
    if launches["flash_fwd"] != L * srv.prefill_dispatches:
        fail(f"flash_fwd launched {launches['flash_fwd']} times, expected "
             f"{L} x {srv.prefill_dispatches}")
    if launches["flash_decode"] != L * srv.decode_dispatches:
        fail(f"flash_decode launched {launches['flash_decode']} times, "
             f"expected {L} x {srv.decode_dispatches}")
    if launches["flash_paged_decode"]:
        fail("the linear tier launched the paged decode kernel")
    if launches["flash_fwd_f32"]:
        fail("the bf16 model launched the f32-query forward kernel")
    if any(plain.values()):
        fail(f"a plain version ran on the main path: {plain}")
    if srv.nonfinite:
        fail(f"{srv.nonfinite} non-finite logits")
    ms = 1e3
    print(f"serve metrics: prefill {rec['prefill_tok_per_s']:.1f} tok/s, "
          f"decode {rec['decode_tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{rec['ttft_p50_s'] * ms:.1f} ms p95 {rec['ttft_p95_s'] * ms:.1f} "
          f"ms, ITL p50 {rec['itl_p50_s'] * ms:.2f} ms p95 "
          f"{rec['itl_p95_s'] * ms:.2f} ms, wall {rec['wall_s']:.2f} s, "
          f"peak memory {peak / 2**30:.2f} GiB {tag}")
    slim = {k: v for k, v in rec.items() if k not in ("itl_s", "ttft_s")}
    slim.update(prefill_dispatches=srv.prefill_dispatches,
                decode_dispatches=srv.decode_dispatches,
                peak_memory_bytes=peak)
    streams = {r: list(t) for r, t in srv.outputs.items()}
    del srv
    if profile:
        slim["profile"] = profile_serve(model, params, scfg, prompts, tag)
    torch.cuda.empty_cache()
    return slim, launches, (model, params, prompts, streams)


# 4c: the paged tier.  P1's pool: 769 blocks (6 x 128 + 1) preempt no
# request on phase 4's prompts, whose admissions wait for blocks instead;
# the largest count below it that preempts, found by replaying the
# scheduler on the CPU (its choices depend on the prompt and output
# lengths only), is 760, and 740 preempts twice.
P1_BLOCKS = 740
P3_PREFIX, P3_REQUESTS = 512, 32


def counting_lm(cfg, dev):
    """An LM whose entry points count their calls and accumulate the
    number of non-finite logits on the device (read once, at the end)."""
    from repro_torch.models.model import LM

    class CountingLM(LM):
        def reset_counts(self):
            self.calls = dict(decode_step=0, parallel_prefill=0,
                              scan_prefill=0, rescore=0)
            self.nonfinite = torch.zeros((), dtype=torch.long, device=dev)

        def _seen(self, logits):
            self.nonfinite += (~torch.isfinite(logits)).sum()
            return logits

        def decode_step(self, params, cache, tokens, active=None):
            self.calls["decode_step"] += 1
            lg, cache = super().decode_step(params, cache, tokens, active)
            return self._seen(lg), cache

        def prefill_chunk(self, params, cache, tokens, slot, n_valid,
                          impl="auto"):
            self.calls["scan_prefill" if impl == "scan"
                       else "parallel_prefill"] += 1
            lg, cache = super().prefill_chunk(params, cache, tokens, slot,
                                              n_valid, impl)
            return self._seen(lg), cache

        def decode_rescore(self, params, cache, tokens, rows, positions):
            self.calls["rescore"] += 1
            return self._seen(super().decode_rescore(params, cache, tokens,
                                                     rows, positions))

    model = CountingLM(cfg)
    model.reset_counts()
    return model


def serve_paged(base, lin_decode, dev, tag):
    """Phase 4c: the paged tier at full width on phase 4's weights.
    P1: 16 slots on a pool of P1_BLOCKS blocks with the prefix cache,
    phase 4's 32 prompts; it must preempt.  P2: 16 slots on the default
    pool (2049 blocks) with spec_k = 4.  Both must give phase 4's
    streams.  P3: 32 slots on 2049 blocks (phase 4's cache bytes),
    P3_REQUESTS requests sharing a 512-token system prefix, once with the
    prefix cache and once without; equal streams, and every request after
    the first re-links the prefix."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_workload
    from repro_torch.runtime.serve import ServeConfig, Server

    lin_model, params, prompts, lin_streams = base
    cfg = lin_model.cfg
    model = counting_lm(cfg, dev)
    L, gen = cfg.n_layers, 32
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab, size=P3_PREFIX).tolist()
    shared = [prefix + rng.integers(
        0, cfg.vocab, size=int(rng.integers(128, 1025))).tolist()
        for _ in range(P3_REQUESTS)]
    base_kw = dict(max_len=2048, prefill_chunk=256, paged=True, block_len=16)
    runs = [
        ("P1", prompts, dict(slots=16, n_blocks=P1_BLOCKS)),
        ("P2", prompts, dict(slots=16, spec_k=4)),
        ("P3", shared, dict(slots=32, n_blocks=2049)),
        ("P3 no prefix cache", shared, dict(slots=32, n_blocks=2049,
                                            prefix_cache=False)),
    ]
    # first launches of the paged shapes (the rescore's GEMMs among them)
    warm = Server(model, params, ServeConfig(slots=16, spec_k=4, **base_kw))
    warm.admit(prompts[0][:300], 0, max_new_tokens=6)
    warm.run()
    del warm
    out, total, streams = {}, {k: 0 for k in fa.launches}, {}
    for name, reqs, kw in runs:
        scfg = ServeConfig(**base_kw, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        srv = Server(model, params, scfg)
        model.reset_counts()
        fa.reset_launches()
        ops.reset_plain_calls()
        rec = run_workload(srv, [(0.0, p) for p in reqs], gen=gen)
        launches, plain = dict(fa.launches), dict(ops.plain_calls)
        calls, nonfinite = dict(model.calls), int(model.nonfinite)
        peak = torch.cuda.max_memory_allocated(dev)
        streams[name] = {r: list(t) for r, t in srv.outputs.items()}
        counters = dict(prefill_dispatches=srv.prefill_dispatches,
                        decode_dispatches=srv.decode_dispatches,
                        verify_dispatches=srv.verify_dispatches,
                        preemptions=srv.preemptions,
                        prompt_cache_hits=srv.prompt_cache_hits)
        want = {"flash_paged_decode": L * (calls["decode_step"]
                                           + calls["rescore"]),
                "flash_fwd": L * calls["parallel_prefill"],
                "flash_fwd_f32": 0, "flash_decode": 0}
        print(f"paged {name}: {scfg.slots} slots, {srv.n_blocks} blocks of "
              f"{scfg.block_len}, spec_k {scfg.spec_k}, prefix cache "
              f"{scfg.prefix_cache}: {rec['requests']} requests, "
              f"{rec['prompt_tokens']} prompt tokens admitted; {counters}; "
              f"calls {calls}")
        print(f"paged {name}: launches {launches} (want {want}), plain "
              f"calls {plain}, non-finite logits {nonfinite}")
        reasons = set(srv.finished.values())
        if (len(srv.finished) != len(reqs) or reasons != {"length"}
                or srv.pending()):
            fail(f"paged {name}: not every request retired by length: "
                 f"{srv.finished}")
        if any(len(t) != gen for t in streams[name].values()):
            fail(f"paged {name}: a request did not produce {gen} tokens")
        if any(launches[k] != v for k, v in want.items()):
            fail(f"paged {name}: launches {launches}, expected {want}")
        if (calls["rescore"] != srv.verify_dispatches
                or calls["parallel_prefill"] + calls["scan_prefill"]
                != srv.prefill_dispatches):
            fail(f"paged {name}: calls {calls} do not match {counters}")
        if any(plain.values()):
            fail(f"paged {name}: a plain version ran: {plain}")
        if nonfinite:
            fail(f"paged {name}: {nonfinite} non-finite logits")
        ms = 1e3
        print(f"paged {name} metrics: prefill {rec['prefill_tok_per_s']:.1f} "
              f"tok/s, decode {rec['decode_tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{rec['ttft_p50_s'] * ms:.1f} ms p95 "
              f"{rec['ttft_p95_s'] * ms:.1f} ms, ITL p50 "
              f"{rec['itl_p50_s'] * ms:.2f} ms p95 "
              f"{rec['itl_p95_s'] * ms:.2f} ms, wall {rec['wall_s']:.2f} s, "
              f"peak memory {peak / 2**30:.2f} GiB {tag}")
        slim = {k: v for k, v in rec.items() if k not in ("itl_s", "ttft_s")}
        slim.update(counters, calls=calls, launches=launches,
                    peak_memory_bytes=peak, n_blocks=srv.n_blocks)
        out[name] = slim
        for k in total:
            total[k] += launches[k]
        del srv
        torch.cuda.empty_cache()

    print(f"paged P2 vs phase 4: {out['P2']['decode_dispatches']} "
          f"speculative rounds + {out['P2']['verify_dispatches']} verify "
          f"dispatches against phase 4's {lin_decode} decode dispatches")
    if out["P1"]["preemptions"] < 1:
        fail(f"paged P1 did not preempt on {P1_BLOCKS} blocks")
    for name in ("P1", "P2"):
        if streams[name] != lin_streams:
            bad = [r for r in lin_streams
                   if streams[name].get(r) != lin_streams[r]]
            fail(f"paged {name}: streams differ from phase 4's linear "
                 f"streams for requests {bad}")
    if out["P3"]["prompt_cache_hits"] < (P3_REQUESTS - 1) * P3_PREFIX:
        fail(f"paged P3 re-linked {out['P3']['prompt_cache_hits']} prompt "
             f"tokens, expected >= {(P3_REQUESTS - 1) * P3_PREFIX}")
    if streams["P3"] != streams["P3 no prefix cache"]:
        fail("paged P3: streams with and without the prefix cache differ")
    print(f"paged: P1 and P2 streams equal phase 4's, P3's equal without "
          f"the prefix cache; P1 preempted {out['P1']['preemptions']} "
          f"times, P3 re-linked {out['P3']['prompt_cache_hits']} prompt "
          f"tokens {tag}")
    return out, total


# 4e: the plan path.  The decode shape the serving harness solves for,
# and the meshes whose plans are printed (solved only: one card here).
PLAN_SHAPE = ("serve16x2048", 2048, 16, "decode")
# 4e serves the first PLAN_SERVE_REQS of phase 4's requests under the
# (1, 1) plan (all 32 until the embedding-stub phases needed the time, 16
# until the observed engines did)
PLAN_SERVE_REQS = 8
PLAN_MESHES = ((1, 1), (4, 2), (2, 4))
# decode steps timed with and without the plan (8 until the SSM phases
# needed the time)
PLAN_STEPS = 4
# the gathered route: requests, prompt tokens and tokens generated each
# (4 requests until the SSM phases needed the time)
FALLBACK_REQS, FALLBACK_PROMPT, FALLBACK_GEN = 2, 600, 8


def decode_step_times(srv, n, tag, label):
    """Host and device ms of ``n`` decode steps of a full pool: the host
    ms is the wall time of the ``LM.decode_step`` call (its enqueue; the
    step reads nothing back), the wall ms that of ``n`` steps ended by a
    device sync, and the device ms the kernels' device time per step
    under torch.profiler (a separate run of ``n`` steps)."""
    tokens = torch.as_tensor(srv.next_tok, device=srv.device)
    active = torch.as_tensor(srv.active, device=srv.device)

    def step():
        srv.model.decode_step(srv.params, srv.cache, tokens, active)
    return step_times(step, n, tag, f"decode step {label}")


def scan_step_times(srv, n, tag, label):
    """``decode_step_times`` for the scan prefill's batch-1 step: one
    token into slot 0 a call (``LM.prefill_chunk`` of one token)."""
    tok = torch.zeros(1, dtype=torch.long, device=srv.device)

    def step():
        srv.model.prefill_chunk(srv.params, srv.cache, tok, 0, 1)
    return step_times(step, n, tag, f"scan step {label}")


def step_times(step, n, tag, what):
    """Host ms of each of ``n`` calls of ``step`` (after one warm call),
    wall ms of the ``n`` ended by a device sync, and device ms per call
    under torch.profiler (a separate ``n``); printed."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType

    step()
    torch.cuda.synchronize()
    host = []
    t0 = time.perf_counter()
    for _ in range(n):
        t = time.perf_counter()
        step()
        host.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e3 / n
    rec = dict(host_ms=float(np.mean(host)), wall_ms=wall_ms,
               device_ms=dev_ms)
    print(f"plan: {what}: host {rec['host_ms']:.3f} ms, wall "
          f"{wall_ms:.3f} ms (n {n}, synced at the end), device "
          f"{dev_ms:.3f} ms (profiler) {tag}")
    return rec


def serve_plan(base, lin_launches, dev, tag, mesh):
    """Phase 4e: phase 4's workload on phase 4's weights under the solved
    (1, 1) decode plan, on the world-1 NCCL group and the (1, 1)
    DeviceMesh ``mesh``: its first PLAN_SERVE_REQS requests.  The streams
    must be phase 4's token for token, flash_fwd and flash_decode must
    launch exactly L a prefill chunk and L a decode step, no
    attention may fall back to the plain path, no plain version may run,
    no logit may be non-finite.  Also prints the (4, 2) and (2, 4) plans
    (solved only), the solve times, and a decode step's host and device
    ms with and without the plan.  Returns the (1, 1) plan too (phase 4i
    serves under it)."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.compile import plan_from_record, solve_cell_plan
    from repro_torch.launch.mesh import solver_axes
    from repro_torch.launch.serve import run_workload
    from repro_torch.models.model import LM
    from repro_torch.runtime.serve import ServeConfig, Server

    lin_model, params, prompts, lin_streams = base
    cfg = lin_model.cfg
    L = cfg.n_layers
    print(f"plan: {dist.get_backend()} group of {dist.get_world_size()}, "
          f"mesh {tuple(mesh.mesh.shape)} {mesh.mesh_dim_names}")
    shape = ShapeConfig(*PLAN_SHAPE)
    plans, solves = {}, {}
    for m in PLAN_MESHES:
        name = f"{m[0]}x{m[1]}"
        t0 = time.perf_counter()
        rec = solve_cell_plan(cfg, shape, solver_axes(m), f"mesh{name}",
                              use_cache=False)
        solves[name] = dict(solve_s=time.perf_counter() - t0,
                            total_bytes=rec["total_bytes"],
                            role_cuts=rec["role_cuts"])
        plans[m] = plan_from_record(rec)
        print(f"plan: {cfg.name} {shape.name} on a {name} mesh (data, "
              f"model), solved in {solves[name]['solve_s']:.3f} s, "
              f"solver cost {rec['total_bytes']:.6g} (bytes, with the "
              f"capacity term's)"
              f"{' (solved only: one card here)' if m != (1, 1) else ''}:")
        print(plans[m].describe())
    plan = plans[(1, 1)]

    CheckedServer = checked_server()
    scfg = ServeConfig(slots=16, max_len=2048, prefill_chunk=256)
    model = LM(cfg, plan=plan, mesh=mesh)
    warm = Server(model, params, scfg)      # DTensor's first ops
    warm.admit(prompts[0][:300], 0, max_new_tokens=2)
    warm.run()
    del warm
    torch.cuda.synchronize()
    srv = CheckedServer(model, params, scfg)
    reqs = prompts[:PLAN_SERVE_REQS]
    fa.reset_launches()
    ops.reset_plain_calls()
    rec = run_workload(srv, [(0.0, p) for p in reqs], gen=32)
    launches = dict(fa.launches)
    plain, fallbacks = dict(ops.plain_calls), dict(ops.plan_fallbacks)
    streams = {r: list(t) for r, t in srv.outputs.items()}
    print(f"plan: {rec['requests']} requests (phase 4's first "
          f"{len(reqs)}), {srv.prefill_dispatches} prefill dispatches, "
          f"{srv.decode_dispatches} decode dispatches; launches {launches}, "
          f"plain calls {plain}, plan fallbacks {fallbacks} (phase 4's 32: "
          f"{ {k: lin_launches[k] for k in ('flash_fwd', 'flash_decode')} })")
    if launches["flash_fwd"] != L * srv.prefill_dispatches:
        fail(f"plan: flash_fwd {launches['flash_fwd']} != {L} x "
             f"{srv.prefill_dispatches}")
    if launches["flash_decode"] != L * srv.decode_dispatches:
        fail(f"plan: flash_decode {launches['flash_decode']} != {L} x "
             f"{srv.decode_dispatches}")
    if any(fallbacks.values()):
        fail(f"plan: an attention call fell back to the plain path: "
             f"{fallbacks}")
    if any(plain.values()):
        fail(f"plan: a plain version ran on the plan path: {plain}")
    if srv.nonfinite:
        fail(f"plan: {srv.nonfinite} non-finite logits")
    want = {r: lin_streams[r] for r in range(len(reqs))}
    if streams != want:
        bad = [r for r in want if streams.get(r) != want[r]]
        fail(f"plan: streams differ from phase 4's for requests {bad}")
    ms = 1e3
    print(f"plan metrics: prefill {rec['prefill_tok_per_s']:.1f} tok/s, "
          f"decode {rec['decode_tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{rec['ttft_p50_s'] * ms:.1f} ms, ITL p50 "
          f"{rec['itl_p50_s'] * ms:.2f} ms, wall {rec['wall_s']:.2f} s "
          f"{tag}")
    print(f"plan: the (1, 1) plan's streams equal phase 4's token for "
          f"token; launches {L} a chunk and a step; 0 fallbacks, 0 plain "
          f"calls {tag}")
    slim = {k: v for k, v in rec.items() if k not in ("itl_s", "ttft_s")}
    slim.update(prefill_dispatches=srv.prefill_dispatches,
                decode_dispatches=srv.decode_dispatches, launches=launches,
                plan_fallbacks=fallbacks, solves=solves)
    del srv

    # a decode step of a full pool (16 slots at up to 1000 cached tokens)
    # with and without the plan, on the same weights and prompts
    steps = {}
    for label, m in (("without the plan", lin_model),
                     ("with the plan", model)):
        srv = Server(m, params, scfg)
        for s in range(scfg.slots):
            srv.admit(prompts[s][:1000], s, max_new_tokens=1000)
        torch.cuda.synchronize()
        steps[label] = decode_step_times(srv, PLAN_STEPS, tag, label)
        del srv
    slim["decode_step"] = steps
    slim["fallback"] = serve_fallback(
        lin_model, params, prompts,
        plan.with_override("kv_cache", {"data": "batch", "model": "seq_kv"}),
        mesh, scfg, tag)
    torch.cuda.empty_cache()
    return slim, launches, plan


def serve_fallback(lin_model, params, prompts, fb_plan, mesh, scfg, tag,
                   label="plan fallback",
                   decode=("attend_cache", "flash_decode")):
    """The gathered route of a plan on the card: ``fb_plan`` cuts the
    cache where no attention call has a local-shard rule (the linear
    cache on ``seq_kv``, which would split the softmax; the paged pool on
    ``blocks``, which would split a row's blocks over ranks), so each call
    gathers the query and the layer's cache (pool and table) and runs the
    kernel on them.  FALLBACK_REQS requests against the server with no
    plan on the same requests: the same streams and launches (flash_fwd
    once a layer a prefill chunk, the decode kernel ``decode[1]`` once a
    layer a decode step), each prefill call counted in
    ``plan_fallbacks["prefill_attention"]`` and each decode call in
    ``plan_fallbacks[decode[0]]``, no plain call, no non-finite logit."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.model import LM

    L = lin_model.cfg.n_layers
    kinds = ("flash_fwd", "flash_decode", "flash_paged_decode")
    CheckedServer = checked_server()
    out = {}
    for name, m in (("no plan", lin_model),
                    ("cut", LM(lin_model.cfg, plan=fb_plan, mesh=mesh))):
        srv = CheckedServer(m, params, scfg)
        fa.reset_launches()
        ops.reset_plain_calls()
        for p in prompts[:FALLBACK_REQS]:
            srv.submit(p[:FALLBACK_PROMPT], max_new_tokens=FALLBACK_GEN)
        streams = srv.run()
        out[name] = dict(
            streams={r: list(t) for r, t in streams.items()},
            launches={k: fa.launches[k] for k in kinds},
            plain=dict(ops.plain_calls), fallbacks=dict(ops.plan_fallbacks),
            prefill=srv.prefill_dispatches, decode=srv.decode_dispatches,
            nonfinite=srv.nonfinite)
        del srv
    ref, got = out["no plan"], out["cut"]
    print(f"{label}: {got['prefill']} prefill and {got['decode']} decode "
          f"dispatches; launches {got['launches']}, plan fallbacks "
          f"{got['fallbacks']}, plain calls {got['plain']} {tag}")
    want = dict.fromkeys(got["fallbacks"], 0)
    want.update({"prefill_attention": L * got["prefill"],
                 decode[0]: L * got["decode"]})
    if got["fallbacks"] != want:
        fail(f"{label}: counted {got['fallbacks']}, want {want}")
    launches = dict.fromkeys(kinds, 0)
    launches.update({"flash_fwd": L * got["prefill"],
                     decode[1]: L * got["decode"]})
    if got["launches"] != ref["launches"] or got["launches"] != launches:
        fail(f"{label}: launches {got['launches']}, without the plan "
             f"{ref['launches']}")
    if any(got["plain"].values()) or got["nonfinite"]:
        fail(f"{label}: plain calls {got['plain']}, {got['nonfinite']} "
             f"non-finite logits")
    if got["streams"] != ref["streams"]:
        fail(f"{label}: streams differ from the server with no plan")
    print(f"{label}: the gathered route's streams equal the unplanned "
          f"server's; every attention call launched its kernel {tag}")
    return {k: v for k, v in got.items() if k != "streams"}


# 4i: serving's remaining tiers under the solved (1, 1) decode plan: 4c's
# P1 and P2, the paged fallback route, and danube's scan prefill
DANUBE_PLAN_SHAPE = ("serve8x2048", DANUBE_MAX_LEN, DANUBE_SLOTS, "decode")
# (128 prompt tokens until the SSM phases needed the time)
DANUBE_PLAN_REQS, DANUBE_PLAN_PROMPT = 1, 64


def serve_paged_plan(base, paged_rec, plan, mesh, dev, tag):
    """Phase 4i, the paged tier: phase 4c's P1 (16 slots on P1_BLOCKS
    blocks with the prefix cache: it preempts and resumes) and P2 (2049
    blocks, spec_k 4: drafts and re-scores) on phase 4's weights and
    prompts under the solved (1, 1) decode plan (pool, table, params as
    DTensors; the paged decode, the offset forward and the re-score's
    kernels inside local_map).  Each must give 4c's streams (phase 4's),
    4c's dispatch counters, and 4c's launches of flash_paged_decode,
    flash_fwd and flash_decode exactly; no plan fallback, no plain call,
    no non-finite logit.  Then a paged decode step's host and device ms
    with and without the plan, and the gathered route with the pool cut on
    blocks (``serve_fallback``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_workload
    from repro_torch.models.model import LM
    from repro_torch.runtime.serve import ServeConfig, Server

    lin_model, params, prompts, lin_streams = base
    cfg = lin_model.cfg
    model = LM(cfg, plan=plan, mesh=mesh)
    base_kw = dict(max_len=2048, prefill_chunk=256, paged=True, block_len=16)
    runs = {"P1": dict(slots=16, n_blocks=P1_BLOCKS),
            "P2": dict(slots=16, spec_k=4)}
    warm = Server(model, params, ServeConfig(slots=16, spec_k=4, **base_kw))
    warm.admit(prompts[0][:300], 0, max_new_tokens=6)    # DTensor's first
    warm.run()                                           # paged ops
    del warm
    kinds = ("flash_paged_decode", "flash_fwd", "flash_decode")
    counters = ("prefill_dispatches", "decode_dispatches",
                "verify_dispatches", "preemptions", "prompt_cache_hits")
    out, total = {}, {k: 0 for k in fa.launches}
    for name, kw in runs.items():
        scfg = ServeConfig(**base_kw, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        srv = checked_server()(model, params, scfg)
        fa.reset_launches()
        ops.reset_plain_calls()
        rec = run_workload(srv, [(0.0, p) for p in prompts], gen=32)
        launches, plain = dict(fa.launches), dict(ops.plain_calls)
        fallbacks = dict(ops.plan_fallbacks)
        peak = torch.cuda.max_memory_allocated(dev)
        streams = {r: list(t) for r, t in srv.outputs.items()}
        got = {c: getattr(srv, c) for c in counters}
        want = {c: paged_rec[name][c] for c in counters}
        print(f"paged plan {name}: {got} (4c {want}); launches "
              f"{ {k: launches[k] for k in kinds} } (4c "
              f"{ {k: paged_rec[name]['launches'][k] for k in kinds} }), "
              f"plan fallbacks {fallbacks}, plain calls {plain}, "
              f"non-finite logits {srv.nonfinite}")
        if got != want:
            fail(f"paged plan {name}: counters {got}, 4c's {want}")
        if any(launches[k] != paged_rec[name]["launches"][k] for k in kinds):
            fail(f"paged plan {name}: launches {launches}, 4c's "
                 f"{paged_rec[name]['launches']}")
        if any(fallbacks.values()) or any(plain.values()) or srv.nonfinite:
            fail(f"paged plan {name}: fallbacks {fallbacks}, plain calls "
                 f"{plain}, {srv.nonfinite} non-finite logits")
        if streams != lin_streams:
            bad = [r for r in lin_streams
                   if streams.get(r) != lin_streams[r]]
            fail(f"paged plan {name}: streams differ from 4c's (phase 4's) "
                 f"for requests {bad}")
        ms = 1e3
        print(f"paged plan {name} metrics: prefill "
              f"{rec['prefill_tok_per_s']:.1f} tok/s, decode "
              f"{rec['decode_tok_per_s']:.1f} tok/s (4c "
              f"{paged_rec[name]['decode_tok_per_s']:.1f}), TTFT p50 "
              f"{rec['ttft_p50_s'] * ms:.1f} ms, ITL p50 "
              f"{rec['itl_p50_s'] * ms:.2f} ms p95 "
              f"{rec['itl_p95_s'] * ms:.2f} ms, wall {rec['wall_s']:.2f} s "
              f"(4c {paged_rec[name]['wall_s']:.2f}), peak memory "
              f"{peak / 2**30:.2f} GiB (4c "
              f"{paged_rec[name]['peak_memory_bytes'] / 2**30:.2f}) {tag}")
        slim = {k: v for k, v in rec.items() if k not in ("itl_s", "ttft_s")}
        slim.update(got, launches=launches, plan_fallbacks=fallbacks,
                    peak_memory_bytes=peak)
        out[name] = slim
        for k in total:
            total[k] += launches[k]
        del srv
        torch.cuda.empty_cache()
    print(f"paged plan: P1 and P2 under the (1, 1) plan give 4c's streams, "
          f"counters and launches; 0 fallbacks, 0 plain calls {tag}")
    steps = {}
    for label, m in (("without the plan", lin_model),
                     ("with the plan", model)):
        srv = Server(m, params, ServeConfig(slots=16, **base_kw))
        for s in range(16):
            srv.admit(prompts[s][:1000], s, max_new_tokens=1000)
        torch.cuda.synchronize()
        steps[label] = decode_step_times(srv, PLAN_STEPS, tag,
                                         f"(paged tier) {label}")
        del srv
    out["decode_step"] = steps
    out["fallback"] = serve_fallback(
        lin_model, params, prompts,
        plan.with_override("kv_cache", {"data": None, "model": "blocks"}),
        mesh, ServeConfig(slots=16, **base_kw), tag, "paged plan fallback",
        ("attend_paged", "flash_paged_decode"))
    torch.cuda.empty_cache()
    return out, total


def serve_danube_plan(dev, tag, mesh):
    """Phase 4i, danube: h2o-danube-3-4b at full width (phase 4f's
    weights, from torch.Generator(0) again) under its solved (1, 1)
    decode plan and with no plan, DANUBE_PLAN_REQS requests of
    DANUBE_PLAN_PROMPT tokens and DANUBE_GEN greedy tokens on 4f's 8
    slots x 2048: every prompt token a batch-1 scan step (under the plan
    the slot's row written and attended by its owner,
    ``attend_slot_sharded``).  Equal streams; on both runs flash_decode
    exactly n_layers x (decode dispatches + prompt tokens), flash_fwd and
    the paged kernel never; no fallback, no plain call, no non-finite
    logit.  Then the reduced danube under the plan against the CPU past
    its window.  Returns the record, the launches of both runs and the
    plan."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.compile import plan_from_record, solve_cell_plan
    from repro_torch.launch.mesh import solver_axes
    from repro_torch.launch.serve import run_workload
    from repro_torch.models.model import LM
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = get_arch(DANUBE)
    params = LM(cfg).init(0, device=dev)
    t0 = time.perf_counter()
    prec = solve_cell_plan(cfg, ShapeConfig(*DANUBE_PLAN_SHAPE),
                           solver_axes((1, 1)), "mesh1x1", use_cache=False)
    plan = plan_from_record(prec)
    print(f"danube plan: {cfg.name} {DANUBE_PLAN_SHAPE[0]} on the 1x1 mesh, "
          f"solved in {time.perf_counter() - t0:.3f} s:")
    print(plan.describe())
    scfg = ServeConfig(slots=DANUBE_SLOTS, max_len=DANUBE_MAX_LEN,
                       prefill_chunk=256)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=DANUBE_PLAN_PROMPT).tolist()
               for _ in range(DANUBE_PLAN_REQS)]
    L, scan_steps = cfg.n_layers, DANUBE_PLAN_REQS * DANUBE_PLAN_PROMPT
    out, total, streams = {}, {k: 0 for k in fa.launches}, {}
    for label, m in (("no plan", LM(cfg)),
                     ("plan", LM(cfg, plan=plan, mesh=mesh))):
        warm = Server(m, params, scfg)
        warm.admit(prompts[0][:8], 0, max_new_tokens=2)
        warm.run()
        del warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        srv = checked_server()(m, params, scfg)
        fa.reset_launches()
        ops.reset_plain_calls()
        rec = run_workload(srv, [(0.0, p) for p in prompts], gen=DANUBE_GEN)
        launches, plain = dict(fa.launches), dict(ops.plain_calls)
        fallbacks = dict(ops.plan_fallbacks)
        peak = torch.cuda.max_memory_allocated(dev)
        streams[label] = {r: list(t) for r, t in srv.outputs.items()}
        want = dict.fromkeys(launches, 0)
        want["flash_decode"] = L * (srv.decode_dispatches + scan_steps)
        ms = 1e3
        print(f"danube plan, {label}: {srv.prefill_dispatches} prefill "
              f"chunks ({scan_steps} scan steps), {srv.decode_dispatches} "
              f"decode dispatches; launches {launches} (want {want}), plan "
              f"fallbacks {fallbacks}, plain calls {plain}, non-finite "
              f"logits {srv.nonfinite}")
        print(f"danube plan, {label} metrics: scan step "
              f"{rec['prefill_s'] / scan_steps * ms:.2f} ms, decode "
              f"{rec['decode_tok_per_s']:.1f} tok/s, ITL p50 "
              f"{rec['itl_p50_s'] * ms:.2f} ms, wall {rec['wall_s']:.2f} s, "
              f"peak memory {peak / 2**30:.2f} GiB {tag}")
        if launches != want:
            fail(f"danube plan, {label}: launches {launches}, want {want}")
        if any(fallbacks.values()) or any(plain.values()) or srv.nonfinite:
            fail(f"danube plan, {label}: fallbacks {fallbacks}, plain calls "
                 f"{plain}, {srv.nonfinite} non-finite logits")
        if any(len(t) != DANUBE_GEN for t in streams[label].values()):
            fail(f"danube plan, {label}: a request did not produce "
                 f"{DANUBE_GEN} tokens")
        slim = {k: v for k, v in rec.items() if k not in ("itl_s", "ttft_s")}
        slim.update(prefill_dispatches=srv.prefill_dispatches,
                    decode_dispatches=srv.decode_dispatches,
                    scan_step_ms=rec["prefill_s"] / scan_steps * ms,
                    launches=launches, plan_fallbacks=fallbacks,
                    peak_memory_bytes=peak)
        out[label] = slim
        for k in total:
            total[k] += launches[k]
        del srv
        torch.cuda.empty_cache()
    if streams["plan"] != streams["no plan"]:
        fail("danube plan: streams differ from the server with no plan")
    print(f"danube plan: the (1, 1) plan's streams equal the unplanned "
          f"server's; launches exact, 0 fallbacks, 0 plain calls {tag}")
    del params
    torch.cuda.empty_cache()
    out["reduced_card_vs_cpu"] = reduced_scan_card_vs_cpu(dev, tag, plan,
                                                          mesh)
    return out, total


def profile_serve(model, params, scfg, prompts, tag, fill=1000, admit=768,
                  tiers=("", "paged ")):
    """Where the time goes: torch.profiler over one admission (the
    first ``admit`` tokens of the last prompt: at most 3 prefill chunks
    of 256, or that many batch-1 scan steps) and 8 decode steps of a full
    pool at up to ``fill`` cached tokens per slot, on the linear tier and
    then on the paged tier (default pool, no other request sharing a
    prefix).  Prints the kernels with the most device time and the
    device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.serve import Server

    out = {}
    for tier in tiers:
        tcfg = dataclasses.replace(scfg, paged=tier == "paged ")
        srv = Server(model, params, tcfg)
        for s in range(tcfg.slots - 1):
            srv.admit(prompts[s % len(prompts)][:fill], s,
                      max_new_tokens=1000)
        torch.cuda.synchronize()
        phases = (("prefill", lambda: srv.admit(prompts[-1][:admit],
                                                tcfg.slots - 1,
                                                max_new_tokens=1000)),
                  ("decode", lambda: [srv.decode_once() for _ in range(8)]))
        for phase, fn in phases:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            out[tier + phase] = report_profile(prof, tier + phase, wall_ms,
                                               tag)
        del srv
    return out


# host calls that make the host wait for the device (or copy synchronously)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def report_profile(prof, phase, wall_ms, tag):
    """Print and return the device's busy share of the wall time, the
    kernels with the most device time, and the host's sync calls."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    # device-side kernel events only: the aten ops that launched them
    # carry the same device time again
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in events
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    syncs = {e.key: e.count for e in events if e.key in SYNC_CALLS}
    copies = sum(e.count for e in events if e.key == "cudaMemcpyAsync")
    groups = {}
    for key, ms, n in rows:
        low = key.lower()
        g = ("repro kernels" if "repro::" in key else
             "matmul" if any(w in low for w in ("nvjet", "gemm", "cutlass"))
             else "other")
        g_ms, g_n = groups.get(g, (0.0, 0))
        groups[g] = (g_ms + ms, g_n + n)
    print(f"profile {phase}: wall {wall_ms:.2f} ms, device busy "
          f"{busy:.2f} ms ({100 * busy / wall_ms:.1f}%), "
          f"{sum(r[2] for r in rows)} kernels, host sync calls {syncs}, "
          f"cudaMemcpyAsync {copies} {tag}")
    print("  by group: " + ", ".join(
        f"{g} {ms:.3f} ms / {n} kernels" for g, (ms, n) in groups.items()))
    for key, ms, n in rows[:12]:
        print(f"  {ms:9.3f} ms {n:6d}x  {key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy, sync_calls=syncs,
                memcpy_async=copies, kernels=sum(r[2] for r in rows),
                groups={g: dict(ms=ms, count=n)
                        for g, (ms, n) in groups.items()},
                top=[dict(kernel=k, ms=m, count=n) for k, m, n in rows[:20]])


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def reduced_card_vs_cpu(dev, tag):
    """The reduced qwen2-1.5b (hd 16) on the card against the same
    weights on the CPU (plain versions): prefill and decode logits."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import LM

    cfg = get_arch("qwen2-1.5b").reduced()
    model = LM(cfg)
    p_cpu = model.init(0, device="cpu")
    p_gpu = {k: v for k, v in _to(p_cpu, dev).items()}
    rng = np.random.default_rng(1)
    worst = 0.0
    caches = {d: model.init_cache(3, 48, device=d) for d in ("cpu", dev)}
    params = {"cpu": p_cpu, dev: p_gpu}
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (5, 16, 11)]
    for slot, pr in enumerate(prompts):
        for i in range(0, len(pr), 8):
            chunk = np.pad(pr[i:i + 8], (0, max(0, 8 - len(pr[i:i + 8]))))
            nv = min(8, len(pr) - i)
            lg = {}
            for d in ("cpu", dev):
                lg[d], _ = model.prefill_chunk(
                    params[d], caches[d], torch.as_tensor(chunk, device=d),
                    slot, nv)
            worst = max(worst, float((lg["cpu"] - lg[dev].cpu()).abs().max()))
    for step in range(6):
        toks = rng.integers(0, cfg.vocab, size=3)
        act = np.array([True, True, step % 2 == 0])
        lg = {}
        for d in ("cpu", dev):
            lg[d], _ = model.decode_step(params[d], caches[d],
                                         torch.as_tensor(toks, device=d),
                                         torch.as_tensor(act, device=d))
        worst = max(worst, float((lg["cpu"].float()
                                  - lg[dev].float().cpu()).abs().max()))
    print(f"reduced qwen2-1.5b, card vs CPU: max|dlogits|={worst:.4g} "
          f"(band {LOGITS_ATOL}) {tag}")
    if not worst <= LOGITS_ATOL:
        fail("reduced model on the card disagrees with the CPU")
    return worst


def train_flops(cfg, b, s):
    """Model FLOPs of one training step (forward + backward = 3 x the
    forward's matmul and attention FLOPs; the remat recompute is not
    counted): every weight matmul, the head (tied or not: one matmul),
    and causal attention (danube's window of 4096 does not bind at the
    1024-token sequences it is given here)."""
    d, hd, h, kv, f = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    per_layer = d * (h + 2 * kv) * hd + h * hd * d + 3 * d * f
    mm = 2.0 * b * s * (cfg.n_layers * per_layer + d * cfg.vocab)
    attn = cfg.n_layers * 4.0 * hd * h * b * s * (s + 1) / 2
    return 3 * (mm + attn)


def moe_train_flops(cfg, b, s):
    """Model FLOPs of one MoE training step (3 x the forward, remat
    recompute not counted), the active experts only: the attention
    projections and causal attention, the router, the top-k experts'
    three matmuls per token (the capacity's padding rows not counted),
    and the untied head."""
    d, hd, h, kv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    m = cfg.moe
    per_layer = (d * (h + 2 * kv) * hd + h * hd * d + d * m.n_experts
                 + m.top_k * 3 * d * m.d_ff_expert)
    mm = 2.0 * b * s * (cfg.n_layers * per_layer + d * cfg.vocab)
    attn = cfg.n_layers * 4.0 * hd * h * b * s * (s + 1) / 2
    return 3 * (mm + attn)


def ssd_work(b, s, h, p, n, q):
    """Bytes (xh, a_log, B, C read once, y written once, f32) and FLOPs of
    one SSD chunk scan: per (b, h, chunk) the causal half of the Q x Q
    scores (C.B over N) and of their product with x (over P), the
    inter-chunk C.S_prev and the state update (Q x P x N each)."""
    pairs = q * (q + 1) / 2
    per_chunk = 2 * pairs * n + 2 * pairs * p + 2 * 2 * q * p * n
    return 4.0 * (2 * b * s * h * p + b * s * h + 2 * b * s * n), \
        b * h * (s // q) * per_chunk


def hybrid_train_flops(cfg, b, s):
    """Model FLOPs of one hybrid training step (3 x the forward, remat
    recompute not counted): the Mamba layers' projections (w_in, w_bcdt,
    w_out) and SSD chunk scans, the shared block's matmuls and causal
    attention at each of its L / attn_every applications, and the untied
    head."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm.state_dim
    p = cfg.ssm.head_dim
    nh = di // p
    hd, h, kv, f = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    apps = cfg.n_layers // cfg.attn_every
    mamba = d * 2 * di + d * (2 * n + nh) + di * d
    shared = d * (h + 2 * kv) * hd + h * hd * d + 3 * d * f
    mm = 2.0 * b * s * (cfg.n_layers * mamba + apps * shared + d * cfg.vocab)
    attn = apps * 4.0 * hd * h * b * s * (s + 1) / 2
    q = min(cfg.ssm.chunk, s)
    ssd = cfg.n_layers * ssd_work(b, s, nh, p, n, q)[1]
    return 3 * (mm + attn + ssd)


def train_argv(arch="qwen2-1.5b", steps=TRAIN_STEPS, batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, micro=TRAIN_MICRO):
    return ["--arch", arch, "--steps", str(steps),
            "--warmup", "2", "--batch", str(batch), "--seq",
            str(seq), "--microbatches", str(micro), "--buckets",
            "4", "--lr", "3e-4", "--log-every", "5", "--seed", "0"]


def train_full_width(dev, tag, arch="qwen2-1.5b", steps=TRAIN_STEPS,
                     n_layers=None, flops_fn=train_flops):
    """The training main path: launch.train's runner at full width, cut
    to ``n_layers`` if given (danube's depth cut, phase 4g; moonshot's,
    4m, whose model FLOPs are ``moe_train_flops``)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train

    cfg = get_arch(arch)
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)
    args = launch_train.build_argparser().parse_args(train_argv(arch, steps))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    ops.reset_plain_calls()
    rec = launch_train.run(args, cfg=cfg)
    launches = dict(fa.launches)
    plain = dict(ops.plain_calls)
    peak = torch.cuda.max_memory_allocated(dev)

    L, n = cfg.n_layers, steps
    want = {"flash_fwd": 2 * L * TRAIN_MICRO * n, "flash_fwd_f32": 0,
            "flash_decode": 0,
            "flash_paged_decode": 0, "flash_bwd_dq": L * TRAIN_MICRO * n,
            "flash_bwd_dkv": L * TRAIN_MICRO * n, "flash_bwd_dq_f32": 0,
            "flash_bwd_dkv_f32": 0}
    losses = rec["losses"]
    print(f"train: {cfg.name} full width, {L} layers "
          f"({cfg.param_count() / 1e9:.3f} B params), {n} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_MICRO} microbatches, "
          f"losses {[round(x, 4) for x in losses]}")
    print(f"train: launches {launches} (want {want}), plain calls {plain}")
    if len(losses) != n or not np.isfinite(losses).all():
        fail(f"training losses not all finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"last loss {losses[-1]} is not below the first {losses[0]}")
    if launches != want:
        fail(f"training launches {launches}, expected {want}")
    if any(plain.values()):
        fail(f"a plain version ran on the training path: {plain}")
    flops = flops_fn(cfg, TRAIN_BATCH, TRAIN_SEQ)
    mfu = flops / rec["mean_step_s"] / BF16_FLOPS_PER_S
    print(f"train metrics: {rec['tokens_per_s']:.1f} tok/s, mean step "
          f"{rec['mean_step_s'] * 1e3:.2f} ms over "
          f"{rec['meta']['measured_steps']} steps, model FLOPs "
          f"{flops / 1e12:.3f} TFLOP/step = {100 * mfu:.2f}% of 989 TFLOP/s, "
          f"peak memory {peak / 2**30:.2f} GiB, breakdown "
          f"{rec['breakdown_s']} {tag}")
    rec.update(launches=launches, peak_memory_bytes=peak,
               model_flops_per_step=flops, mfu=mfu, n_layers=L)
    return rec, launches


def train_step_times(dev, cfg, plan, mesh, tag, label, profile=False,
                     timed=STEP_TIMED, profiled=STEP_PROFILED, argv=None):
    """Host, wall and device ms of a full-width training step of phase
    4b's engine (``plan``/``mesh`` None: unplanned), fed by BatchFeed as
    the training loop feeds it: one warm step, ``timed`` steps whose
    ``step()`` calls are timed on the host (the step reads nothing back)
    and ended by one sync, then ``profiled`` steps under torch.profiler
    for the kernels' device time.  With ``profile``, the profiler's report
    too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from repro_torch.data.pipeline import BatchFeed, DataConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainConfig, make_engine

    args = launch_train.build_argparser().parse_args(argv or train_argv())
    tcfg = TrainConfig(microbatches=args.microbatches, buckets=args.buckets,
                       optim=AdamWConfig(lr=args.lr, warmup_steps=2,
                                         total_steps=args.steps))
    engine = make_engine(LM(cfg), tcfg, device=dev, mesh=mesh, plan=plan)
    state = engine.init_state(0)
    dcfg = DataConfig(seed=0, vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    feed_at = ({} if plan is None else
               dict(mesh=mesh, placements=engine.batch_placements()))
    with BatchFeed(dcfg, device=dev, **feed_at) as feed:
        state, _ = engine.step(state, feed.get())
        torch.cuda.synchronize()
        host = []
        t0 = time.perf_counter()
        for _ in range(timed):
            batch = feed.get()
            t = time.perf_counter()
            state, _ = engine.step(state, batch)
            host.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / timed
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(profiled):
                state, _ = engine.step(state, feed.get())
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
    dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e3 / profiled
    rec = dict(host_ms=float(np.mean(host)), wall_ms=wall_ms,
               device_ms=dev_ms)
    print(f"train plan: step {label}: host {rec['host_ms']:.2f} ms "
          f"(enqueue), wall {wall_ms:.2f} ms (n {timed}, synced at the "
          f"end), device {dev_ms:.2f} ms (profiler, {profiled} steps) "
          f"{tag}")
    if profile:
        rec["profile"] = report_profile(
            prof, f"train {cfg.name} {label} ({profiled} steps)",
            prof_ms, tag)
    del state, engine
    return rec


def train_plan(dev, tag, ref_rec, profile=False):
    """Phase 4h: phase 4b's training run under the solved (1, 1) train
    plan, on a world-1 NCCL group and a (1, 1) DeviceMesh, through
    launch.train's runner with --mesh 1x1 --plan auto.  Launches must be
    phase 4b's exactly, with no plan fallback and no plain call; every
    loss finite, the last below the first, each within
    TRAIN_PLAN_LOSS_REL of phase 4b's.  Also a step's host and device ms
    with and without the plan.  Tears the group down before it
    returns.  (The (4, 2) and (2, 4) train plans, solved only, are the
    CPU tests' (tests/test_torch_train_plan.py): solved here they took
    ~70 s of the smoke's time.)"""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.compile import plan_from_record, solve_cell_plan
    from repro_torch.launch.mesh import (free_port, init_distributed,
                                         make_mesh, solver_axes)

    cfg = get_arch("qwen2-1.5b")
    L, n = cfg.n_layers, TRAIN_STEPS
    init_distributed("cuda", 0, 1, free_port())
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    print(f"train plan: {dist.get_backend()} group of "
          f"{dist.get_world_size()}, mesh {tuple(mesh.mesh.shape)} "
          f"{mesh.mesh_dim_names}")
    shape = ShapeConfig(*TRAIN_PLAN_SHAPE)
    graph_kwargs = {"master_fp32": True, "error_feedback": False}
    t0 = time.perf_counter()
    plan_rec = solve_cell_plan(cfg, shape, solver_axes((1, 1)), "gpu1x1_mp",
                               use_cache=False, graph_kwargs=graph_kwargs)
    solves = {"1x1": dict(solve_s=time.perf_counter() - t0,
                          total_bytes=plan_rec["total_bytes"],
                          role_cuts=plan_rec["role_cuts"])}
    cut = sorted(r for r, c in plan_rec["role_cuts"].items()
                 if any(c.values()))
    print(f"train plan: the (1, 1) plan solved in "
          f"{solves['1x1']['solve_s']:.3f} s (solver cost "
          f"{plan_rec['total_bytes']:.6g}, roles cut: {cut or 'none'})")
    plan = plan_from_record(plan_rec)

    args = launch_train.build_argparser().parse_args(
        train_argv() + ["--mesh", "1x1", "--plan", "auto"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    ops.reset_plain_calls()
    rec = launch_train.run(args, cfg=cfg)
    launches = dict(fa.launches)
    plain, fallbacks = dict(ops.plain_calls), dict(ops.plan_fallbacks)
    peak = torch.cuda.max_memory_allocated(dev)
    want = {"flash_fwd": 2 * L * TRAIN_MICRO * n, "flash_fwd_f32": 0,
            "flash_decode": 0,
            "flash_paged_decode": 0, "flash_bwd_dq": L * TRAIN_MICRO * n,
            "flash_bwd_dkv": L * TRAIN_MICRO * n, "flash_bwd_dq_f32": 0,
            "flash_bwd_dkv_f32": 0}
    losses, ref = rec["losses"], ref_rec["losses"][:n]
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(losses, ref))
    print(f"train plan: {cfg.name} full width under the (1, 1) plan, {n} "
          f"steps, losses {[round(x, 4) for x in losses]}")
    print(f"train plan: launches {launches} (want {want}), plan fallbacks "
          f"{fallbacks}, plain calls {plain}")
    print(f"train plan: losses against phase 4b's: bit-equal "
          f"{losses == ref}, max relative gap {rel:.3g} (band "
          f"{TRAIN_PLAN_LOSS_REL})")
    if len(losses) != n or not np.isfinite(losses).all():
        fail(f"train plan: losses not all finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train plan: last loss {losses[-1]} is not below the first "
             f"{losses[0]}")
    if launches != want:
        fail(f"train plan: launches {launches}, expected {want}")
    if any(fallbacks.values()):
        fail(f"train plan: an attention call gathered: {fallbacks}")
    if any(plain.values()):
        fail(f"train plan: a plain version ran: {plain}")
    if len(ref) != n or not rel <= TRAIN_PLAN_LOSS_REL:
        fail(f"train plan: losses {losses} against phase 4b's {ref}")
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    mfu = flops / rec["mean_step_s"] / BF16_FLOPS_PER_S
    print(f"train plan metrics: {rec['tokens_per_s']:.1f} tok/s (phase 4b "
          f"{ref_rec['tokens_per_s']:.1f}), mean step "
          f"{rec['mean_step_s'] * 1e3:.2f} ms (phase 4b "
          f"{ref_rec['mean_step_s'] * 1e3:.2f}) over "
          f"{rec['meta']['measured_steps']} steps, {100 * mfu:.2f}% of 989 "
          f"TFLOP/s, peak memory {peak / 2**30:.2f} GiB (phase 4b "
          f"{ref_rec['peak_memory_bytes'] / 2**30:.2f}) {tag}")
    rec.update(launches=launches, plan_fallbacks=fallbacks,
               peak_memory_bytes=peak, model_flops_per_step=flops, mfu=mfu,
               bit_equal=losses == ref, max_rel_gap=rel, solves=solves)
    gc.collect()
    torch.cuda.empty_cache()
    steps = {}
    for label, p, m in (("without the plan", None, None),
                        ("with the plan", plan, mesh)):
        steps[label] = train_step_times(dev, cfg, p, m, tag, label,
                                        profile and p is not None)
        gc.collect()
        torch.cuda.empty_cache()
    rec["step"] = steps
    dist.destroy_process_group()
    return rec, launches


def train_hybrid_full_width(dev, tag):
    """The hybrid training main path: zamba2-2.7b through launch.train's
    runner at full width, with exact launch identities."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ssd
    from repro_torch.launch import train as launch_train

    cfg = get_arch(HYBRID_ARCH)
    args = launch_train.build_argparser().parse_args(
        train_argv(HYBRID_ARCH, HYBRID_STEPS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    ssd.reset_launches()
    ops.reset_plain_calls()
    rec = launch_train.run(args)
    launches = dict(fa.launches, **ssd.launches)
    recomputes = dict(ops.bwd_recomputes)
    plain = dict(ops.plain_calls)
    peak = torch.cuda.max_memory_allocated(dev)

    L, n, m = cfg.n_layers, HYBRID_STEPS, TRAIN_MICRO
    apps = L // cfg.attn_every
    want = {"flash_fwd": 2 * apps * m * n, "flash_fwd_f32": 0,
            "flash_decode": 0,
            "flash_paged_decode": 0, "flash_bwd_dq": apps * m * n,
            "flash_bwd_dkv": apps * m * n, "flash_bwd_dq_f32": 0,
            "flash_bwd_dkv_f32": 0, "ssd_chunk_scan": 2 * L * m * n}
    losses = rec["losses"]
    print(f"hybrid train: {cfg.name} full width, {L} Mamba2 layers + the "
          f"shared block x {apps}, {n} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens in {m} microbatches, losses "
          f"{[round(x, 4) for x in losses]}")
    print(f"hybrid train: launches {launches} (want {want}), SSD backward "
          f"recomputes {recomputes} (want {L * m * n}), plain calls {plain}")
    if len(losses) != n or not np.isfinite(losses).all():
        fail(f"hybrid training losses not all finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"hybrid: last loss {losses[-1]} is not below the first "
             f"{losses[0]}")
    if launches != want:
        fail(f"hybrid training launches {launches}, expected {want}")
    if recomputes != {"ssd_chunk_scan": L * m * n}:
        fail(f"SSD backward recomputes {recomputes}, expected {L * m * n}")
    if any(plain.values()):
        fail(f"a plain version ran on the hybrid training path: {plain}")
    flops = hybrid_train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    mfu = flops / rec["mean_step_s"] / BF16_FLOPS_PER_S
    print(f"hybrid train metrics: {rec['tokens_per_s']:.1f} tok/s, mean step "
          f"{rec['mean_step_s'] * 1e3:.2f} ms over "
          f"{rec['meta']['measured_steps']} steps, model FLOPs "
          f"{flops / 1e12:.3f} TFLOP/step = {100 * mfu:.2f}% of 989 TFLOP/s, "
          f"peak memory {peak / 2**30:.2f} GiB, breakdown "
          f"{rec['breakdown_s']} {tag}")
    rec.update(launches=launches, bwd_recomputes=recomputes,
               peak_memory_bytes=peak, model_flops_per_step=flops, mfu=mfu)
    return rec, launches


def hybrid_cache_bytes(cache):
    """(ring bytes, Mamba state bytes) of a hybrid cache, all slots."""
    from repro_torch.models.common import local

    def nbytes(tree):
        return sum(local(t).numel() * local(t).element_size()
                   for t in tree.values())
    return nbytes(cache["shared"]), nbytes(cache["mamba"])


def hybrid_launches_want(cfg, srv, scan_steps, launches):
    """What a hybrid serving run must launch: the decode kernel once a
    shared application for every decode step and every batch-1 scan step,
    nothing else (no forward, no SSD scan, no paged kernel)."""
    want = dict.fromkeys(launches, 0)
    want["flash_decode"] = (cfg.n_layers // cfg.attn_every
                            * (srv.decode_dispatches + scan_steps))
    return want


def serve_hybrid(dev, tag, profile=False):
    """Phase 4j: zamba2-2.7b served at full width through
    launch.serve.run_workload.  The hybrid family has no parallel prefill:
    every prompt token is a batch-1 decode step (the scan prefill), each
    of the 54 Mamba layers a ``mamba_step`` on its state and each of the
    9 shared-block applications a ring write and ``flash_decode``.  So
    flash_decode launches exactly 9 x (decode dispatches + prompt tokens)
    times, flash_fwd and ssd_chunk_scan never, no plain call, no
    non-finite logit.  Then the reduced zamba2 on the card against the
    CPU.  Returns the record, the launches and what 4k serves again (the
    params, prompts, streams and ServeConfig)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ssd
    from repro_torch.launch.serve import run_workload
    from repro_torch.models.model import LM
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = get_arch(HYBRID_ARCH)
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    apps = cfg.n_layers // cfg.attn_every
    print(f"serve zamba2: {cfg.name} full width, {cfg.n_layers} Mamba2 "
          f"layers + the shared block x {apps} ({cfg.n_heads} heads of hd "
          f"{cfg.hd}, g 1), d {cfg.d_model}, vocab {cfg.vocab}, "
          f"{n_params / 1e9:.3f} B params bf16, init "
          f"{time.perf_counter() - t0:.1f}s {tag}")
    scfg = ServeConfig(slots=HYBRID_SLOTS, max_len=HYBRID_MAX_LEN,
                       prefill_chunk=256)
    rng = np.random.default_rng(0)
    lo, hi = HYBRID_PROMPT
    prompts = [rng.integers(0, cfg.vocab,
                            size=int(rng.integers(lo, hi + 1))).tolist()
               for _ in range(HYBRID_REQUESTS)]

    warm = Server(model, params, scfg)      # first launches, cuBLAS set-up
    warm.admit(prompts[0][:8], 0, max_new_tokens=2)
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    srv = checked_server()(model, params, scfg)
    ring_b, state_b = hybrid_cache_bytes(srv.cache)
    fa.reset_launches()
    ssd.reset_launches()
    ops.reset_plain_calls()
    t0 = time.perf_counter()
    rec = run_workload(srv, [(0.0, p) for p in prompts], gen=HYBRID_GEN)
    wall = time.perf_counter() - t0
    launches = dict(fa.launches, **ssd.launches)
    plain = dict(ops.plain_calls)
    peak = torch.cuda.max_memory_allocated(dev)

    n = HYBRID_REQUESTS
    scan_steps = sum(len(p) for p in prompts)
    reasons = set(srv.finished.values())
    want = hybrid_launches_want(cfg, srv, scan_steps, launches)
    print(f"serve zamba2: {rec['requests']} requests, "
          f"{rec['prompt_tokens']} prompt tokens ({scan_steps} batch-1 scan "
          f"steps), {rec['generated_tokens']} generated, "
          f"{srv.prefill_dispatches} prefill chunks, {srv.decode_dispatches} "
          f"decode dispatches, retire reasons {sorted(reasons)}; cache: "
          f"rings {ring_b / 1e9:.3f} GB, Mamba state {state_b / 1e9:.3f} GB")
    print(f"serve zamba2: launches {launches} (want {want}), plain calls "
          f"{plain}")
    if rec["requests"] != n or len(srv.finished) != n or reasons != {
            "length"}:
        fail(f"not every zamba2 request retired by length: {srv.finished}")
    if any(len(srv.outputs[r]) != HYBRID_GEN for r in srv.finished):
        fail(f"a zamba2 request did not produce {HYBRID_GEN} tokens")
    if launches != want:
        fail(f"zamba2 serving launches {launches}, expected {want}")
    if any(plain.values()):
        fail(f"a plain version ran on zamba2's serving path: {plain}")
    if srv.nonfinite:
        fail(f"{srv.nonfinite} non-finite zamba2 logits")
    ms = 1e3
    print(f"serve zamba2 metrics: prefill {rec['prefill_tok_per_s']:.1f} "
          f"tok/s, decode {rec['decode_tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{rec['ttft_p50_s'] * ms:.1f} ms p95 {rec['ttft_p95_s'] * ms:.1f} "
          f"ms, ITL p50 {rec['itl_p50_s'] * ms:.2f} ms p95 "
          f"{rec['itl_p95_s'] * ms:.2f} ms, scan step "
          f"{rec['prefill_s'] / scan_steps * ms:.2f} ms, wall {wall:.2f} s, "
          f"peak memory {peak / 2**30:.2f} GiB {tag}")
    slim = {k: v for k, v in rec.items() if k not in ("itl_s", "ttft_s")}
    slim.update(prefill_dispatches=srv.prefill_dispatches,
                decode_dispatches=srv.decode_dispatches,
                scan_steps=scan_steps, ring_bytes=ring_b,
                state_bytes=state_b, wall_s=wall, peak_memory_bytes=peak,
                params=n_params,
                # the lengths the decode kernel reached: prompt + 31 on the
                # rows that served, 1 on the idle ones (phase 5's hd-80 row)
                lengths=[len(p) + HYBRID_GEN - 1 for p in prompts]
                + [1] * (HYBRID_SLOTS - n))
    streams = {r: list(t) for r, t in srv.outputs.items()}
    del srv
    torch.cuda.empty_cache()
    if profile:
        # 15 slots of 4 tokens, an admission of 32 (32 scan steps), then
        # 8 decode steps of the 16 slots
        slim["profile"] = profile_serve(model, params, scfg, prompts, tag,
                                        fill=4, admit=32, tiers=("",))
    slim["reduced_card_vs_cpu"] = reduced_scan_card_vs_cpu(
        dev, tag, arch=HYBRID_ARCH)
    return slim, launches, (params, prompts, streams, scfg)


def serve_hybrid_plan(base, dev, tag, mesh):
    """Phase 4k, serving: 4j's first HYBRID_PLAN_REQS requests on 4j's
    weights and slots under the solved (1, 1) decode plan (params, each
    layer's Mamba state and the shared block's rings as DTensors; the
    state update, the ring write and flash_decode inside local_map; the
    scan step on the slot's owner).  They must give 4j's streams of those
    requests; flash_decode exactly 9 x (decode dispatches + prompt
    tokens), flash_fwd and ssd_chunk_scan never, no fallback, no plain
    call, no non-finite logit.  Prints a decode step's and a scan step's
    host and device ms with and without the plan (on a fresh pool each),
    then the reduced zamba2 under the plan against the CPU.  Returns the
    record and the launches."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ssd
    from repro_torch.launch.compile import plan_from_record, solve_cell_plan
    from repro_torch.launch.mesh import solver_axes
    from repro_torch.launch.serve import run_workload
    from repro_torch.models.model import LM
    from repro_torch.runtime.serve import Server

    params, prompts, streams4j, scfg = base
    cfg = get_arch(HYBRID_ARCH)
    t0 = time.perf_counter()
    prec = solve_cell_plan(cfg, ShapeConfig(*HYBRID_PLAN_SHAPE),
                           solver_axes((1, 1)), "mesh1x1", use_cache=False)
    plan = plan_from_record(prec)
    print(f"zamba2 plan: {cfg.name} {HYBRID_PLAN_SHAPE[0]} on the 1x1 mesh, "
          f"solved in {time.perf_counter() - t0:.3f} s:")
    print(plan.describe())
    model = LM(cfg, plan=plan, mesh=mesh)
    reqs = prompts[:HYBRID_PLAN_REQS]
    scan_steps = sum(len(p) for p in reqs)
    warm = Server(model, params, scfg)
    warm.admit(reqs[0][:8], 0, max_new_tokens=2)
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    srv = checked_server()(model, params, scfg)
    fa.reset_launches()
    ssd.reset_launches()
    ops.reset_plain_calls()
    rec = run_workload(srv, [(0.0, p) for p in reqs], gen=HYBRID_GEN)
    launches = dict(fa.launches, **ssd.launches)
    plain, fallbacks = dict(ops.plain_calls), dict(ops.plan_fallbacks)
    peak = torch.cuda.max_memory_allocated(dev)
    streams = {r: list(t) for r, t in srv.outputs.items()}
    want = hybrid_launches_want(cfg, srv, scan_steps, launches)
    ms = 1e3
    print(f"zamba2 plan: {len(reqs)} requests, {scan_steps} scan steps, "
          f"{srv.decode_dispatches} decode dispatches; launches {launches} "
          f"(want {want}), plan fallbacks {fallbacks}, plain calls {plain}, "
          f"non-finite logits {srv.nonfinite}")
    print(f"zamba2 plan metrics: scan step "
          f"{rec['prefill_s'] / scan_steps * ms:.2f} ms, decode "
          f"{rec['decode_tok_per_s']:.1f} tok/s, ITL p50 "
          f"{rec['itl_p50_s'] * ms:.2f} ms, wall {rec['wall_s']:.2f} s, "
          f"peak memory {peak / 2**30:.2f} GiB {tag}")
    if launches != want:
        fail(f"zamba2 plan: launches {launches}, want {want}")
    if any(fallbacks.values()) or any(plain.values()) or srv.nonfinite:
        fail(f"zamba2 plan: fallbacks {fallbacks}, plain calls {plain}, "
             f"{srv.nonfinite} non-finite logits")
    if streams != {r: streams4j[r] for r in range(len(reqs))}:
        fail("zamba2 plan: streams differ from phase 4j's")
    out = {k: v for k, v in rec.items() if k not in ("itl_s", "ttft_s")}
    out.update(decode_dispatches=srv.decode_dispatches,
               scan_step_ms=rec["prefill_s"] / scan_steps * ms,
               launches=launches, plan_fallbacks=fallbacks,
               peak_memory_bytes=peak)
    del srv
    torch.cuda.empty_cache()
    for label, m in (("no plan", LM(cfg)), ("plan", model)):
        srv = Server(m, params, scfg)
        out[label] = dict(
            decode_step=decode_step_times(srv, PLAN_STEPS, tag,
                                          f"zamba2 {label}"),
            scan_step=scan_step_times(srv, PLAN_STEPS, tag,
                                      f"zamba2 {label}"))
        del srv
        torch.cuda.empty_cache()
    print(f"zamba2 plan: 4j's streams of its first {len(reqs)} requests "
          f"under the (1, 1) plan; launches exact, 0 fallbacks, 0 plain "
          f"calls {tag}")
    out["reduced_card_vs_cpu"] = reduced_scan_card_vs_cpu(
        dev, tag, plan, mesh, arch=HYBRID_ARCH)
    return out, launches


def train_hybrid_plan(dev, tag, ref_rec, mesh, profile=False):
    """Phase 4k, training: phase 4d's run (its batch, optimizer, schedule
    and HYBRID_STEPS steps) under the solved (1, 1) train plan through
    launch.train's runner with --mesh 1x1 --plan auto (4k's group must be
    up): params, moments and master as DTensors, the SSD scan and the
    shared block's attention kernels inside local_map.  Launches exactly
    4d's, 0 fallbacks, 0 plain calls, every loss finite and within
    TRAIN_PLAN_LOSS_REL of 4d's; the peak memory; a step's host and
    device ms with and without the plan."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ssd
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.compile import plan_from_record

    cfg = get_arch(HYBRID_ARCH)
    args = launch_train.build_argparser().parse_args(
        train_argv(HYBRID_ARCH, HYBRID_STEPS) + ["--mesh", "1x1", "--plan",
                                                 "auto"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    ssd.reset_launches()
    ops.reset_plain_calls()
    rec = launch_train.run(args)
    launches = dict(fa.launches, **ssd.launches)
    recomputes = dict(ops.bwd_recomputes)
    plain, fallbacks = dict(ops.plain_calls), dict(ops.plan_fallbacks)
    peak = torch.cuda.max_memory_allocated(dev)
    want = ref_rec["launches"]
    losses, ref = rec["losses"], ref_rec["losses"]
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(losses, ref))
    L, n, m = cfg.n_layers, HYBRID_STEPS, TRAIN_MICRO
    print(f"hybrid train plan: {cfg.name} full width under the (1, 1) plan, "
          f"{n} steps, losses {[round(x, 4) for x in losses]}")
    print(f"hybrid train plan: launches {launches} (want 4d's {want}), SSD "
          f"backward recomputes {recomputes}, plan fallbacks {fallbacks}, "
          f"plain calls {plain}")
    print(f"hybrid train plan: losses against 4d's: bit-equal "
          f"{losses == ref}, max relative gap {rel:.3g} (band "
          f"{TRAIN_PLAN_LOSS_REL})")
    if len(losses) != n or not np.isfinite(losses).all():
        fail(f"hybrid train plan: losses not all finite: {losses}")
    if launches != want:
        fail(f"hybrid train plan: launches {launches}, expected {want}")
    if recomputes != {"ssd_chunk_scan": L * m * n}:
        fail(f"hybrid train plan: SSD backward recomputes {recomputes}")
    if any(fallbacks.values()) or any(plain.values()):
        fail(f"hybrid train plan: fallbacks {fallbacks}, plain {plain}")
    if len(ref) != n or not rel <= TRAIN_PLAN_LOSS_REL:
        fail(f"hybrid train plan: losses {losses} against 4d's {ref}")
    print(f"hybrid train plan metrics: {rec['tokens_per_s']:.1f} tok/s (4d "
          f"{ref_rec['tokens_per_s']:.1f}), mean step "
          f"{rec['mean_step_s'] * 1e3:.2f} ms (4d "
          f"{ref_rec['mean_step_s'] * 1e3:.2f}), peak memory "
          f"{peak / 2**30:.2f} GiB (4d "
          f"{ref_rec['peak_memory_bytes'] / 2**30:.2f}) {tag}")
    rec.update(launches=launches, bwd_recomputes=recomputes,
               plan_fallbacks=fallbacks, peak_memory_bytes=peak,
               bit_equal=losses == ref, max_rel_gap=rel)
    if not profile:
        return rec, launches
    plan = plan_from_record(rec["plan"])
    gc.collect()
    torch.cuda.empty_cache()
    steps = {}
    for label, p in (("without the plan", None), ("with the plan", plan)):
        steps[label] = train_step_times(
            dev, cfg, p, None if p is None else mesh, tag,
            f"zamba2 {label}", p is not None,
            timed=HYBRID_STEP_TIMED, profiled=HYBRID_STEP_PROFILED)
        gc.collect()
        torch.cuda.empty_cache()
    rec["step"] = steps
    return rec, launches


def serve_danube(dev, tag, profile=False):
    """Phase 4f: h2o-danube-3-4b served at full width through
    launch.serve.run_workload.  Its 4096 window gives the linear tier a
    ring cache of min(max_len, 4096) positions and no parallel prefill:
    every prompt token is a batch-1 decode step (the scan prefill), so
    flash_decode launches n_layers x (decode dispatches + prompt tokens)
    times and flash_fwd never."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_workload
    from repro_torch.models.model import LM
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = get_arch(DANUBE)
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serve danube: {cfg.name} full width, {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads of hd {cfg.hd} on "
          f"{cfg.n_kv_heads} KV heads, window {cfg.swa_window}, vocab "
          f"{cfg.vocab}, {n_params / 1e9:.3f} B params bf16, init "
          f"{time.perf_counter() - t0:.1f}s {tag}")
    scfg = ServeConfig(slots=DANUBE_SLOTS, max_len=DANUBE_MAX_LEN,
                       prefill_chunk=256)
    rng = np.random.default_rng(0)
    lo, hi = DANUBE_PROMPT
    prompts = [rng.integers(0, cfg.vocab,
                            size=int(rng.integers(lo, hi + 1))).tolist()
               for _ in range(DANUBE_REQUESTS)]

    warm = Server(model, params, scfg)      # first launches, cuBLAS set-up
    warm.admit(prompts[0][:8], 0, max_new_tokens=2)
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    srv = checked_server()(model, params, scfg)
    ring = srv.cache["kv"]["k"].shape[2]
    fa.reset_launches()
    ops.reset_plain_calls()
    t0 = time.perf_counter()
    rec = run_workload(srv, [(0.0, p) for p in prompts], gen=DANUBE_GEN)
    wall = time.perf_counter() - t0
    launches = dict(fa.launches)
    plain = dict(ops.plain_calls)
    peak = torch.cuda.max_memory_allocated(dev)

    L, n = cfg.n_layers, DANUBE_REQUESTS
    scan_steps = sum(len(p) for p in prompts)
    reasons = set(srv.finished.values())
    print(f"serve danube: {rec['requests']} requests, "
          f"{rec['prompt_tokens']} prompt tokens ({scan_steps} batch-1 scan "
          f"steps), {rec['generated_tokens']} generated, "
          f"{srv.prefill_dispatches} prefill chunks, {srv.decode_dispatches} "
          f"decode dispatches, ring of {ring} positions, retire reasons "
          f"{sorted(reasons)}")
    want = dict.fromkeys(launches, 0)
    want["flash_decode"] = L * (srv.decode_dispatches + scan_steps)
    print(f"serve danube: launches {launches} (want {want}), plain calls "
          f"{plain}")
    if ring != min(DANUBE_MAX_LEN, cfg.swa_window):
        fail(f"danube's ring holds {ring} positions, expected "
             f"{min(DANUBE_MAX_LEN, cfg.swa_window)}")
    if rec["requests"] != n or len(srv.finished) != n or reasons != {
            "length"}:
        fail(f"not every danube request retired by length: {srv.finished}")
    if any(len(srv.outputs[r]) != DANUBE_GEN for r in srv.finished):
        fail(f"a danube request did not produce {DANUBE_GEN} tokens")
    if launches != want:
        fail(f"danube serving launches {launches}, expected {want}")
    if any(plain.values()):
        fail(f"a plain version ran on danube's serving path: {plain}")
    if srv.nonfinite:
        fail(f"{srv.nonfinite} non-finite danube logits")
    ms = 1e3
    print(f"serve danube metrics: prefill {rec['prefill_tok_per_s']:.1f} "
          f"tok/s, decode {rec['decode_tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{rec['ttft_p50_s'] * ms:.1f} ms p95 {rec['ttft_p95_s'] * ms:.1f} "
          f"ms, ITL p50 {rec['itl_p50_s'] * ms:.2f} ms p95 "
          f"{rec['itl_p95_s'] * ms:.2f} ms, scan step "
          f"{rec['prefill_s'] / scan_steps * ms:.2f} ms, wall {wall:.2f} s, "
          f"peak memory {peak / 2**30:.2f} GiB {tag}")
    slim = {k: v for k, v in rec.items() if k not in ("itl_s", "ttft_s")}
    slim.update(prefill_dispatches=srv.prefill_dispatches,
                decode_dispatches=srv.decode_dispatches,
                scan_steps=scan_steps, ring=ring, wall_s=wall,
                peak_memory_bytes=peak, params=n_params)
    del srv
    if profile:
        # 7 slots of 16 tokens, an admission of 32 (32 scan steps), then 8
        # decode steps of the 8 slots
        slim["profile"] = profile_serve(model, params, scfg, prompts, tag,
                                        fill=16, admit=32, tiers=("",))
    del params, model
    return slim, launches


def reduced_scan_card_vs_cpu(dev, tag, plan=None, mesh=None,
                             arch=DANUBE, cfg=None, name=None):
    """The reduced h2o-danube-3-4b (window 16, hd 16) on the card against
    the same bf16 weights on the CPU: a scan prefill of 20 tokens into
    slot 0 (its ring of 16 wraps) and of 10 into slot 1, then 40 decode
    steps of both rows, so that slot 0 runs 44 positions past the
    window.  With ``plan`` and ``mesh`` the card's side runs under the
    plan (params and ring cache placed as the Server places them).
    ``arch`` zamba2-2.7b: the reduced hybrid the same way (each Mamba
    layer's state and the shared block's ring of 64, 4f's band); ``cfg``
    (printed as ``name``) in place of ``arch``'s reduced config: a
    recurrent family with no ring (xLSTM, the pure-SSM branch)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.common import whole
    from repro_torch.models.model import LM
    from repro_torch.models.sharding import (CACHE_RULES, place_tree,
                                             zeros_tree)

    cfg = cfg or get_arch(arch).reduced()
    model = LM(cfg)
    p_cpu = model.init(0, device="cpu")
    models = {"cpu": model, dev: model}
    params = {"cpu": p_cpu, dev: _to(p_cpu, dev)}
    caches = {d: model.init_cache(2, 64, device=d) for d in ("cpu", dev)}
    if plan is not None:
        plan = plan.for_pool(2, dict(zip(mesh.mesh_dim_names,
                                         mesh.mesh.shape)))
        models[dev] = LM(cfg, plan=plan, mesh=mesh)
        params[dev] = place_tree(params[dev], mesh, plan)
        caches[dev] = zeros_tree(model.cache_shapes(2, 64), mesh, plan,
                                 CACHE_RULES, device=dev)
    rng = np.random.default_rng(2)
    worst = 0.0
    for slot, n in ((0, 20), (1, 10)):
        pr = rng.integers(0, cfg.vocab, size=n)
        lg = {d: whole(models[d].prefill_chunk(
            params[d], caches[d], torch.as_tensor(pr, device=d), slot,
            n)[0]) for d in ("cpu", dev)}
        worst = max(worst, float((lg["cpu"] - lg[dev].cpu()).abs().max()))
    for _ in range(40):
        toks = rng.integers(0, cfg.vocab, size=2)
        lg = {d: whole(models[d].decode_step(
            params[d], caches[d], torch.as_tensor(toks, device=d))[0])
              for d in ("cpu", dev)}
        worst = max(worst, float((lg["cpu"].float()
                                  - lg[dev].float().cpu()).abs().max()))
    name = name or ("danube" if arch == DANUBE else "zamba2")
    kv = caches[dev].get("kv", caches[dev].get("shared"))
    ring = None if kv is None else kv["k"].shape[2]
    pos = whole(caches[dev]["pos"]).tolist()
    print(f"reduced {name}{' under the plan' if plan is not None else ''}, "
          f"card vs CPU, {'' if kv is None else f'ring of {ring} positions, '}"
          f"rows at positions {pos}: max|dlogits|={worst:.4g} (band "
          f"{LOGITS_ATOL}) {tag}")
    if (kv is not None and ring != (cfg.swa_window or 64)) or pos != [60, 50]:
        fail(f"reduced {name}'s ring {ring} / positions {pos}")
    if not worst <= LOGITS_ATOL:
        fail(f"reduced {name} on the card disagrees with the CPU")
    return worst


def profile_train(dev, tag, arch="qwen2-1.5b", cfg=None):
    """torch.profiler over 2 full-width training steps (after one warm
    step), fed by BatchFeed as the training loop feeds them; ``cfg``, if
    given, in place of ``arch``'s config (danube's depth cut)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import BatchFeed, DataConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainConfig, make_engine

    args = launch_train.build_argparser().parse_args(train_argv(arch))
    cfg = cfg or get_arch(args.arch)
    tcfg = TrainConfig(microbatches=args.microbatches, buckets=args.buckets,
                       optim=AdamWConfig(lr=args.lr, warmup_steps=2,
                                         total_steps=args.steps))
    engine = make_engine(LM(cfg), tcfg, device=dev)
    state = engine.init_state(0)
    dcfg = DataConfig(seed=0, vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    with BatchFeed(dcfg, device=dev) as feed:
        state, _ = engine.step(state, feed.get())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                state, _ = engine.step(state, feed.get())
            torch.cuda.synchronize()      # the window's own end: 1 call
            wall_ms = (time.perf_counter() - t0) * 1e3
    del state, engine
    return report_profile(prof, f"train {arch} (2 steps)", wall_ms, tag)


def reduced_grads_card_vs_cpu(dev, tag, arch):
    """A reduced model on the card against the same weights on the CPU:
    the loss and every param's grad.  -> (dloss, worst grad ratio, its
    key, model, CPU params, data config)."""
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.models.model import LM

    cfg = get_arch(arch).reduced()
    model = LM(cfg)
    p_cpu = model.init(0, device="cpu")
    dcfg = DataConfig(seed=0, vocab=cfg.vocab, seq_len=64, global_batch=4)
    batch = host_batch(dcfg, 0)
    out = {}
    for d in ("cpu", dev):
        p = tree.tree_map(lambda t: t.detach().clone().to(d), p_cpu)
        leaves = [t.requires_grad_(True) for t in tree.leaves(p)]
        loss = model.loss(p, {k: torch.as_tensor(v, device=d)
                              for k, v in batch.items()})
        grads = torch.autograd.grad(loss, leaves)
        out[d] = (float(loss.detach()), [g.float().cpu() for g in grads])
    dloss = abs(out["cpu"][0] - out[dev][0])
    worst, worst_key = 0.0, ""
    for (path, _), gc, gg in zip(tree.flatten(p_cpu), out["cpu"][1],
                                 out[dev][1]):
        ratio = float((gc - gg).abs().max()) / max(float(gc.abs().max()),
                                                   1e-12)
        if ratio > worst:
            worst, worst_key = ratio, tree.key(path)
    print(f"reduced {arch} train, card vs CPU: |dloss|={dloss:.4g} (band "
          f"{LOSS_ATOL}), worst max|dgrad|/max|grad| {worst:.4g} at "
          f"{worst_key} (band {PARAM_GRAD_REL}) {tag}")
    if not dloss <= LOSS_ATOL or not worst <= PARAM_GRAD_REL:
        fail(f"reduced {arch}'s loss or grads on the card disagree with the "
             "CPU")
    return dloss, worst, worst_key, model, p_cpu, dcfg


def reduced_train_card_vs_cpu(dev, tag):
    """The reduced qwen2-1.5b's loss and grads on the card against the
    CPU; then 3 steps of the engine with the int8 compressed sync on
    both."""
    from repro_torch import tree
    from repro_torch.data.pipeline import host_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.engine import EngineConfig, TrainEngine

    dloss, worst, worst_key, model, p_cpu, dcfg = reduced_grads_card_vs_cpu(
        dev, tag, "qwen2-1.5b")
    losses = {}
    for d in ("cpu", dev):
        eng = TrainEngine(model, EngineConfig(
            grad_compression=True, buckets=4,
            optim=AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=1000)),
            device=d)
        state = eng.init_state(params=tree.tree_map(
            lambda t: t.detach().clone().to(d), p_cpu))
        losses[d] = []
        for step in range(3):
            state, m = eng.step(state, host_batch(dcfg, step))
            losses[d].append(float(m["loss"]))
    gap = float(np.abs(np.subtract(losses["cpu"], losses[dev])).max())
    print(f"reduced compressed-sync engine, 3 steps: CPU {losses['cpu']}, "
          f"card {losses[dev]}, max |dloss| {gap:.4g} (band "
          f"{TRAIN_LOSS_ATOL}) {tag}")
    if not gap <= TRAIN_LOSS_ATOL:
        fail("compressed-sync engine on the card disagrees with the CPU")
    return dict(dloss=dloss, grad_rel=worst, grad_rel_at=worst_key,
                compressed_losses={str(k): v for k, v in losses.items()},
                compressed_gap=gap)


def counting_routes(chunk, n_layers, dev):
    """Wrap ``models.moe.route`` to sum, on the device and layer by layer,
    the choices routed and dropped by the calls of ``chunk`` tokens (the
    prefill chunks, whose layers route in order).  Returns the [layer,
    (routed, dropped)] counter and the function that undoes the wrap."""
    from repro_torch.models import moe

    route = moe.route
    acc = torch.zeros((n_layers, 2), dtype=torch.long, device=dev)
    calls = [0]

    def counted(xf, router, cfg, cap):
        out = route(xf, router, cfg, cap)
        if xf.shape[0] == chunk:
            row = acc[calls[0] % n_layers]
            row[0] += out[1].numel()
            row[1] += (~out[1]).sum()
            calls[0] += 1
        return out

    def restore():
        moe.route = route
    moe.route = counted
    return acc, restore


def prefill_drops(model, params, scfg, prompts, dev, tag):
    """The share of the prefill chunks' routed choices dropped at
    capacity, from a pass of its own that only prefills ``prompts`` (the
    count adds device work to every chunk, so it stays out of the timed
    runs; a chunk's drops depend on its tokens alone, so they are those
    of the timed runs)."""
    from repro_torch.runtime.serve import Server

    srv = Server(model, params, scfg)
    acc, restore = counting_routes(scfg.prefill_chunk, model.cfg.n_layers,
                                   dev)
    try:
        for slot, p in enumerate(prompts):
            srv.admit(p, slot, max_new_tokens=1)
    finally:
        restore()
    by_layer = acc.tolist()
    routed, dropped = (sum(r[i] for r in by_layer) for i in (0, 1))
    print(f"serve moe: prefill chunks dropped {dropped} of {routed} "
          f"routed choices ({100 * dropped / max(routed, 1):.2f}%; by layer "
          f"{[round(100 * d / max(r, 1), 1) for r, d in by_layer]}%) {tag}")
    return dict(routed=routed, dropped=dropped,
                dropped_by_layer=[d / max(r, 1) for r, d in by_layer])


def serve_moe(dev, tag):
    """Phase 4l: moonshot-v1-16b-a3b served at full width through
    launch.serve.run_workload, on the linear tier and then the paged tier
    (16-token blocks, no speculation) with the same requests.  Launches
    exactly flash_fwd 48 a prefill chunk and flash_decode (linear) or
    flash_paged_decode (paged) 48 a decode step, no plain call, no
    non-finite logit; the paged streams equal the linear ones token for
    token (the same MoE calls, so the same capacities).  Prints prefill
    and decode tok/s, TTFT / ITL, the peak memory, the share of the
    prefill chunks' routed choices dropped at capacity, and a decode
    step's host and device ms.  Returns the record, the launches of both
    tiers and (model, params, prompts, linear streams, serve config)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_workload
    from repro_torch.models.model import LM
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = get_arch(MOE_ARCH)
    m = cfg.moe
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serve moe: {cfg.name} full width, {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of hd "
          f"{cfg.hd}, {m.n_experts} experts top-{m.top_k} of d_ff "
          f"{m.d_ff_expert}, vocab {cfg.vocab}, {n_params / 1e9:.3f} B "
          f"params bf16 ({2 * n_params / 1e9:.1f} GB), init "
          f"{time.perf_counter() - t0:.1f}s {tag}")
    scfg = ServeConfig(slots=MOE_SLOTS, max_len=MOE_MAX_LEN,
                       prefill_chunk=MOE_CHUNK)
    rng = np.random.default_rng(0)
    lo, hi = MOE_PROMPT
    prompts = [rng.integers(0, cfg.vocab,
                            size=int(rng.integers(lo, hi + 1))).tolist()
               for _ in range(MOE_REQUESTS)]
    warm = Server(model, params, scfg)      # first launches, cuBLAS set-up
    warm.admit(prompts[0][:300], 0, max_new_tokens=2)
    warm.run()
    del warm
    torch.cuda.synchronize()

    L, ms = cfg.n_layers, 1e3
    out, launches_all = {}, {}
    for tier, extra in (("linear", {}),
                        ("paged", dict(paged=True, block_len=16))):
        torch.cuda.reset_peak_memory_stats(dev)
        srv = checked_server()(model, params,
                               dataclasses.replace(scfg, **extra))
        fa.reset_launches()
        ops.reset_plain_calls()
        rec = run_workload(srv, [(0.0, p) for p in prompts], gen=MOE_GEN)
        launches = dict(fa.launches)
        plain = dict(ops.plain_calls)
        peak = torch.cuda.max_memory_allocated(dev)
        want = dict.fromkeys(launches, 0)
        want["flash_fwd"] = L * srv.prefill_dispatches
        kernel = "flash_paged_decode" if extra else "flash_decode"
        want[kernel] = L * srv.decode_dispatches
        reasons = set(srv.finished.values())
        print(f"serve moe {tier}: {rec['requests']} requests, "
              f"{rec['prompt_tokens']} prompt tokens, "
              f"{rec['generated_tokens']} generated, "
              f"{srv.prefill_dispatches} prefill chunks, "
              f"{srv.decode_dispatches} decode dispatches; launches "
              f"{launches} (want {want}), plain calls {plain}")
        if rec["requests"] != MOE_REQUESTS or reasons != {"length"} or any(
                len(srv.outputs[r]) != MOE_GEN for r in srv.finished):
            fail(f"moe {tier}: not every request gave {MOE_GEN} tokens: "
                 f"{srv.finished}")
        if launches != want:
            fail(f"moe {tier}: launches {launches}, expected {want}")
        if any(plain.values()) or srv.nonfinite:
            fail(f"moe {tier}: plain calls {plain}, {srv.nonfinite} "
                 f"non-finite logits")
        print(f"serve moe {tier} metrics: prefill "
              f"{rec['prefill_tok_per_s']:.1f} tok/s, decode "
              f"{rec['decode_tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{rec['ttft_p50_s'] * ms:.1f} ms p95 "
              f"{rec['ttft_p95_s'] * ms:.1f} ms, ITL p50 "
              f"{rec['itl_p50_s'] * ms:.2f} ms p95 "
              f"{rec['itl_p95_s'] * ms:.2f} ms, wall {rec['wall_s']:.2f} s, "
              f"peak memory {peak / 2**30:.2f} GiB {tag}")
        slim = {k: v for k, v in rec.items() if k not in ("itl_s",
                                                          "ttft_s")}
        slim.update(prefill_dispatches=srv.prefill_dispatches,
                    decode_dispatches=srv.decode_dispatches,
                    peak_memory_bytes=peak, launches=launches,
                    streams={r: list(t) for r, t in srv.outputs.items()})
        if tier == "linear":
            slim["decode_step"] = decode_step_times(srv, PLAN_STEPS, tag,
                                                    "moonshot")
        out[tier], launches_all[tier] = slim, launches
        del srv
        torch.cuda.empty_cache()
    streams = out["linear"]["streams"]
    if out["paged"]["streams"] != streams:
        fail("moe: the paged tier's streams differ from the linear tier's")
    out["drops"] = prefill_drops(model, params, scfg, prompts, dev, tag)
    print(f"serve moe: the paged tier's streams equal the linear tier's "
          f"token for token {tag}")
    out["params"] = n_params
    return out, launches_all, (model, params, prompts, streams, scfg)


def reduced_moe_card_vs_cpu(dev, tag, plan=None, mesh=None):
    """The reduced moonshot (4 experts top-2, hd 16) on the card against
    the same bf16 weights on the CPU: two prefill chunks of 8 into 3
    slots, then 6 decode steps with an inactive row.  Prints the worst
    logits gap (LOGITS_ATOL) and the routing decisions that differ: for
    every MoE call, the tokens whose top-k expert set differs between the
    card and the CPU, beside the router logits' largest gap.  With
    ``plan`` and ``mesh`` the card's side runs under the plan."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    from repro_torch.models.common import whole
    from repro_torch.models.model import LM
    from repro_torch.models.sharding import (CACHE_RULES, place_tree,
                                             zeros_tree)

    cfg = get_arch(MOE_ARCH).reduced()
    model = LM(cfg)
    p_cpu = model.init(0, device="cpu")
    models = {"cpu": model, dev: model}
    params = {"cpu": p_cpu, dev: _to(p_cpu, dev)}
    caches = {d: model.init_cache(3, 48, device=d) for d in ("cpu", dev)}
    if plan is not None:
        plan = plan.for_pool(3, dict(zip(mesh.mesh_dim_names,
                                         mesh.mesh.shape)))
        models[dev] = LM(cfg, plan=plan, mesh=mesh)
        params[dev] = place_tree(params[dev], mesh, plan)
        caches[dev] = zeros_tree(model.cache_shapes(3, 48), mesh, plan,
                                 CACHE_RULES, device=dev)
    sides = ("cpu", "card")
    seen, side = {d: [] for d in sides}, ["cpu"]
    route = moe.route

    def recorded(xf, router, cfg_, cap):
        logits = xf.float() @ router
        seen[side[0]].append(
            (logits.cpu(), torch.topk(logits, cfg_.moe.top_k).indices
             .sort(-1).values.cpu()))
        return route(xf, router, cfg_, cap)

    def both(call):
        """call(d) on the CPU, then on the card: the gathered logits."""
        out = {}
        for name, d in zip(sides, ("cpu", dev)):
            side[0] = name
            out[name] = whole(call(d)[0]).float().cpu()
        return float((out["cpu"] - out["card"]).abs().max())
    moe.route = recorded
    rng = np.random.default_rng(1)
    worst = 0.0
    try:
        for slot, pr in enumerate(rng.integers(0, cfg.vocab, size=n)
                                  for n in (5, 16, 11)):
            for i in range(0, len(pr), 8):
                chunk = np.pad(pr[i:i + 8], (0, max(0, 8 - len(pr[i:i + 8]))))
                nv = min(8, len(pr) - i)
                worst = max(worst, both(lambda d: models[d].prefill_chunk(
                    params[d], caches[d], torch.as_tensor(chunk, device=d),
                    slot, nv)))
        for step in range(6):
            toks = rng.integers(0, cfg.vocab, size=3)
            act = np.array([True, True, step % 2 == 0])
            worst = max(worst, both(lambda d: models[d].decode_step(
                params[d], caches[d], torch.as_tensor(toks, device=d),
                torch.as_tensor(act, device=d))))
    finally:
        moe.route = route
    calls = list(zip(seen["cpu"], seen["card"]))
    flips = sum(int((a[1] != b[1]).any(-1).sum()) for a, b in calls)
    tokens = sum(a[1].shape[0] for a, _ in calls)
    gap = max(float((a[0] - b[0]).abs().max()) for a, b in calls)
    print(f"reduced moonshot{' under the plan' if plan is not None else ''}"
          f", card vs CPU: max|dlogits|={worst:.4g} (band {LOGITS_ATOL}); "
          f"routing: {flips} of {tokens} tokens in {len(calls)} MoE calls "
          f"chose another expert set, router logits max gap {gap:.3g} "
          f"{tag}")
    if len(seen["cpu"]) != len(seen["card"]) or not worst <= LOGITS_ATOL:
        fail("reduced moonshot on the card disagrees with the CPU")
    return dict(max_abs_err=worst, routing_flips=flips, routed_tokens=tokens,
                router_logit_gap=gap)


def serve_moe_plan(base, dev, tag, mesh):
    """Phase 4m, serving: 4l's first MOE_PLAN_REQS requests on 4l's
    weights and pool under the solved (1, 1) decode plan, pinned by
    normalize_moe_plan (params and cache as DTensors; the MoE layer's
    global formula on the local experts, the kernels inside local_map).
    They must give 4l's streams of those requests; launches exactly
    flash_fwd 48 a chunk and flash_decode 48 a step, no fallback, no
    all-to-all (serving routes globally), no plain call, no non-finite
    logit.  Prints a decode step's host and device ms with the plan, then
    the reduced moonshot under the plan against the CPU."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.compile import (normalize_moe_plan,
                                            plan_from_record,
                                            solve_cell_plan)
    from repro_torch.launch.mesh import solver_axes
    from repro_torch.launch.serve import run_workload
    from repro_torch.models.model import LM
    from repro_torch.runtime.serve import Server

    model0, params, prompts, streams4l, scfg = base
    cfg = model0.cfg
    t0 = time.perf_counter()
    prec = solve_cell_plan(cfg, ShapeConfig(*MOE_PLAN_SHAPE),
                           solver_axes((1, 1)), "mesh1x1", use_cache=False)
    plan = normalize_moe_plan(plan_from_record(prec), cfg)
    print(f"moe plan: {cfg.name} {MOE_PLAN_SHAPE[0]} on the 1x1 mesh, "
          f"solved in {time.perf_counter() - t0:.3f} s:")
    print(plan.describe())
    model = LM(cfg, plan=plan, mesh=mesh)
    reqs = prompts[:MOE_PLAN_REQS]
    warm = Server(model, params, scfg)
    warm.admit(reqs[0][:8], 0, max_new_tokens=2)
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    srv = checked_server()(model, params, scfg)
    fa.reset_launches()
    ops.reset_plain_calls()
    rec = run_workload(srv, [(0.0, p) for p in reqs], gen=MOE_GEN)
    launches = dict(fa.launches)
    plain, fallbacks = dict(ops.plain_calls), dict(ops.plan_fallbacks)
    a2a = dict(ops.all_to_all)
    peak = torch.cuda.max_memory_allocated(dev)
    streams = {r: list(t) for r, t in srv.outputs.items()}
    L, ms = cfg.n_layers, 1e3
    want = dict.fromkeys(launches, 0)
    want["flash_fwd"] = L * srv.prefill_dispatches
    want["flash_decode"] = L * srv.decode_dispatches
    print(f"moe plan: {len(reqs)} requests, {srv.prefill_dispatches} "
          f"prefill chunks, {srv.decode_dispatches} decode dispatches; "
          f"launches {launches} (want {want}), plan fallbacks {fallbacks}, "
          f"all-to-alls {a2a}, plain calls {plain}, non-finite logits "
          f"{srv.nonfinite}")
    print(f"moe plan metrics: prefill {rec['prefill_tok_per_s']:.1f} tok/s, "
          f"decode {rec['decode_tok_per_s']:.1f} tok/s, ITL p50 "
          f"{rec['itl_p50_s'] * ms:.2f} ms, wall {rec['wall_s']:.2f} s, "
          f"peak memory {peak / 2**30:.2f} GiB {tag}")
    if launches != want:
        fail(f"moe plan: launches {launches}, want {want}")
    if (any(fallbacks.values()) or any(a2a.values()) or any(plain.values())
            or srv.nonfinite):
        fail(f"moe plan: fallbacks {fallbacks}, all-to-alls {a2a}, plain "
             f"calls {plain}, {srv.nonfinite} non-finite logits")
    if streams != {r: streams4l[r] for r in range(len(reqs))}:
        fail("moe plan: streams differ from phase 4l's")
    print(f"moe plan: 4l's streams of its first {len(reqs)} requests under "
          f"the (1, 1) plan; launches exact, 0 fallbacks, 0 plain calls "
          f"{tag}")
    out = {k: v for k, v in rec.items() if k not in ("itl_s", "ttft_s")}
    out.update(decode_dispatches=srv.decode_dispatches,
               prefill_dispatches=srv.prefill_dispatches, launches=launches,
               plan_fallbacks=fallbacks, peak_memory_bytes=peak,
               decode_step=decode_step_times(srv, PLAN_STEPS, tag,
                                             "moonshot plan"))
    del srv
    torch.cuda.empty_cache()
    out["reduced_card_vs_cpu"] = reduced_moe_card_vs_cpu(dev, tag, plan,
                                                         mesh)
    return out, launches


@contextlib.contextmanager
def recording_aux():
    """Record the aux loss of every training forward (one a microbatch),
    as device tensors, read once at the end."""
    from repro_torch.models.model import LM

    auxes, forward = [], LM.forward

    def recorded(self, params, tokens=None, embeds=None):
        logits, aux = forward(self, params, tokens, embeds)
        auxes.append(aux.detach())
        return logits, aux
    LM.forward = recorded
    try:
        yield auxes
    finally:
        LM.forward = forward


def aux_per_step(auxes):
    """The recorded aux losses as the mean of each step's microbatches."""
    from repro_torch.models.common import whole
    vals = [float(whole(a)) for a in auxes]
    return [float(np.mean(vals[i:i + TRAIN_MICRO]))
            for i in range(0, len(vals), TRAIN_MICRO)]


def train_moe(dev, tag):
    """Phase 4m, training: moonshot at full width cut to MOE_TRAIN_LAYERS
    layers, launch.train's runner (4b's batch and optimizer, MOE_STEPS
    steps): losses finite and falling, launches per step exactly
    flash_fwd 4 x 2 x 2 (microbatches, forward and remat) and dq / dk/dv
    4 x 2 each, no plain call; the aux of each step printed; the model-
    FLOPs share counts the active experts only."""
    with recording_aux() as auxes:
        rec, launches = train_full_width(dev, tag, MOE_ARCH, MOE_STEPS,
                                         MOE_TRAIN_LAYERS, moe_train_flops)
    rec["aux"] = aux_per_step(auxes)
    print(f"train moe: aux per step {[round(a, 4) for a in rec['aux']]} "
          f"(0.01 x of it in each loss)")
    if len(rec["aux"]) != MOE_STEPS or not np.isfinite(rec["aux"]).all():
        fail(f"train moe: aux {rec['aux']}")
    return rec, launches


def train_moe_plan(dev, tag, ref_rec):
    """Phase 4m, training under the plan: train_moe's run (its cut, batch,
    optimizer, schedule) through launch.train's runner with --mesh 1x1
    --plan auto (a world-1 NCCL group must be up; the plan pinned by
    normalize_moe_plan): launches exactly train_moe's, 0 fallbacks, 0
    plain calls, every loss within TRAIN_PLAN_LOSS_REL of train_moe's
    (bit-equality printed); the all-to-alls 0, the expert axis being of
    size 1."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train

    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    args = launch_train.build_argparser().parse_args(
        train_argv(MOE_ARCH, MOE_STEPS) + ["--mesh", "1x1", "--plan",
                                           "auto"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    ops.reset_plain_calls()
    with recording_aux() as auxes:
        rec = launch_train.run(args, cfg=cfg)
    launches = dict(fa.launches)
    plain, fallbacks = dict(ops.plain_calls), dict(ops.plan_fallbacks)
    a2a = dict(ops.all_to_all)
    peak = torch.cuda.max_memory_allocated(dev)
    want = ref_rec["launches"]
    losses, ref = rec["losses"], ref_rec["losses"]
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(losses, ref))
    rec["aux"] = aux_per_step(auxes)
    print(f"train moe plan: {cfg.name} cut to {cfg.n_layers} layers under "
          f"the (1, 1) plan, {MOE_STEPS} steps, losses "
          f"{[round(x, 4) for x in losses]}, aux "
          f"{[round(x, 4) for x in rec['aux']]}")
    print(f"train moe plan: launches {launches} (want {want}), plan "
          f"fallbacks {fallbacks}, all-to-alls {a2a}, plain calls {plain}")
    print(f"train moe plan: losses against the unplanned run's: bit-equal "
          f"{losses == ref}, max relative gap {rel:.3g} (band "
          f"{TRAIN_PLAN_LOSS_REL})")
    if len(losses) != MOE_STEPS or not np.isfinite(losses).all():
        fail(f"train moe plan: losses not all finite: {losses}")
    if launches != want:
        fail(f"train moe plan: launches {launches}, expected {want}")
    if any(fallbacks.values()) or any(plain.values()) or any(a2a.values()):
        fail(f"train moe plan: fallbacks {fallbacks}, plain {plain}, "
             f"all-to-alls {a2a}")
    if len(ref) != MOE_STEPS or not rel <= TRAIN_PLAN_LOSS_REL:
        fail(f"train moe plan: losses {losses} against {ref}")
    print(f"train moe plan metrics: {rec['tokens_per_s']:.1f} tok/s "
          f"(unplanned {ref_rec['tokens_per_s']:.1f}), mean step "
          f"{rec['mean_step_s'] * 1e3:.2f} ms (unplanned "
          f"{ref_rec['mean_step_s'] * 1e3:.2f}), peak memory "
          f"{peak / 2**30:.2f} GiB {tag}")
    rec.update(launches=launches, plan_fallbacks=fallbacks,
               peak_memory_bytes=peak, bit_equal=losses == ref,
               max_rel_gap=rel)
    return rec, launches


def serve_qwen32(dev, tag):
    """Phase 4n: qwen2.5-32b served at full width through
    launch.serve.run_workload on the linear tier: launches exactly
    flash_fwd 64 a prefill chunk and flash_decode 64 a decode step, no
    plain call, no non-finite logit, and a peak memory under the card's
    own.  Every earlier phase's tensors must be freed before it."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_workload
    from repro_torch.models.model import LM
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = get_arch(QWEN32)
    model = LM(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serve qwen32: {cfg.name} full width, {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of hd "
          f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{n_params / 1e9:.3f} B params bf16 ({2 * n_params / 1e9:.1f} "
          f"GB), init {time.perf_counter() - t0:.1f}s {tag}")
    scfg = ServeConfig(slots=MOE_SLOTS, max_len=MOE_MAX_LEN,
                       prefill_chunk=MOE_CHUNK)
    rng = np.random.default_rng(0)
    lo, hi = QWEN32_PROMPT
    prompts = [rng.integers(0, cfg.vocab,
                            size=int(rng.integers(lo, hi + 1))).tolist()
               for _ in range(QWEN32_REQUESTS)]
    warm = Server(model, params, scfg)
    warm.admit(prompts[0][:300], 0, max_new_tokens=2)
    warm.run()
    del warm
    torch.cuda.synchronize()
    srv = checked_server()(model, params, scfg)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in srv.cache["kv"].values())
    fa.reset_launches()
    ops.reset_plain_calls()
    rec = run_workload(srv, [(0.0, p) for p in prompts], gen=QWEN32_GEN)
    launches = dict(fa.launches)
    plain = dict(ops.plain_calls)
    peak = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    L, ms = cfg.n_layers, 1e3
    want = dict.fromkeys(launches, 0)
    want["flash_fwd"] = L * srv.prefill_dispatches
    want["flash_decode"] = L * srv.decode_dispatches
    reasons = set(srv.finished.values())
    print(f"serve qwen32: {rec['requests']} requests, {rec['prompt_tokens']} "
          f"prompt tokens, {rec['generated_tokens']} generated, "
          f"{srv.prefill_dispatches} prefill chunks, "
          f"{srv.decode_dispatches} decode dispatches, cache "
          f"{cache_bytes / 1e9:.2f} GB; launches {launches} (want {want}), "
          f"plain calls {plain}")
    if rec["requests"] != QWEN32_REQUESTS or reasons != {"length"} or any(
            len(srv.outputs[r]) != QWEN32_GEN for r in srv.finished):
        fail(f"qwen32: not every request gave {QWEN32_GEN} tokens: "
             f"{srv.finished}")
    if launches != want:
        fail(f"qwen32 launches {launches}, expected {want}")
    if any(plain.values()) or srv.nonfinite:
        fail(f"qwen32: plain calls {plain}, {srv.nonfinite} non-finite "
             f"logits")
    if not peak < total:
        fail(f"qwen32: peak memory {peak} is not under the card's {total}")
    print(f"serve qwen32 metrics: prefill {rec['prefill_tok_per_s']:.1f} "
          f"tok/s, decode {rec['decode_tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{rec['ttft_p50_s'] * ms:.1f} ms, ITL p50 "
          f"{rec['itl_p50_s'] * ms:.2f} ms p95 {rec['itl_p95_s'] * ms:.2f} "
          f"ms, wall {rec['wall_s']:.2f} s, peak memory "
          f"{peak / 2**30:.2f} GiB of {total / 2**30:.2f} GiB {tag}")
    slim = {k: v for k, v in rec.items() if k not in ("itl_s", "ttft_s")}
    slim.update(prefill_dispatches=srv.prefill_dispatches,
                decode_dispatches=srv.decode_dispatches,
                peak_memory_bytes=peak, cache_bytes=cache_bytes,
                params=n_params, launches=launches)
    del srv, params, model
    return slim, launches


def xlstm_train_flops(cfg, b, s):
    """Model FLOPs of one xLSTM training step (3 x the forward, remat
    recompute not counted): each sLSTM block's input gates, recurrent
    product and up / down projection, each mLSTM block's fused projection,
    out-projection and chunked scan (heads folded into the batch: one
    head of P = N = 2 d / H a row, chunk min(256, S)), and the untied
    head."""
    d, h = cfg.d_model, cfg.n_heads
    dm = int(d * cfg.xlstm.proj_factor_mlstm)
    df = int(d * cfg.xlstm.proj_factor_slstm)
    hds, hdm = d // h, dm // h
    pairs = cfg.n_layers // 2
    per_tok = (d * 4 * d + h * hds * 4 * hds + 2 * d * df
               + d * (4 * dm + 2 * h) + dm * d)
    mm = 2.0 * b * s * (pairs * per_tok + d * cfg.vocab)
    scan = pairs * ssd_work(b * h, s, 1, hdm, hdm, min(256, s))[1]
    return 3 * (mm + scan)


def serve_xlstm(dev, tag):
    """Phase 4o: xlstm-125m served at full width through
    launch.serve.run_workload.  Every prompt token is a batch-1 decode
    step (the scan prefill): each pair an sLSTM step on its h, c, n and
    an mLSTM step on its C, in place.  No kernel launches (the family
    runs none), no plain call, no non-finite logit, every request
    retired by length with XLSTM_GEN tokens.  Prints TTFT and ITL p50 /
    p95, a scan step's and a decode step's host and device ms, the peak
    memory; then the reduced xlstm on the card against the CPU.  Returns
    the record, the launches and what the plan part serves again."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ssd
    from repro_torch.launch.serve import run_workload
    from repro_torch.models.model import LM
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = get_arch(XLSTM)
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serve xlstm: {cfg.name} full width, {cfg.n_layers // 2} sLSTM + "
          f"{cfg.n_layers // 2} mLSTM blocks, d {cfg.d_model}, "
          f"{cfg.n_heads} heads, vocab {cfg.vocab}, {n_params / 1e9:.3f} B "
          f"params bf16, init {time.perf_counter() - t0:.1f}s {tag}")
    scfg = ServeConfig(slots=XLSTM_SLOTS, max_len=XLSTM_MAX_LEN,
                       prefill_chunk=256)
    rng = np.random.default_rng(0)
    lo, hi = XLSTM_PROMPT
    prompts = [rng.integers(0, cfg.vocab,
                            size=int(rng.integers(lo, hi + 1))).tolist()
               for _ in range(XLSTM_REQUESTS)]
    warm = Server(model, params, scfg)
    warm.admit(prompts[0][:8], 0, max_new_tokens=2)
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    srv = checked_server()(model, params, scfg)
    state_b = sum(t.numel() * t.element_size() for k, sub in srv.cache.items()
                  if k != "pos" for t in sub.values())
    fa.reset_launches()
    ssd.reset_launches()
    ops.reset_plain_calls()
    t0 = time.perf_counter()
    rec = run_workload(srv, [(0.0, p) for p in prompts], gen=XLSTM_GEN)
    wall = time.perf_counter() - t0
    launches = dict(fa.launches, **ssd.launches)
    plain = dict(ops.plain_calls)
    peak = torch.cuda.max_memory_allocated(dev)
    n = XLSTM_REQUESTS
    scan_steps = sum(len(p) for p in prompts)
    reasons = set(srv.finished.values())
    want = dict.fromkeys(launches, 0)       # the family runs no kernel
    print(f"serve xlstm: {rec['requests']} requests, {rec['prompt_tokens']} "
          f"prompt tokens ({scan_steps} batch-1 scan steps), "
          f"{rec['generated_tokens']} generated, {srv.decode_dispatches} "
          f"decode dispatches, retire reasons {sorted(reasons)}; state "
          f"{state_b / 1e9:.3f} GB ({state_b / XLSTM_SLOTS / 1e6:.2f} MB a "
          f"slot)")
    print(f"serve xlstm: launches {launches} (want {want}), plain calls "
          f"{plain}")
    if rec["requests"] != n or len(srv.finished) != n or reasons != {
            "length"}:
        fail(f"not every xlstm request retired by length: {srv.finished}")
    if any(len(srv.outputs[r]) != XLSTM_GEN for r in srv.finished):
        fail(f"an xlstm request did not produce {XLSTM_GEN} tokens")
    if launches != want or any(plain.values()) or srv.nonfinite:
        fail(f"xlstm serving: launches {launches}, plain calls {plain}, "
             f"{srv.nonfinite} non-finite logits")
    ms = 1e3
    print(f"serve xlstm metrics: prefill {rec['prefill_tok_per_s']:.1f} "
          f"tok/s, decode {rec['decode_tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{rec['ttft_p50_s'] * ms:.1f} ms p95 {rec['ttft_p95_s'] * ms:.1f} "
          f"ms, ITL p50 {rec['itl_p50_s'] * ms:.2f} ms p95 "
          f"{rec['itl_p95_s'] * ms:.2f} ms, scan step "
          f"{rec['prefill_s'] / scan_steps * ms:.2f} ms, wall {wall:.2f} s, "
          f"peak memory {peak / 2**30:.2f} GiB {tag}")
    slim = {k: v for k, v in rec.items() if k not in ("itl_s", "ttft_s")}
    slim.update(decode_dispatches=srv.decode_dispatches,
                scan_steps=scan_steps, state_bytes=state_b, wall_s=wall,
                peak_memory_bytes=peak, params=n_params)
    streams = {r: list(t) for r, t in srv.outputs.items()}
    del srv
    torch.cuda.empty_cache()
    srv = Server(model, params, scfg)
    slim["decode_step"] = decode_step_times(srv, PLAN_STEPS, tag,
                                            "xlstm no plan")
    slim["scan_step"] = scan_step_times(srv, PLAN_STEPS, tag,
                                        "xlstm no plan")
    del srv
    torch.cuda.empty_cache()
    slim["reduced_card_vs_cpu"] = reduced_scan_card_vs_cpu(
        dev, tag, cfg=cfg.reduced(), name="xlstm")
    return slim, launches, (params, prompts, streams, scfg)


def serve_xlstm_plan(base, dev, tag, mesh):
    """Phase 4o under the plan (a world-1 NCCL group must be up): 4o's
    first XLSTM_PLAN_REQS requests on 4o's weights and slots under the
    solved (1, 1) decode plan (params and every layer's C, h, c, n as
    DTensors; each block's state update in a local_map region on the
    state's rows, in place).  They must give 4o's streams of those
    requests token for token, with no launch, 0 plan fallbacks, 0 plain
    calls; a decode step's and a scan step's host and device ms under
    the plan; then the reduced xlstm under the plan against the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ssd
    from repro_torch.launch.compile import plan_from_record, solve_cell_plan
    from repro_torch.launch.mesh import solver_axes
    from repro_torch.launch.serve import run_workload
    from repro_torch.models.model import LM
    from repro_torch.runtime.serve import Server

    params, prompts, streams4o, scfg = base
    cfg = get_arch(XLSTM)
    t0 = time.perf_counter()
    plan = plan_from_record(solve_cell_plan(
        cfg, ShapeConfig(*XLSTM_PLAN_SHAPE), solver_axes((1, 1)), "mesh1x1",
        use_cache=False))
    print(f"xlstm plan: {cfg.name} {XLSTM_PLAN_SHAPE[0]} on the 1x1 mesh, "
          f"solved in {time.perf_counter() - t0:.3f} s:")
    print(plan.describe())
    model = LM(cfg, plan=plan, mesh=mesh)
    reqs = prompts[:XLSTM_PLAN_REQS]
    scan_steps = sum(len(p) for p in reqs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    srv = checked_server()(model, params, scfg)
    fa.reset_launches()
    ssd.reset_launches()
    ops.reset_plain_calls()
    rec = run_workload(srv, [(0.0, p) for p in reqs], gen=XLSTM_GEN)
    launches = dict(fa.launches, **ssd.launches)
    plain, fallbacks = dict(ops.plain_calls), dict(ops.plan_fallbacks)
    peak = torch.cuda.max_memory_allocated(dev)
    streams = {r: list(t) for r, t in srv.outputs.items()}
    ms = 1e3
    print(f"xlstm plan: {len(reqs)} requests, {scan_steps} scan steps, "
          f"{srv.decode_dispatches} decode dispatches; launches {launches}, "
          f"plan fallbacks {fallbacks}, plain calls {plain}, non-finite "
          f"logits {srv.nonfinite}")
    print(f"xlstm plan metrics: scan step "
          f"{rec['prefill_s'] / scan_steps * ms:.2f} ms, ITL p50 "
          f"{rec['itl_p50_s'] * ms:.2f} ms, wall {rec['wall_s']:.2f} s, "
          f"peak memory {peak / 2**30:.2f} GiB {tag}")
    if any(launches.values()):
        fail(f"xlstm plan: launches {launches}")
    if any(fallbacks.values()) or any(plain.values()) or srv.nonfinite:
        fail(f"xlstm plan: fallbacks {fallbacks}, plain calls {plain}, "
             f"{srv.nonfinite} non-finite logits")
    if streams != {r: streams4o[r] for r in range(len(reqs))}:
        fail("xlstm plan: streams differ from phase 4o's")
    out = {k: v for k, v in rec.items() if k not in ("itl_s", "ttft_s")}
    out.update(decode_dispatches=srv.decode_dispatches,
               scan_step_ms=rec["prefill_s"] / scan_steps * ms,
               launches=launches, plan_fallbacks=fallbacks,
               peak_memory_bytes=peak)
    del srv
    torch.cuda.empty_cache()
    srv = Server(model, params, scfg)
    out["decode_step"] = decode_step_times(srv, PLAN_STEPS, tag,
                                           "xlstm plan")
    out["scan_step"] = scan_step_times(srv, PLAN_STEPS, tag, "xlstm plan")
    del srv
    torch.cuda.empty_cache()
    print(f"xlstm plan: 4o's streams of its first {len(reqs)} requests "
          f"under the (1, 1) plan; 0 fallbacks, 0 plain calls {tag}")
    out["reduced_card_vs_cpu"] = reduced_scan_card_vs_cpu(
        dev, tag, plan, mesh, cfg=cfg.reduced(), name="xlstm")
    return out, launches


def train_xlstm(dev, tag, ref_rec=None, profile=False):
    """Phase 4p: xlstm-125m trained at full width through launch.train's
    runner (XLSTM_BATCH x XLSTM_SEQ tokens a step in XLSTM_MICRO
    microbatches, AdamW, f32 master, XLSTM_STEPS steps); with ``ref_rec`` (the
    unplanned run's record) the same run with --mesh 1x1 --plan auto (a
    world-1 NCCL group must be up), each loss within TRAIN_PLAN_LOSS_REL
    of the unplanned run's.  No kernel launches (the family runs none),
    no plain call, no plan fallback; losses finite (falling, unplanned);
    tok/s, step ms, the model-FLOPs share and the peak memory; with
    ``profile`` (unplanned) also a step's host and device ms."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ssd
    from repro_torch.launch import train as launch_train

    cfg = get_arch(XLSTM)
    planned = ref_rec is not None
    argv = train_argv(XLSTM, XLSTM_STEPS, XLSTM_BATCH, XLSTM_SEQ,
                      XLSTM_MICRO)
    if planned:
        argv += ["--mesh", "1x1", "--plan", "auto"]
    args = launch_train.build_argparser().parse_args(argv)
    label = "xlstm train plan" if planned else "xlstm train"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    ssd.reset_launches()
    ops.reset_plain_calls()
    rec = launch_train.run(args)
    launches = dict(fa.launches, **ssd.launches)
    plain, fallbacks = dict(ops.plain_calls), dict(ops.plan_fallbacks)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = rec["losses"]
    print(f"{label}: {cfg.name} full width, {XLSTM_STEPS} steps of "
          f"{XLSTM_BATCH} x {XLSTM_SEQ} tokens in {XLSTM_MICRO} "
          f"microbatch(es), losses {[round(x, 4) for x in losses]}")
    print(f"{label}: launches {launches}, plan fallbacks {fallbacks}, plain "
          f"calls {plain}")
    if len(losses) != XLSTM_STEPS or not np.isfinite(losses).all():
        fail(f"{label}: losses not all finite: {losses}")
    if any(launches.values()) or any(plain.values()) or any(
            fallbacks.values()):
        fail(f"{label}: launches {launches}, plain {plain}, fallbacks "
             f"{fallbacks}")
    if not planned and not losses[-1] < losses[0]:
        fail(f"xlstm: last loss {losses[-1]} is not below the first "
             f"{losses[0]}")
    flops = xlstm_train_flops(cfg, XLSTM_BATCH, XLSTM_SEQ)
    mfu = flops / rec["mean_step_s"] / BF16_FLOPS_PER_S
    print(f"{label} metrics: {rec['tokens_per_s']:.1f} tok/s, mean step "
          f"{rec['mean_step_s'] * 1e3:.2f} ms over "
          f"{rec['meta']['measured_steps']} steps, model FLOPs "
          f"{flops / 1e12:.4f} TFLOP/step = {100 * mfu:.3f}% of 989 "
          f"TFLOP/s, peak memory {peak / 2**30:.2f} GiB, breakdown "
          f"{rec['breakdown_s']} {tag}")
    rec.update(launches=launches, plan_fallbacks=fallbacks,
               peak_memory_bytes=peak, model_flops_per_step=flops, mfu=mfu)
    if planned:
        ref = ref_rec["losses"]
        rel = max(abs(a - b) / max(abs(b), 1e-12)
                  for a, b in zip(losses, ref))
        print(f"{label}: losses against 4p's: bit-equal {losses == ref}, "
              f"max relative gap {rel:.3g} (band {TRAIN_PLAN_LOSS_REL}); "
              f"mean step {rec['mean_step_s'] * 1e3:.2f} ms (4p "
              f"{ref_rec['mean_step_s'] * 1e3:.2f}) {tag}")
        if len(ref) != XLSTM_STEPS or not rel <= TRAIN_PLAN_LOSS_REL:
            fail(f"{label}: losses {losses} against 4p's {ref}")
        rec.update(bit_equal=losses == ref, max_rel_gap=rel)
    elif profile:
        gc.collect()
        torch.cuda.empty_cache()
        rec["step"] = train_step_times(dev, cfg, None, None, tag, "xlstm",
                                       True, timed=1, profiled=1,
                                       argv=argv)
    return rec, launches


def ssm_branch(dev, tag):
    """Phase 4q: the pure-Mamba branch of LM on the card, on a test-built
    config (zamba2-2.7b's widths, family "ssm", no shared block, cut to
    SSM_LAYERS layers; no config of the repo has the branch).  One
    training step of the engine (f32 master, AdamW, TRAIN_BATCH x
    TRAIN_SEQ in 2 microbatches) and SSM_DECODE_STEPS decode steps of
    SSM_ROWS rows: ssd_chunk_scan launches exactly layers x microbatches
    x 2 (the forward and the remat recompute; the backward recomputes by
    the chunked scan, counted apart), the decode steps none (each layer a
    mamba_step on its state), no attention kernel, no plain call; the
    loss and logits finite.  Then, outside the counted run, the forward
    pass of the kernel route (ssd_impl "auto") against the chunked
    route's on the same weights: the bf16 loss within LOSS_ATOL (4d's
    band), the logits of an f32 copy of the weights within LOGITS_ATOL;
    then the reduced branch on the card against the CPU.  Returns the record and
    the launches."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ssd
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.engine import EngineConfig, TrainEngine

    base = get_arch(HYBRID_ARCH)
    cfg = dataclasses.replace(base, name="zamba2-2.7b-ssm-8l",
                              family="ssm", attn_every=0,
                              n_layers=SSM_LAYERS)
    model = LM(cfg)
    print(f"pure SSM: a test-built config, not a registered one: "
          f"{HYBRID_ARCH}'s widths (d {cfg.d_model}, {cfg.d_inner // cfg.ssm.head_dim} "
          f"SSM heads of P {cfg.ssm.head_dim} / N {cfg.ssm.state_dim}, chunk "
          f"{cfg.ssm.chunk}, vocab {cfg.vocab}), family 'ssm', no shared "
          f"block, {SSM_LAYERS} of {base.n_layers} layers {tag}")
    eng = TrainEngine(model, EngineConfig(
        microbatches=TRAIN_MICRO, optim=AdamWConfig(
            lr=3e-4, warmup_steps=2, total_steps=100)), device=dev)
    state = eng.init_state(0)
    dcfg = DataConfig(seed=0, vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    batch = host_batch(dcfg, 0)
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (SSM_DECODE_STEPS, SSM_ROWS)), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    ssd.reset_launches()
    ops.reset_plain_calls()
    t0 = time.perf_counter()
    state, m = eng.step(state, batch)
    loss = float(m["loss"])
    step_s = time.perf_counter() - t0
    params = state["params"]
    cache = model.init_cache(SSM_ROWS, 64, device=dev)
    nonfinite = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(SSM_DECODE_STEPS):
            lg, _ = model.decode_step(params, cache, toks[i])
            nonfinite += int((~torch.isfinite(lg)).sum())
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / SSM_DECODE_STEPS
    launches = dict(fa.launches, **ssd.launches)
    recomputes = dict(ops.bwd_recomputes)
    plain = dict(ops.plain_calls)
    peak = torch.cuda.max_memory_allocated(dev)
    L, m_ = cfg.n_layers, TRAIN_MICRO
    want = dict.fromkeys(launches, 0)
    want["ssd_chunk_scan"] = L * m_ * 2
    print(f"pure SSM: one training step, loss {loss:.4f}, {step_s * 1e3:.1f} "
          f"ms (first step: includes cuBLAS set-up); {SSM_DECODE_STEPS} "
          f"decode steps of {SSM_ROWS} rows, {decode_ms:.2f} ms a step; peak "
          f"memory {peak / 2**30:.2f} GiB {tag}")
    print(f"pure SSM: launches {launches} (want {want}), SSD backward "
          f"recomputes {recomputes} (want {L * m_}), plain calls {plain}, "
          f"non-finite logits {nonfinite}")
    if launches != want or recomputes != {"ssd_chunk_scan": L * m_}:
        fail(f"pure SSM: launches {launches}, recomputes {recomputes}")
    if any(plain.values()) or nonfinite or not np.isfinite(loss):
        fail(f"pure SSM: plain calls {plain}, {nonfinite} non-finite "
             f"logits, loss {loss}")
    # the kernel route against the chunked route on the same weights: in
    # bf16 (the main path's dtype) the loss, and in f32 (a copy of the
    # weights, so that bf16 roundings of the activations, which 8 layers
    # amplify, do not hide the scans' own gap) the logits
    chunked = dataclasses.replace(model, ssd_impl="chunked")
    one = {k: torch.as_tensor(v[:1], device=dev) for k, v in batch.items()}
    with torch.no_grad():
        lk16 = model.forward(params, one["tokens"])[0]
        lc16 = chunked.forward(params, one["tokens"])[0]
        gap16 = float((lk16.float() - lc16.float()).abs().max())
        dloss = abs(float(model.loss(params, one))
                    - float(chunked.loss(params, one)))
        del lk16, lc16
        p32 = {k: v.float() if torch.is_tensor(v) else
               {n: t.float() for n, t in v.items()}
               for k, v in params.items()}
        lk = model.forward(p32, one["tokens"])[0]
        lc = chunked.forward(p32, one["tokens"])[0]
        gap = float((lk - lc).abs().max())
        finite = bool(torch.isfinite(lk).all())
    print(f"pure SSM: forward [1, {TRAIN_SEQ}] tokens, the kernel route "
          f"against the chunked route on the same weights: bf16 |dloss| "
          f"{dloss:.4g} (band {LOSS_ATOL}), max|dlogits| {gap16:.4g}; f32 "
          f"copy max|dlogits| {gap:.4g} (band {LOGITS_ATOL}) {tag}")
    if not dloss <= LOSS_ATOL or not gap <= LOGITS_ATOL or not finite:
        fail(f"pure SSM: the kernel route is {dloss} (loss) / {gap} (f32 "
             "logits) from the chunked route")
    del state, eng, params, cache, lk, lc, p32
    gc.collect()
    torch.cuda.empty_cache()
    red = dataclasses.replace(get_arch(HYBRID_ARCH).reduced(),
                              family="ssm", attn_every=0)
    rec = dict(loss=loss, step_s=step_s, decode_step_ms=decode_ms,
               launches=launches, bwd_recomputes=recomputes,
               peak_memory_bytes=peak, logits_gap_f32=gap,
               logits_gap_bf16=gap16, loss_gap_bf16=dloss,
               reduced_card_vs_cpu=reduced_scan_card_vs_cpu(
                   dev, tag, cfg=red, name="pure SSM"))
    return rec, launches


def stub_cfg(arch, n_layers=None):
    """An embedding-stub config at full width, cut to ``n_layers`` if
    given."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    return dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)


def serve_stub(dev, tag, arch, n_layers=None, n_requests=MUSICGEN_REQUESTS,
               gen=MUSICGEN_GEN, tiers=("linear", "paged")):
    """Phases 4r / 4s, serving: an embedding-stub backbone at full width
    (cut to ``n_layers`` if given) through launch.serve.run_workload, fed
    token ids through its embed table as repro's Server feeds them, on
    each of ``tiers`` (the paged tier: 16-token blocks, no speculation)
    with the same requests.  Launches exactly flash_fwd L a prefill chunk
    and flash_decode (linear) or flash_paged_decode (paged) L a decode
    step, no plain call, no non-finite logit, every request its ``gen``
    tokens; the paged streams equal the linear ones token for token.
    Prints prefill and decode tok/s, TTFT / ITL, the peak memory and a
    decode step's host and device ms.  Returns the record, the launches
    of each tier and (model, params, prompts, linear streams, serve
    config, gen)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_workload
    from repro_torch.models.model import LM
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = stub_cfg(arch, n_layers)
    model = LM(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    full = stub_cfg(arch)
    print(f"serve {arch}: full width, {cfg.n_layers} of {full.n_layers} "
          f"layers, d {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads "
          f"of hd {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{n_params / 1e9:.3f} B params bf16 ({2 * n_params / 1e9:.2f} "
          f"GB), init {time.perf_counter() - t0:.1f}s {tag}")
    scfg = ServeConfig(slots=STUB_SLOTS, max_len=STUB_MAX_LEN,
                       prefill_chunk=STUB_CHUNK)
    rng = np.random.default_rng(0)
    lo, hi = STUB_PROMPT
    prompts = [rng.integers(0, cfg.vocab,
                            size=int(rng.integers(lo, hi + 1))).tolist()
               for _ in range(n_requests)]
    warm = Server(model, params, scfg)      # first launches, cuBLAS set-up
    warm.admit(prompts[0][:300], 0, max_new_tokens=2)
    warm.run()
    del warm
    torch.cuda.synchronize()

    L, ms = cfg.n_layers, 1e3
    out, launches_all = {"params": n_params, "n_layers": L}, {}
    for tier in tiers:
        extra = dict(paged=True, block_len=16) if tier == "paged" else {}
        srv = checked_server()(model, params,
                               dataclasses.replace(scfg, **extra))
        cache_bytes = sum(t.numel() * t.element_size() for t in _leaves(
            {k: v for k, v in srv.cache.items() if k != "pos"}))
        fa.reset_launches()
        ops.reset_plain_calls()
        rec = run_workload(srv, [(0.0, p) for p in prompts], gen=gen)
        launches = dict(fa.launches)
        plain = dict(ops.plain_calls)
        peak = torch.cuda.max_memory_allocated(dev)
        want = dict.fromkeys(launches, 0)
        want["flash_fwd"] = L * srv.prefill_dispatches
        kernel = "flash_paged_decode" if extra else "flash_decode"
        want[kernel] = L * srv.decode_dispatches
        reasons = set(srv.finished.values())
        print(f"serve {arch} {tier}: {rec['requests']} requests, "
              f"{rec['prompt_tokens']} prompt tokens, "
              f"{rec['generated_tokens']} generated, "
              f"{srv.prefill_dispatches} prefill chunks, "
              f"{srv.decode_dispatches} decode dispatches, cache "
              f"{cache_bytes / 1e9:.2f} GB; launches {launches} (want "
              f"{want}), plain calls {plain}")
        if rec["requests"] != n_requests or reasons != {"length"} or any(
                len(srv.outputs[r]) != gen for r in srv.finished):
            fail(f"{arch} {tier}: not every request gave {gen} tokens: "
                 f"{srv.finished}")
        if launches != want:
            fail(f"{arch} {tier}: launches {launches}, expected {want}")
        if any(plain.values()) or srv.nonfinite:
            fail(f"{arch} {tier}: plain calls {plain}, {srv.nonfinite} "
                 f"non-finite logits")
        print(f"serve {arch} {tier} metrics: prefill "
              f"{rec['prefill_tok_per_s']:.1f} tok/s, decode "
              f"{rec['decode_tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{rec['ttft_p50_s'] * ms:.1f} ms p95 "
              f"{rec['ttft_p95_s'] * ms:.1f} ms, ITL p50 "
              f"{rec['itl_p50_s'] * ms:.2f} ms p95 "
              f"{rec['itl_p95_s'] * ms:.2f} ms, wall {rec['wall_s']:.2f} s, "
              f"peak memory {peak / 2**30:.2f} GiB {tag}")
        slim = {k: v for k, v in rec.items() if k not in ("itl_s",
                                                          "ttft_s")}
        slim.update(prefill_dispatches=srv.prefill_dispatches,
                    decode_dispatches=srv.decode_dispatches,
                    peak_memory_bytes=peak, cache_bytes=cache_bytes,
                    launches=launches,
                    streams={r: list(t) for r, t in srv.outputs.items()})
        if tier == "linear":
            slim["decode_step"] = decode_step_times(srv, PLAN_STEPS, tag,
                                                    arch)
        out[tier], launches_all[tier] = slim, launches
        del srv
        torch.cuda.empty_cache()
    streams = out["linear"]["streams"]
    if "paged" in out:
        if out["paged"]["streams"] != streams:
            fail(f"{arch}: the paged tier's streams differ from the linear "
                 "tier's")
        print(f"serve {arch}: the paged tier's streams equal the linear "
              f"tier's token for token {tag}")
    return out, launches_all, (model, params, prompts, streams, scfg, gen)


def stub_embeds_step(model, params, dev, tag):
    """Phase 4r: the model API's embeds input on the card.  One decode
    step of 8 rows fed ``params["embed"][tokens]`` as [B, D] embeds gives
    the same step fed the token ids bit for bit (logits and the K/V it
    writes), each launching flash_decode once a layer."""
    from repro_torch.kernels import flash_attention as fa

    cfg = model.cfg
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, size=STUB_SLOTS), dtype=torch.int32, device=dev)
    out = {}
    with torch.no_grad():
        for how, feed in (("tokens", toks),
                          ("embeds", params["embed"][toks.long()])):
            cache = model.init_cache(STUB_SLOTS, 64, device=dev)
            fa.reset_launches()
            logits, cache = model.decode_step(params, cache, feed)
            torch.cuda.synchronize()
            out[how] = (logits, cache, fa.launches["flash_decode"])
    same = (torch.equal(out["tokens"][0], out["embeds"][0])
            and all(torch.equal(a, b) for a, b in zip(
                _leaves(out["tokens"][1]), _leaves(out["embeds"][1]))))
    n = [out[k][2] for k in ("tokens", "embeds")]
    print(f"{cfg.name}: a decode step fed [B, D] embeds "
          f"{tuple(out['embeds'][0].shape)} logits, bit-equal to the step "
          f"fed the token ids (logits and cache) {same}; flash_decode "
          f"launches {n} (want {cfg.n_layers} each) {tag}")
    if not same or n != [cfg.n_layers] * 2:
        fail(f"{cfg.name}: the embeds decode step differs from the token "
             f"step (bit-equal {same}, launches {n})")
    return dict(bit_equal=same, launches=n)


def serve_stub_plan(base, dev, tag, mesh):
    """Phases 4r / 4s under the plan: the first STUB_PLAN_REQS requests of
    the serving phase on its weights under the solved (1, 1) decode plan
    (params and cache as DTensors, the kernels inside local_map): the
    serving phase's streams of those requests, launches exactly
    flash_fwd L a chunk and flash_decode L a step, no fallback, no plain
    call, no non-finite logit; a decode step's host and device ms."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.compile import plan_from_record, solve_cell_plan
    from repro_torch.launch.mesh import solver_axes
    from repro_torch.launch.serve import run_workload
    from repro_torch.models.model import LM
    from repro_torch.runtime.serve import Server

    model0, params, prompts, streams0, scfg, gen = base
    cfg = model0.cfg
    t0 = time.perf_counter()
    plan = plan_from_record(solve_cell_plan(
        cfg, ShapeConfig(*STUB_PLAN_SHAPE), solver_axes((1, 1)), "mesh1x1",
        use_cache=False))
    print(f"{cfg.name} plan: {STUB_PLAN_SHAPE[0]} on the 1x1 mesh, solved "
          f"in {time.perf_counter() - t0:.3f} s:")
    print(plan.describe())
    model = LM(cfg, plan=plan, mesh=mesh)
    reqs = prompts[:STUB_PLAN_REQS]
    warm = Server(model, params, scfg)
    warm.admit(reqs[0][:8], 0, max_new_tokens=2)
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    srv = checked_server()(model, params, scfg)
    fa.reset_launches()
    ops.reset_plain_calls()
    rec = run_workload(srv, [(0.0, p) for p in reqs], gen=gen)
    launches = dict(fa.launches)
    plain, fallbacks = dict(ops.plain_calls), dict(ops.plan_fallbacks)
    peak = torch.cuda.max_memory_allocated(dev)
    streams = {r: list(t) for r, t in srv.outputs.items()}
    L, ms = cfg.n_layers, 1e3
    want = dict.fromkeys(launches, 0)
    want["flash_fwd"] = L * srv.prefill_dispatches
    want["flash_decode"] = L * srv.decode_dispatches
    print(f"{cfg.name} plan: {len(reqs)} request(s), "
          f"{srv.prefill_dispatches} prefill chunks, "
          f"{srv.decode_dispatches} decode dispatches; launches {launches} "
          f"(want {want}), plan fallbacks {fallbacks}, plain calls {plain}, "
          f"non-finite logits {srv.nonfinite}")
    print(f"{cfg.name} plan metrics: prefill {rec['prefill_tok_per_s']:.1f} "
          f"tok/s, decode {rec['decode_tok_per_s']:.1f} tok/s, ITL p50 "
          f"{rec['itl_p50_s'] * ms:.2f} ms, wall {rec['wall_s']:.2f} s, "
          f"peak memory {peak / 2**30:.2f} GiB {tag}")
    if launches != want:
        fail(f"{cfg.name} plan: launches {launches}, want {want}")
    if any(fallbacks.values()) or any(plain.values()) or srv.nonfinite:
        fail(f"{cfg.name} plan: fallbacks {fallbacks}, plain calls {plain}, "
             f"{srv.nonfinite} non-finite logits")
    if streams != {r: streams0[r] for r in range(len(reqs))}:
        fail(f"{cfg.name} plan: streams differ from the unplanned run's")
    print(f"{cfg.name} plan: the unplanned streams of its first {len(reqs)} "
          f"request(s) under the (1, 1) plan; launches exact, 0 fallbacks, "
          f"0 plain calls {tag}")
    out = {k: v for k, v in rec.items() if k not in ("itl_s", "ttft_s")}
    out.update(decode_dispatches=srv.decode_dispatches,
               prefill_dispatches=srv.prefill_dispatches, launches=launches,
               plan_fallbacks=fallbacks, peak_memory_bytes=peak,
               decode_step=decode_step_times(srv, PLAN_STEPS, tag,
                                             f"{cfg.name} plan"))
    del srv
    torch.cuda.empty_cache()
    return out, launches


def stub_batch(cfg, step, dev):
    """The embedding-stub frontend's batch for ``step``: [STUB_BATCH,
    STUB_SEQ, d] embeds from audio_frame_embeds (musicgen-large) or
    vision_patch_embeds (internvl2-76b), seeded by the step, and
    host_batch's labels for the step."""
    from repro_torch.data.pipeline import (DataConfig, audio_frame_embeds,
                                           host_batch, vision_patch_embeds)
    frontend = (audio_frame_embeds if cfg.family == "audio"
                else vision_patch_embeds)
    labels = host_batch(DataConfig(seed=0, vocab=cfg.vocab, seq_len=STUB_SEQ,
                                   global_batch=STUB_BATCH), step)["labels"]
    return {"embeds": torch.from_numpy(frontend(
                cfg, STUB_BATCH, STUB_SEQ, seed=step)).to(dev),
            "labels": torch.from_numpy(labels).to(dev)}


def train_stub(dev, tag, arch, n_layers, steps, mesh=None, ref_rec=None):
    """Phases 4r / 4s, training: an embedding-stub backbone at full width
    (cut to ``n_layers``) trained by the engine from its stub frontend's
    embeds (``stub_batch``: STUB_BATCH x STUB_SEQ in one microbatch, the
    same batch every step, so that the loss must fall), f32
    master, AdamW lr 3e-4 with 2 warmup steps, ``steps`` steps; with
    ``mesh`` (a world-1 NCCL group up) under the solved (1, 1) train plan.
    Launches per step exactly flash_fwd 2 L (forward and remat) and
    flash_bwd_dq / flash_bwd_dkv L each, no plain call, no plan fallback,
    losses finite and falling; under the plan (``ref_rec``: the unplanned
    run's record) each loss bit-equal to the unplanned run's (4r) or
    within TRAIN_PLAN_LOSS_REL of it (printed either way).  Prints the
    step ms, tok/s, the model-FLOPs share and the peak memory."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainConfig, make_engine

    cfg = stub_cfg(arch, n_layers)
    planned = mesh is not None
    label = f"train {arch}" + (" plan" if planned else "")
    plan = None
    if planned:
        from repro_torch.launch.compile import (plan_from_record,
                                                solve_cell_plan)
        from repro_torch.launch.mesh import solver_axes
        t0 = time.perf_counter()
        plan = plan_from_record(solve_cell_plan(
            cfg, ShapeConfig(*STUB_TRAIN_SHAPE), solver_axes((1, 1)),
            "mesh1x1_mp", use_cache=False,
            graph_kwargs={"master_fp32": True}))
        print(f"{label}: the (1, 1) train plan solved in "
              f"{time.perf_counter() - t0:.3f} s (roles cut: "
              f"{sorted(r for r, c in plan.role_cuts.items() if c)})")
    tcfg = TrainConfig(microbatches=1, buckets=4, optim=AdamWConfig(
        lr=3e-4, warmup_steps=2, total_steps=steps))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    engine = make_engine(LM(cfg), tcfg, device=dev, mesh=mesh, plan=plan)
    state = engine.init_state(0)
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    batch = stub_batch(cfg, 0, dev)
    fa.reset_launches()
    ops.reset_plain_calls()
    metrics, stamps = [], []
    torch.cuda.synchronize()
    for _ in range(steps):
        stamps.append(time.perf_counter())
        state, m = engine.step(state, batch)
        metrics.append(m)
        torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    launches = dict(fa.launches)
    plain, fallbacks = dict(ops.plain_calls), dict(ops.plan_fallbacks)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["gnorm"]) for m in metrics]
    step_s = float(np.mean(np.diff(stamps)[1:]))      # after the first
    L = cfg.n_layers
    want = dict.fromkeys(launches, 0)
    want.update(flash_fwd=2 * L * steps, flash_bwd_dq=L * steps,
                flash_bwd_dkv=L * steps)
    print(f"{label}: full width, {L} of {stub_cfg(arch).n_layers} layers, "
          f"{n_params / 1e9:.3f} B params, {steps} steps of {STUB_BATCH} x "
          f"{STUB_SEQ} embeds in one microbatch, losses "
          f"{[round(x, 4) for x in losses]}, gnorms "
          f"{[round(x, 4) for x in gnorms]}")
    print(f"{label}: launches {launches} (want {want}), plan fallbacks "
          f"{fallbacks}, plain calls {plain}")
    if len(losses) != steps or not np.isfinite(losses + gnorms).all():
        fail(f"{label}: losses or gnorms not all finite: {losses} {gnorms}")
    if not losses[-1] < losses[0]:
        fail(f"{label}: last loss {losses[-1]} is not below the first "
             f"{losses[0]}")
    if launches != want:
        fail(f"{label}: launches {launches}, expected {want}")
    if any(plain.values()) or any(fallbacks.values()):
        fail(f"{label}: plain calls {plain}, fallbacks {fallbacks}")
    flops = train_flops(cfg, STUB_BATCH, STUB_SEQ)
    mfu = flops / step_s / BF16_FLOPS_PER_S
    print(f"{label} metrics: {STUB_BATCH * STUB_SEQ / step_s:.1f} tok/s, "
          f"mean step {step_s * 1e3:.2f} ms over {steps - 1} steps (each "
          f"synced), model FLOPs {flops / 1e12:.3f} TFLOP/step = "
          f"{100 * mfu:.2f}% of 989 TFLOP/s, peak memory "
          f"{peak / 2**30:.2f} GiB {tag}")
    rec = dict(losses=losses, gnorms=gnorms, launches=launches,
               plan_fallbacks=fallbacks, peak_memory_bytes=peak,
               mean_step_s=step_s, model_flops_per_step=flops, mfu=mfu,
               params=n_params, n_layers=L)
    if planned:
        ref = ref_rec["losses"]
        rel = max(abs(a - b) / max(abs(b), 1e-12)
                  for a, b in zip(losses, ref))
        equal = losses == ref
        print(f"{label}: against the unplanned run's: losses bit-equal "
              f"{equal}, gnorms bit-equal {gnorms == ref_rec['gnorms']}, max "
              f"relative loss gap {rel:.3g}; mean step {step_s * 1e3:.2f} ms "
              f"(unplanned {ref_rec['mean_step_s'] * 1e3:.2f}) {tag}")
        if arch == MUSICGEN and not equal:
            fail(f"{label}: losses {losses} are not the unplanned run's "
                 f"{ref}")
        if not rel <= TRAIN_PLAN_LOSS_REL:
            fail(f"{label}: losses {losses} against {ref}")
        rec.update(bit_equal=equal, max_rel_gap=rel)
    del state, engine, batch, metrics
    return rec, launches


def reduced_stub_card_vs_cpu(dev, tag, arch):
    """The reduced embedding-stub backbone (bf16, hd 16) on the card against
    the same weights on the CPU: the forward's logits from stub-frontend
    embeds and 4 decode steps fed [B, D] embeds (LOGITS_ATOL), the loss
    (LOSS_ATOL)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import (audio_frame_embeds,
                                           vision_patch_embeds)
    from repro_torch.models.model import LM

    cfg = get_arch(arch).reduced()
    frontend = (audio_frame_embeds if cfg.family == "audio"
                else vision_patch_embeds)
    model = LM(cfg)
    p_cpu = model.init(0, device="cpu")
    params = {"cpu": p_cpu, dev: _to(p_cpu, dev)}
    e = torch.from_numpy(frontend(cfg, 3, 12, seed=1))
    labels = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(3, 12)).astype(np.int32))
    steps = torch.from_numpy(frontend(cfg, 4, 3, seed=2))
    out = {}
    with torch.no_grad():
        for d in ("cpu", dev):
            lg, _ = model.forward(params[d], embeds=e.to(d))
            loss = model.loss(params[d], {"embeds": e.to(d),
                                          "labels": labels.to(d)})
            cache = model.init_cache(3, 16, device=d)
            dec = [model.decode_step(params[d], cache, steps[i].to(d))[0]
                   for i in range(4)]
            out[d] = (lg.float().cpu(), float(loss),
                      torch.stack(dec).float().cpu())
    e_fwd = float((out["cpu"][0] - out[dev][0]).abs().max())
    e_loss = abs(out["cpu"][1] - out[dev][1])
    e_dec = float((out["cpu"][2] - out[dev][2]).abs().max())
    print(f"reduced {arch}, card vs CPU: forward from embeds "
          f"max|dlogits|={e_fwd:.4g}, decode on [B, D] embeds "
          f"max|dlogits|={e_dec:.4g} (band {LOGITS_ATOL}), "
          f"|dloss|={e_loss:.4g} (band {LOSS_ATOL}) {tag}")
    if not (e_fwd <= LOGITS_ATOL and e_dec <= LOGITS_ATOL
            and e_loss <= LOSS_ATOL):
        fail(f"reduced {arch} on the card disagrees with the CPU")
    return dict(forward=e_fwd, decode=e_dec, loss=e_loss)


def pipeline_s1(dev, tag):
    """Phase 4t: the pipeline runner (runtime/pipeline_parallel.py) at S =
    1 on the card, over a stack of PIPE_LAYERS of the port's dense
    decoder blocks (``LM._layer``) at qwen2-1.5b's widths, random bf16
    activations [PIPE_BATCH, TRAIN_SEQ, d] and targets, the loss their
    mean squared error in f32, PIPE_MICRO microbatches, AdamW on the bf16
    stack (no master, as repro's runner), PIPE_STEPS steps on the same
    batch.  PipelineTrainer's losses and gnorms must equal TrainEngine's on
    the same stack bit for bit; each run launches exactly flash_fwd and
    flash_bwd_dq / flash_bwd_dkv PIPE_LAYERS x PIPE_MICRO a step (no
    remat in the stack), no plain call; losses finite and falling."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import pipeline_parallel as pp
    from repro_torch.train.engine import EngineConfig, TrainEngine

    cfg = dataclasses.replace(get_arch("qwen2-1.5b"), n_layers=PIPE_LAYERS)
    lm = LM(cfg)
    stack = lm.init(0, device=dev)["layers"]

    def layer_fn(p, x):
        b, s = x.shape[:2]
        pos = torch.arange(s, device=x.device)[None].expand(b, s)
        return lm._layer(p, x, pos)[0]

    def loss_fn(h, y):
        return torch.mean(torch.square(h.float() - y.float()))

    g = torch.Generator(device=dev).manual_seed(4)
    x, y = (torch.randn((PIPE_BATCH, TRAIN_SEQ, cfg.d_model), generator=g,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    optim = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=100)
    runs, launches_all = {}, {}
    for how in ("engine", "pipeline"):
        if how == "engine":
            eng = TrainEngine(pp._StackModel(layer_fn, loss_fn, stack),
                              EngineConfig(microbatches=PIPE_MICRO,
                                           master_fp32=False, optim=optim),
                              device=dev)
            state = eng.init_state(0)

            def step(st):
                return eng.step(st, {"x": x, "y": y})
        else:
            tr = pp.PipelineTrainer(layer_fn, loss_fn, n_stages=1,
                                    n_micro=PIPE_MICRO, optim=optim,
                                    device=dev)
            state = tr.init(stack)

            def step(st):
                return tr.step(st, x, y)
        fa.reset_launches()
        ops.reset_plain_calls()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = []
        for _ in range(PIPE_STEPS):
            state, m = step(state)
            hist.append(m)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches_all[how] = dict(fa.launches)
        plain = dict(ops.plain_calls)
        runs[how] = dict(losses=[float(m["loss"]) for m in hist],
                         gnorms=[float(m["gnorm"]) for m in hist],
                         step_ms=wall * 1e3 / PIPE_STEPS)
        want = dict.fromkeys(launches_all[how], 0)
        n = PIPE_LAYERS * PIPE_MICRO * PIPE_STEPS
        want.update(flash_fwd=n, flash_bwd_dq=n, flash_bwd_dkv=n)
        print(f"pipeline S=1 {how}: {PIPE_LAYERS} dense blocks at "
              f"{cfg.name}'s widths, {PIPE_STEPS} steps of {PIPE_BATCH} x "
              f"{TRAIN_SEQ} in {PIPE_MICRO} microbatches, losses "
              f"{runs[how]['losses']}, gnorms {runs[how]['gnorms']}, "
              f"{runs[how]['step_ms']:.2f} ms a step; launches "
              f"{launches_all[how]} (want {want}), plain calls {plain} {tag}")
        if launches_all[how] != want or any(plain.values()):
            fail(f"pipeline S=1 {how}: launches {launches_all[how]}, want "
                 f"{want}, plain calls {plain}")
        losses = runs[how]["losses"]
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            fail(f"pipeline S=1 {how}: losses {losses}")
        del state
    equal = (runs["pipeline"]["losses"] == runs["engine"]["losses"]
             and runs["pipeline"]["gnorms"] == runs["engine"]["gnorms"])
    print(f"pipeline S=1: PipelineTrainer's losses and gnorms equal "
          f"TrainEngine's bit for bit {equal} {tag}")
    if not equal:
        fail("pipeline S=1: PipelineTrainer's trajectory is not the "
             "engine's")
    launches = {k: launches_all["engine"][k] + launches_all["pipeline"][k]
                for k in launches_all["engine"]}
    return dict(runs=runs, bit_equal=equal, launches=launches_all), launches


def _spans(events):
    """{name: count} of the serve.* / train.* spans and instants."""
    import collections
    return collections.Counter(e["name"] for e in events)


def _validate_files(paths, what):
    """The trace, metrics and flight files through ``python -m
    repro_torch.obs validate``; fails on a problem (printed by it)."""
    from repro_torch.obs import __main__ as obs_cli
    if obs_cli.main(["validate"] + [str(p) for p in paths]):
        fail(f"{what}: invalid observability files")


def serve_observed(base, dev, tag):
    """Phase 4u, serving on phase 4's weights.  (a) Phase 4's first
    OBS_REQS requests with the tracer, a registry and a monitor (ITL and
    TTFT SLOs at OBS_ITL_SLO_MS, MAD-z, a flight recorder) on the linear
    tier and on the paged tier (spec_k 4): phase 4's streams; launches
    exactly L a chunk and a decode step (and a re-score); serve.decode /
    serve.draft / serve.verify spans equal to the decode and verify
    dispatches, serve.admit to the admissions, serve.retire to the
    requests; serve.tokens equal to the tokens served; the monitor's TTFT
    and ITL counts equal to the requests and the later tokens; no plain
    call; the trace validates.  The monitor's host cost per observed
    token is timed apart (observe("itl") and the token counter, 20,000
    times).  (b) launch.serve's main, Poisson arrivals at OBS_RATE, an
    ITL SLO and injected stalls (see OBS_*): the breach, the flight
    file, trace and metrics validate, and the spans agree with the
    launches.  Returns the record."""
    import tempfile

    from repro_torch import obs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch.serve import run_workload
    from repro_torch.runtime.serve import ServeConfig, Server

    lin_model, params, prompts, lin_streams = base
    cfg = lin_model.cfg
    L = cfg.n_layers
    reqs = prompts[:OBS_REQS]
    want_streams = {r: lin_streams[r] for r in range(OBS_REQS)}
    tmp = Path(tempfile.mkdtemp(prefix="obs4u-"))
    tracer = obs.tracing.get_tracer()
    out = {}
    base_kw = dict(slots=16, max_len=2048, prefill_chunk=256)
    for tier, model, kw in (
            ("linear", lin_model, base_kw),
            ("paged", counting_lm(cfg, dev),
             dict(base_kw, paged=True, block_len=16, spec_k=4))):
        reg = obs.Registry()
        rec_ = obs.FlightRecorder(str(tmp / f"flight-{tier}"), registry=reg)
        mon = obs.Monitor(slos=[obs.SLO("itl", OBS_ITL_SLO_MS / 1e3),
                                obs.SLO("ttft", 10.0)],
                          registry=reg, recorder=rec_)
        tracer.clear()
        obs.enable()
        srv = Server(model, params, ServeConfig(**kw), registry=reg,
                     monitor=mon)
        if tier == "paged":
            model.reset_counts()
        fa.reset_launches()
        ops.reset_plain_calls()
        rec = run_workload(srv, [(0.0, p) for p in reqs], gen=32)
        launches, plain = dict(fa.launches), dict(ops.plain_calls)
        obs.disable()
        trace = tracer.to_dict()
        tracer.clear()
        rec_.close()
        spans = _spans(trace["traceEvents"])
        streams = {r: list(t) for r, t in srv.outputs.items()}
        n_tok = sum(len(t) for t in streams.values())
        sig = mon.snapshot()["signals"]
        counters = dict(prefill_dispatches=srv.prefill_dispatches,
                        decode_dispatches=srv.decode_dispatches,
                        verify_dispatches=srv.verify_dispatches,
                        preemptions=srv.preemptions)
        print(f"observed {tier}: {rec['requests']} requests (phase 4's first "
              f"{OBS_REQS}), {counters}; launches {launches}, plain calls "
              f"{plain}; spans {dict(spans)}; monitor {mon.n_events} "
              f"event(s), ttft {sig['ttft']['count']} itl "
              f"{sig['itl']['count']} observations; "
              f"{len(rec_.dumps)} flight dump(s)")
        if streams != want_streams:
            bad = [r for r in want_streams if streams.get(r) != want_streams[r]]
            fail(f"observed {tier}: streams differ from phase 4's for {bad}")
        if tier == "linear":
            want = {"flash_fwd": L * srv.prefill_dispatches,
                    "flash_decode": L * srv.decode_dispatches,
                    "flash_paged_decode": 0}
            want_spans = {"serve.decode": srv.decode_dispatches}
        else:
            calls = dict(model.calls)
            want = {"flash_fwd": L * calls["parallel_prefill"],
                    "flash_paged_decode": L * (calls["decode_step"]
                                               + calls["rescore"]),
                    "flash_decode": 0}
            want_spans = {"serve.draft": srv.decode_dispatches,
                          "serve.verify": srv.verify_dispatches}
        want_spans.update({
            "serve.admit": OBS_REQS + srv.preemptions,
            "serve.admitted": OBS_REQS, "serve.retire": OBS_REQS,
            "serve.preempt": srv.preemptions})
        if any(launches[k] != v for k, v in want.items()) \
                or launches["flash_fwd_f32"]:
            fail(f"observed {tier}: launches {launches}, want {want}")
        if any(spans.get(k, 0) != v for k, v in want_spans.items()):
            fail(f"observed {tier}: spans {dict(spans)}, want {want_spans}")
        if any(plain.values()):
            fail(f"observed {tier}: a plain version ran: {plain}")
        if reg.counter("serve.tokens").value != n_tok \
                or sig["ttft"]["count"] != OBS_REQS \
                or sig["itl"]["count"] != n_tok - OBS_REQS:
            fail(f"observed {tier}: registry / monitor counts "
                 f"{reg.counter('serve.tokens').value}, {sig} against "
                 f"{n_tok} tokens")
        path = tmp / f"{tier}.trace.json"
        path.write_text(json.dumps(trace))
        _validate_files([path] + list(rec_.dumps), f"observed {tier}")
        out[tier] = dict(
            {k: v for k, v in rec.items() if k not in ("itl_s", "ttft_s")},
            counters=counters, launches=launches, spans=dict(spans),
            monitor_events=mon.n_events, flight_dumps=len(rec_.dumps))
        del srv
    # the monitor's host cost a token: what _append adds with a monitor
    # (one ITL observation: burn-rate windows, MAD-z over 64, the window
    # percentile ring) and a registry (the token counter)
    reg = obs.Registry()
    mon = obs.Monitor(slos=[obs.SLO("itl", OBS_ITL_SLO_MS / 1e3),
                            obs.SLO("ttft", 10.0)], registry=reg)
    ctr = reg.counter("serve.tokens")
    itl = out["linear"]["itl_p50_s"]
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        ctr.inc()
        mon.observe("itl", itl)
    per_tok_us = (time.perf_counter() - t0) / n * 1e6
    out["monitor_us_per_token"] = per_tok_us
    print(f"observed: monitor + registry host cost {per_tok_us:.2f} us a "
          f"token ({n} observations), against phase 4's ITL p50 "
          f"{itl * 1e3:.2f} ms {tag}")

    # (b) launch.serve with Poisson arrivals, an ITL SLO and stalls
    argv = ["--arch", cfg.name, "--slots", "16", "--max-len", "2048",
            "--chunk", "256", "--gen", "32", "--prompt-len", str(OBS_PROMPT),
            "--requests", str(OBS_REQS), "--arrivals", "poisson", "--rate",
            str(OBS_RATE), "--seed", "0", "--slo-itl-ms",
            str(OBS_ITL_SLO_MS), "--inject-spike-ms", str(OBS_STALL_MS),
            "--inject-at", str(OBS_STALL_AT), "--inject-steps",
            str(OBS_STALL_STEPS), "--trace-out", str(tmp / "p.trace.json"),
            "--metrics-out", str(tmp / "p.metrics.jsonl"), "--flight-dir",
            str(tmp / "flight-poisson"), "--json-out", str(tmp / "p.json")]
    fa.reset_launches()
    ops.reset_plain_calls()
    t0 = time.perf_counter()
    rc = launch_serve.main(argv)
    wall = time.perf_counter() - t0
    launches, plain = dict(fa.launches), dict(ops.plain_calls)
    if rc:
        fail(f"launch.serve exited {rc}")
    rec = json.loads((tmp / "p.json").read_text())
    trace = json.loads((tmp / "p.trace.json").read_text())
    spans = _spans(trace["traceEvents"])
    mon = rec["monitor"]
    breaches = [e for e in mon["events"] if e["type"] == "slo_breach"
                and e["signal"] == "itl"]
    print(f"observed poisson: {rec['requests']} requests at {OBS_RATE} req/s, "
          f"{rec['decode_steps']} decode steps, {len(breaches)} ITL breach "
          f"observations, {mon['n_events']} monitor events, flight "
          f"{[Path(p).name for p in mon['flight_dumps']]}; spans "
          f"{dict(spans)}; launches {launches}; ITL p50 "
          f"{rec['itl_p50_s'] * 1e3:.2f} ms p95 {rec['itl_p95_s'] * 1e3:.2f} "
          f"ms, wall {wall:.1f} s (init and warm-up included) {tag}")
    _validate_files([tmp / "p.trace.json", tmp / "p.metrics.jsonl"]
                    + mon["flight_dumps"], "observed poisson")
    if not breaches or not any("slo_breach-itl" in p
                               for p in mon["flight_dumps"]):
        fail(f"observed poisson: the stalls did not breach the ITL SLO "
             f"({mon['events'][:4]})")
    # one extra admission, prefill and decode step: the warm-up server's
    # (prompts of OBS_PROMPT tokens are one chunk each)
    want_spans = {"serve.admit": OBS_REQS + 1, "serve.prefill": OBS_REQS + 1,
                  "serve.retire": OBS_REQS + 1,
                  "serve.decode": rec["decode_steps"] + 1}
    want = {"flash_fwd": L * want_spans["serve.prefill"],
            "flash_decode": L * want_spans["serve.decode"]}
    if any(spans.get(k, 0) != v for k, v in want_spans.items()) or any(
            launches[k] != v for k, v in want.items()) or any(plain.values()):
        fail(f"observed poisson: spans {dict(spans)} (want {want_spans}), "
             f"launches {launches} (want {want}), plain calls {plain}")
    out["poisson"] = dict({k: v for k, v in rec.items()
                           if k not in ("monitor",)},
                          breaches=len(breaches), spans=dict(spans),
                          launches=launches, wall_s=wall)
    return out


def train_observed(dev, tag, ref_rec):
    """Phase 4u, training: launch.train's run of phase 4b's arguments for
    OBS_TRAIN_STEPS steps with --slo-step-ms at 1.5 x 4b's mean step, a
    stall of OBS_TRAIN_STALL_MS after step 1's dispatch, the trace and the
    metrics file: the straggler event fires for step 1; the losses are
    4b's first OBS_TRAIN_STEPS bit for bit; the launches 4b's a step; the
    monitor observes every step; the files validate."""
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train

    cfg_name = "qwen2-1.5b"
    tmp = Path(tempfile.mkdtemp(prefix="obs4u-train-"))
    slo_ms = 1.5 * ref_rec["mean_step_s"] * 1e3
    n = OBS_TRAIN_STEPS
    argv = train_argv(cfg_name, n) + [
        "--slo-step-ms", f"{slo_ms:.1f}", "--inject-spike-ms",
        str(OBS_TRAIN_STALL_MS), "--inject-at", "1", "--inject-steps", "1",
        "--flight-dir", str(tmp / "flight"), "--trace-out",
        str(tmp / "t.trace.json"), "--metrics-out",
        str(tmp / "t.metrics.jsonl")]
    args = launch_train.build_argparser().parse_args(argv)
    torch.cuda.synchronize()
    fa.reset_launches()
    ops.reset_plain_calls()
    rec = launch_train.run(args)
    launches, plain = dict(fa.launches), dict(ops.plain_calls)
    L = get_arch(cfg_name).n_layers
    want = {"flash_fwd": 2 * L * TRAIN_MICRO * n, "flash_bwd_dq":
            L * TRAIN_MICRO * n, "flash_bwd_dkv": L * TRAIN_MICRO * n}
    trace = json.loads((tmp / "t.trace.json").read_text())
    spans = _spans(trace["traceEvents"])
    ref = ref_rec["losses"][:n]
    steps = [s["step"] for s in rec["stragglers"]]
    counts = {k: v["count"] for k, v in rec["monitor"]["signals"].items()}
    print(f"observed train: {n} steps of 4b's run, losses {rec['losses']} "
          f"(4b {ref}, bit-equal {rec['losses'] == ref}); stragglers "
          f"{rec['stragglers']} over {slo_ms:.1f} ms; monitor {counts}; "
          f"spans {dict(spans)}; launches {launches} (want {want}); mean "
          f"step {rec['mean_step_s'] * 1e3:.2f} ms with a sync a step (4b "
          f"{ref_rec['mean_step_s'] * 1e3:.2f} ms) {tag}")
    if rec["losses"] != ref:
        fail(f"observed train: losses {rec['losses']} are not 4b's {ref}")
    if 1 not in steps:
        fail(f"observed train: no straggler event for step 1 ({steps})")
    if any(launches[k] != v for k, v in want.items()) or any(plain.values()):
        fail(f"observed train: launches {launches}, want {want}, plain "
             f"{plain}")
    if counts != {"step": n, "data_wait": n, "sync": n} or any(
            spans.get(k, 0) != n for k in ("train.step", "train.sync",
                                           "train.data_wait")):
        fail(f"observed train: monitor {counts}, spans {dict(spans)}")
    _validate_files([tmp / "t.trace.json", tmp / "t.metrics.jsonl"]
                    + rec["monitor"]["flight_dumps"], "observed train")
    return dict(losses=rec["losses"], stragglers=rec["stragglers"],
                slo_ms=slo_ms, monitor=counts, spans=dict(spans),
                launches=launches, mean_step_s=rec["mean_step_s"],
                ref_mean_step_s=ref_rec["mean_step_s"]), launches


# 4v: the dry run (launch/dryrun.py) in a process of its own, where torch's
# fake process group can be the default group (this one holds NCCL's
# world-1 groups in turn): llama3.2-3b train_4k on the fake (16, 16) mesh,
# and phase 4b's cell on one device with no plan, whose predicted FLOPs,
# peak bytes and modeled step are printed beside 4b's measured ones.
# Ratios are printed, not gated: nothing is claimed of a speed.
DRYRUN_TIMEOUT_S = 240
DRYRUN_KEYS = {
    "arch", "shape", "mesh", "n_devices", "flops_per_dev",
    "hbm_bytes_per_dev", "wire_bytes_per_dev", "naive_collective_bytes",
    "collective_counts", "model_flops_total", "bytes_per_dev_peak",
    "t_compute", "t_memory", "t_collective", "t_step", "dominant",
    "useful_ratio", "roofline_fraction", "ideal_bytes_per_dev",
    "mem_efficiency", "status", "trace_s", "memory_analysis",
    "solver_bytes", "solver_per_axis", "probe_depths", "probe_flops"}


def dryrun_cells(tag, ref_rec):
    """Phase 4v (see DRYRUN_TIMEOUT_S): both records complete, finite and
    positive (the one-device cell has no collective), else fail."""
    import math
    import tempfile
    out = Path(tempfile.mkdtemp(prefix="dry4v-"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    cells = {
        "llama3.2-3b_train_4k_pod1": [
            "--arch", "llama3.2-3b", "--shape", "train_4k", "--mesh",
            "single"],
        f"qwen2-1.5b_train_{TRAIN_BATCH}x{TRAIN_SEQ}_one": [
            "--arch", "qwen2-1.5b", "--shape", "train_4k", "--mesh", "one",
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--microbatches", str(TRAIN_MICRO)]}
    recs = {}
    for key, argv in cells.items():
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
                 "--no-cache", "--out", str(out)], env=env, cwd=str(ROOT),
                capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"dry run {key}: over {DRYRUN_TIMEOUT_S} s")
        if proc.returncode != 0:
            fail(f"dry run {key}: exit {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        rec = json.loads((out / f"{key}.json").read_text())
        rec["wall_s"] = time.perf_counter() - t0
        if set(rec) - {"wall_s"} != DRYRUN_KEYS or rec["status"] != "ok":
            fail(f"dry run {key}: record keys {sorted(rec)}")
        positive = ["flops_per_dev", "hbm_bytes_per_dev", "bytes_per_dev_peak",
                    "t_compute", "t_memory", "t_step", "model_flops_total",
                    "useful_ratio", "trace_s"]
        if rec["n_devices"] > 1:
            positive += ["wire_bytes_per_dev", "t_collective"]
        bad = [k for k in positive if not (isinstance(rec[k], (int, float))
                                           and math.isfinite(rec[k])
                                           and rec[k] > 0)]
        if bad:
            fail(f"dry run {key}: not finite and positive: "
                 + str({k: rec[k] for k in bad}))
        print(f"dry run {key}: {rec['n_devices']} devices, "
              f"{rec['flops_per_dev']:.4e} FLOP, {rec['hbm_bytes_per_dev']:.4e} "
              f"HBM bytes, {rec['wire_bytes_per_dev']:.4e} wire bytes, peak "
              f"{rec['bytes_per_dev_peak'] / 2**30:.2f} GiB a device; "
              f"t_compute {rec['t_compute'] * 1e3:.2f} ms, t_memory "
              f"{rec['t_memory'] * 1e3:.2f} ms, t_collective "
              f"{rec['t_collective'] * 1e3:.2f} ms, t_step "
              f"{rec['t_step'] * 1e3:.2f} ms ({rec['dominant']}); trace "
              f"{rec['trace_s']:.2f} s, wall {rec['wall_s']:.1f} s")
        recs[key] = rec
    from repro_torch.configs import get_arch
    one = recs[f"qwen2-1.5b_train_{TRAIN_BATCH}x{TRAIN_SEQ}_one"]
    flops = train_flops(get_arch("qwen2-1.5b"), TRAIN_BATCH, TRAIN_SEQ)
    pairs = {
        "FLOPs a step": (one["flops_per_dev"], flops),
        "peak bytes": (one["bytes_per_dev_peak"],
                       float(ref_rec["peak_memory_bytes"])),
        "step s": (one["t_step"], ref_rec["mean_step_s"])}
    for what, (pred, meas) in pairs.items():
        print(f"dry run vs 4b, {what}: predicted {pred:.6g}, "
              f"{'model (train_flops)' if what == 'FLOPs a step' else 'measured'} "
              f"{meas:.6g}, ratio {pred / meas:.4f} {tag}")
    recs["vs_4b"] = {k: {"predicted": p, "measured": m, "ratio": p / m}
                     for k, (p, m) in pairs.items()}
    return recs


# 4w: conformance (repro_torch.verify).  The card legs run in a process of
# their own (``verify_legs``, on a world-1 NCCL group with a (1, 1) mesh);
# beside it, on the CPU, the CLI runs its 8 gloo ranks.  Plans are solved
# on the verification mesh's axes (verify/calibration.verify_axes) at
# beam VERIFY_BEAM: on the (1, 1) card mesh every cut is whole, so the
# plan's search depth moves no number, and the full-width train graph's
# solve at "auto" takes ~110 s on a CPU.
VERIFY_TIMEOUT_S = 300
VERIFY_BEAM = 32
VERIFY_FULL = "qwen2-1.5b"
VERIFY_CLI = ["--device", "cpu", "--cells", "dense-decode,xlstm-train",
              "--fuzz", "10", "--json", "--out", ""]
# the kernels each card leg must launch (a forward at an offset counted
# apart, "fwd@offset"); (b)'s nine cells are one leg: on the (1, 1) mesh
# every cut is whole, so serial and planned run the same kernels and each
# cell's gap is printed and gated, its launches summed with the others'
VERIFY_FULL_WANT = ("flash_fwd",)
VERIFY_CELLS_WANT = ("flash_fwd", "flash_decode", "ssd_chunk_scan")
VERIFY_PAGED_WANT = ("flash_fwd", "fwd@offset", "flash_decode",
                     "flash_paged_decode")
VERIFY_TRAIN_WANT = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# leg (d): the trace frontend on qwen2-1.5b's forward at this shape
# (one flash_fwd launch a layer, 28 layers), captured and solved at
# trace_cell.TRACE_BEAM
VERIFY_TRACE_SHAPE = (4, 1024)
VERIFY_TRACE_WANT = ("flash_fwd",)


def verify_legs(out_path):
    """Phase 4w's card legs, in a process of their own (see
    ``verify_cells``); writes {leg: record} to ``out_path``.  Each leg's
    record carries the launches of each kernel by the port's counters
    (reset before the leg), the forward's launches at an offset
    ("fwd@offset") and the plain versions' calls."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.builders import build_graph
    from repro_torch.core.plan import ShardingPlan
    from repro_torch.core.solver import solve_mesh
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ssd
    from repro_torch.launch.mesh import free_port, init_distributed, make_mesh
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.engine import EngineConfig, TrainEngine
    from repro_torch.verify import cells, numerics, serve_paged_cell
    from repro_torch.verify import train_cell
    from repro_torch.verify.calibration import verify_axes

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: phase 4w needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    build.load_library()
    dev = torch.device("cuda", 0)
    init_distributed("cuda", 0, 1, free_port())
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")

    def plan_for(cfg, shape, **kw):
        g = build_graph(cfg, shape, **kw)
        sol = solve_mesh(g, verify_axes(), beam=VERIFY_BEAM)
        return ShardingPlan.from_graph_solution(sol, g)

    legs = {}

    def leg(name, fn):
        fa.reset_launches()
        ssd.reset_launches()
        ops.reset_plain_calls()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = fn()
        torch.cuda.synchronize()
        rec["seconds"] = time.perf_counter() - t0
        launches = {**fa.launches, **ssd.launches,
                    "fwd@offset": fa.offset_launches["flash_fwd"]}
        rec["launches"] = {k: v for k, v in launches.items() if v}
        rec["plain_calls"] = {k: v for k, v in ops.plain_calls.items() if v}
        legs[name] = rec
        gc.collect()
        torch.cuda.empty_cache()

    # (a) qwen2-1.5b at full width and depth, at the two cells' shapes
    full = get_arch(VERIFY_FULL)
    full_params = LM(full).init(0, device=dev)
    for cname in ("dense-train", "gqa-prefill"):
        shape = cells.get_cells([cname])[0].shape()
        leg(f"a {cname}", lambda shape=shape: numerics.run_numerics(
            full, shape, plan_for(full, shape), mesh, params=full_params))
    # (b) the nine reduced cells, one leg
    def reduced_cells():
        recs = {spec.name: numerics.run_numerics(
            spec.cfg(), spec.shape(), plan_for(spec.cfg(), spec.shape()),
            mesh) for spec in cells.CELLS}
        return dict(cells=recs, ok=all(r["ok"] for r in recs.values()))
    leg("b cells", reduced_cells)
    # (c) serve-paged's one-device bit-equality leg, both families, and
    # train-engine's trajectory leg at (1, 1)
    for arch in serve_paged_cell.FAMILIES:
        leg(f"c serve-paged {arch}",
            lambda arch=arch: serve_paged_cell.bit_equal_leg(arch, dev))

    def trajectory():
        cfg = get_arch(train_cell.TRAIN_ARCH).reduced()
        shape = ShapeConfig("conf_train_engine", train_cell.SEQ,
                            train_cell.BATCH, "train")
        plan = plan_for(cfg, shape, master_fp32=True)
        ecfg = EngineConfig(optim=AdamWConfig(lr=2e-3, warmup_steps=2,
                                              total_steps=1000))
        ref, sh, _, _ = train_cell.trajectory(
            TrainEngine(LM(cfg), ecfg, device=dev),
            TrainEngine(LM(cfg, plan=plan, mesh=mesh), ecfg, device=dev,
                        mesh=mesh),
            DataConfig(seed=0, vocab=cfg.vocab, seq_len=train_cell.SEQ,
                       global_batch=train_cell.BATCH), train_cell.STEPS)
        d = max(abs(a - b) for a, b in zip(ref, sh))
        return dict(ref_losses=ref, sharded_losses=sh, max_abs_dloss=d,
                    tol=train_cell.TRAIN_LOSS_ATOL,
                    ok=bool(d < train_cell.TRAIN_LOSS_ATOL))
    leg("c train-engine", trajectory)
    leg("d trace", lambda: trace_leg(full, full_params, mesh, dev))
    del full_params
    import torch.distributed as dist
    dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(legs, indent=1, default=str))


def trace_leg(cfg, params, mesh, dev):
    """4w's leg (d): ``cfg``'s ``LM.forward`` at VERIFY_TRACE_SHAPE
    captured on meta tensors (``trace_cell.capture_forward``: no storage,
    the kernel counters as they were), solved on the verification axes at
    the trace cell's beam, and run by ``autoshard`` on ``mesh`` with
    ``params``, against the unplanned forward; then the MLP fixture's
    ``autoshard`` against its serial function."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.model import LM
    from repro_torch.trace import autoshard
    from repro_torch.trace.demo import mlp_fixture
    from repro_torch.verify import numerics, trace_cell
    from repro_torch.verify.calibration import verify_axes
    from repro_torch.verify.fuzz import EXEC_ATOL

    b, s = VERIFY_TRACE_SHAPE
    model = LM(cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, s))).to(dev)

    def fwd(p, t):
        return model.forward(p, t)[0]
    counters = [dict(c) for c in (ops.plain_calls, ops.bwd_recomputes,
                                  ops.plan_fallbacks, ops.all_to_all)]
    t0 = time.perf_counter()
    traced = trace_cell.capture_forward(cfg, b, s, params=params)
    capture_s = time.perf_counter() - t0
    kept = counters == [dict(c) for c in (
        ops.plain_calls, ops.bwd_recomputes, ops.plan_fallbacks,
        ops.all_to_all)]
    t0 = time.perf_counter()
    ash = autoshard(fwd, mesh, params, toks, weight_argnums=(0,),
                    axes=verify_axes(), beam=trace_cell.TRACE_BEAM,
                    traced=traced)
    solve_s = time.perf_counter() - t0
    g = traced.graph
    repeats = sorted({op.repeat for op in g.ops})
    before = fa.launches["flash_fwd"]
    with torch.no_grad():
        got = ash(params, toks).full_tensor()
        torch.cuda.synchronize()
        auto_launches = fa.launches["flash_fwd"] - before
        ref = fwd(params, toks)
    gap = float((got.float() - ref.float()).abs().max())
    bit = bool(torch.equal(got, ref))
    del got, ref
    mlp, args, wn = mlp_fixture(device=dev)
    ash_mlp = autoshard(mlp, mesh, *args, weight_argnums=wn, name="mlp")
    with torch.no_grad():
        want = mlp(*args)
        mlp_err = float((ash_mlp(*args).full_tensor() - want).abs().max())
    mlp_tol = EXEC_ATOL * max(1.0, float(want.abs().max()))
    ok = (kept and auto_launches == cfg.n_layers
          and gap <= numerics.LOGITS_ATOL and mlp_err <= mlp_tol)
    return dict(ops=len(g.ops), tensors=len(g.tensors), repeats=repeats,
                folds=traced.folds, unknown=traced.unknown_primitives,
                capture_s=capture_s, solve_s=solve_s,
                predicted_bytes=ash.predicted_bytes,
                counters_kept=kept, autoshard_flash_fwd=auto_launches,
                max_abs_err=gap, bit_equal=bit, tol=numerics.LOGITS_ATOL,
                mlp_max_abs_err=mlp_err, mlp_tol=mlp_tol, ok=bool(ok))


def _verify_gap(rec):
    """A numerics record's gap and band, as printed."""
    err = rec.get("abs_err", rec.get("max_abs_err"))
    return f"{err:.4e} (tol {rec['tol']}{'' if rec['ok'] else ', FAILED'})"


def start_verify():
    """Start phase 4w's two processes (``verify_cells``), to run beside
    phase 4v's dry run, which needs neither the card nor more than one
    core: the card legs (``verify_legs``) and ``python -m
    repro_torch.verify`` with VERIFY_CLI on 8 gloo ranks on this
    machine's CPU (the CLI imports no JAX).  Each writes its output to a
    file; both are killed at exit if still running."""
    import atexit
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="verify4w-"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + [p for p in [
            os.environ.get("PYTHONPATH")] if p]))
    jobs = dict(tmp=tmp, t0=time.perf_counter())
    for name, cmd in (
            ("cli", ["-m", "repro_torch.verify", *VERIFY_CLI]),
            ("legs", ["-c", "import chip_smoke; chip_smoke.verify_legs("
                      f"{str(tmp / 'legs.json')!r})"])):
        jobs[name] = subprocess.Popen(
            [sys.executable, *cmd], env=env, cwd=str(ROOT),
            stdout=open(tmp / f"{name}.out", "w"),
            stderr=open(tmp / f"{name}.err", "w"), text=True)
        atexit.register(jobs[name].kill)
    return jobs


def verify_cells(tag, jobs):
    """Phase 4w: the conformance cells (repro_torch.verify) on the card, in
    a process of its own (``verify_legs``), while ``python -m
    repro_torch.verify`` with VERIFY_CLI runs its 8 gloo ranks on this
    machine's CPU; both started by ``start_verify`` and done within
    VERIFY_TIMEOUT_S of it.  The
    legs: (a) the dense-train and gqa-prefill cells at VERIFY_FULL's full
    width and depth, serial against planned on the (1, 1) mesh, at
    LOSS_ATOL / LOGITS_ATOL; (b) the nine reduced cells' numerics the same
    way, one leg; (c) serve-paged's one-device bit-equality leg for both
    families and train-engine's trajectory leg.  Every leg's gate (and
    each of (b)'s cells') must hold, no plain call may run, each leg must
    launch what VERIFY_FULL_WANT / VERIFY_CELLS_WANT / VERIFY_PAGED_WANT /
    VERIFY_TRAIN_WANT says, and the legs together all
    seven kernels (the forward at an offset and not); the CLI's "pass"
    must be true.  Returns (the record, the launches summed over the
    legs)."""
    tmp, t0 = jobs["tmp"], jobs["t0"]
    done = {}
    for name in ("legs", "cli"):
        left = VERIFY_TIMEOUT_S - (time.perf_counter() - t0)
        try:
            jobs[name].wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            fail(f"phase 4w: over {VERIFY_TIMEOUT_S} s")
        done[name] = time.perf_counter() - t0
    legs_s, cli_s = done["legs"], done["cli"]
    cli_out = (tmp / "cli.out").read_text()
    cli_err = (tmp / "cli.err").read_text()
    cli = jobs["cli"]
    if jobs["legs"].returncode != 0:
        fail(f"phase 4w card legs: exit {jobs['legs'].returncode}: "
             f"{(tmp / 'legs.err').read_text()[-3000:]}")
    out = tmp / "legs.json"
    legs = json.loads(out.read_text())
    bad = []
    for name, rec in legs.items():
        kind = name.split(" ")[0]
        if kind == "c" and "serve-paged" in name:
            want, ok = VERIFY_PAGED_WANT, rec["bit_equal"]
            gap = (f"bit_equal {rec['bit_equal']}, dispatches "
                   f"{rec['decode_dispatches']}, re-scores "
                   f"{rec['verify_dispatches']}")
        elif kind == "c":
            want, ok = VERIFY_TRAIN_WANT, rec["ok"]
            gap = (f"max |dloss| {rec['max_abs_dloss']:.3e} over "
                   f"{len(rec['ref_losses'])} steps (tol {rec['tol']})")
        elif kind == "d":
            want, ok = VERIFY_TRACE_WANT, rec["ok"]
            gap = (f"{rec['ops']} ops (repeats {rec['repeats']}, folds "
                   f"{rec['folds']}), capture {rec['capture_s']:.1f} s, "
                   f"solve {rec['solve_s']:.1f} s, predicted "
                   f"{rec['predicted_bytes']:.4g} B; counters kept "
                   f"{rec['counters_kept']}; autoshard flash_fwd "
                   f"{rec['autoshard_flash_fwd']} (one a layer); logits gap "
                   f"{_verify_gap(rec)}, bit-equal {rec['bit_equal']}; MLP "
                   f"{rec['mlp_max_abs_err']:.3e} (tol "
                   f"{rec['mlp_tol']:.3e})")
        elif kind == "b":
            want, ok = VERIFY_CELLS_WANT, rec["ok"]
            gap = "gaps " + ", ".join(
                f"{c} {_verify_gap(r)}" for c, r in rec["cells"].items())
        else:
            want, ok = VERIFY_FULL_WANT, rec["ok"]
            gap = f"gap {_verify_gap(rec)}"
        missing = [k for k in want if not rec["launches"].get(k)]
        print(f"4w {name}: {gap}; launches {rec['launches']}; "
              f"{rec['seconds']:.1f} s {tag}")
        if not ok or missing or rec["plain_calls"]:
            bad.append(f"{name}: ok {ok}, missing launches {missing}, "
                       f"plain calls {rec['plain_calls']}")
    launches = {}
    for rec in legs.values():
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
    seven = ("flash_fwd", "fwd@offset", "flash_decode", "flash_paged_decode",
             "flash_bwd_dq", "flash_bwd_dkv", "ssd_chunk_scan")
    print(f"4w launches over the legs: {launches} (the card legs done "
          f"{legs_s:.1f} s after their start) {tag}")
    if any(not launches.get(k) for k in seven):
        bad.append(f"the legs together launch {launches}, want all of "
                   f"{seven}")
    try:
        report = json.loads(cli_out)
    except json.JSONDecodeError:
        report = {"pass": False}
    if "cells" in report:
        print(f"4w verify CLI (--device cpu, 8 gloo ranks): exit "
              f"{cli.returncode}, pass {report['pass']}, cells "
              f"{[(c['cell'], c['status']) for c in report['cells']]}, "
              f"fuzz {report['fuzz']['n']} graphs ok {report['fuzz']['ok']}"
              f" {report['fuzz']['failures'][:2]}, done {cli_s:.1f} s "
              f"after its start")
    if "fuzz" in report:
        print(f"4w verify CLI fuzz: trace round trips "
              f"{report['fuzz']['trace_checked']}, autoshard runs "
              f"{report['fuzz']['trace_exec_checked']}")
        if not report["fuzz"]["trace_checked"] > 0:
            bad.append("verify CLI: the fuzz ran no trace round trip")
    if cli.returncode != 0 or report["pass"] is not True:
        # the ranks' lines without torch's warnings
        err = [ln for ln in cli_err.splitlines()
               if "]:W" not in ln and "Warning" not in ln
               and not ln.startswith("[W")]
        bad.append(f"verify CLI: exit {cli.returncode}, pass "
                   f"{report['pass']}: " + "\n".join(err[-30:]))
    if bad:
        fail("phase 4w: " + "; ".join(bad))
    launches.pop("fwd@offset")
    return dict(legs=legs, cli=report, legs_s=legs_s, cli_s=cli_s), launches


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the full record as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one admission and 8 decode steps on "
                         "each tier, and 2 full-width training steps "
                         "(torch.profiler)")
    args = ap.parse_args()

    t_start = time.perf_counter()
    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    # the port must import before anything is printed
    from repro_torch.kernels import build
    smi = nvidia_smi_line()
    print(smi)
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    tag = f"[{smi}]"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    print(f"build: {lib} in {time.perf_counter() - t0:.1f}s "
          f"(cached={build.build_info.get('cached')})")
    for ln in build.build_info.get("ptxas", []):
        print(f"  {ln}")
    hgmma = hgmma_counts(lib)
    for fn, n in sorted(hgmma.items()):
        print(f"  HGMMA {n:3d} {fn}")
    # one instance per head dim (attention), one (the SSD scan)
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    for kern in WGMMA_KERNELS:
        found = [n for fn, n in hgmma.items() if kern in fn]
        want = 1 if kern.startswith("ssd_") else len(HEAD_DIMS)
        if len(found) != want or min(found) == 0:
            fail(f"{kern}: {len(found)} instances, want {want}, "
                 f"each with HGMMA in its SASS ({found})")
    # the hd-120 instances (danube): HGMMA in the three on wgmma, and
    # ptxas's lines (registers, spills) of every one
    for kern in WGMMA_KERNELS[:3]:
        n120 = [n for fn, n in hgmma.items() if f"{kern}ILi120E" in fn]
        if n120 != [n120[0]] or n120[0] == 0:
            fail(f"{kern}'s hd-120 instance has no HGMMA ({n120})")
        print(f"hd 120: {kern} {n120[0]} HGMMA")
    ptxas = build.build_info.get("ptxas", [])
    for i, ln in enumerate(ptxas):
        if "Compiling" in ln and "ILi120E" in ln:
            print(f"hd 120 ptxas: {ln.split(chr(39))[1]}: "
                  + " | ".join(ptxas[i + 1:i + 3]))

    # 3. kernel vs plain
    timer = Timer(dev)
    checks = check_kernels(dev, tag)

    # 4. serve at full width, then the reduced model against the CPU
    serve_rec, serve_launches, base = serve_full_width(dev, tag, args.profile)
    # 4c. the paged tier on the same weights, held to phase 4's streams
    paged_rec, paged_launches = serve_paged(
        base, serve_rec["decode_dispatches"], dev, tag)
    # 4u (serving). the same weights served observed, then launch.serve
    # with Poisson arrivals, an ITL SLO and injected stalls
    t_4u = time.perf_counter()
    obs_serve = serve_observed(base, dev, tag)
    gc.collect()
    torch.cuda.empty_cache()
    phase_4u_s = time.perf_counter() - t_4u
    print(f"phase 4u (serving) done at {time.perf_counter() - t_start:.1f}s")
    # 4e. the same workload under the solved (1, 1) plan on a DeviceMesh
    # of a world-1 NCCL group, which stays up until phase 4i is done
    import torch.distributed as dist

    from repro_torch.launch.mesh import (free_port, init_distributed,
                                         make_mesh)
    init_distributed("cuda", 0, 1, free_port())
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    plan_rec, plan_launches, plan = serve_plan(base, serve_launches, dev,
                                               tag, mesh)
    print(f"phase 4e done at {time.perf_counter() - t_start:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    reduced_err = reduced_card_vs_cpu(dev, tag)

    # 4f. h2o-danube-3-4b (hd 120, the ring cache, the scan prefill) served
    # at full width, then the reduced danube against the CPU past its window
    danube_rec, danube_launches = serve_danube(dev, tag, args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    danube_reduced = reduced_scan_card_vs_cpu(dev, tag)
    print(f"phase 4f done at {time.perf_counter() - t_start:.1f}s")

    # 4i. 4c's P1 and P2, the paged fallback route and danube's scan
    # prefill under the solved (1, 1) plans, on 4e's group and mesh
    t_4i = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    paged_plan_rec, paged_plan_launches = serve_paged_plan(
        base, paged_rec, plan, mesh, dev, tag)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    danube_plan_rec, danube_plan_launches = serve_danube_plan(dev, tag, mesh)
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    phase_4i_s = time.perf_counter() - t_4i
    print(f"phase 4i: {phase_4i_s:.1f} s, peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB {tag}")
    print(f"phase 4i done at {time.perf_counter() - t_start:.1f}s")

    # 4b. train at full width, then the reduced model against the CPU
    train_rec, train_launches = train_full_width(dev, tag)
    gc.collect()
    torch.cuda.empty_cache()
    # 4u (training). 4b's run observed, with a stall
    t_4u = time.perf_counter()
    obs_train, obs_train_launches = train_observed(dev, tag, train_rec)
    gc.collect()
    torch.cuda.empty_cache()
    phase_4u_s += time.perf_counter() - t_4u
    print(f"phase 4u: {phase_4u_s:.1f} s {tag}")
    print(f"phase 4u done at {time.perf_counter() - t_start:.1f}s")
    # 4v. the dry run in a process of its own: a production cell on the
    # fake (16, 16) mesh, and 4b's cell on one device beside 4b's numbers
    # 4w. conformance: the cells' numerics on the card in a process of
    # their own, the verify CLI on this machine's CPU beside it; both
    # start with 4v
    t_4v = time.perf_counter()
    verify_jobs = start_verify()
    dry = dryrun_cells(tag, train_rec)
    print(f"phase 4v: {time.perf_counter() - t_4v:.1f} s (4w beside it); "
          f"done at {time.perf_counter() - t_start:.1f}s")
    t_4w = time.perf_counter()
    verify_rec, verify_launches = verify_cells(tag, verify_jobs)
    phase_4w_s = time.perf_counter() - t_4w
    print(f"phase 4w: {phase_4w_s:.1f} s after 4v; done at "
          f"{time.perf_counter() - t_start:.1f}s")
    if args.profile:
        train_rec["profile"] = profile_train(dev, tag)
        gc.collect()
        torch.cuda.empty_cache()
    reduced_train = reduced_train_card_vs_cpu(dev, tag)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phases 1-4b done at {time.perf_counter() - t_start:.1f}s")

    # 4h. phase 4b's run under the solved (1, 1) train plan
    train_plan_rec, train_plan_launches = train_plan(dev, tag, train_rec,
                                                     args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 4h done at {time.perf_counter() - t_start:.1f}s")

    # 4d. the hybrid family: zamba2-2.7b training at full width, then the
    # reduced zamba2 against the CPU
    hybrid_rec, hybrid_launches = train_hybrid_full_width(dev, tag)
    gc.collect()
    torch.cuda.empty_cache()
    if args.profile:
        hybrid_rec["profile"] = profile_train(dev, tag, HYBRID_ARCH)
        gc.collect()
        torch.cuda.empty_cache()
    hybrid_reduced = reduced_grads_card_vs_cpu(dev, tag, HYBRID_ARCH)[:3]
    print(f"phase 4d done at {time.perf_counter() - t_start:.1f}s")

    # 4g. danube trained at full width, cut in depth, then the reduced
    # danube's loss and grads against the CPU
    danube_train, danube_train_launches = train_full_width(
        dev, tag, DANUBE, DANUBE_STEPS, DANUBE_TRAIN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    if args.profile:
        from repro_torch.configs import get_arch
        danube_train["profile"] = profile_train(
            dev, tag, DANUBE, dataclasses.replace(
                get_arch(DANUBE), n_layers=DANUBE_TRAIN_LAYERS))
        gc.collect()
        torch.cuda.empty_cache()
    danube_train_reduced = reduced_grads_card_vs_cpu(dev, tag, DANUBE)[:3]
    print(f"phase 4g done at {time.perf_counter() - t_start:.1f}s")

    # 4j. zamba2-2.7b served at full width (the scan prefill, each Mamba
    # layer's decode step, the shared block's ring), then the reduced
    # zamba2 against the CPU
    hybrid_serve, hybrid_serve_launches, hybrid_base = serve_hybrid(
        dev, tag, args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 4j done at {time.perf_counter() - t_start:.1f}s")

    # 4k. the hybrid family under the solved (1, 1) plans, on a world-1
    # NCCL group of its own: 4j's first requests, then 4d's training
    t_4k = time.perf_counter()
    init_distributed("cuda", 0, 1, free_port())
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    hybrid_plan_serve, hybrid_plan_serve_launches = serve_hybrid_plan(
        hybrid_base, dev, tag, mesh)
    del hybrid_base
    gc.collect()
    torch.cuda.empty_cache()
    hybrid_plan_train, hybrid_plan_train_launches = train_hybrid_plan(
        dev, tag, hybrid_rec, mesh, args.profile)
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    phase_4k_s = time.perf_counter() - t_4k
    print(f"phase 4k: {phase_4k_s:.1f} s, peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB {tag}")
    print(f"phase 4k done at {time.perf_counter() - t_start:.1f}s")

    # 4l. the MoE family: moonshot-v1-16b-a3b served at full width on both
    # tiers, then the reduced moonshot against the CPU
    t_moe = time.perf_counter()
    moe_serve, moe_serve_launches, moe_base = serve_moe(dev, tag)
    moe_reduced = reduced_moe_card_vs_cpu(dev, tag)
    print(f"phase 4l done at {time.perf_counter() - t_start:.1f}s")

    # 4m. on a world-1 NCCL group of its own: 4l's first requests under the
    # solved (1, 1) decode plan, then moonshot cut in depth trained, and
    # the same run under the (1, 1) train plan
    init_distributed("cuda", 0, 1, free_port())
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    moe_plan_serve, moe_plan_serve_launches = serve_moe_plan(moe_base, dev,
                                                             tag, mesh)
    del moe_base
    gc.collect()
    torch.cuda.empty_cache()
    moe_train, moe_train_launches = train_moe(dev, tag)
    gc.collect()
    torch.cuda.empty_cache()
    moe_train_plan, moe_train_plan_launches = train_moe_plan(dev, tag,
                                                             moe_train)
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 4m done at {time.perf_counter() - t_start:.1f}s")

    # 4n. qwen2.5-32b served at full width, every earlier tensor freed
    qwen32_rec, qwen32_launches = serve_qwen32(dev, tag)
    gc.collect()
    torch.cuda.empty_cache()
    phase_moe_s = time.perf_counter() - t_moe
    print(f"phases 4l-4n: {phase_moe_s:.1f} s {tag}")
    print(f"phase 4n done at {time.perf_counter() - t_start:.1f}s")

    # 4o / 4p. the SSM family: xlstm-125m served at full width, then trained
    # at full width, each again under its solved (1, 1) plan on a world-1
    # NCCL group of its own; 4q. the pure-Mamba branch (a test-built
    # config) trained a step and decoded
    t_ssm = time.perf_counter()
    xlstm_serve, xlstm_serve_launches, xlstm_base = serve_xlstm(dev, tag)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 4o (unplanned) done at {time.perf_counter() - t_start:.1f}s")
    xlstm_train, xlstm_train_launches = train_xlstm(dev, tag,
                                                    profile=args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 4p (unplanned) done at {time.perf_counter() - t_start:.1f}s")
    init_distributed("cuda", 0, 1, free_port())
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    xlstm_plan_serve, xlstm_plan_serve_launches = serve_xlstm_plan(
        xlstm_base, dev, tag, mesh)
    del xlstm_base
    gc.collect()
    torch.cuda.empty_cache()
    xlstm_plan_train, xlstm_plan_train_launches = train_xlstm(
        dev, tag, xlstm_train)
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phases 4o-4p done at {time.perf_counter() - t_start:.1f}s")
    ssm_rec, ssm_launches = ssm_branch(dev, tag)
    gc.collect()
    torch.cuda.empty_cache()
    phase_ssm_s = time.perf_counter() - t_ssm
    print(f"phases 4o-4q: {phase_ssm_s:.1f} s {tag}")
    print(f"phase 4q done at {time.perf_counter() - t_start:.1f}s")

    # 4r / 4s. the embedding-stub backbones: musicgen-large at full width
    # and depth, served on both tiers, one decode step fed [B, D] embeds,
    # trained from audio frame embeds; internvl2-76b at full width cut in
    # depth, served and trained from vision patch embeds; each serving and
    # training run again under its solved (1, 1) plan on a world-1 NCCL
    # group of its own; then the reduced configs against the CPU
    t_stub = time.perf_counter()
    mg_serve, mg_serve_launches, mg_base = serve_stub(dev, tag, MUSICGEN)
    mg_serve["embeds_step"] = stub_embeds_step(mg_base[0], mg_base[1], dev,
                                               tag)
    init_distributed("cuda", 0, 1, free_port())
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    mg_plan_serve, mg_plan_serve_launches = serve_stub_plan(mg_base, dev,
                                                            tag, mesh)
    del mg_base
    gc.collect()
    torch.cuda.empty_cache()
    mg_train, mg_train_launches = train_stub(dev, tag, MUSICGEN, None,
                                             MUSICGEN_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    mg_plan_train, mg_plan_train_launches = train_stub(
        dev, tag, MUSICGEN, None, MUSICGEN_STEPS, mesh, mg_train)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 4r done at {time.perf_counter() - t_start:.1f}s")
    iv_serve, iv_serve_launches, iv_base = serve_stub(
        dev, tag, INTERNVL, INTERNVL_SERVE_LAYERS, INTERNVL_REQUESTS,
        INTERNVL_GEN, ("linear",))
    iv_plan_serve, iv_plan_serve_launches = serve_stub_plan(iv_base, dev,
                                                            tag, mesh)
    del iv_base
    gc.collect()
    torch.cuda.empty_cache()
    iv_train, iv_train_launches = train_stub(
        dev, tag, INTERNVL, INTERNVL_TRAIN_LAYERS, INTERNVL_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    iv_plan_train, iv_plan_train_launches = train_stub(
        dev, tag, INTERNVL, INTERNVL_TRAIN_LAYERS, INTERNVL_STEPS, mesh,
        iv_train)
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    stub_reduced = {a: reduced_stub_card_vs_cpu(dev, tag, a)
                    for a in (MUSICGEN, INTERNVL)}
    print(f"phase 4s done at {time.perf_counter() - t_start:.1f}s")
    # 4t. the pipeline runner at S = 1, bit-equal to the engine
    pipe_rec, pipe_launches = pipeline_s1(dev, tag)
    gc.collect()
    torch.cuda.empty_cache()
    phase_stub_s = time.perf_counter() - t_stub
    print(f"phases 4r-4t: {phase_stub_s:.1f} s {tag}")
    print(f"phase 4t done at {time.perf_counter() - t_start:.1f}s")

    # 5. times
    times = time_kernels(dev, tag, timer, hybrid_serve["lengths"])
    print(f"phase 5 done at {time.perf_counter() - t_start:.1f}s")

    # 6. the kernels line: launches are those of the main paths (linear
    # serving, the four paged runs, serving under the plan, the paged runs
    # under the plan, training, training under the plan, hybrid training,
    # hybrid serving, the hybrid family's serving and training under the
    # plan, the MoE family's serving on both tiers and under the plan, its
    # training and training under the plan, qwen2.5-32b's serving, the
    # SSM family's: xlstm-125m served and trained, each with and without
    # its plan (no kernel launches), the pure-Mamba branch's training step
    # and decode steps; the embedding-stub backbones': musicgen-large
    # served on both tiers and trained, internvl2-76b served and trained,
    # each with and without its plan; the pipeline runner's S = 1 runs;
    # the observed engines': both tiers, launch.serve with Poisson
    # arrivals, launch.train with the monitor)
    fa_py = "src/repro/kernels/flash_attention.py"
    replaces = {"flash_fwd": f"{fa_py}:146 and {fa_py}:191",
                "flash_decode": f"{fa_py}:280",
                "flash_paged_decode": f"{fa_py}:378",
                "flash_bwd_dq": f"{fa_py}:491",
                "flash_bwd_dkv": f"{fa_py}:519",
                "ssd_chunk_scan": "src/repro/kernels/ssd.py:73"}
    csrc = "src/repro_torch/kernels/csrc"
    sources = {"flash_fwd": f"{csrc}/flash_fwd.cu",
               "flash_decode": f"{csrc}/flash_decode.cu",
               "flash_paged_decode": f"{csrc}/flash_paged_decode.cu",
               "flash_bwd_dq": f"{csrc}/flash_bwd.cu",
               "flash_bwd_dkv": f"{csrc}/flash_bwd.cu",
               "ssd_chunk_scan": f"{csrc}/ssd_scan.cu"}
    # the hd-120 instances (danube's) have entries of their own: launches
    # from phases 4f and 4g, errors from phase 3's hd-120 cases, times from
    # phase 5's hd-120 rows; the other entries keep the other runs and hd
    runs = (serve_launches, paged_launches, plan_launches,
            paged_plan_launches, train_launches, train_plan_launches,
            hybrid_launches, hybrid_serve_launches,
            hybrid_plan_serve_launches, hybrid_plan_train_launches,
            moe_serve_launches["linear"], moe_serve_launches["paged"],
            moe_plan_serve_launches, moe_train_launches,
            moe_train_plan_launches, qwen32_launches, xlstm_serve_launches,
            xlstm_plan_serve_launches, xlstm_train_launches,
            xlstm_plan_train_launches, ssm_launches,
            mg_serve_launches["linear"], mg_serve_launches["paged"],
            mg_plan_serve_launches, mg_train_launches,
            mg_plan_train_launches, iv_serve_launches["linear"],
            iv_plan_serve_launches, iv_train_launches,
            iv_plan_train_launches, pipe_launches,
            obs_serve["linear"]["launches"], obs_serve["paged"]["launches"],
            obs_serve["poisson"]["launches"], obs_train_launches,
            verify_launches)
    runs120 = (danube_launches, danube_plan_launches, danube_train_launches)
    kernels = []
    for k, hd120 in [(k, False) for k in replaces] + [
            (k, True) for k in ("flash_fwd", "flash_decode", "flash_bwd_dq",
                                "flash_bwd_dkv")]:
        t = times[f"{k} {HD120}" if hd120 else k]
        kernels.append({
            "name": f"{k} {HD120}" if hd120 else k, "route": "cuda",
            "source": sources[k], "replaces": replaces[k],
            "launches": sum(run.get(k, 0)
                            for run in (runs120 if hd120 else runs)),
            "max_abs_err": max(r["max_abs_err"] for r in checks[k]
                               if (r.get("hd") == 120) == hd120),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            device=name, nvidia_smi=smi, torch=torch.__version__,
            build=build.build_info, hgmma=hgmma, checks=checks, times=times,
            serve=serve_rec, paged=paged_rec, plan=plan_rec,
            paged_plan=paged_plan_rec, danube_plan=danube_plan_rec,
            phase_4i_s=phase_4i_s,
            reduced_card_vs_cpu=reduced_err,
            train=train_rec, reduced_train_card_vs_cpu=reduced_train,
            train_plan=train_plan_rec,
            hybrid_train=hybrid_rec,
            reduced_hybrid_card_vs_cpu=hybrid_reduced,
            danube_serve=danube_rec, reduced_danube_card_vs_cpu=danube_reduced,
            danube_train=danube_train,
            reduced_danube_train_card_vs_cpu=danube_train_reduced,
            hybrid_serve=hybrid_serve, hybrid_plan_serve=hybrid_plan_serve,
            hybrid_plan_train=hybrid_plan_train, phase_4k_s=phase_4k_s,
            moe_serve=moe_serve, reduced_moe_card_vs_cpu=moe_reduced,
            moe_plan_serve=moe_plan_serve, moe_train=moe_train,
            moe_train_plan=moe_train_plan, qwen32_serve=qwen32_rec,
            phase_moe_s=phase_moe_s, xlstm_serve=xlstm_serve,
            xlstm_plan_serve=xlstm_plan_serve, xlstm_train=xlstm_train,
            xlstm_plan_train=xlstm_plan_train, ssm_branch=ssm_rec,
            phase_ssm_s=phase_ssm_s, musicgen_serve=mg_serve,
            musicgen_plan_serve=mg_plan_serve, musicgen_train=mg_train,
            musicgen_plan_train=mg_plan_train, internvl_serve=iv_serve,
            internvl_plan_serve=iv_plan_serve, internvl_train=iv_train,
            internvl_plan_train=iv_plan_train,
            reduced_stub_card_vs_cpu=stub_reduced, pipeline_s1=pipe_rec,
            observed_serve=obs_serve, observed_train=obs_train,
            phase_4u_s=phase_4u_s, dryrun=dry, verify=verify_rec,
            phase_4w_s=phase_4w_s,
            phase_stub_s=phase_stub_s, kernels=kernels), indent=1,
            default=str))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
