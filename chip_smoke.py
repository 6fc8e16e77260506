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
     queries; one paged case) and at the reduced configs' hd 16;
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
     for token.  P3, 32 slots on 2049 blocks (phase 4's cache bytes), 64
     requests sharing a 512-token prefix: at least 63 x 512 prompt tokens
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
     two solved only); phase 4's workload on phase 4's weights under the
     (1, 1) plan (params and cache as DTensors, attention through
     local_map): phase 4's streams token for token, flash_fwd and
     flash_decode launched as often as in phase 4, no plan fallback, no
     plain call, no non-finite logit; a decode step's host and device ms
     with and without the plan; then the gathered route (the cache's cut
     on seq_kv, which has no local-shard rule) on 4 requests: the
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
     cell (4 x 1024, f32 master state in the graph) for it, and for the
     (4, 2) and (2, 4) meshes (solved only, printed: which roles cut the
     moments, the master and the weights); phase 4b's run with --mesh 1x1
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
     of 2048 positions), 8 requests of 128-512 prompt tokens, 32 greedy
     tokens each, through launch.serve.run_workload; every prompt token is
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
     plan; then the pool's cut moved to blocks on 4 requests: every
     paged call gathered, counted in plan_fallbacks, its kernel launched,
     the unplanned streams; then danube at full width under its solved
     (1, 1) decode plan and with no plan, 2 requests of 128 tokens and
     32 greedy tokens on 8 slots x 2048 through the scan prefill: equal
     streams, flash_decode exactly 24 x (decode dispatches + prompt
     tokens) on both, flash_fwd never; the reduced danube under the plan
     against the CPU past its window; the phase's seconds and peak
     memory; the group is torn down after;
  4d. hybrid train: zamba2-2.7b at full width (54 Mamba2 layers, d 2560,
     80 SSM heads of P 64 / N 64, chunk 256; the shared attention+MLP
     block, 32 heads of hd 80, after every 6 layers), f32 master weights,
     global batch 4 x 1024 in 2 microbatches, AdamW lr 3e-4 with 2 warmup
     steps, 8 steps through launch.train's runner; every loss finite, the
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
     shapes (hd 120);
  6. the kernels line (the hd-120 instances as entries of their own) and
     the contract's last line.
With --profile, also torch.profiler over one admission and 8 decode
steps on each tier, and 2 full-width training steps of each model.
Imports nothing of JAX and nothing of the repro (JAX) package.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
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
# given for (1, 1), and the meshes whose plans are printed
TRAIN_PLAN_LOSS_REL = 1e-3
TRAIN_PLAN_SHAPE = ("train4x1024", 1024, 4, "train")
TRAIN_PLAN_MESHES = ((4, 2), (2, 4))      # solved only, printed
# host and device ms a step, with and without the plan: steps timed after
# one warm step (host: each step()'s enqueue; wall: the steps ended by a
# sync), and steps under torch.profiler (device: its kernels' time)
STEP_TIMED, STEP_PROFILED = 3, 2
# the hybrid (zamba2-2.7b) run: 8 steps of the same batch, 2 of them warmup
HYBRID_ARCH, HYBRID_STEPS = "zamba2-2.7b", 8
# h2o-danube-3-4b (hd 120, window 4096): served at full width, 8 slots x
# 2048 (a ring of min(2048, 4096) positions), 8 requests of 128-512
# prompt tokens (each a batch-1 scan step), 32 greedy tokens each; trained
# at full width cut to 12 of its 24 layers (full depth holds ~71 GB of
# params, master weights, moments and grads before activations), 8 steps
# of the dense run's batch, 2 of them warmup
DANUBE = "h2o-danube-3-4b"
DANUBE_SLOTS, DANUBE_MAX_LEN, DANUBE_REQUESTS = 8, 2048, 8
DANUBE_PROMPT, DANUBE_GEN = (128, 512), 32
DANUBE_TRAIN_LAYERS, DANUBE_STEPS = 12, 8
HD120 = "(hd 120, danube)"     # the suffix of its rows in phase 5 and 6
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
             (DANUBE_SLOTS, DANUBE_MAX_LEN, 32, 8, 120, 4096, None, "f32")]
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
             (4, 32, 8, 120, 16, 8, [5, 128, 0, 77])]     # hd 120
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


def time_kernels(dev, tag, timer):
    """Times at the main paths' shapes: a 256-row prefill chunk at offset
    768 against a 2048-slot cache (row 2) and a 16-slot decode step (row
    3) of serving; the forward without an offset (row 1) and the two
    backward kernels (rows 5, 6) at the training shape, q [4,1024,12,128]
    against kv [4,1024,2,128], causal, and at zamba2's microbatch through
    its shared block, [2,1024,32,80] (g 1); the SSD scan (row 7) at the
    hybrid training shape; the forward and backward at danube's training
    microbatch, q [2,1024,32,120] against kv [2,1024,8,120], and its decode
    step, q [8,32,120] against [8,2048,8,120] (hd 120)."""
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


def time_decode(dev, timer, rnd, h, kv, hd, b=16, paged=True):
    """Row 3: a ``b``-slot decode step of serving against 2048-slot caches
    (lengths drawn from default_rng(0)); row 4 (``paged``): the paged
    kernel on the same lengths."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    scale = hd ** -0.5
    s = 2048
    q, kc, vc = rnd((b, h, hd)), rnd((b, s, kv, hd)), rnd((b, s, kv, hd))
    ln = np.random.default_rng(0).integers(1, s + 1, size=b)
    ln[0], ln[-1] = 1, s
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
P3_PREFIX, P3_REQUESTS = 512, 64


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
    streams.  P3: 32 slots on 2049 blocks (phase 4's cache bytes), 64
    requests sharing a 512-token system prefix, once with the prefix
    cache and once without; equal streams, and the 63 later requests
    re-link the prefix."""
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
PLAN_MESHES = ((1, 1), (4, 2), (2, 4))
PLAN_STEPS = 8          # decode steps timed with and without the plan
# the gathered route: requests, prompt tokens and tokens generated each
FALLBACK_REQS, FALLBACK_PROMPT, FALLBACK_GEN = 4, 600, 8


def decode_step_times(srv, n, tag, label):
    """Host and device ms of ``n`` decode steps of a full pool: the host
    ms is the wall time of the ``LM.decode_step`` call (its enqueue; the
    step reads nothing back), the wall ms that of ``n`` steps ended by a
    device sync, and the device ms the kernels' device time per step
    under torch.profiler (a separate run of ``n`` steps)."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType

    tokens = torch.as_tensor(srv.next_tok, device=srv.device)
    active = torch.as_tensor(srv.active, device=srv.device)

    def step():
        srv.model.decode_step(srv.params, srv.cache, tokens, active)

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
    print(f"plan: decode step {label}: host {rec['host_ms']:.3f} ms, wall "
          f"{wall_ms:.3f} ms (n {n}, synced at the end), device "
          f"{dev_ms:.3f} ms (profiler) {tag}")
    return rec


def serve_plan(base, lin_launches, dev, tag, mesh):
    """Phase 4e: phase 4's workload on phase 4's weights under the solved
    (1, 1) decode plan, on the world-1 NCCL group and the (1, 1)
    DeviceMesh ``mesh``.  The streams must be phase 4's token for token,
    flash_fwd and flash_decode must launch as often as in phase 4, no
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
    fa.reset_launches()
    ops.reset_plain_calls()
    rec = run_workload(srv, [(0.0, p) for p in prompts], gen=32)
    launches = dict(fa.launches)
    plain, fallbacks = dict(ops.plain_calls), dict(ops.plan_fallbacks)
    streams = {r: list(t) for r, t in srv.outputs.items()}
    print(f"plan: {rec['requests']} requests, {srv.prefill_dispatches} "
          f"prefill dispatches, {srv.decode_dispatches} decode dispatches; "
          f"launches {launches}, plain calls {plain}, plan fallbacks "
          f"{fallbacks}")
    for k in ("flash_fwd", "flash_decode"):
        if launches[k] != lin_launches[k]:
            fail(f"plan: {k} launched {launches[k]} times, phase 4 "
                 f"{lin_launches[k]}")
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
    if streams != lin_streams:
        bad = [r for r in lin_streams if streams.get(r) != lin_streams[r]]
        fail(f"plan: streams differ from phase 4's for requests {bad}")
    ms = 1e3
    print(f"plan metrics: prefill {rec['prefill_tok_per_s']:.1f} tok/s, "
          f"decode {rec['decode_tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{rec['ttft_p50_s'] * ms:.1f} ms, ITL p50 "
          f"{rec['itl_p50_s'] * ms:.2f} ms, wall {rec['wall_s']:.2f} s "
          f"{tag}")
    print(f"plan: the (1, 1) plan's streams equal phase 4's token for "
          f"token; launches equal phase 4's; 0 fallbacks, 0 plain calls "
          f"{tag}")
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
DANUBE_PLAN_REQS, DANUBE_PLAN_PROMPT = 2, 128


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
    out["reduced_card_vs_cpu"] = reduced_danube_card_vs_cpu(dev, tag, plan,
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


def train_argv(arch="qwen2-1.5b", steps=TRAIN_STEPS):
    return ["--arch", arch, "--steps", str(steps),
            "--warmup", "2", "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--microbatches", str(TRAIN_MICRO), "--buckets",
            "4", "--lr", "3e-4", "--log-every", "5", "--seed", "0"]


def train_full_width(dev, tag, arch="qwen2-1.5b", steps=TRAIN_STEPS,
                     n_layers=None):
    """The training main path: launch.train's runner at full width, cut
    to ``n_layers`` if given (danube's depth cut, phase 4g)."""
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
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
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


def train_step_times(dev, cfg, plan, mesh, tag, label, profile=False):
    """Host, wall and device ms of a full-width training step of phase
    4b's engine (``plan``/``mesh`` None: unplanned), fed by BatchFeed as
    the training loop feeds it: one warm step, STEP_TIMED steps whose
    ``step()`` calls are timed on the host (the step reads nothing back)
    and ended by one sync, then STEP_PROFILED steps under torch.profiler
    for the kernels' device time.  With ``profile``, the profiler's report
    too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from repro_torch.data.pipeline import BatchFeed, DataConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainConfig, make_engine

    args = launch_train.build_argparser().parse_args(train_argv())
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
        for _ in range(STEP_TIMED):
            batch = feed.get()
            t = time.perf_counter()
            state, _ = engine.step(state, batch)
            host.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / STEP_TIMED
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(STEP_PROFILED):
                state, _ = engine.step(state, feed.get())
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
    dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e3 / STEP_PROFILED
    rec = dict(host_ms=float(np.mean(host)), wall_ms=wall_ms,
               device_ms=dev_ms)
    print(f"train plan: step {label}: host {rec['host_ms']:.2f} ms "
          f"(enqueue), wall {wall_ms:.2f} ms (n {STEP_TIMED}, synced at the "
          f"end), device {dev_ms:.2f} ms (profiler, {STEP_PROFILED} steps) "
          f"{tag}")
    if profile:
        rec["profile"] = report_profile(
            prof, f"train {cfg.name} {label} ({STEP_PROFILED} steps)",
            prof_ms, tag)
    del state, engine
    return rec


def train_plan(dev, tag, ref_rec, profile=False):
    """Phase 4h: phase 4b's training run under the solved (1, 1) train
    plan, on a world-1 NCCL group and a (1, 1) DeviceMesh, through
    launch.train's runner with --mesh 1x1 --plan auto.  Launches must be
    phase 4b's exactly, with no plan fallback and no plain call; every
    loss finite, the last below the first, each within
    TRAIN_PLAN_LOSS_REL of phase 4b's.  Also solves and prints the (4, 2)
    and (2, 4) train plans (solved only), and a step's host and device ms
    with and without the plan.  Tears the group down before it
    returns."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.builders import build_graph
    from repro_torch.core.plan import ShardingPlan
    from repro_torch.core.solver import solve_mesh
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
    # the (4, 2) and (2, 4) plans, solved only (one card here), in two
    # processes side by side (~1 min each on the card's host), started
    # fresh: this process has CUDA's and NCCL's threads, so no fork
    g = build_graph(cfg, shape, **graph_kwargs)
    t0 = time.perf_counter()
    with ProcessPoolExecutor(len(TRAIN_PLAN_MESHES),
                             mp_context=mp.get_context("spawn")) as ex:
        futures = [ex.submit(solve_mesh, g, solver_axes(m))
                   for m in TRAIN_PLAN_MESHES]
        sols = [f.result() for f in futures]
    many_s = time.perf_counter() - t0
    for m, sol in zip(TRAIN_PLAN_MESHES, sols):
        name = f"{m[0]}x{m[1]}"
        cuts = ShardingPlan.from_graph_solution(sol, g).role_cuts
        solves[name] = dict(solve_s=many_s, total_bytes=sol.total_bytes,
                            role_cuts=cuts)
        state = {r: {a: d for a, d in c.items() if d}
                 for r, c in cuts.items()
                 if r.endswith((".opt", ".master")) or r.startswith("w")}
        print(f"train plan: {cfg.name} {shape.name} on a {name} mesh "
              f"(solved only: one card here), solver cost "
              f"{sol.total_bytes:.6g}; cuts of the moments, master and "
              f"weights: { {r: c for r, c in sorted(state.items()) if c} }")
    cut = sorted(r for r, c in plan_rec["role_cuts"].items()
                 if any(c.values()))
    print(f"train plan: the (1, 1) plan solved in "
          f"{solves['1x1']['solve_s']:.3f} s (solver cost "
          f"{plan_rec['total_bytes']:.6g}, roles cut: {cut or 'none'}); "
          f"the other two side by side in {many_s:.1f} s")
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
        # 7 slots of 64 tokens, an admission of 32 (32 scan steps), then 8
        # decode steps of the 8 slots
        slim["profile"] = profile_serve(model, params, scfg, prompts, tag,
                                        fill=64, admit=32, tiers=("",))
    del params, model
    return slim, launches


def reduced_danube_card_vs_cpu(dev, tag, plan=None, mesh=None):
    """The reduced h2o-danube-3-4b (window 16, hd 16) on the card against
    the same bf16 weights on the CPU: a scan prefill of 20 tokens into
    slot 0 (its ring of 16 wraps) and of 10 into slot 1, then 40 decode
    steps of both rows, so that slot 0 runs 44 positions past the
    window.  With ``plan`` and ``mesh`` the card's side runs under the
    plan (params and ring cache placed as the Server places them)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.common import whole
    from repro_torch.models.model import LM
    from repro_torch.models.sharding import (CACHE_RULES, place_tree,
                                             zeros_tree)

    cfg = get_arch(DANUBE).reduced()
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
    ring = caches[dev]["kv"]["k"].shape[2]
    pos = whole(caches[dev]["pos"]).tolist()
    print(f"reduced danube{' under the plan' if plan is not None else ''}, "
          f"card vs CPU, ring of {ring} positions, rows at positions {pos}: "
          f"max|dlogits|={worst:.4g} (band {LOGITS_ATOL}) {tag}")
    if ring != cfg.swa_window or pos != [60, 50]:
        fail(f"reduced danube's ring {ring} / positions {pos}")
    if not worst <= LOGITS_ATOL:
        fail("reduced danube on the card disagrees with the CPU")
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
    danube_reduced = reduced_danube_card_vs_cpu(dev, tag)
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

    # 5. times
    times = time_kernels(dev, tag, timer)
    print(f"phase 5 done at {time.perf_counter() - t_start:.1f}s")

    # 6. the kernels line: launches are those of the main paths (linear
    # serving, the four paged runs, serving under the plan, the paged runs
    # under the plan, training, training under the plan, hybrid training)
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
            hybrid_launches)
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
            kernels=kernels), indent=1, default=str))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
