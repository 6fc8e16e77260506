#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA card, end to end.

  python3 chip_smoke.py                    # one CUDA card, nvcc, ~minutes
  python3 chip_smoke.py --out run.json     # also write the full record

Phases, each of which exits non-zero on failure (nothing is caught):
  1. device: requires a CUDA card; prints its name and power limit;
  2. build: compiles the CUDA kernels from src/repro_torch/kernels/csrc
     with nvcc for sm_90a into build/ (ptxas register / smem lines shown);
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     card, at the serving path's shapes (12 q heads over 2 KV heads,
     hd 128) and at the reduced configs' hd 16;
     The backward kernels (dq, dk/dv) are held the same way, causal and
     not, with a window, GQA groups 1 and 6, hd 16 / 64 / 128, a ragged
     S = 1000 and the training shape;
     The paged decode kernel at the serving shape (16 slots, ~1000 tokens
     each, shuffled blocks, one block shared by two rows), the re-score's
     64-row grid, hd 16, a 48-token block, ragged and empty rows: within
     O_TOL of its plain version, bit-equal to flash_decode on the view the
     table spells, and unmoved by 1e9 / NaN poison in unowned blocks;
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
  4b. train: qwen2-1.5b at full width, f32 master weights, global batch
     4 x 1024 in 2 microbatches, AdamW lr 3e-4 with 2 warmup steps, 12
     steps through launch.train's runner; every loss finite, the last
     below the first, launches per step exactly flash_fwd 112 (forward and
     remat recompute) and flash_bwd_dq / flash_bwd_dkv 56 each, no plain
     call; then the reduced model's loss and grads on the card against the
     CPU, and 3 compressed-sync engine steps on both;
  5. times: each kernel's time (CUDA events, L2 flushed before every
     launch), its bound, the plain version's time and SDPA's (forward or
     backward; for the paged kernel an index_select gather, then SDPA) as
     the library yardstick;
  6. the kernels line and the contract's last line.
With --profile, also torch.profiler over one admission and 8 decode
steps on each tier, and 2 full-width training steps.
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

class Timer:
    """Mean device time of fn() over n launches, with the 50 MB L2
    flushed before each launch (the serving path reads each layer's
    cache cold)."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, n: int = 20, warm: int = 3) -> float:
        for _ in range(warm):
            fn()
        total = 0.0
        pairs = []
        for _ in range(n):
            self.flush.zero_()
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


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def rel_err(out, ref):
    """max |out - ref| and max of it over max(1, |ref|), in f32."""
    d = (out.float() - ref.float()).abs()
    return float(d.max()), float((d / ref.float().abs().clamp(min=1.0)).max())


def check_kernels(dev, tag):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    def rnd(shape, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    rows = {"flash_fwd": [], "flash_decode": [], "flash_bwd_dq": [],
            "flash_bwd_dkv": []}
    # (b, sq, sk, h, kv, hd, q_off, causal, window)
    fwd_cases = [
        (1, 256, 2048, 12, 2, 128, 0, True, None),
        (1, 256, 2048, 12, 2, 128, 768, True, None),
        (1, 256, 2048, 12, 2, 128, 1792, True, None),
        (1, 256, 2048, 12, 2, 128, 1900, True, None),  # tail past the cache
        (1, 512, 512, 12, 2, 128, 0, True, None),
        (1, 512, 512, 12, 2, 128, 0, True, 128),
        (2, 100, 300, 8, 2, 64, 37, True, 50),
        (1, 40, 64, 4, 1, 16, 30, True, None),
        (2, 33, 70, 4, 2, 16, 0, False, 9),
    ]
    for i, (b, sq, sk, h, kv, hd, off, causal, window) in enumerate(
            fwd_cases):
        q, k, v = (rnd((b, sq, h, hd), 3 * i), rnd((b, sk, kv, hd), 3 * i + 1),
                   rnd((b, sk, kv, hd), 3 * i + 2))
        offt = torch.tensor([off], dtype=torch.int32, device=dev)
        kw = dict(causal=causal, window=window)
        o, lse = fa.flash_attention_fwd(q, k, v, q_offset=offt, **kw)
        o_r, lse_r = ref.flash_attention_fwd_ref(q, k, v, q_offset=off, **kw)
        torch.cuda.synchronize()
        e_o, r_o = rel_err(o, o_r)
        e_l = float((lse - lse_r).abs().max())
        ok = r_o <= O_TOL and e_l <= LSE_TOL and bool(torch.isfinite(o).all())
        print(f"check flash_fwd b={b} sq={sq} sk={sk} h={h} kv={kv} hd={hd} "
              f"q_offset={off} causal={causal} window={window}: "
              f"max|dO|={e_o:.3g} rel={r_o:.3g} max|dlse|={e_l:.3g} "
              f"{'ok' if ok else 'MISS'} {tag}")
        if not ok:
            fail(f"flash_fwd disagrees with its plain version (case {i})")
        rows["flash_fwd"].append(dict(case=i, max_abs_err=e_o, rel_err=r_o,
                                      lse_err=e_l))

    # (b, s, h, kv, hd, window)
    dec_cases = [(16, 2048, 12, 2, 128, None), (16, 2048, 12, 2, 128, 256),
                 (4, 64, 4, 2, 16, None), (4, 64, 4, 1, 16, 7),
                 (3, 200, 8, 8, 64, None)]
    for i, (b, s, h, kv, hd, window) in enumerate(dec_cases):
        q = rnd((b, h, hd), 100 + 3 * i)
        kc, vc = rnd((b, s, kv, hd), 101 + 3 * i), rnd((b, s, kv, hd),
                                                      102 + 3 * i)
        ln = np.random.default_rng(i).integers(1, s + 1, size=b)
        ln[0], ln[-1] = 1, s
        lengths = torch.tensor(ln, dtype=torch.int32, device=dev)
        o = fa.flash_attention_decode(q, kc, vc, lengths, window=window)
        o_r = ref.flash_attention_decode_ref(q, kc, vc, lengths,
                                             window=window)
        torch.cuda.synchronize()
        e_o, r_o = rel_err(o, o_r)
        ok = r_o <= O_TOL and bool(torch.isfinite(o).all())
        print(f"check flash_decode b={b} s={s} h={h} kv={kv} hd={hd} "
              f"window={window} lengths in [{ln.min()},{ln.max()}]: "
              f"max|dO|={e_o:.3g} rel={r_o:.3g} {'ok' if ok else 'MISS'} "
              f"{tag}")
        if not ok:
            fail(f"flash_decode disagrees with its plain version (case {i})")
        rows["flash_decode"].append(dict(case=i, max_abs_err=e_o,
                                         rel_err=r_o))

    rows["flash_paged_decode"] = check_paged(dev, tag)

    # (b, s, h, kv, hd, causal, window)
    bwd_cases = [
        (TRAIN_BATCH, TRAIN_SEQ, 12, 2, 128, True, None),  # training shape
        (2, 1000, 12, 2, 128, True, None),                # ragged S
        (1, 512, 12, 12, 128, False, None),               # g = 1
        (1, 512, 12, 2, 128, True, 128),                  # window
        (2, 100, 8, 2, 64, False, 50),
        (2, 33, 4, 1, 16, True, 9),
        (1, 40, 4, 4, 16, False, None),
    ]
    for i, (b, s, h, kv, hd, causal, window) in enumerate(bwd_cases):
        q, do = rnd((b, s, h, hd), 200 + 4 * i), rnd((b, s, h, hd), 201 + 4 * i)
        k, v = rnd((b, s, kv, hd), 202 + 4 * i), rnd((b, s, kv, hd), 203 + 4 * i)
        kw = dict(causal=causal, window=window)
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        errs = {n: rel_err(a, w) for n, a, w in zip(("dq", "dk", "dv"), got,
                                                     want)}
        ok = (all(r <= GRAD_TOL for _, r in errs.values())
              and all(bool(torch.isfinite(a).all()) for a in got))
        print(f"check flash_bwd b={b} s={s} h={h} kv={kv} hd={hd} "
              f"causal={causal} window={window}: "
              + " ".join(f"max|d{n}|={e:.3g} rel={r:.3g}"
                         for n, (e, r) in errs.items())
              + f" {'ok' if ok else 'MISS'} {tag}")
        if not ok:
            fail(f"flash_bwd disagrees with its plain version (case {i})")
        rows["flash_bwd_dq"].append(dict(case=i, max_abs_err=errs["dq"][0],
                                         rel_err=errs["dq"][1]))
        rows["flash_bwd_dkv"].append(dict(
            case=i, max_abs_err=max(errs["dk"][0], errs["dv"][0]),
            rel_err=max(errs["dk"][1], errs["dv"][1])))
        del q, k, v, do, o, lse, got, want
    return rows


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
    flash_decode on the view the table spells, and blind to poison (1e9,
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
    cases = [(16, 12, 2, 128, 16, 128, serving.tolist()),
             (64, 12, 2, 128, 16, 128,
              np.repeat(serving, 4).clip(1).tolist()),
             (4, 4, 1, 16, 8, 8, [37, 16, 0, 64]),
             (3, 12, 2, 128, 48, 6, [200, 97, 288])]
    out = []
    for i, (b, h, kv, hd, bl, mb, lengths) in enumerate(cases):
        q, kp, vp, table, ln, live = paged_case(dev, b, h, kv, hd, bl, mb,
                                                lengths, 300 + i)
        o = fa.flash_attention_paged_decode(q, kp, vp, table, ln)
        o_r = ref.flash_attention_paged_decode_ref(q, kp, vp, table, ln)
        view = [p[table.long()].reshape(b, mb * bl, kv, hd)
                for p in (kp, vp)]
        o_d = fa.flash_attention_decode(q, *view, ln)
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
              and torch.equal(o, o_d)
              and all(torch.equal(o, x) for x in poisoned)
              and all(float(o[r].float().abs().max()) == 0.0
                      for r in zero_rows))
        print(f"check flash_paged_decode b={b} h={h} kv={kv} hd={hd} bl={bl} "
              f"mb={mb} lengths in [{min(lengths)},{max(lengths)}]: "
              f"max|dO|={e_o:.3g} rel={r_o:.3g}, vs flash_decode on the "
              f"gathered view max|d|={d_view:.3g}, poison 1e9/NaN "
              f"{[torch.equal(o, x) for x in poisoned]} "
              f"{'ok' if ok else 'MISS'} {tag}")
        if not ok:
            fail(f"flash_paged_decode check failed (case {i})")
        out.append(dict(case=i, max_abs_err=e_o, rel_err=r_o,
                        vs_flash_decode=d_view))
    return out


def time_kernels(dev, tag, timer):
    """Times at the main paths' shapes: a 256-row prefill chunk at offset
    768 against a 2048-slot cache (row 2) and a 16-slot decode step (row
    3) of serving; the forward without an offset (row 1) and the two
    backward kernels (rows 5, 6) at the training shape, q [4,1024,12,128]
    against kv [4,1024,2,128], causal."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    g = torch.Generator(device=dev).manual_seed(7)

    def rnd(shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    h, kv, hd = 12, 2, 128
    scale = hd ** -0.5

    def fwd_record(b, sq, sk, off):
        q, k, v = (rnd((b, sq, h, hd)), rnd((b, sk, kv, hd)),
                   rnd((b, sk, kv, hd)))
        offt = (None if off is None
                else torch.tensor([off], dtype=torch.int32, device=dev))
        by, fl = fwd_work(b, sq, sk, h, kv, hd, off or 0, True, None)
        bms, bby = bound(by, fl)
        rec = dict(
            shape=f"q[{b},{sq},{h},{hd}] kv[{b},{sk},{kv},{hd}] "
                  f"q_offset={off}",
            ms=timer(lambda: fa.flash_attention_fwd(q, k, v, q_offset=offt)),
            plain_ms=timer(lambda: ref.flash_attention_fwd_ref(
                q, k, v, q_offset=off)),
            bound_ms=bms, bound_by=bby, bytes=by, flops=fl)
        try:
            rec["library_ms"] = timer(sdpa_fwd(q, k, v, off or 0, True, None,
                                               scale))
        except (TypeError, RuntimeError) as e:  # no enable_gqa in this torch
            print(f"SDPA yardstick unavailable: {e}")
            rec["library_ms"] = None
        return rec

    out = {"flash_fwd": fwd_record(1, 256, 2048, 768),
           "flash_fwd (row 1, training shape)": fwd_record(
               TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, None)}

    b, s = 16, 2048
    q, kc, vc = rnd((b, h, hd)), rnd((b, s, kv, hd)), rnd((b, s, kv, hd))
    ln = np.random.default_rng(0).integers(1, s + 1, size=b)
    ln[0], ln[-1] = 1, s
    lengths = torch.tensor(ln, dtype=torch.int32, device=dev)
    by, fl = decode_work(ln, h, kv, hd, None)
    bms, bby = bound(by, fl)
    rec = dict(
        shape=f"q[{b},{h},{hd}] cache[{b},{s},{kv},{hd}] "
              f"sum(lengths)={int(ln.sum())}",
        ms=timer(lambda: fa.flash_attention_decode(q, kc, vc, lengths)),
        plain_ms=timer(lambda: ref.flash_attention_decode_ref(
            q, kc, vc, lengths)),
        bound_ms=bms, bound_by=bby, bytes=by, flops=fl)
    try:
        rec["library_ms"] = timer(sdpa_decode(q, kc, vc, lengths, None,
                                              scale))
    except (TypeError, RuntimeError) as e:
        print(f"SDPA yardstick unavailable: {e}")
        rec["library_ms"] = None
    out["flash_decode"] = rec
    out["flash_paged_decode"] = time_paged(dev, timer, ln, h, kv, hd, scale)
    out.update(time_bwd(dev, timer, rnd, h, kv, hd))
    for name, r in out.items():
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"time {name} {r['shape']}: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, SDPA {lib} {tag}")
    return out


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
        ms=timer(lambda: fa.flash_attention_paged_decode(q, kp, vp, table,
                                                         lengths)),
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


def time_bwd(dev, timer, rnd, h, kv, hd):
    """The two backward kernels timed apart at the training shape; the
    plain version and SDPA's backward compute dq, dk and dv together, so
    both rows carry the same plain and library time."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    b, s = TRAIN_BATCH, TRAIN_SEQ
    q, k, v, do = (rnd((b, s, h, hd)), rnd((b, s, kv, hd)),
                   rnd((b, s, kv, hd)), rnd((b, s, h, hd)))
    o, lse = fa.flash_attention_fwd(q, k, v)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do)
    plain_ms = timer(lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do),
                     n=5)
    try:
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        lib_ms = timer(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                   retain_graph=True))
    except (TypeError, RuntimeError) as e:   # no enable_gqa in this torch
        print(f"SDPA backward yardstick unavailable: {e}")
        lib_ms = None
    shape = (f"q/do [{b},{s},{h},{hd}] kv [{b},{s},{kv},{hd}] causal; plain "
             f"and SDPA times are the whole backward")
    fns = {"flash_bwd_dq": lambda: fa.flash_attention_bwd_dq(
               q, k, v, o, lse, do),
           "flash_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(
               q, k, v, lse, delta, do)}
    out_rec = {}
    for name, fn in fns.items():
        by, fl = bwd_work(b, s, h, kv, hd, True, None, name[len("flash_bwd_"):])
        bms, bby = bound(by, fl)
        out_rec[name] = dict(shape=shape, ms=timer(fn), plain_ms=plain_ms,
                             bound_ms=bms, bound_by=bby, bytes=by, flops=fl,
                             library_ms=lib_ms)
    return out_rec


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

    class CheckedServer(Server):
        """Counts non-finite logits of every prefill and decode step."""
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
                "flash_decode": 0}
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


def profile_serve(model, params, scfg, prompts, tag):
    """Where the time goes: torch.profiler over one admission (the
    first 768 tokens of the last prompt, at most 3 prefill chunks) and 8
    decode steps of a full 16-slot pool at up to ~1000 cached tokens per
    slot, on the linear tier and then on the paged tier (default pool, no
    other request sharing a prefix).  Prints the kernels with the most
    device time and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.serve import Server

    out = {}
    for tier, tcfg in (("", scfg),
                       ("paged ", dataclasses.replace(scfg, paged=True))):
        srv = Server(model, params, tcfg)
        for s in range(tcfg.slots - 1):
            srv.admit(prompts[s % len(prompts)][:1000], s,
                      max_new_tokens=1000)
        torch.cuda.synchronize()
        phases = (("prefill", lambda: srv.admit(prompts[-1][:768],
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
    counted): every weight matmul, the tied head, and causal attention."""
    d, hd, h, kv, f = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    per_layer = d * (h + 2 * kv) * hd + h * hd * d + 3 * d * f
    mm = 2.0 * b * s * (cfg.n_layers * per_layer + d * cfg.vocab)
    attn = cfg.n_layers * 4.0 * hd * h * b * s * (s + 1) / 2
    return 3 * (mm + attn)


def train_argv():
    return ["--arch", "qwen2-1.5b", "--steps", str(TRAIN_STEPS),
            "--warmup", "2", "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--microbatches", str(TRAIN_MICRO), "--buckets",
            "4", "--lr", "3e-4", "--log-every", "5", "--seed", "0"]


def train_full_width(dev, tag):
    """The training main path: launch.train's runner at full width."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train

    cfg = get_arch("qwen2-1.5b")
    args = launch_train.build_argparser().parse_args(train_argv())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    ops.reset_plain_calls()
    rec = launch_train.run(args)
    launches = dict(fa.launches)
    plain = dict(ops.plain_calls)
    peak = torch.cuda.max_memory_allocated(dev)

    L, n = cfg.n_layers, TRAIN_STEPS
    want = {"flash_fwd": 2 * L * TRAIN_MICRO * n, "flash_decode": 0,
            "flash_paged_decode": 0, "flash_bwd_dq": L * TRAIN_MICRO * n,
            "flash_bwd_dkv": L * TRAIN_MICRO * n}
    losses = rec["losses"]
    print(f"train: {cfg.name} full width, {n} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens in {TRAIN_MICRO} microbatches, losses "
          f"{[round(x, 4) for x in losses]}")
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
               model_flops_per_step=flops, mfu=mfu)
    return rec, launches


def profile_train(dev, tag):
    """torch.profiler over 2 full-width training steps (after one warm
    step), fed by BatchFeed as the training loop feeds them."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import BatchFeed, DataConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainConfig, make_engine

    args = launch_train.build_argparser().parse_args(train_argv())
    cfg = get_arch(args.arch)
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
    return report_profile(prof, "train (2 steps)", wall_ms, tag)


def reduced_train_card_vs_cpu(dev, tag):
    """The reduced qwen2-1.5b on the card against the same weights on the
    CPU: the loss and every param's grad; then 3 steps of the engine with
    the int8 compressed sync on both."""
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.engine import EngineConfig, TrainEngine

    cfg = get_arch("qwen2-1.5b").reduced()
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
    print(f"reduced qwen2-1.5b train, card vs CPU: |dloss|={dloss:.4g} (band "
          f"{LOSS_ATOL}), worst max|dgrad|/max|grad| {worst:.4g} at "
          f"{worst_key} (band {PARAM_GRAD_REL}) {tag}")
    if not dloss <= LOSS_ATOL or not worst <= PARAM_GRAD_REL:
        fail("reduced model's loss or grads on the card disagree with the "
             "CPU")

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

    # 3. kernel vs plain
    timer = Timer(dev)
    checks = check_kernels(dev, tag)

    # 4. serve at full width, then the reduced model against the CPU
    serve_rec, serve_launches, base = serve_full_width(dev, tag, args.profile)
    # 4c. the paged tier on the same weights, held to phase 4's streams
    paged_rec, paged_launches = serve_paged(
        base, serve_rec["decode_dispatches"], dev, tag)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    reduced_err = reduced_card_vs_cpu(dev, tag)

    # 4b. train at full width, then the reduced model against the CPU
    train_rec, train_launches = train_full_width(dev, tag)
    gc.collect()
    torch.cuda.empty_cache()
    if args.profile:
        train_rec["profile"] = profile_train(dev, tag)
        gc.collect()
        torch.cuda.empty_cache()
    reduced_train = reduced_train_card_vs_cpu(dev, tag)

    # 5. times
    times = time_kernels(dev, tag, timer)

    # 6. the kernels line: launches are those of the main paths (linear
    # serving, the four paged runs, training)
    fa_py = "src/repro/kernels/flash_attention.py"
    replaces = {"flash_fwd": f"{fa_py}:146 and {fa_py}:191",
                "flash_decode": f"{fa_py}:280",
                "flash_paged_decode": f"{fa_py}:378",
                "flash_bwd_dq": f"{fa_py}:491",
                "flash_bwd_dkv": f"{fa_py}:519"}
    csrc = "src/repro_torch/kernels/csrc"
    sources = {"flash_fwd": f"{csrc}/flash_fwd.cu",
               "flash_decode": f"{csrc}/flash_decode.cu",
               "flash_paged_decode": f"{csrc}/flash_paged_decode.cu",
               "flash_bwd_dq": f"{csrc}/flash_bwd.cu",
               "flash_bwd_dkv": f"{csrc}/flash_bwd.cu"}
    kernels = []
    for k in replaces:
        t = times[k]
        kernels.append({
            "name": k, "route": "cuda", "source": sources[k],
            "replaces": replaces[k],
            "launches": (serve_launches[k] + paged_launches[k]
                         + train_launches[k]),
            "max_abs_err": max(r["max_abs_err"] for r in checks[k]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            device=name, nvidia_smi=smi, torch=torch.__version__,
            build=build.build_info, checks=checks, times=times,
            serve=serve_rec, paged=paged_rec,
            reduced_card_vs_cpu=reduced_err,
            train=train_rec, reduced_train_card_vs_cpu=reduced_train,
            kernels=kernels), indent=1, default=str))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
