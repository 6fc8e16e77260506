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
  4. serve: qwen2-1.5b at full width (28 layers, d 1536, vocab 151936,
     bf16, random weights from torch.Generator(0)), 16 slots x 2048,
     prefill chunk 256, 32 requests of 256-1536 prompt tokens, 32 greedy
     tokens each, through launch.serve.run_workload; every launch counter
     must match the dispatch counts and the plain versions must not run;
     then the reduced model on the card against the same model on the CPU;
  5. times: each kernel's time (CUDA events, L2 flushed before every
     launch), its bound, the plain version's time and SDPA's as the
     library yardstick;
  6. the kernels line and the contract's last line.
Imports nothing of JAX and nothing of the repro (JAX) package.
"""
from __future__ import annotations

import argparse
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

    rows = {"flash_fwd": [], "flash_decode": []}
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
    return rows


def time_kernels(dev, tag, timer):
    """Times at the serving path's shapes: a 256-row prefill chunk at
    offset 768 against a 2048-slot cache (row 2) and a 16-slot decode step
    (row 3); plus the same forward kernel without an offset on a
    2048-token causal self-attention (row 1, the training shape)."""
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
           "flash_fwd (row 1, no offset)": fwd_record(1, 2048, 2048, None)}

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
    for name, r in out.items():
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"time {name} {r['shape']}: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, SDPA {lib} {tag}")
    return out


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
    del srv
    if profile:
        slim["profile"] = profile_serve(model, params, scfg, prompts, tag)
    del params
    torch.cuda.empty_cache()
    return slim, launches


def profile_serve(model, params, scfg, prompts, tag):
    """Where the time goes: torch.profiler over one admission (the
    first 768 tokens of the last prompt, at most 3 prefill chunks) and 8
    decode steps of a full 16-slot pool at up to ~1000 cached tokens per
    slot.  Prints the kernels with
    the most device time and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.serve import Server

    srv = Server(model, params, scfg)
    for s in range(scfg.slots - 1):
        srv.admit(prompts[s % len(prompts)][:1000], s, max_new_tokens=1000)
    torch.cuda.synchronize()
    phases = (("prefill", lambda: srv.admit(prompts[-1][:768],
                                            scfg.slots - 1,
                                            max_new_tokens=1000)),
              ("decode", lambda: [srv.decode_once() for _ in range(8)]))
    out = {}
    for phase, fn in phases:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side kernel events only: the aten ops that launched them
        # carry the same device time again
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        print(f"profile {phase}: wall {wall_ms:.2f} ms, device busy "
              f"{busy:.2f} ms ({100 * busy / wall_ms:.1f}%) {tag}")
        for key, ms, n in rows[:12]:
            print(f"  {ms:9.3f} ms {n:6d}x  {key[:90]}")
        out[phase] = dict(wall_ms=wall_ms, busy_ms=busy,
                          top=[dict(kernel=k, ms=m, count=n)
                               for k, m, n in rows[:20]])
    return out


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


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the full record as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one admission and 8 decode steps "
                         "at full width (torch.profiler)")
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
    serve_rec, launches = serve_full_width(dev, tag, args.profile)
    reduced_err = reduced_card_vs_cpu(dev, tag)

    # 5. times
    times = time_kernels(dev, tag, timer)

    # 6. the kernels line
    replaces = {"flash_fwd": "src/repro/kernels/flash_attention.py:191",
                "flash_decode": "src/repro/kernels/flash_attention.py:280"}
    sources = {"flash_fwd": "src/repro_torch/kernels/csrc/flash_fwd.cu",
               "flash_decode": "src/repro_torch/kernels/csrc/flash_decode.cu"}
    kernels = []
    for k in ("flash_fwd", "flash_decode"):
        t = times[k]
        kernels.append({
            "name": k, "route": "cuda", "source": sources[k],
            "replaces": replaces[k], "launches": launches[k],
            "max_abs_err": max(r["max_abs_err"] for r in checks[k]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            device=name, nvidia_smi=smi, torch=torch.__version__,
            build=build.build_info, checks=checks, times=times,
            serve=serve_rec, reduced_card_vs_cpu=reduced_err,
            kernels=kernels), indent=1, default=str))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
