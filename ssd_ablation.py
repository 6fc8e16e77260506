#!/usr/bin/env python3
"""Where the SSD chunk scan's time goes on the card: build variants of
``csrc/ssd_scan.cu`` with parts of the output kernel's work removed and
print each kernel's device time at the hybrid training shape (xh
[2,1024,80,64], N 64, chunk 256).  The variants compute wrong values; they
only time.

  python3 ssd_ablation.py            # one CUDA card, nvcc

Each variant is a list of (text, replacement) edits applied to a copy of
the sources under build/ablation/<name>; an edit that does not apply fails
the run, so the variants follow the kernel or stop.  Times are CUDA-event
means with the L2 flushed and the stream held (chip_smoke.Timer), per
kernel from torch.profiler.  Imports nothing of JAX.
"""
from __future__ import annotations

import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

SPLITS = ("    for (int i = 0; i < 1 + nh; ++i) "
          "split_in_place(st + i * BOX_F32, tv);\n")
EXPS = ("        float v = sc[i] * clip_exp(cr[g][hi] - "
        "ck[g][2 * (i >> 2) + (i & 1)]);")
WX = ("        wg::rs_n64(acc[g], w_hi[g][kk], desc_mn(xh_, kk), 1);\n"
      "        wg::rs_n64(acc[g], w_hi[g][kk], desc_mn(xl_, kk), 1);\n"
      "        wg::rs_n64(acc[g], w_lo[g][kk], desc_mn(xh_, kk), 1);")
CB = ("      wg::ss_n64(sc, desc_k(c_hi, kk), desc_k(b_hi, kk), 1);\n"
      "      wg::ss_n64(sc, desc_k(c_hi, kk), desc_k(b_lo, kk), 1);\n"
      "      wg::ss_n64(sc, desc_k(c_lo, kk), desc_k(b_hi, kk), 1);")
PREV = "  if (c > 0)\n    prev_states("
INTER = ("        wg::ss_n64(acc[g], desc_k(c_hi, kk), "
         "desc_k(s_hi, kk), 1);\n"
         "        wg::ss_n64(acc[g], desc_k(c_hi, kk), "
         "desc_k(s_lo, kk), 1);\n"
         "        wg::ss_n64(acc[g], desc_k(c_lo, kk), "
         "desc_k(s_hi, kk), 1);")
KEY_CUM = ("              g < nh && t < tv\n"
           "                  ? cum[((long)b * H + h0 + g) * S + pos0 + t0 "
           "+ t]\n"
           "                  : 0.f;")
STORE = "        if (p < P)\n          *reinterpret_cast<float2*>(yb"
WAIT = "    mbar_wait(&bar[1 + (kt & 1)], (kt >> 1) & 1);\n"
# everything but the copies and the stores of y
NO_WORK = [(SPLITS, ""), (EXPS, "        float v = sc[i];"), (WX, ""),
           (CB, ""), (PREV, "  if (c < 0)\n    prev_states("), (INTER, ""),
           (KEY_CUM, "0.f;")]
VARIANTS = {
    "as built": [],
    "copies + y stores only": NO_WORK,
    "copies only": NO_WORK + [(STORE, STORE.replace("p < P", "p < 0"))],
    "C copy + y stores only": NO_WORK + [
        (WAIT, ""),
        ("    load_tile(0);\n    if (c == 0 && qt > 0) load_tile(1);", ""),
        ("    if (tid == 0 && qt > 0) load_tile(1);", ""),
        ("    if (tid == 0 && kt + 2 <= qt) load_tile(kt + 2);", "")],
    "no decays (exp)": [(EXPS, "        float v = sc[i];")],
    "no W x products": [(WX, "")],
    "no box conversion": [(SPLITS, "")],
}


def build_variant(name, edits, csrc):
    """Build and load, in place of the library, the sources ``csrc`` with
    ``edits`` applied to a copy of ssd_scan.cu."""
    from repro_torch.kernels import build

    if edits:
        dst = ROOT / "build" / "ablation" / name.replace(" ", "_")
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(csrc, dst)
        text = (dst / "ssd_scan.cu").read_text()
        for old, new in edits:
            if old not in text:
                cs.fail(f"variant {name!r}: an edit no longer applies:\n{old}")
            text = text.replace(old, new)
        (dst / "ssd_scan.cu").write_text(text)
        csrc = dst
    build.CSRC = csrc
    build._lib = None
    build.load_library()


def main() -> int:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs a card")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build, ssd

    smi = cs.nvidia_smi_line()
    print(smi)
    dev = torch.device("cuda", 0)
    timer = cs.Timer(dev)
    xh, al, bb, cc = cs.ssd_inputs(dev, 2, 1024, 80, 64, 64, 600)
    csrc = build.CSRC
    for name, edits in VARIANTS.items():
        build_variant(name, edits, csrc)

        def run():
            return ssd.ssd_chunk_scan(xh, al, bb, cc, chunk=256)

        ms = timer(run)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                timer.flush.zero_()
                run()
            torch.cuda.synchronize()
        parts = {e.key.split("(")[0].split("::")[-1]:
                 e.self_device_time_total / 1e3 / e.count
                 for e in prof.key_averages()
                 if "ssd" in e.key and e.self_device_time_total > 0}
        print(f"{name:24s} call {ms:.4f} ms  " + "  ".join(
            f"{k} {v:.4f}" for k, v in sorted(parts.items())), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
