"""Training harness: drives the training engine (``train/engine.py``)
through the training loop (``runtime/train_loop.py``) over the synthetic
pipeline and reports tokens/s with a step-time breakdown (counterpart of
``repro.launch.train``, its single-card subset).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 12 --batch 4 --seq 1024 --microbatches 2
  # the hybrid family (Mamba2 + shared attention), full width:
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
      --steps 8 --batch 4 --seq 1024 --microbatches 2
  # on the CPU, at the reduced size:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --device cpu --steps 3

Runs on the card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it raises.  Weights are random, from
``torch.Generator(--seed)``; nothing is downloaded.  Not ported yet:
``--mesh``, ``--plan``, ``--stages``, the trace / metrics / monitor flags
and fault injection."""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Optional, Sequence

import torch

from ..configs.base import get_arch
from ..data.pipeline import DataConfig
from ..models.common import resolve_device
from ..models.model import LM
from ..optim.adamw import AdamWConfig
from ..runtime.train_loop import TrainConfig, train


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=2,
                    help="steps excluded from throughput (first launches, "
                         "kernel build, allocator growth)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--buckets", type=int, default=4)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--no-master-fp32", action="store_true",
                    help="disable the f32 master copy (pure bf16 AdamW)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10,
                    help="device sync interval in steps: losses stay on the "
                         "device between boundaries")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    return ap


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Train as ``args`` say and return the record (the fields of repro's
    launch record that a single card has)."""
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    master_fp32 = not args.no_master_fp32
    model = LM(cfg)
    tcfg = TrainConfig(
        steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        log_every=args.log_every, warmup=args.warmup,
        grad_compression=args.grad_compression,
        optim=AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                          total_steps=args.steps),
        microbatches=args.microbatches, buckets=args.buckets,
        master_fp32=master_fp32)
    dcfg = DataConfig(seed=args.seed, vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    out = train(model, dcfg, tcfg, device=device)
    hist = out["history"]
    n_meas = max(1, out["measured_steps"])
    step_s = out["breakdown_s"]["step"]
    mean_step = step_s / n_meas
    tokens_per_step = args.batch * args.seq
    return {
        "meta": {
            "arch": cfg.name, "reduced": args.reduced, "batch": args.batch,
            "seq": args.seq, "steps": len(hist),
            "microbatches": args.microbatches, "buckets": args.buckets,
            "grad_compression": args.grad_compression,
            "master_fp32": master_fp32,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "measured_steps": out["measured_steps"],
        },
        "first_loss": hist[0]["loss"] if hist else None,
        "last_loss": hist[-1]["loss"] if hist else None,
        "tokens_per_step": tokens_per_step,
        "mean_step_s": mean_step,
        "tokens_per_s": tokens_per_step / mean_step if step_s else 0.0,
        "breakdown_s": out["breakdown_s"],
        "losses": [h["loss"] for h in hist],
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_argparser().parse_args(argv)
    rec = run(args)
    if rec["losses"]:
        print(f"{rec['meta']['steps']} steps on {rec['meta']['device']}, "
              f"loss {rec['first_loss']:.3f} -> {rec['last_loss']:.3f}")
        print(f"  throughput {rec['tokens_per_s']:,.1f} tok/s (mean step "
              f"{rec['mean_step_s'] * 1e3:.1f} ms over "
              f"{rec['meta']['measured_steps']} steps)")
    else:
        print(f"nothing to do: the checkpoint is at or past --steps "
              f"{args.steps}")
    b = rec["breakdown_s"]
    print(f"  breakdown  data {b['data']:.2f}s | step {b['step']:.2f}s | "
          f"ckpt {b['ckpt']:.2f}s")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"metrics -> {args.json_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
