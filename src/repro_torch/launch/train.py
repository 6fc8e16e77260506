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
  # under the solved train plan on a 2x2 mesh of 4 gloo ranks:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --reduced --device cpu --mesh 2x2 --plan auto --steps 3 \\
      --batch 4 --seq 16

Runs on the card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it raises.  Weights are random, from
``torch.Generator(--seed)``; nothing is downloaded.

``--mesh DxM`` trains on a ("data", "model") DeviceMesh of D*M ranks:
gloo ranks with ``--device cpu``, otherwise NCCL, one rank a card.  Under
``torchrun --nproc-per-node D*M`` each process is a rank; run directly,
the module spawns the D*M ranks itself.  ``--plan auto`` solves the train
tiling of ``ShapeConfig(f"train{tag}{batch}x{seq}")`` for the mesh, with
the f32 master and error-feedback state in the graph as the flags say
(``launch/compile.solve_cell_plan``, cached under
``.cache/plans_torch/`` with ``_mp`` / ``_ef`` in the name), and the
trainer places the state under it (an MoE plan's roles pinned by
``normalize_moe_plan`` in ``runtime/train_loop.make_engine``);
rank 0 prints and writes the record.  ``--mesh`` without ``--plan auto``
trains unsharded, as repro does, and says so.  Not ported yet:
``--stages``, the trace / metrics / monitor flags and fault injection."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..configs.base import ArchConfig, get_arch
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
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="e.g. 4x2: train on a (data, model) mesh of D*M "
                         "ranks (gloo with --device cpu, NCCL otherwise)")
    ap.add_argument("--plan", default=None, choices=[None, "auto"],
                    help="'auto' solves the train tiling for the mesh and "
                         "places params, optimizer state and batches "
                         "with it")
    return ap


def solve_train_plan(args: argparse.Namespace, cfg: ArchConfig,
                     shape: Sequence[int], names: Sequence[str]):
    """The train plan record for ``args`` on a mesh of ``shape`` (repro's
    ``launch.train`` solve: the cache name folds in the master / error
    feedback flags, the graph carries their state)."""
    from ..configs.base import ShapeConfig
    from .compile import solve_cell_plan
    from .mesh import solver_axes
    master_fp32 = not args.no_master_fp32
    tag = "r" if args.reduced else ""
    flags = ("_mp" if master_fp32 else "") + \
        ("_ef" if args.grad_compression else "")
    return solve_cell_plan(
        cfg, ShapeConfig(f"train{tag}{args.batch}x{args.seq}", args.seq,
                         args.batch, "train"),
        solver_axes(shape, names), mesh_name=f"mesh{args.mesh}{flags}",
        graph_kwargs={"master_fp32": master_fp32,
                                 "error_feedback": args.grad_compression})


def run(args: argparse.Namespace, cfg: Optional[ArchConfig] = None,
        plan_rec: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Train as ``args`` say and return the record (the fields of repro's
    launch record that this port has).  ``cfg``, if given, is trained in
    place of ``--arch``'s config (a depth cut of it, say).  With
    ``--mesh`` the default process group must be up (``main`` brings it
    up, or spawns the ranks); ``plan_rec``, if given, is the plan record
    ``--plan auto`` takes in place of solving (the one the parent solved
    before it spawned the ranks)."""
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_arch(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    master_fp32 = not args.no_master_fp32
    mesh = plan = None
    rank = 0
    if args.mesh:
        import torch.distributed as dist

        from .compile import plan_from_record
        from .mesh import make_mesh
        rank = dist.get_rank()
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        shape = tuple(int(s) for s in args.mesh.lower().split("x"))
        names = ("data", "model")[:len(shape)]
        mesh = make_mesh(shape, names, device.type)
        if args.plan == "auto":
            t0 = time.time()
            if plan_rec is None:
                plan_rec = solve_train_plan(args, cfg, shape, names)
            plan = plan_from_record(plan_rec)
            if rank == 0:
                print(f"train plan ({time.time() - t0:.2f}s, solve "
                      f"{plan_rec['solve_time']:.2f}s):")
                print(plan.describe())
        else:
            plan_rec = None
            if rank == 0:
                print(f"note: --mesh {args.mesh} without --plan auto trains "
                      "UNSHARDED (no plan, no placements)")
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
    out = train(model, dcfg, tcfg, device=device, mesh=mesh, plan=plan)
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
            "measured_steps": out["measured_steps"], "mesh": args.mesh,
            "rank": rank,
        },
        "plan": (None if plan_rec is None else
                 {k: plan_rec[k] for k in ("mesh_axes", "role_cuts",
                                           "total_bytes", "solve_time")}),
        "first_loss": hist[0]["loss"] if hist else None,
        "last_loss": hist[-1]["loss"] if hist else None,
        "tokens_per_step": tokens_per_step,
        "mean_step_s": mean_step,
        "tokens_per_s": tokens_per_step / mean_step if step_s else 0.0,
        "breakdown_s": out["breakdown_s"],
        "losses": [h["loss"] for h in hist],
    }


def _rank_main(rank: int, world: int, argv: List[str],
               plan_rec: Optional[Dict[str, Any]]) -> None:
    main(argv, plan_rec)


def main(argv: Optional[Sequence[str]] = None,
         plan_rec: Optional[Dict[str, Any]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = build_argparser()
    args = ap.parse_args(argv)
    if args.plan and not args.mesh:
        ap.error("--plan requires --mesh (the plan places the state on a "
                 "mesh)")
    if not args.mesh:
        return _report(args, run(args))
    import torch.distributed as dist

    from .mesh import init_distributed, spawn
    device = resolve_device(args.device)
    world = 1
    for s in args.mesh.lower().split("x"):
        world *= int(s)
    if not dist.is_initialized() and "RANK" not in os.environ:
        # no launcher: start the ranks here, each running this main; the
        # plan is solved (or read from the cache) once, here, and handed
        # to every rank, so no rank solves it again
        if args.plan == "auto":
            cfg = get_arch(args.arch)
            shape = [int(s) for s in args.mesh.lower().split("x")]
            plan_rec = solve_train_plan(
                args, cfg.reduced() if args.reduced else cfg, shape,
                ("data", "model")[:len(shape)])
        spawn(_rank_main, world, device.type, (argv, plan_rec))
        return 0
    ours = not dist.is_initialized()
    init_distributed(device.type)
    try:
        rec = run(args, plan_rec=plan_rec)
        return _report(args, rec) if rec["meta"]["rank"] == 0 else 0
    finally:
        if ours:
            dist.destroy_process_group()


def _report(args: argparse.Namespace, rec: Dict[str, Any]) -> int:
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
