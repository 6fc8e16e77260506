"""Training harness: drives the training engine (``train/engine.py``)
through the training loop (``runtime/train_loop.py``) over the synthetic
pipeline and reports tokens/s with a step-time breakdown (counterpart of
``repro.launch.train``).

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
  # observed: a trace, the metrics registry, a step SLO that an injected
  # stall breaks (the straggler event, flight records in --flight-dir):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --device cpu --steps 6 --trace-out /tmp/train.trace.json \\
      --metrics-out /tmp/train.jsonl --slo-step-ms 500 \\
      --inject-spike-ms 800 --inject-at 3 --inject-steps 1
  # the joint pipeline plan of 2 stages reported for a 2x2 mesh of 4
  # gloo ranks, which then train on the flat plan (the stage solve takes
  # minutes on a CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --reduced --device cpu --mesh 2x2 --plan auto --stages 2 --steps 3 \\
      --batch 4 --seq 16 --microbatches 2

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
trains unsharded, as repro does, and says so.

Observation (repro's flags): ``--trace-out`` (the ``train.*`` spans),
``--metrics-out`` (the registry: the step-time breakdown, the drift
gauges), ``--slo-step-ms`` (a p95 step-time objective; it turns on the
continuous monitor, a flight recorder writing into ``--flight-dir``, the
replan advisor under ``--plan auto``, and the straggler watchdog:
``TrainConfig.straggler_timeout_s`` at the same target, whose callback
logs the step), ``--inject-spike-ms`` / ``--inject-at`` /
``--inject-steps`` (a stall after the step dispatch, inside the step's
timed interval), ``--min-step-tput`` (a throughput gate), and under
``--plan auto`` the drift check: the first training step's collectives
(``analysis/comm.record`` around it) against the plan record's
predicted bytes, judged after the run, unless ``--no-drift``.  A monitor or
a straggler timeout makes every step a flush boundary (one device
synchronise a step, ``runtime/train_loop``); without them the loop and
its losses are as before.  Under a mesh only rank 0 traces and keeps
the registry, the monitor, the recorder and the advisor.

``--stages auto|N`` (with ``--mesh``) solves the joint pipeline stage
cuts and per-stage tilings (``core/solver.solve_pipeline``, n_micro =
``--microbatches``, repro's call) and reports the pipeline plan, as
repro does: the record's ``pipeline``.  The run then trains on the flat
plan, as repro's does (the stage runner,
``runtime/pipeline_parallel.PipelineTrainer``, executes homogeneous
layer stacks, not a whole model)."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from .. import obs
from ..configs.base import ArchConfig, get_arch
from ..data.pipeline import DataConfig
from ..models.common import resolve_device
from ..models.model import LM
from ..optim.adamw import AdamWConfig
from ..runtime.train_loop import TrainConfig, train
from . import observe


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
    ap.add_argument("--stages", default=None, metavar="auto|N",
                    help="jointly solve pipeline stage cuts + per-stage "
                         "tilings for the mesh (bubble-aware, n_micro = "
                         "--microbatches) and report the hybrid plan; "
                         "'auto' searches every stage carving, N pins "
                         "the stage count.  The run proceeds with the "
                         "flat plan (the stage runner executes "
                         "homogeneous layer stacks)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome/Perfetto trace of the run "
                         "(data wait / step / sync / ckpt spans)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the run's metrics registry as JSONL "
                         "(step-time breakdown, drift gauges)")
    ap.add_argument("--no-drift", action="store_true",
                    help="skip the predicted-vs-measured wire-byte drift "
                         "check (drift needs --plan auto)")
    ap.add_argument("--min-step-tput", type=float, default=None,
                    help="exit non-zero unless steady-state tokens/s "
                         "exceeds this")
    ap.add_argument("--slo-step-ms", type=float, default=None,
                    help="per-step wall-time SLO target in ms (p95 "
                         "objective; enables the continuous monitor and "
                         "the straggler watchdog at this target)")
    ap.add_argument("--flight-dir", default="flight",
                    help="directory for flight-<trigger>.json dumps")
    ap.add_argument("--inject-spike-ms", type=float, default=0.0,
                    help="fault injection: stall this long after the step "
                         "dispatch in the injection window")
    ap.add_argument("--inject-at", type=int, default=4,
                    help="step the injection window starts at")
    ap.add_argument("--inject-steps", type=int, default=20,
                    help="injection window length in steps")
    return ap


def _flags(args: argparse.Namespace) -> str:
    return ("" if args.no_master_fp32 else "_mp") + \
        ("_ef" if args.grad_compression else "")


def _graph_kwargs(args: argparse.Namespace) -> Dict[str, bool]:
    return {"master_fp32": not args.no_master_fp32,
            "error_feedback": args.grad_compression}


def solve_train_plan(args: argparse.Namespace, cfg: ArchConfig,
                     shape: Sequence[int], names: Sequence[str]):
    """The train plan record for ``args`` on a mesh of ``shape`` (repro's
    ``launch.train`` solve: the cache name folds in the master / error
    feedback flags, the graph carries their state)."""
    from ..configs.base import ShapeConfig
    from .compile import solve_cell_plan
    from .mesh import solver_axes
    tag = "r" if args.reduced else ""
    return solve_cell_plan(
        cfg, ShapeConfig(f"train{tag}{args.batch}x{args.seq}", args.seq,
                         args.batch, "train"),
        solver_axes(shape, names),
        mesh_name=f"mesh{args.mesh}{_flags(args)}",
        graph_kwargs=_graph_kwargs(args))


def solve_stages(args: argparse.Namespace, cfg: ArchConfig,
                 beam="auto") -> Dict[str, Any]:
    """repro's ``--stages`` solve on the mesh's solver axes: the pipeline
    record (stage count, cuts, bubble factor, modeled step against the
    best flat one).  ``beam``: the solver's (a reduced config's solve at
    "auto" takes minutes on a CPU, at 32 seconds)."""
    from ..configs.base import ShapeConfig
    from ..core.builders import build_graph
    from ..core.solver import solve_pipeline
    from .mesh import solver_axes
    shape = [int(s) for s in args.mesh.lower().split("x")]
    g = build_graph(cfg, ShapeConfig(f"stages{args.batch}x{args.seq}",
                                     args.seq, args.batch, "train"),
                    master_fp32=not args.no_master_fp32)
    n_micro = max(1, args.microbatches)
    counts = None if args.stages == "auto" else (1, int(args.stages))
    t0 = time.time()
    psol = solve_pipeline(g, solver_axes(shape, ("data", "model")[
        :len(shape)]), n_micro=n_micro, stage_counts=counts, beam=beam,
        mem_scale=0.0)
    return {
        "n_stages": psol.n_stages,
        "cuts": psol.cuts,
        "n_micro": n_micro,
        "bubble_factor": psol.bubble_factor,
        "modeled_step_s": psol.total_seconds,
        "flat_step_s": psol.candidates.get(1, float("inf")),
        "candidates_ms": {str(k): v * 1e3
                          for k, v in psol.candidates.items()},
        "solve_s": time.time() - t0,
    }


def _monitor(args, cfg, registry, plan_rec):
    """The step SLO's monitor, recorder and advisor
    (``observe.make_monitor``)."""
    from .compile import solve_observed_regime
    slos = []
    if args.slo_step_ms is not None:
        slos.append(obs.SLO("step", target=args.slo_step_ms / 1e3))

    def solve_regime(axes, regime):
        return solve_observed_regime(
            cfg, axes, f"mesh{args.mesh}{_flags(args)}", regime,
            batch=args.batch, seq_len=args.seq,
            graph_kwargs=_graph_kwargs(args))

    return observe.make_monitor(args, slos, registry, plan_rec,
                                solve_regime, regime_fn=lambda: "train")


def run(args: argparse.Namespace, cfg: Optional[ArchConfig] = None,
        plan_rec: Optional[Dict[str, Any]] = None,
        pipeline_rec: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Train as ``args`` say and return the record (the fields of repro's
    launch record that this port has).  ``cfg``, if given, is trained in
    place of ``--arch``'s config (a depth cut of it, say).  With
    ``--mesh`` the default process group must be up (``main`` brings it
    up, or spawns the ranks); ``plan_rec`` / ``pipeline_rec``, if given,
    are the records ``--plan auto`` / ``--stages`` take in place of
    solving (those the parent solved before it spawned the ranks)."""
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
        rank = dist.get_rank()
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    if args.stages:
        if pipeline_rec is None:
            pipeline_rec = solve_stages(args, cfg)
        if rank == 0:
            _print_stages(pipeline_rec)
    if args.mesh:
        from .compile import plan_from_record
        from .mesh import make_mesh
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
    # rank 0 owns the trace, the registry, the monitor and its recorder
    if args.trace_out and rank == 0:
        obs.enable(args.trace_out)
    registry = obs.Registry() if rank == 0 else None
    monitor = recorder = advisor = None
    if rank == 0:
        monitor, recorder, advisor = _monitor(args, cfg, registry, plan_rec)
    model = LM(cfg)
    tcfg = TrainConfig(
        steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        log_every=args.log_every, warmup=args.warmup,
        grad_compression=args.grad_compression,
        straggler_timeout_s=(None if args.slo_step_ms is None
                             else args.slo_step_ms / 1e3),
        optim=AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                          total_steps=args.steps),
        microbatches=args.microbatches, buckets=args.buckets,
        master_fp32=master_fp32)
    dcfg = DataConfig(seed=args.seed, vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    drift = plan is not None and not args.no_drift
    stragglers: List[Dict[str, float]] = []

    def straggler_cb(step: int, sec: float) -> None:
        # a multi-host deployment would re-dispatch the slow host; here
        # the event is logged and kept in the record
        stragglers.append({"step": step, "sec": sec})
        if rank == 0:
            print(f"straggler: step {step} took {sec * 1e3:.1f} ms > "
                  f"{args.slo_step_ms:.1f} ms")

    step_hook = None
    if args.inject_spike_ms:
        lo, hi = args.inject_at, args.inject_at + args.inject_steps

        def step_hook(step: int) -> None:
            if lo <= step < hi:
                time.sleep(args.inject_spike_ms / 1e3)

    out = train(model, dcfg, tcfg, device=device, mesh=mesh, plan=plan,
                straggler_cb=straggler_cb, monitor=monitor,
                step_hook=step_hook, collectives=drift)
    drift_rec = None
    if drift and out["collectives"] is not None and rank == 0:
        drift_rec = observe.check_drift(plan_rec, out["collectives"],
                                        mesh.size(), registry, monitor)
    hist = out["history"]
    n_meas = max(1, out["measured_steps"])
    step_s = out["breakdown_s"]["step"]
    mean_step = step_s / n_meas
    tokens_per_step = args.batch * args.seq
    tput = tokens_per_step / mean_step if step_s else 0.0
    rec = {
        "meta": {
            "arch": cfg.name, "reduced": args.reduced, "batch": args.batch,
            "seq": args.seq, "steps": len(hist),
            "microbatches": args.microbatches, "buckets": args.buckets,
            "grad_compression": args.grad_compression,
            "master_fp32": master_fp32,
            "device": _device_name(device),
            "measured_steps": out["measured_steps"], "mesh": args.mesh,
            "plan": args.plan, "stages": args.stages, "rank": rank,
        },
        "plan": (None if plan_rec is None else
                 {k: plan_rec[k] for k in ("mesh_axes", "role_cuts",
                                           "total_bytes", "solve_time")}),
        "first_loss": hist[0]["loss"] if hist else None,
        "last_loss": hist[-1]["loss"] if hist else None,
        "tokens_per_step": tokens_per_step,
        "mean_step_s": mean_step,
        "tokens_per_s": tput,
        "breakdown_s": out["breakdown_s"],
        "losses": [h["loss"] for h in hist],
        "predicted_wire_bytes": (plan_rec or {}).get("total_bytes"),
        "drift": drift_rec,
        "pipeline": pipeline_rec,
        "stragglers": stragglers,
    }
    if rank:
        return rec
    # registry sinks: each measured step's time, the breakdown gauges,
    # throughput, and the solver's memo-cache counters from the global
    # registry
    for h in hist[len(hist) - out["measured_steps"]:]:
        registry.histogram("train.step_s").observe(h["sec"])
    registry.gauge("train.tokens_per_s").set(tput)
    registry.gauge("train.mean_step_s").set(mean_step)
    registry.gauge("train.data_s").set(out["breakdown_s"]["data"])
    registry.gauge("train.step_total_s").set(step_s)
    registry.gauge("train.ckpt_s").set(out["breakdown_s"]["ckpt"])
    for m in obs.default_registry().collect():
        if m["name"].startswith("solver.") and m["type"] == "counter":
            registry.counter(m["name"]).inc(m["value"])
    if monitor is not None:
        observe.finish_monitor(rec, monitor, recorder, advisor)
    observe.write_sinks(args, registry)
    return rec


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _print_stages(p: Dict[str, Any]) -> None:
    """repro's report of the pipeline plan."""
    print(f"pipeline plan ({p['solve_s']:.1f}s): {p['n_stages']} stage(s), "
          f"cuts {p['cuts']}, bubble x{p['bubble_factor']:.3f}")
    if p["n_stages"] > 1:
        print(f"  modeled {p['modeled_step_s'] * 1e3:.3f} ms vs best flat "
              f"{p['flat_step_s'] * 1e3:.3f} ms "
              f"(x{p['flat_step_s'] / p['modeled_step_s']:.2f}); this run "
              f"proceeds with the flat plan (the stage runner executes "
              f"homogeneous stacks)")
    elif p["n_micro"] == 1:
        print("  flat plan wins (with --microbatches 1 the bubble factor "
              "equals the stage count)")


def _rank_main(rank: int, world: int, argv: List[str],
               plan_rec: Optional[Dict[str, Any]],
               pipeline_rec: Optional[Dict[str, Any]]) -> None:
    main(argv, plan_rec, pipeline_rec)


def main(argv: Optional[Sequence[str]] = None,
         plan_rec: Optional[Dict[str, Any]] = None,
         pipeline_rec: Optional[Dict[str, Any]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = build_argparser()
    args = ap.parse_args(argv)
    if args.plan and not args.mesh:
        ap.error("--plan requires --mesh (the plan places the state on a "
                 "mesh)")
    if args.stages and not args.mesh:
        ap.error("--stages requires --mesh")
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
        # plans are solved (or read from the cache) once, here, and handed
        # to every rank, so no rank solves them again
        cfg = get_arch(args.arch)
        cfg = cfg.reduced() if args.reduced else cfg
        if args.plan == "auto":
            shape = [int(s) for s in args.mesh.lower().split("x")]
            plan_rec = solve_train_plan(args, cfg, shape,
                                        ("data", "model")[:len(shape)])
        if args.stages:
            pipeline_rec = solve_stages(args, cfg)
        spawn(_rank_main, world, device.type, (argv, plan_rec, pipeline_rec))
        return 0
    ours = not dist.is_initialized()
    init_distributed(device.type)
    try:
        rec = run(args, plan_rec=plan_rec, pipeline_rec=pipeline_rec)
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
    if args.slo_step_ms is not None:
        print(f"  {len(rec['stragglers'])} straggler(s) over "
              f"{args.slo_step_ms:.1f} ms")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"metrics -> {args.json_out}")
    if args.min_step_tput is not None:
        if not rec["losses"]:
            print("step throughput gate skipped (no steps ran)")
            return 0
        if rec["tokens_per_s"] < args.min_step_tput:
            print(f"FAIL: step throughput {rec['tokens_per_s']} < "
                  f"{args.min_step_tput}")
            return 1
        print(f"step throughput gate ok "
              f"({rec['tokens_per_s']:.1f} >= {args.min_step_tput})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
