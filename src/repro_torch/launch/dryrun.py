"""Production-mesh dry run (the port's counterpart of
``repro.launch.dryrun``): for every (architecture x input shape x mesh),
solve the tiling on repro's production meshes, trace the step the cell
runs on meta tensors under the plan, and record its per-device FLOPs,
HBM bytes, collectives, peak bytes and three-term roofline at H100
constants.

The mesh is a fake process group of 256 (``--mesh single``, (16, 16)) or
512 (``--mesh multi``, (2, 16, 16)) ranks in this process
(``launch/mesh.make_production_mesh``): its device is ``meta``, said
explicitly, and no rank runs.  repro lowers and compiles the step with
XLA; the port traces it (``analysis/cost_trace``), and ``trace_s``
stands for repro's ``lower_s`` / ``compile_s``.

Depth: the port's trace counts every layer and every step of a Python
loop, so one full-depth trace gives the per-device terms directly, and
repro's two shallow probes extrapolated linearly in depth (XLA counts a
scan body once) have no counterpart: the largest cell traces in seconds
on the CPU, and a train step's peak is not linear in depth.  The record
keeps repro's ``probe_depths`` / ``probe_flops`` keys, each None.
The sLSTM loop is traced step by step, so repro's ``_slstm_correction``
(the S - 1 scan steps XLA does not count) has no counterpart: the
record's FLOPs mean what repro's do without it (``tests/
test_torch_dryrun.py``), and neither does ``_batch_shard``, which only
that correction used.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape train_4k --mesh single            # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out experiments/dryrun_torch            # the full table
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

from ..analysis import roofline as rf
from ..configs.base import ASSIGNED, SHAPES, ArchConfig, get_arch
from .compile import (normalize_moe_plan, plan_from_record,  # noqa: F401
                      solve_plan)
from .mesh import make_production_mesh, production_axes

MEMORY_ANALYSIS = ("cost_trace live-bytes tally: state + the step's tensors "
                   "at their peak")


def trace_cell(cfg: ArchConfig, shape, plan, multi_pod: bool):
    """Trace ``cfg``'s step for ``shape`` under ``plan`` on a production
    mesh made for the call and torn down after it: (StepCost, n_devices).
    """
    import torch.distributed as dist

    from ..analysis.cost_trace import trace_step
    mesh = make_production_mesh(multi_pod=multi_pod)
    try:
        return trace_step(cfg, shape, plan, mesh), mesh.size()
    finally:
        dist.destroy_process_group()


def analyze_cell(cfg: ArchConfig, shape, plan, multi_pod: bool,
                 mesh_name: str):
    """The cell's ``Roofline`` from one full-depth trace, and the trace
    seconds."""
    axis_bw = {a.name: a.bandwidth for a in production_axes(multi_pod)}
    cost, n = trace_cell(cfg, shape, plan, multi_pod)
    roof = rf.analyze(cost, n, rf.model_train_flops(cfg, shape), cfg.name,
                      shape.name, mesh_name, axis_bw)
    return roof, cost.trace_s


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = None,
             use_cache: bool = True,
             capacity: bool = False) -> Dict[str, Any]:
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    mesh_name = "pod2" if multi_pod else "pod1"
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped",
               "reason": "full-attention arch: long_500k needs "
                         "sub-quadratic attention (DESIGN.md)"}
        _write(out_dir, rec)
        return rec

    prec = solve_plan(cfg, shape, multi_pod, use_cache, capacity)
    plan = normalize_moe_plan(plan_from_record(prec), cfg)
    roof, trace_s = analyze_cell(cfg, shape, plan, multi_pod, mesh_name)
    roof.ideal_bytes_per_dev = _ideal_bytes(cfg, shape, roof.n_devices)
    rec = dict(roof.to_dict(), status="ok", trace_s=trace_s,
               memory_analysis=MEMORY_ANALYSIS,
               solver_bytes=prec["total_bytes"],
               solver_per_axis=prec["per_axis_bytes"], probe_depths=None,
               probe_flops=None)
    _write(out_dir, rec)
    return rec


def _ideal_bytes(cfg: ArchConfig, shape, n_dev: int) -> float:
    """The compulsory-traffic bound for the memory term (repro's)."""
    from ..models.model import LM
    params_b = rf.tree_bytes(LM(cfg).param_shapes())
    if shape.kind == "decode":
        state_b = rf.tree_bytes(LM(cfg).cache_shapes(shape.global_batch,
                                                     shape.seq_len))
    elif shape.kind == "train":
        state_b = params_b * 4.0   # fp32 m+v over bf16 params
    else:
        state_b = 0.0
    return rf.ideal_step_bytes(params_b, state_b, shape.kind, n_dev)


def run_one_device(arch: str, shape, microbatches: int = 1,
                   out_dir: Optional[str] = None) -> Dict[str, Any]:
    """A cell on one device with no plan and no process group, as the
    card's own runs go (``launch.train`` without ``--mesh``): the same
    record as ``run_cell``'s, mesh ``one``, no solver terms.  ``shape``
    is a ``ShapeConfig``; ``microbatches`` splits a train step as the
    engine does."""
    from ..analysis.cost_trace import trace_step
    cfg = get_arch(arch)
    cost = trace_step(cfg, shape, None, None, microbatches)
    roof = rf.analyze(cost, 1, rf.model_train_flops(cfg, shape), arch,
                      shape.name, "one")
    roof.ideal_bytes_per_dev = _ideal_bytes(cfg, shape, 1)
    rec = dict(roof.to_dict(), status="ok", trace_s=cost.trace_s,
               memory_analysis=MEMORY_ANALYSIS, solver_bytes=None,
               solver_per_axis=None, probe_depths=None, probe_flops=None)
    _write(out_dir, rec)
    return rec


def _write(out_dir, rec):
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both", "one"],
                    default="single",
                    help="one: one device, no plan (the card's own runs)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--capacity", action="store_true",
                    help="capacity-aware (dual-ascent) tiling solve")
    ap.add_argument("--batch", type=int, default=None,
                    help="--mesh one: the cell's batch in place of the "
                         "shape's")
    ap.add_argument("--seq", type=int, default=None,
                    help="--mesh one: the cell's sequence length")
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args(argv)
    if args.mesh == "one":
        if not (args.arch and args.shape):
            ap.error("--mesh one needs --arch and --shape")
        base = SHAPES[args.shape]
        b = args.batch or base.global_batch
        s = args.seq or base.seq_len
        name = (base.name if (b, s) == (base.global_batch, base.seq_len)
                else f"{base.kind}_{b}x{s}")
        shape = dataclasses.replace(base, name=name, global_batch=b,
                                    seq_len=s)
        rec = run_one_device(args.arch, shape, args.microbatches, args.out)
        print(json.dumps(rec))
        return

    cells = []
    archs = ASSIGNED if args.all or not args.arch else [args.arch]
    shapes = (["train_4k", "prefill_32k", "decode_32k", "long_500k"]
              if args.all or not args.shape else [args.shape])
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.mesh]
    for a in archs:
        for s in shapes:
            for mp in pods:
                cells.append((a, s, mp))

    failures = 0
    for a, s, mp in cells:
        mesh_name = "pod2" if mp else "pod1"
        out_path = os.path.join(args.out, f"{a}_{s}_{mesh_name}.json")
        if args.skip_existing and os.path.exists(out_path):
            print(f"[skip existing] {a} {s} {mesh_name}")
            continue
        t0 = time.time()
        try:
            rec = run_cell(a, s, mp, args.out,
                           use_cache=not args.no_cache,
                           capacity=args.capacity)
            status = rec["status"]
            extra = ""
            if status == "ok":
                extra = (f"dom={rec['dominant']} "
                         f"tc={rec['t_compute']:.3e} "
                         f"tm={rec['t_memory']:.3e} "
                         f"tx={rec['t_collective']:.3e} "
                         f"frac={rec['roofline_fraction']:.2f} "
                         f"trace={rec['trace_s']:.1f}s")
            print(f"[{status}] {a} {s} {mesh_name} "
                  f"({time.time()-t0:.0f}s) {extra}", flush=True)
        except Exception as e:
            failures += 1
            traceback.print_exc()
            _write(args.out, {"arch": a, "shape": s,
                              "mesh": mesh_name, "status": "error",
                              "error": str(e)})
            print(f"[ERROR] {a} {s} {mesh_name}: {e}", flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
