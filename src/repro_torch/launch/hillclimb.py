"""Perf-iteration tool (the port's counterpart of
``repro.launch.hillclimb``): re-measure one dry-run cell with the current
code and optional plan overrides or a capacity-escalated solve, and print
the three roofline terms and the step's largest collectives by ring
wire bytes.  The step is traced on meta tensors over a fake process
group of the production mesh (``launch/dryrun``); nothing runs.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --arch qwen2.5-32b --shape train_4k \\
      --capacity --override wq=model:heads --tag iter1
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..analysis import roofline as rf
from ..analysis.comm import ring_wire_bytes
from ..configs.base import SHAPES, get_arch
from ..core.plan import ShardingPlan
from . import dryrun as dr
from .mesh import production_axes


def parse_override(text: str) -> Tuple[str, Dict[str, Optional[str]]]:
    """``role=axis:dim[,axis:dim]`` (dim ``-`` = whole) -> (role, cuts)."""
    role, cuts_s = text.split("=")
    cuts: Dict[str, Optional[str]] = {}
    for part in cuts_s.split(","):
        ax, dim = part.split(":")
        cuts[ax] = None if dim == "-" else dim
    return role, cuts


def apply_overrides(plan: ShardingPlan, overrides: Sequence[str]
                    ) -> ShardingPlan:
    """``plan`` with each override's role cut as given on the named axes
    and whole on the others."""
    for ov in overrides:
        role, cuts = parse_override(ov)
        full = {a: None for a in plan.mesh_axis_names}
        full.update(cuts)
        plan = plan.with_override(role, full)
        print(f"override {role} -> {full}")
    return plan


def top_collectives(ops: Sequence[Tuple[str, float, int]], n: int = 12
                    ) -> List[Tuple[str, float, int, float]]:
    """(kind, per-device result bytes, group size, ring wire bytes) of the
    recorded collectives, largest wire bytes first."""
    out = [(kind, s, g, ring_wire_bytes(kind, s, g)) for kind, s, g in ops
           if not kind.startswith("unpriced")]
    return sorted(out, key=lambda x: -x[3])[:n]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--capacity", action="store_true",
                    help="re-solve with the capacity dual ascent")
    ap.add_argument("--override", action="append", default=[],
                    help="role=axis:dim[,axis:dim]  (dim '-' = None)")
    ap.add_argument("--tag", default="iter")
    ap.add_argument("--out", default="experiments/perf_torch")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    shape = SHAPES[args.shape]
    mesh_name = "pod2" if args.multi_pod else "pod1"
    axes = production_axes(args.multi_pod)

    t0 = time.time()
    plan = dr.plan_from_record(dr.solve_plan(cfg, shape, args.multi_pod,
                                             capacity=args.capacity))
    print(f"plan solve {time.time()-t0:.0f}s (capacity={args.capacity})")
    plan = apply_overrides(dr.normalize_moe_plan(plan, cfg), args.override)
    print("plan:")
    print(plan.describe())

    cost, n_dev = dr.trace_cell(cfg, shape, plan, args.multi_pod)
    roof = rf.analyze(cost, n_dev, rf.model_train_flops(cfg, shape),
                      args.arch, args.shape, mesh_name,
                      {a.name: a.bandwidth for a in axes})

    print(f"\n== {args.arch} {args.shape} {mesh_name} [{args.tag}] ==")
    print(f"tc={roof.t_compute:.3e}  tm={roof.t_memory:.3e}  "
          f"tx={roof.t_collective:.3e}  dom={roof.dominant}  "
          f"mfu_bound={roof.roofline_fraction:.4f}  "
          f"useful={roof.useful_ratio:.3f}")
    print(f"trace {cost.trace_s:.1f}s; persistent/dev = "
          f"{cost.state_bytes/1e9:.2f} GB (params, optimizer state, cache "
          f"and inputs as traced)")
    print("collectives (top by wire bytes):")
    for kind, s, g, wire in top_collectives(cost.ops):
        print(f"  {kind:20s} g={g:<4d} {wire/1e9:8.3f} GB  "
              f"(result {s/1e9:.3f} GB)")

    os.makedirs(args.out, exist_ok=True)
    rec = dict(roof.to_dict(), tag=args.tag, trace_s=cost.trace_s,
               overrides=args.override, capacity=args.capacity)
    path = os.path.join(
        args.out, f"{args.arch}_{args.shape}_{mesh_name}_{args.tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print("saved", path)


if __name__ == "__main__":
    main()
