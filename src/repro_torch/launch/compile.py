"""Plan solve with an on-disk record cache (the port's counterpart of
``repro.launch.compile``'s ``plan_cache_path`` / ``solve_cell_plan`` /
``plan_from_record``).

A record holds the solved role cuts and the solver's byte and second
totals (and, with a compute term, the plan's compute seconds).  It has no
``breakdown`` (repro's as-executed wire-byte attribution): that needs the
calibration projection of a verify layer the port does not have yet."""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional, Sequence

from ..configs.base import ArchConfig, ShapeConfig
from ..core.builders import build_graph
from ..core.plan import ShardingPlan
from ..core.solver import (MeshAxis, solution_compute_seconds, solve_mesh,
                           solve_mesh_capacity)
from ..obs.tracing import span as _span

CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         ".cache", "plans_torch")


def plan_cache_path(arch: str, shape: str, mesh_name: str) -> str:
    os.makedirs(CACHE_DIR, exist_ok=True)
    return os.path.join(CACHE_DIR, f"{arch}_{shape}_{mesh_name}.json")


def solve_cell_plan(cfg: ArchConfig, shape: ShapeConfig,
                    axes: Sequence[MeshAxis], mesh_name: str,
                    use_cache: bool = True, capacity: bool = False,
                    beam="auto",
                    graph_kwargs: Optional[Dict[str, Any]] = None,
                    compute=None) -> Dict[str, Any]:
    """Solve (or load from cache) the tiling plan record for one cell on
    explicit solver axes (repro's ``solve_cell_plan``).  ``graph_kwargs``
    go to ``build_graph`` (the trainer solves with ``master_fp32`` /
    ``error_feedback`` as it runs; the caller folds the flags into
    ``mesh_name``, ``_mp`` / ``_ef``, so cache entries stay distinct).
    ``capacity`` solves with ``solve_mesh_capacity``'s escalation (the
    card's 80 GB budget and penalty).  ``compute``: a
    ``core.costterms.ComputeConfig`` making the solve kernel-aware; its
    ``token()`` is folded into the cache key."""
    if compute is not None:
        mesh_name = f"{mesh_name}_{compute.token()}"
    path = plan_cache_path(cfg.name, shape.name, mesh_name)
    if use_cache and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    g = build_graph(cfg, shape, **(graph_kwargs or {}))
    t0 = time.time()
    with _span("compile.solve_plan", arch=cfg.name, shape=shape.name,
               mesh=mesh_name):
        if capacity:
            sol = solve_mesh_capacity(g, axes, beam=beam, compute=compute)
        else:
            sol = solve_mesh(g, axes, beam=beam, compute=compute)
    plan = ShardingPlan.from_graph_solution(sol, g)
    rec = {
        "mesh_axes": list(plan.mesh_axis_names),
        "role_cuts": plan.role_cuts,
        "total_bytes": sol.total_bytes,
        "per_axis_bytes": sol.per_axis_bytes,
        "total_seconds": sol.total_seconds,
        "solve_time": time.time() - t0,
    }
    if compute is not None:
        rec["compute_seconds"] = solution_compute_seconds(
            g, axes, sol.per_axis, compute)
    tmp = f"{path}.{os.getpid()}.tmp"   # ranks may solve the same cell
    with open(tmp, "w") as f:
        json.dump(rec, f, indent=1)
    os.replace(tmp, path)
    return rec


def plan_from_record(rec: Dict[str, Any]) -> ShardingPlan:
    return ShardingPlan(tuple(rec["mesh_axes"]),
                        {r: dict(c) for r, c in rec["role_cuts"].items()})
