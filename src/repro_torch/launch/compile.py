"""Plan solve with an on-disk record cache (the port's counterpart of
``repro.launch.compile``'s ``plan_cache_path`` / ``solve_cell_plan`` /
``solve_observed_regime`` / ``plan_from_record``, and of
``expert_parallel_axis`` / ``normalize_moe_plan``, which pin an MoE
plan's expert weights to the layout the MoE layer runs).

A record holds the solved role cuts, the solver's byte and second totals
(and, with a compute term, the plan's compute seconds), and
``breakdown``: the predicted system-wide wire bytes of the as-executed
projection of the solved tiling (``_executed_breakdown``), the drift
gauge's predicted side (``obs/drift``).  A record cached before the
breakdown existed has none; the launchers report it as stale and skip
the drift check, as repro's do.  ``solve_plan`` is the dry run's cell
solve on the production meshes (``launch/mesh.production_axes``), and
``input_specs`` its inputs as ``meta`` stand-ins.  repro's
``compile_step`` (XLA lowering) has no counterpart: the port traces a
step on meta tensors instead (``analysis/cost_trace``)."""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional, Sequence

from ..configs.base import ArchConfig, ShapeConfig
from ..core.builders import build_graph
from ..core.plan import ShardingPlan
from ..core.solver import (MeshAxis, solution_breakdown,
                           solution_compute_seconds, solve_mesh,
                           solve_mesh_capacity)
from ..obs.tracing import span as _span
from .mesh import production_axes

CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         ".cache", "plans_torch")


def plan_cache_path(arch: str, shape: str, mesh_name: str) -> str:
    os.makedirs(CACHE_DIR, exist_ok=True)
    return os.path.join(CACHE_DIR, f"{arch}_{shape}_{mesh_name}.json")


def _executed_breakdown(g, axes, per_axis, kind: str) -> Dict[str, Any]:
    """Predicted system-wide wire bytes of the *as-executed* projection of
    a solved tiling (grads and optimizer state follow what the step can
    actually shard: ``verify/calibration.faithful_assignments``, or
    ``verify/train_cell.train_faithful_assignments`` for a train cell),
    split by collective kind and phase.  Stored in the plan record so a
    launch compares against it without solving again."""
    if kind == "train":
        from ..verify.train_cell import train_faithful_assignments
        executed = train_faithful_assignments(g, per_axis)
    else:
        from ..verify.calibration import faithful_assignments
        executed = faithful_assignments(g, per_axis)
    br = solution_breakdown(g, axes, executed)
    return {"total": br["total"], "by_kind": br["by_kind"],
            "by_phase": br["by_phase"]}


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
        "breakdown": _executed_breakdown(g, axes, sol.per_axis, shape.kind),
    }
    if compute is not None:
        rec["compute_seconds"] = solution_compute_seconds(
            g, axes, sol.per_axis, compute)
    tmp = f"{path}.{os.getpid()}.tmp"   # ranks may solve the same cell
    with open(tmp, "w") as f:
        json.dump(rec, f, indent=1)
    os.replace(tmp, path)
    return rec


def solve_observed_regime(cfg: ArchConfig, axes: Sequence[MeshAxis],
                          mesh_name: str, regime: str,
                          batch: int, seq_len: int,
                          use_cache: bool = True,
                          graph_kwargs: Optional[Dict[str, Any]] = None,
                          compute=None) -> Dict[str, Any]:
    """Solve the cell plan again under an *observed* regime: the replan
    advisor's solver bridge (repro's).  ``regime`` names the cell kind
    whose cost now dominates: a serving run that turned decode-heavy is
    priced as a decode cell over the live slot count and KV length,
    prefill-heavy as a prefill cell over the live prompt shape, and
    training stays a train cell.  The record caches under a
    regime-suffixed name, so advisories do not thrash the plan cache."""
    kind = {"decode-heavy": "decode", "prefill-heavy": "prefill",
            "train": "train"}.get(regime)
    if kind is None:
        raise ValueError(
            f"unknown regime {regime!r} (expected decode-heavy | "
            f"prefill-heavy | train)")
    shape = ShapeConfig(f"observed_{kind}_b{batch}_s{seq_len}",
                        seq_len, batch, kind)
    return solve_cell_plan(cfg, shape, axes, f"{mesh_name}_{regime}",
                           use_cache=use_cache,
                           graph_kwargs=graph_kwargs, compute=compute)


def solve_plan(cfg: ArchConfig, shape: ShapeConfig, multi_pod: bool,
               use_cache: bool = True,
               capacity: bool = False) -> Dict[str, Any]:
    """The production-mesh cell solve (repro's, the dry run's entry
    point): mesh names ``pod1`` / ``pod2``, ``_cap`` with ``capacity``."""
    mesh_name = ("pod2" if multi_pod else "pod1") + \
        ("_cap" if capacity else "")
    return solve_cell_plan(cfg, shape, production_axes(multi_pod),
                           mesh_name, use_cache, capacity)


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The cell's inputs as ``meta`` tensors (repro's ShapeDtypeStruct
    stand-ins, no memory): int32 token ids [B, S] (the data pipeline's
    dtype, repro's too), or bf16 embeds [B, S, D] for an embedding-stub
    config, plus int32 labels [B, S] for a train cell; a decode cell's
    tokens are [B] (embeds [B, D])."""
    import torch
    b, s = shape.global_batch, shape.seq_len

    def meta(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")
    if shape.kind == "decode":
        if cfg.embed_stub:
            return {"tokens": meta(b, cfg.d_model, dtype=torch.bfloat16)}
        return {"tokens": meta(b)}
    specs: Dict[str, Any] = {}
    if cfg.embed_stub:
        specs["embeds"] = meta(b, s, cfg.d_model, dtype=torch.bfloat16)
    else:
        specs["tokens"] = meta(b, s)
    if shape.kind == "train":
        specs["labels"] = meta(b, s)
    return specs


def plan_from_record(rec: Dict[str, Any]) -> ShardingPlan:
    return ShardingPlan(tuple(rec["mesh_axes"]),
                        {r: dict(c) for r, c in rec["role_cuts"].items()})


def expert_parallel_axis(cfg: ArchConfig,
                         axis: str = "model") -> Optional[str]:
    """Mesh axis the MoE layer cuts the expert dim on (expert
    parallelism: the all-to-all of ``models/moe.moe_ffn_sharded``), or
    None when the experts stay whole: at 16 experts or a multiple of 16
    only (repro's rule)."""
    if cfg.moe is not None and cfg.moe.n_experts % 16 == 0:
        return axis
    return None


def normalize_moe_plan(plan: ShardingPlan, cfg: ArchConfig,
                       axis: str = "model") -> ShardingPlan:
    """``plan`` with the MoE roles pinned to the layout the MoE layer
    runs (repro's ``normalize_moe_plan``): the experts' weights
    (``moe_up`` / ``moe_down``) cut on ``expert`` over
    ``expert_parallel_axis`` and whole elsewhere, the router
    (``moe_gate``) whole.  A plan without experts is returned as it is."""
    if cfg.moe is None:
        return plan
    full = {a: None for a in plan.mesh_axis_names}
    ep = dict(full)
    ep_axis = expert_parallel_axis(cfg, axis)
    if ep_axis is not None:
        ep[ep_axis] = "expert"
    for role in ("moe_up", "moe_down"):
        plan = plan.with_override(role, dict(ep))
    return plan.with_override("moe_gate", dict(full))
