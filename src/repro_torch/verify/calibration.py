"""Cost-model calibration (the port's ``repro.verify.calibration``):
solver-predicted wire bytes against the collectives the executed step
issues, per conformance cell.

Pipeline per cell (the same builders, solver and steps as the dry run and
the launchers):

  1. build the semantic graph, solve the tiling on mesh-matched axes
  2. predicted bytes = ``solution_breakdown`` of the *as-executed*
     projection of the solved tiling (``faithful_assignments``; for
     training, ``train_cell.train_faithful_assignments``): communication
     only, system-wide, by collective kind and tensor role
  3. run the sharded step once on the verification mesh's 8 ranks under
     ``analysis/comm.record``; measured bytes = this rank's ring wire
     bytes x N_DEVICES (``_measure``)
  4. run the pure-data-parallel baseline plan's step and measure it too
  5. differential numerics (numerics.py) for the solved plan

repro lowers and compiles the step and parses its HLO (``compile_step``,
``analysis/hlo.collect``).  The port has no compiled program: the
measured step is the executed one, the step ``analysis/cost_trace.
build_step`` builds (the dry run's) on real tensors.

Gates (tolerances declared here, repro's):

  calibration   measured/predicted in [RATIO_LO, RATIO_HI], or both sides
                under ABS_FLOOR ("no meaningful communication" cells)
  dp-no-worse   measured(solved) <= measured(pure-DP) x DP_SLACK +
                ABS_FLOOR, on train cells, where gradient sync makes
                communication mandatory
  numerics      sharded == serial within the numerics bands

Stdlib-only at import (the port's ``core`` is; ``obs/drift`` reads the
bands from here); torch comes in with the functions that run steps.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

from ..configs.base import ArchConfig
from ..core.builders import build_graph
from ..core.plan import ShardingPlan
from ..core.solver import (MeshAxis, TilingSolution, composed_cost,
                           data_parallel_assignment, solution_breakdown,
                           solve_mesh)
from ..core.tiling import Part, REPLICATE
from ..obs.tracing import span as _span
from .cells import CellSpec, MESH_AXES, MESH_SHAPE, N_DEVICES

# declared calibration tolerance bands (repro's)
RATIO_LO = 0.25      # measured may undershoot: moves fused or elided
RATIO_HI = 4.0       # or overshoot: resharding the model does not see
ABS_FLOOR = 256e3    # bytes; below this a cell is "no communication"
# measured dp gate: the executed step moves bytes the ring model does
# not see (an execution tax); the solved plan must stay within this band
# of measured pure-DP.  The predicted comparison is gated strictly: DP is
# inside the solver's search space, so predicted(solved) > predicted(DP)
# can only be a search regression.
DP_SLACK = 1.35


def verify_axes() -> List[MeshAxis]:
    """Solver axes of the verification mesh at the port's link rates
    (``launch/mesh.solver_axes``: every axis of one host on NVLink)."""
    from ..launch.mesh import solver_axes
    return solver_axes(MESH_SHAPE, MESH_AXES)


def _moe_pins(g, cfg: ArchConfig,
              axes: Sequence[MeshAxis]) -> Optional[Dict[str, dict]]:
    """Pin MoE expert-weight tilings to the layout the MoE layer runs
    (``launch/compile.normalize_moe_plan``), so predicted and measured
    steps agree on the expert placement."""
    from ..launch.compile import expert_parallel_axis

    if cfg.moe is None:
        return None
    roles = ("moe_up", "moe_down", "moe_gate")
    ep_axis = expert_parallel_axis(cfg)
    pins: Dict[str, dict] = {}
    for ax in axes:
        per = {}
        for name, ts in g.tensors.items():
            if ts.role not in roles:
                continue
            if ts.role != "moe_gate" and ax.name == ep_axis:
                per[name] = Part("expert")
            else:
                per[name] = REPLICATE
        pins[ax.name] = per
    return pins


def faithful_assignments(g, per_axis: Sequence[dict]) -> List[dict]:
    """Project per-axis assignments onto what the executed step can
    actually run: gradient and optimizer tensors follow their weight's
    tiling (the grads are internal to the step; only params, optimizer
    state and the batch carry placements).  In the ring model this
    projection is nearly cost-neutral (red→P + P→r ≡ red→r =
    2·s·(A-1)); what it removes is the ZeRO-style sharded-gradient
    accounting the executed step does not perform.  Calibration prices
    THIS assignment."""
    out = []
    for assign in per_axis:
        a = dict(assign)
        for name, ts in g.tensors.items():
            if ts.kind != "weight":
                continue
            w = a.get(name, REPLICATE)
            for der, dts in g.tensors.items():
                if dts.kind == "opt" and der == f"opt:{name}":
                    a[der] = w
                elif dts.kind == "grad" and (
                        der == f"d_{name}" or
                        der.startswith(f"d_{name}#") or
                        der.startswith(f"d_{name}.sum")):
                    a[der] = w
        out.append(a)
    return out


def _dp_solution(g, axes: Sequence[MeshAxis]) -> TilingSolution:
    """Pure data parallelism: batch-partition on the first (data) axis,
    replicate on the rest."""
    dp = data_parallel_assignment(g)
    per_axis = [dp if i == 0 else {t: REPLICATE for t in g.tensors}
                for i in range(len(axes))]
    return TilingSolution(list(axes), per_axis,
                          [0.0] * len(axes), 0.0, 0.0)


def _measure(cfg: ArchConfig, shape, plan: ShardingPlan, mesh,
             n_dev: int = N_DEVICES) -> Dict[str, object]:
    """Run the cell's step once under ``plan`` on ``mesh`` (every rank)
    and price the collectives this rank issued (``analysis/comm.
    record``): the system-wide total is this rank's ring wire bytes x
    ``n_dev``, as ``obs/drift.record_drift`` takes it (an SPMD step
    issues the same collectives on every rank)."""
    import torch

    from ..analysis import comm
    from ..analysis.cost_trace import build_step
    from .numerics import mesh_device

    step, state, inputs = build_step(cfg, shape, plan, mesh,
                                     device=mesh_device(mesh))
    with torch.no_grad():       # the train step enables grad for its loss
        _, st = comm.record(step, state, inputs, sites=True)
    return {
        "counts": st.counts,
        # the collectives by call site, system-wide wire bytes
        "by_site": [dict(r, wire_bytes=r["wire_bytes"] * n_dev)
                    for r in st.by_site],
        "wire_bytes_per_device": st.wire_bytes_per_device,
        "wire_bytes_total": st.wire_bytes_per_device * n_dev,
        "wire_by_kind_total": {k: v * n_dev
                               for k, v in st.wire_by_kind.items()},
    }


def calibration_pass(predicted: float, measured: float) -> Dict[str, object]:
    """Within-band when the ratio fits, or when both sides are under the
    absolute floor (cells whose whole traffic is small fixed overhead)."""
    rec: Dict[str, object] = {"band": [RATIO_LO, RATIO_HI],
                              "floor_bytes": ABS_FLOOR}
    if predicted > 0:
        rec["ratio"] = measured / predicted
    in_band = predicted > 0 and \
        RATIO_LO <= measured / predicted <= RATIO_HI
    under_floor = predicted <= ABS_FLOOR and \
        measured <= ABS_FLOOR * RATIO_HI
    rec["mode"] = "ratio" if in_band or not under_floor else "floor"
    rec["ok"] = bool(in_band or under_floor)
    return rec


def run_cell(spec: CellSpec, mesh=None, *, numerics: bool = True,
             baseline: bool = True) -> Dict[str, object]:
    """Full conformance record for one cell.  ``mesh``: the verification
    mesh (made from MESH_SHAPE over the default process group when
    omitted: 8 ranks, see __main__)."""
    with _span("verify.cell", cell=spec.name, kind=spec.kind):
        return _run_cell_impl(spec, mesh, numerics=numerics,
                              baseline=baseline)


def _run_cell_impl(spec: CellSpec, mesh=None, *, numerics: bool = True,
                   baseline: bool = True) -> Dict[str, object]:
    from ..launch.compile import normalize_moe_plan

    cfg = spec.cfg()
    shape = spec.shape()
    axes = verify_axes()
    n_dev = N_DEVICES
    if mesh is None:
        from ..launch.mesh import make_mesh
        mesh = make_mesh(MESH_SHAPE, MESH_AXES, "cpu")
    rec: Dict[str, object] = {
        "cell": spec.name, "arch": spec.arch, "family": spec.family,
        "kind": spec.kind,
        "mesh": dict(zip(MESH_AXES, MESH_SHAPE)),
        "reduced_config": {"n_layers": cfg.n_layers,
                           "d_model": cfg.d_model,
                           "seq_len": shape.seq_len,
                           "global_batch": shape.global_batch},
    }
    try:
        t0 = time.time()
        g = build_graph(cfg, shape)
        sol = solve_mesh(g, axes, fixed_per_axis=_moe_pins(g, cfg, axes))
        predicted_raw = composed_cost(g, axes, sol.per_axis)
        executed = faithful_assignments(g, sol.per_axis)
        breakdown = solution_breakdown(g, axes, executed)
        rec["solve_s"] = time.time() - t0
        rec["predicted"] = {
            "wire_bytes_total": breakdown["total"],
            "raw_solver_bytes": predicted_raw,
            "by_kind": breakdown["by_kind"],
            "by_role": breakdown["by_role"],
            "by_axis": breakdown["by_axis"],
        }

        exec_sol = TilingSolution(list(axes), executed,
                                  [0.0] * len(axes), 0.0, 0.0)
        plan = normalize_moe_plan(
            ShardingPlan.from_graph_solution(exec_sol, g), cfg)
        t0 = time.time()
        rec["measured"] = _measure(cfg, shape, plan, mesh, n_dev)
        rec["exec_s"] = time.time() - t0

        rec["calibration"] = calibration_pass(
            breakdown["total"], rec["measured"]["wire_bytes_total"])

        if baseline:
            dp_sol = _dp_solution(g, axes)
            dp_bd = solution_breakdown(g, axes, dp_sol.per_axis)
            dp_plan = normalize_moe_plan(
                ShardingPlan.from_graph_solution(dp_sol, g), cfg)
            dp_meas = _measure(cfg, shape, dp_plan, mesh, n_dev)
            solved_m = rec["measured"]["wire_bytes_total"]
            dp_m = dp_meas["wire_bytes_total"]
            # the dp-no-worse gate only bites on train cells, where
            # gradient sync makes communication mandatory and DP is a
            # genuine competitor.  On small-batch decode/prefill cells
            # the capacity term *intentionally* spends wire bytes to
            # avoid replicating weights/caches: DP's zero-wire plan
            # wins a wire-only comparison by paying in memory the
            # measurement cannot see.
            gated = spec.kind == "train"
            rec["dp_baseline"] = {
                "predicted_wire_bytes_total": dp_bd["total"],
                "measured_wire_bytes_total": dp_m,
                "solved_measured": solved_m,
                "slack": DP_SLACK,
                "gated": gated,
                # strict: the solver's own objective must dominate DP
                "predicted_ok": bool(predicted_raw
                                     <= dp_bd["total"] * (1 + 1e-9)),
                "measured_ok": bool(solved_m
                                    <= dp_m * DP_SLACK + ABS_FLOOR),
            }
            rec["dp_baseline"]["ok"] = bool(
                rec["dp_baseline"]["predicted_ok"]
                and rec["dp_baseline"]["measured_ok"])

        if numerics:
            from .numerics import run_numerics
            t0 = time.time()
            rec["numerics"] = run_numerics(cfg, shape, plan, mesh)
            rec["numerics"]["seconds"] = time.time() - t0

        gates = [rec["calibration"]["ok"]]
        if baseline and rec["dp_baseline"]["gated"]:
            gates.append(rec["dp_baseline"]["ok"])
        if numerics:
            gates.append(rec["numerics"]["ok"])
        rec["status"] = "ok" if all(gates) else "fail"
    except Exception as e:
        import traceback
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=8)
    return rec


def run_cells(specs: Sequence[CellSpec], mesh=None, *,
              numerics: bool = True,
              baseline: bool = True,
              verbose: bool = True) -> List[Dict[str, object]]:
    out = []
    for spec in specs:
        t0 = time.time()
        rec = run_cell(spec, mesh, numerics=numerics, baseline=baseline)
        if verbose:
            pred = rec.get("predicted", {}).get("wire_bytes_total")
            meas = rec.get("measured", {}).get("wire_bytes_total")
            ratio = (f"{meas / pred:.2f}x" if pred and meas
                     else "n/a")
            print(f"[{rec['status']}] {spec.name:16s} "
                  f"pred={pred if pred is None else f'{pred:.3e}'} "
                  f"meas={meas if meas is None else f'{meas:.3e}'} "
                  f"ratio={ratio} ({time.time() - t0:.0f}s)",
                  flush=True)
            if rec["status"] == "error":
                print(rec["traceback"], flush=True)
        out.append(rec)
    return out
