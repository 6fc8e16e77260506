"""Kernel-aware compute calibration pseudo-cell (the port's ``repro.
verify.compute_cell``).

The ComputeTerm prices per-op compute time inside the tiling DP; this
cell checks that pricing against the step the port runs, measured the
way the dry run measures it (``analysis/cost_trace`` and
``analysis/roofline``, at the H100's ``roofline.PEAK_FLOPS``):

  1. solve each cell's tiling WITH the compute config enabled
  2. trace the sharded step on the verification mesh's shape (torch's
     fake process group of 8, meta tensors: ``cost_trace.trace_step``)
     and price it with ``roofline.analyze`` — traced FLOPs / peak is the
     measured compute time, ring wire bytes / link rate the measured
     collective time (repro: ``roofline.analyze`` of the compiled HLO)
  3. fit ``calibration`` (measured-over-analytic flops ratio,
     Roofline.compute_calibration) on the FIRST cell only
  4. on every other cell, predicted step time =
     calibration × solution_compute_seconds + predicted wire seconds
     must sit within the standard calibration band of measured
     t_compute + t_collective

The gated comparison deliberately excludes the HBM-traffic roofline
term: the solver models compute and communication, not memory traffic.
The full three-term ``t_step`` is reported ungated for the record.  The
trace needs a process without a default process group (it makes the
fake one and tears it down): the CLI runs this cell before it starts
the ranks.
"""
from __future__ import annotations

import time
from typing import Dict, List

from ..core.builders import build_graph
from ..core.costterms import ComputeConfig
from ..core.plan import ShardingPlan
from ..core.solver import (TilingSolution, solution_breakdown,
                           solution_compute_seconds, solve_mesh)
from .calibration import (RATIO_HI, RATIO_LO, _moe_pins,
                          faithful_assignments, verify_axes)
from .cells import MESH_AXES, MESH_SHAPE, N_DEVICES, get_cells

# first entry fits the calibration; the rest are band-checked with it
CAL_CELLS = ("dense-train", "gqa-prefill", "xlstm-train")


def _axis_seconds(axes, by_axis: Dict[str, float]) -> float:
    """Predicted collective seconds of a composed tiling: each axis'
    weighted bytes (cost × groups) back through the solve_mesh currency
    — one axis-k byte is 1/(bw_k × a_k) seconds, charged per group."""
    total = 0.0
    groups = 1
    for ax in axes:
        total += by_axis.get(ax.name, 0.0) / (groups * ax.bandwidth
                                              * ax.size)
        groups *= ax.size
    return total


def _trace(cfg, shape, plan):
    """The cell's step traced on torch's fake process group of
    N_DEVICES laid out as the verification mesh (this process's default
    group while it runs)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ..analysis.cost_trace import trace_step
    if dist.is_initialized():
        raise RuntimeError("the compute cell traces on a fake process "
                           "group and needs a process without a default "
                           "group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=N_DEVICES)
    try:
        mesh = init_device_mesh("cpu", MESH_SHAPE, mesh_dim_names=MESH_AXES)
        return trace_step(cfg, shape, plan, mesh)
    finally:
        dist.destroy_process_group()


def run_compute_cell(mesh=None) -> Dict[str, object]:
    """``mesh`` is unused (the cell traces on a fake group of its own) —
    accepted for signature parity with the other pseudo-cells."""
    del mesh
    from ..analysis.roofline import PEAK_FLOPS, analyze, model_train_flops
    from ..launch.compile import normalize_moe_plan

    rec: Dict[str, object] = {
        "cell": "compute",
        "mesh": dict(zip(MESH_AXES, MESH_SHAPE)),
        "cells": [],
        "band": [RATIO_LO, RATIO_HI],
    }
    axes = verify_axes()
    axis_bw = {ax.name: ax.bandwidth for ax in axes}
    n_dev = N_DEVICES
    cc = ComputeConfig(peak_flops=PEAK_FLOPS)   # calibration fitted below
    try:
        calibration = None
        gates: List[bool] = []
        for spec in get_cells(list(CAL_CELLS)):
            cfg, shape = spec.cfg(), spec.shape()
            t0 = time.time()
            g = build_graph(cfg, shape)
            sol = solve_mesh(g, axes, compute=cc,
                             fixed_per_axis=_moe_pins(g, cfg, axes))
            executed = faithful_assignments(g, sol.per_axis)
            bd = solution_breakdown(g, axes, executed)
            analytic_sec = solution_compute_seconds(g, axes, executed, cc)
            pred_wire_sec = _axis_seconds(axes, bd["by_axis"])

            exec_sol = TilingSolution(list(axes), executed,
                                      [0.0] * len(axes), 0.0, 0.0)
            plan = normalize_moe_plan(
                ShardingPlan.from_graph_solution(exec_sol, g), cfg)
            rl = analyze(_trace(cfg, shape, plan), n_dev,
                         model_train_flops(cfg, shape), spec.arch,
                         shape.name, "verify", axis_bw=axis_bw)

            analytic_flops_total = analytic_sec * PEAK_FLOPS * n_dev
            if calibration is None:
                calibration = rl.compute_calibration(analytic_flops_total)
                rec["calibration_fit"] = {
                    "cell": spec.name, "calibration": calibration,
                    "measured_flops_per_dev": rl.flops_per_dev,
                    "analytic_flops_total": analytic_flops_total,
                }
                gates.append(calibration > 0)

            predicted = calibration * analytic_sec + pred_wire_sec
            measured = rl.t_compute + rl.t_collective
            crec: Dict[str, object] = {
                "cell": spec.name,
                "predicted_step_s": predicted,
                "measured_step_s": measured,
                "analytic_compute_s": analytic_sec,
                "predicted_wire_s": pred_wire_sec,
                "t_compute": rl.t_compute,
                "t_collective": rl.t_collective,
                "t_step_3term": rl.t_step,     # ungated (includes HBM)
                "solve_plus_trace_s": time.time() - t0,
            }
            if predicted > 0:
                crec["ratio"] = measured / predicted
            fitted = rec["calibration_fit"]["cell"] == spec.name
            crec["gated"] = not fitted
            crec["ok"] = bool(
                fitted or (predicted > 0 and
                           RATIO_LO <= measured / predicted <= RATIO_HI))
            gates.append(crec["ok"])
            rec["cells"].append(crec)
        rec["status"] = "ok" if all(gates) else "fail"
    except Exception as e:
        import traceback
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=8)
    return rec
