"""Pipeline conformance pseudo-cell (the port's ``repro.verify.
pipeline_cell``): the solver's joint stage-cut + tiling hybrid, executed
by the plan-driven stage runner (runtime/pipeline_parallel.py), must

  (a) model a win: the chosen pipelined candidate beats the best flat
      tiling on modeled step time (and reprices to its own cost),
  (b) track the one-stage reference loss trajectory (the S=1 path, which
      IS the TrainEngine by delegation), and
  (c) put the stage-boundary wire bytes the step actually moves inside
      the declared calibration band of the solver's boundary prediction.

The solve runs on a ("pod", "data") (4, 2) solver mesh: "pod" crosses
hosts (InfiniBand, ``launch/mesh.IB_BW``), "data" rides NVLink, the
port's counterpart of repro's DCN-over-ICI hierarchy.

Measurement for (c): the port sends each hop's activations (forward) and
their gradients (backward) point to point, and ``pipeline_parallel.
hop_bytes`` counts the bytes each rank sent; the measured side is their
sum over the 8 ranks.  repro reconstructs the same quantity from the
compiled HLO: one collective-permute in the forward schedule's scan body
and one in its transpose, each priced once by ``hlo.collect`` and
multiplied by the n_micro + S - 1 schedule steps.  Both count what
crosses the stage boundaries in a step, forward and backward: repro's
also counts the bubble steps' masked hops and the ring's wrap from the
last stage to the first, which the port does not send, so the port's
side is the smaller.  The model's side (``pipeline_breakdown``'s
boundary_wire_bytes_total) counts each crossing tensor once per boundary
edge, so the two sides land within the standard RATIO band rather than
equality — the calibration posture of the other cells.
"""
from __future__ import annotations

import time
from typing import Dict

from .calibration import calibration_pass

# deep homogeneous stack: 8 layers over a cross-host (pod) outer axis
LAYERS = 8
D_MODEL = 512
BATCH = 64
N_MICRO = 8
STEPS = 4
STAGE_COUNTS = (1, 4)       # flat baseline + the (4, 2) stage x data run
# runner-vs-engine trajectories differ only by microbatch-gradient
# reassociation through the schedule (ulp scale)
PIPE_LOSS_ATOL = 1e-4


def _layer(w, h):
    import torch
    return torch.tanh(h @ w["w"])


def _loss(h, y):
    import torch
    return torch.mean((h - y) ** 2)


def run_pipeline_cell(mesh=None) -> Dict[str, object]:
    """The cell builds its own stage x data mesh over the default process
    group's ranks, of the device type of ``mesh`` (the verification
    mesh; the CPU without one)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..core.builders import mlp_graph
    from ..core.solver import (MeshAxis, pipeline_breakdown,
                               reprice_pipeline, solve_pipeline)
    from ..launch.mesh import IB_BW, NVLINK_BW
    from ..optim.adamw import AdamWConfig
    from ..runtime import pipeline_parallel as pp
    from .numerics import mesh_device

    device_type = "cpu" if mesh is None else mesh.device_type
    n_dev = dist.get_world_size()
    rec: Dict[str, object] = {
        "cell": "pipeline", "kind": "train-pipeline",
        "config": {"layers": LAYERS, "d_model": D_MODEL, "batch": BATCH,
                   "n_micro": N_MICRO, "steps": STEPS,
                   "stage_counts": list(STAGE_COUNTS)},
        "loss_atol": PIPE_LOSS_ATOL,
    }
    try:
        # --- solve: pod (across hosts) x data (NVLink) hierarchy --------
        axes = [MeshAxis("pod", 4, IB_BW), MeshAxis("data", 2, NVLINK_BW)]
        rec["mesh"] = {"pod": 4, "data": 2}
        g = mlp_graph(BATCH, [D_MODEL] * (LAYERS + 1),
                      with_backward=True)
        t0 = time.time()
        psol = solve_pipeline(g, axes, n_micro=N_MICRO,
                              stage_counts=STAGE_COUNTS, mem_scale=0.0)
        rec["solve_s"] = time.time() - t0
        bd = pipeline_breakdown(g, psol)
        rec["solution"] = {
            "n_stages": psol.n_stages,
            "cuts": psol.cuts,
            "bubble_factor": psol.bubble_factor,
            "modeled_ms": psol.total_seconds * 1e3,
            "candidates_ms": {k: v * 1e3
                              for k, v in bd["candidates"].items()},
            "boundary_wire_bytes_total": bd["boundary_wire_bytes_total"],
            "n_boundaries": len(bd["boundaries"]),
        }
        reprice = reprice_pipeline(g, psol)
        modeled_win = (psol.n_stages > 1
                       and psol.total_seconds < psol.candidates[1])
        reprice_ok = abs(reprice - psol.total_seconds) <= \
            1e-9 * max(abs(reprice), abs(psol.total_seconds))
        rec["solution"]["modeled_win"] = bool(modeled_win)
        rec["solution"]["reprice_ok"] = bool(reprice_ok)

        # --- execute: (S, n_dev/S) stage x data runner ------------------
        s = psol.n_stages
        run_mesh = init_device_mesh(device_type, (s, n_dev // s),
                                    mesh_dim_names=("stage", "data"))
        dev = mesh_device(run_mesh)
        # solved boundary placement of one microbatch [mb, d_model]
        boundary_t = next(t for t in psol.stages[1].incoming
                          if g.tensors[t].kind == "activation")
        x_spec = pp.stage_tensor_spec(psol, boundary_t,
                                      g.tensors[boundary_t].dims)
        rec["solution"]["boundary_tensor"] = boundary_t
        rec["solution"]["x_spec"] = str(x_spec)

        optim = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=100)
        gen = torch.Generator(device="cpu").manual_seed(0)
        ws = {"w": torch.randn((LAYERS, D_MODEL, D_MODEL), generator=gen)
              * (1.0 / D_MODEL ** 0.5)}
        tr_pipe = pp.PipelineTrainer(_layer, _loss, n_stages=s,
                                     n_micro=N_MICRO, mesh=run_mesh,
                                     optim=optim, x_spec=x_spec, device=dev)
        tr_ref = pp.PipelineTrainer(_layer, _loss, n_stages=1,
                                    n_micro=N_MICRO, optim=optim,
                                    device=dev)
        st_pipe = tr_pipe.init(ws)
        st_ref = tr_ref.init(ws)

        # (b) solved hybrid vs one-stage reference trajectory; (c) the
        # boundary bytes of its first step
        losses_p, losses_r = [], []
        t0 = time.time()
        for i in range(STEPS):
            x = torch.randn((BATCH, D_MODEL), generator=gen).to(dev)
            y = torch.randn((BATCH, D_MODEL), generator=gen).to(dev)
            pp.reset_hop_bytes()
            st_pipe, mp = tr_pipe.step(st_pipe, x, y)
            if i == 0:
                sent = torch.tensor([float(sum(pp.hop_bytes.values()))],
                                    dtype=torch.float64, device=dev)
                dist.all_reduce(sent)
                measured = float(sent.item())
            st_ref, mr = tr_ref.step(st_ref, x, y)
            losses_p.append(float(mp["loss"]))
            losses_r.append(float(mr["loss"]))
        rec["exec_s"] = time.time() - t0
        predicted = bd["boundary_wire_bytes_total"]
        rec["measured"] = {"boundary_wire_bytes_total": measured,
                           "schedule_steps": N_MICRO + s - 1}
        rec["predicted"] = {"boundary_wire_bytes_total": predicted}
        rec["calibration"] = calibration_pass(predicted, measured)
        max_dloss = max(abs(a - b) for a, b in zip(losses_p, losses_r))
        rec["trajectory"] = {
            "pipelined_losses": losses_p,
            "reference_losses": losses_r,
            "max_abs_dloss": max_dloss,
            "tol": PIPE_LOSS_ATOL,
            "ok": bool(max_dloss < PIPE_LOSS_ATOL),
        }

        gates = [modeled_win, reprice_ok, rec["calibration"]["ok"],
                 rec["trajectory"]["ok"]]
        rec["status"] = "ok" if all(gates) else "fail"
    except Exception as e:
        import traceback
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=8)
    return rec
