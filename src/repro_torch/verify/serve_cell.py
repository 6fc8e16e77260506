"""Sharded-decode serving conformance (the port's ``repro.verify.
serve_cell``): the plan-sharded continuous-batching pool (chunked
prefill + pooled decode, runtime/serve.py) must compute the same numbers
as the one-process reference pool.

Unlike the per-phase cells (calibration.py), this cell exercises the
*engine*: solver-plan sharded params AND cache on the verification
mesh's 8 ranks, slot-sliced chunked prefill, then teacher-forced pool
decode — both servers are fed identical token streams so bf16 argmax
near-ties cannot fork the comparison, and the per-step logits are gated
by the same band as the decode numerics cells (numerics.LOGITS_ATOL).
Every rank runs both servers: the reference on its own device alone.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np

from .cells import MESH_AXES, MESH_SHAPE
from .numerics import LOGITS_ATOL

SERVE_ARCH = "llama3.2-3b"
SLOTS = 4
MAX_LEN = 32
CHUNK = 8
DECODE_STEPS = 4


def _logits(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def run_serve_cell(mesh=None) -> Dict[str, object]:
    from ..configs.base import ShapeConfig, get_arch
    from ..core.builders import build_graph
    from ..core.plan import ShardingPlan
    from ..core.solver import solve_mesh
    from ..models.model import LM
    from ..runtime.serve import ServeConfig, Server
    from .calibration import verify_axes
    from .numerics import mesh_device

    if mesh is None:
        from ..launch.mesh import make_mesh
        mesh = make_mesh(MESH_SHAPE, MESH_AXES, "cpu")
    cfg = get_arch(SERVE_ARCH).reduced()
    rec: Dict[str, object] = {
        "cell": "serve", "arch": SERVE_ARCH, "slots": SLOTS,
        "max_len": MAX_LEN, "chunk": CHUNK, "steps": DECODE_STEPS,
        "mesh": dict(zip(MESH_AXES, MESH_SHAPE)), "tol": LOGITS_ATOL,
    }
    try:
        t0 = time.time()
        g = build_graph(cfg, ShapeConfig("serve", MAX_LEN, SLOTS,
                                         "decode"))
        sol = solve_mesh(g, verify_axes())
        plan = ShardingPlan.from_graph_solution(sol, g)
        rec["solve_s"] = time.time() - t0

        params = LM(cfg).init(0, device=mesh_device(mesh))
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab,
                                size=int(rng.integers(3, 12))).tolist()
                   for _ in range(SLOTS)]
        scfg = ServeConfig(slots=SLOTS, max_len=MAX_LEN,
                           prefill_chunk=CHUNK)

        t0 = time.time()
        ref = Server(LM(cfg), params, scfg)
        shd = Server(LM(cfg, plan=plan, mesh=mesh), params, scfg)
        for s, p in enumerate(prompts):
            ref.admit(p, s)
            shd.admit(p, s)
        prefill_err = float(np.max(np.abs(ref.prefill_logits
                                          - shd.prefill_logits)))
        decode_err = 0.0
        for _ in range(DECODE_STEPS):
            forced = ref.next_tok.copy()
            ref.decode_once(forced)
            shd.decode_once(forced)
            decode_err = max(decode_err, float(np.max(np.abs(
                _logits(ref.last_logits) - _logits(shd.last_logits)))))
        rec["exec_s"] = time.time() - t0
        rec["prefill_max_abs_err"] = prefill_err
        rec["decode_max_abs_err"] = decode_err
        rec["ok"] = bool(prefill_err < LOGITS_ATOL
                         and decode_err < LOGITS_ATOL)
        rec["status"] = "ok" if rec["ok"] else "fail"
    except Exception as e:
        import traceback
        rec["status"] = "error"
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=8)
    return rec
