"""Paged-serving conformance (the port's ``repro.verify.
serve_paged_cell``): the paged KV tier (block-table pool, shared-prefix
reuse, self-speculative decoding) must be invisible in the emitted
tokens.

Two gates per dense family:

- **bit-equality** (one device, :func:`bit_equal_leg`): paged +
  speculative serving emits exactly the linear greedy engine's token
  streams — the block-table indirection, trie re-linking, CoW and
  draft/verify rounds are cache-placement and scheduling transforms, not
  numerics changes;
- **sharded logits** (the verification mesh's 8 ranks): the solver-plan
  sharded paged pool (params, block pool AND block table placed by the
  plan) tracks the one-process reference within the same band as the
  decode numerics cells (numerics.LOGITS_ATOL), under teacher-forced
  feeds so bf16 argmax near-ties cannot fork the comparison.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from .cells import MESH_AXES, MESH_SHAPE
from .numerics import LOGITS_ATOL

FAMILIES = ("qwen2-1.5b", "llama3.2-3b")
SLOTS = 4
MAX_LEN = 32
BLOCK_LEN = 8
BUDGET = 8
N_REQ = 6
SPEC_K = 4
DECODE_STEPS = 4


def _setup(arch: str, device):
    from ..configs.base import get_arch
    from ..models.model import LM
    cfg = get_arch(arch).reduced()
    params = LM(cfg).init(0, device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab,
                            size=int(rng.integers(3, 12))).tolist()
               for _ in range(N_REQ)]
    return cfg, params, prompts


def bit_equal_leg(arch: str, device) -> Dict[str, object]:
    """Paged + speculative serving against the linear greedy engine on
    ``device`` alone: the streams, and the dispatch counts."""
    from ..models.model import LM
    from ..runtime.serve import ServeConfig, Server

    cfg, params, prompts = _setup(arch, device)
    lin = Server(LM(cfg), params,
                 ServeConfig(slots=SLOTS, max_len=MAX_LEN))
    for p in prompts:
        lin.submit(p, BUDGET)
    ref = lin.run()
    paged = Server(LM(cfg), params,
                   ServeConfig(slots=SLOTS, max_len=MAX_LEN, paged=True,
                               block_len=BLOCK_LEN, spec_k=SPEC_K))
    for p in prompts:
        paged.submit(p, BUDGET)
    out = paged.run()
    return {"arch": arch, "bit_equal": bool(out == ref),
            "verify_dispatches": paged.verify_dispatches,
            "decode_dispatches": {"paged_spec": paged.decode_dispatches,
                                  "linear": lin.decode_dispatches}}


def _family_leg(arch: str, mesh) -> Dict[str, object]:
    from ..configs.base import ShapeConfig
    from ..core.builders import build_graph
    from ..core.plan import ShardingPlan
    from ..core.solver import solve_mesh
    from ..models.model import LM
    from ..runtime.serve import ServeConfig, Server
    from .calibration import verify_axes
    from .numerics import mesh_device

    dev = mesh_device(mesh)
    leg = bit_equal_leg(arch, dev)

    # -- sharded paged pool vs one-process reference ----------------------
    cfg, params, prompts = _setup(arch, dev)
    g = build_graph(cfg, ShapeConfig("serve", MAX_LEN, SLOTS, "decode"))
    sol = solve_mesh(g, verify_axes())
    plan = ShardingPlan.from_graph_solution(sol, g)
    scfg = ServeConfig(slots=SLOTS, max_len=MAX_LEN, paged=True,
                       block_len=BLOCK_LEN)
    srd = Server(LM(cfg, plan=plan, mesh=mesh), params, scfg)
    one = Server(LM(cfg), params, ServeConfig(slots=SLOTS,
                                              max_len=MAX_LEN))
    for s, p in enumerate(prompts[:SLOTS]):
        one.admit(p, s)
        srd.admit(p, s)
    prefill_err = float(np.max(np.abs(one.prefill_logits
                                      - srd.prefill_logits)))
    decode_err = 0.0
    for _ in range(DECODE_STEPS):
        forced = one.next_tok.copy()
        one.decode_once(forced)
        srd.decode_once(forced)
        decode_err = max(decode_err, float(
            (one.last_logits - srd.last_logits).abs().max()))
    leg["sharded_prefill_max_abs_err"] = prefill_err
    leg["sharded_decode_max_abs_err"] = decode_err
    leg["ok"] = bool(leg["bit_equal"] and prefill_err < LOGITS_ATOL
                     and decode_err < LOGITS_ATOL)
    return leg


def run_serve_paged_cell(mesh=None) -> Dict[str, object]:
    if mesh is None:
        from ..launch.mesh import make_mesh
        mesh = make_mesh(MESH_SHAPE, MESH_AXES, "cpu")
    rec: Dict[str, object] = {
        "cell": "serve-paged", "families": list(FAMILIES),
        "slots": SLOTS, "max_len": MAX_LEN, "block_len": BLOCK_LEN,
        "spec_k": SPEC_K, "budget": BUDGET, "n_requests": N_REQ,
        "mesh": dict(zip(MESH_AXES, MESH_SHAPE)), "tol": LOGITS_ATOL,
    }
    try:
        t0 = time.time()
        legs: List[Dict[str, object]] = [_family_leg(a, mesh)
                                         for a in FAMILIES]
        rec["legs"] = legs
        rec["exec_s"] = time.time() - t0
        rec["ok"] = all(l["ok"] for l in legs)
        rec["status"] = "ok" if rec["ok"] else "fail"
    except Exception as e:
        import traceback
        rec["status"] = "error"
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=8)
    return rec
