"""Trace-frontend conformance (the port's ``repro.verify.trace_cell``):
the FX capture frontend (repro_torch.trace) must agree with the
hand-written builders it replaces.

Two legs:

  families   for dense / moe / xlstm, the port's *actual*
             ``models.model.LM`` forward (reduced config, on meta
             tensors) is captured through the frontend and solved on the
             verification axes; its solved cost must sit within repro's
             declared band of the hand-builder prefill graph's solved
             cost.  The bands are per-family because the two graphs model
             different executions: the traced MoE prices the
             scatter / gather dispatch it sees, the builder the
             all-to-all; dense traces cheaper than the builder because
             capture has no forced seed conversion and finer conversion
             points.  repro's committed ratios (CONFORMANCE.json, jax
             0.4.37) are printed beside the port's; only the bands gate.

  mlp        ``autoshard`` on an un-modeled plain-torch MLP: the solved
             one-cut cost must EQUAL the brute-force oracle at every mesh
             axis of the k-cut recursion, and the sharded output (the
             verification mesh's DTensors) must match the serial function
             within the fuzz numeric band.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

from .cells import MESH_AXES, MESH_SHAPE
from .fuzz import EXEC_ATOL

# cost-parity bands (repro's, measured in repro: dense 0.38, moe 8.4,
# xlstm 2.9; see the module docstring for why each family sits where it
# does)
FAMILY_BANDS: Dict[str, Tuple[float, float]] = {
    "dense": (0.1, 2.0),
    "moe": (0.8, 15.0),
    "xlstm": (0.3, 6.0),
}
# repro's committed ratios (experiments/conformance/CONFORMANCE.json,
# "trace", jax 0.4.37): printed beside the port's, never gated
REPRO_RATIOS: Dict[str, float] = {"dense": 0.37811123424589077,
                                  "moe": 8.405991706973323,
                                  "xlstm": 2.912221212571193}
TRACE_FAMILIES: List[Tuple[str, str]] = [
    ("dense", "llama3.2-3b"),
    ("moe", "moonshot-v1-16b-a3b"),
    ("xlstm", "xlstm-125m"),
]
TRACE_BEAM = 1024          # traced graphs are finer than builder graphs;
                           # a fixed moderate beam keeps the cell fast
BATCH, SEQ = 4, 32
MLP_ATOL = EXEC_ATOL       # f32 end-to-end, same band as the fuzz


def meta_params(model):
    """The model's parameter tree as meta tensors (shapes and dtypes
    only): what the capture reads, with no storage."""
    import torch

    def go(t):
        return {k: go(v) if isinstance(v, dict)
                else torch.empty(v[0], dtype=v[1], device="meta")
                for k, v in t.items()}
    return go(model.param_shapes())


def capture_forward(cfg, batch: int = BATCH, seq: int = SEQ,
                    params=None):
    """``capture`` of ``LM(cfg).forward``'s logits on [batch, seq] token
    ids, the params of kind "weight" (meta tensors unless ``params``
    given)."""
    import torch

    from ..models.model import LM
    from ..trace import capture

    model = LM(cfg)
    if params is None:
        params = meta_params(model)
    toks = torch.zeros(batch, seq, dtype=torch.long, device="meta")
    return capture(lambda p, t: model.forward(p, t)[0], params, toks,
                   weight_argnums=(0,), name=cfg.name)


def _family_record(family: str, arch: str, axes) -> Dict[str, object]:
    from ..configs.base import ShapeConfig, get_arch
    from ..core.builders import build_graph
    from ..core.solver import solve_mesh

    cfg = get_arch(arch).reduced()
    t0 = time.time()
    traced = capture_forward(cfg)
    t_cap = time.time() - t0
    t0 = time.time()
    tsol = solve_mesh(traced.graph, axes, beam=TRACE_BEAM)
    t_solve = time.time() - t0
    bsol = solve_mesh(build_graph(cfg, ShapeConfig("tr", SEQ, BATCH,
                                                   "prefill")), axes)
    lo, hi = FAMILY_BANDS[family]
    ratio = tsol.total_bytes / max(bsol.total_bytes, 1.0)
    return {
        "family": family, "arch": arch,
        "ops": len(traced.graph.ops),
        "tensors": len(traced.graph.tensors),
        "folds": [list(f) for f in traced.folds],
        "unknown_primitives": traced.unknown_primitives,
        "capture_s": t_cap, "solve_s": t_solve,
        "traced_bytes": tsol.total_bytes,
        "builder_bytes": bsol.total_bytes,
        "ratio": ratio, "band": [lo, hi],
        "repro_ratio": REPRO_RATIOS[family],
        "ok": bool(lo <= ratio <= hi),
    }


def mlp_oracle(g, solution) -> Tuple[bool, List[Dict[str, object]]]:
    """At every axis of the k-cut recursion, the solver's one-cut cost
    against the exhaustive optimum: (all equal, per-axis records)."""
    from ..core.solver import solve_one_cut, solve_one_cut_bruteforce

    ok, per_axis = True, []
    for ax, assign in zip(solution.axes, solution.per_axis):
        solved = solve_one_cut(g, ax.size, beam="auto").cost
        oracle = solve_one_cut_bruteforce(g, ax.size, workers=0).cost
        per_axis.append({"axis": ax.name, "solved": solved,
                         "oracle": oracle})
        if abs(solved - oracle) > 1e-6 * max(1.0, abs(oracle)):
            ok = False
        g = g.divided(assign, ax.size)
    return ok, per_axis


def _mlp_record(mesh, numerics: bool = True) -> Dict[str, object]:
    import torch

    from ..trace import autoshard
    from ..trace.demo import mlp_fixture
    from .numerics import mesh_device

    mlp, args, weight_argnums = mlp_fixture(device=mesh_device(mesh))
    ash = autoshard(mlp, mesh, *args, weight_argnums=weight_argnums,
                    name="mlp")
    rec: Dict[str, object] = {
        "ops": len(ash.traced.graph.ops),
        "predicted_bytes": ash.predicted_bytes,
        "plan_axes": list(ash.plan.mesh_axis_names),
    }
    rec["oracle_ok"], rec["per_axis"] = mlp_oracle(ash.traced.graph,
                                                   ash.solution)
    if not numerics:          # cost/oracle legs only (--no-numerics)
        rec["ok"] = bool(rec["oracle_ok"])
        return rec
    with torch.no_grad():
        ref = mlp(*args).float().cpu()
        got = ash(*args).full_tensor().float().cpu()
    err = float((ref - got).abs().max())
    scale = float(ref.abs().max())
    rec.update(max_abs_err=err, scale=scale, tol=MLP_ATOL,
               exec_ok=bool(err <= MLP_ATOL * max(1.0, scale)))
    rec["ok"] = bool(rec["oracle_ok"] and rec["exec_ok"])
    return rec


def _families(axes) -> List[Dict[str, object]]:
    """The families leg: family i on rank i % world of the default
    process group when one is up (every rank of it calls this), the
    records gathered to every rank in TRACE_FAMILIES order; all of them
    here otherwise."""
    import torch.distributed as dist

    def one(f, a):
        try:
            return _family_record(f, a, axes)
        except Exception as e:     # the others still gather this record
            return {"family": f, "arch": a, "ok": False,
                    "error": f"{type(e).__name__}: {e}"}
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [one(f, a) for f, a in TRACE_FAMILIES]
    rank, world = dist.get_rank(), dist.get_world_size()
    mine = [(i, one(f, a))
            for i, (f, a) in enumerate(TRACE_FAMILIES) if i % world == rank]
    got: List = [None] * world
    dist.all_gather_object(got, mine)
    return [r for _, r in sorted((x for part in got for x in part),
                                 key=lambda x: x[0])]


def run_trace_cell(mesh=None, numerics: bool = True) -> Dict[str, object]:
    """The cell on ``mesh`` (the verification mesh; made over the default
    process group when omitted: every rank of it calls this)."""
    from .calibration import verify_axes

    if mesh is None:
        from ..launch.mesh import make_mesh
        mesh = make_mesh(MESH_SHAPE, MESH_AXES, "cpu")
    rec: Dict[str, object] = {
        "cell": "trace",
        "mesh": dict(zip(MESH_AXES, MESH_SHAPE)),
        "batch": BATCH, "seq_len": SEQ, "beam": TRACE_BEAM,
    }
    try:
        axes = verify_axes()
        fams = _families(axes)
        rec["families"] = fams
        rec["mlp"] = _mlp_record(mesh, numerics=numerics)
        ok = all(f["ok"] for f in fams) and rec["mlp"]["ok"]
        rec["status"] = "ok" if ok else "fail"
    except Exception as e:
        import traceback
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=8)
    return rec
