"""Training-engine conformance (the port's ``repro.verify.train_cell``):
the plan-driven trainer (train/engine.py) must (a) track the one-process
reference loss trajectory, (b) make microbatch gradient accumulation
equivalent to the full batch, and (c) put the wire bytes its step
actually moves inside the declared calibration band of the solver's
prediction — with the optimizer-state collectives (the sharded update's
reduce/gather traffic) attributed via ``solution_breakdown``'s
``by_phase["update"]``.

Prediction prices the *as-executed* projection (the train-step analogue
of calibration.faithful_assignments): optimizer moments / f32 masters
keep their solver-chosen tilings — the engine places state with exactly
those — while weight-gradient tensors are projected to replicated,
because the engine's grad sync brings each weight gradient whole (an
all-reduce, then a local slice into the state's layout).  The raw solver
optimum stays in the record as ``raw_solver_bytes``.  The measured side
is one executed engine step on the verification mesh's 8 ranks under
``analysis/comm.record`` (repro compiles the step and parses its HLO).

A fourth gate re-checks solver integrity after the optimizer-state
graph extension: solve == reprice == brute-force oracle on a micro
graph carrying master + error-feedback tensors.  Stdlib-only at import
(``launch/compile`` reads ``train_faithful_assignments``).
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence

from ..core.tiling import REPLICATE
from .cells import MESH_AXES, MESH_SHAPE, N_DEVICES
from .calibration import calibration_pass, verify_axes

TRAIN_ARCH = "llama3.2-3b"
BATCH = 16
SEQ = 32
STEPS = 5                 # reference-trajectory steps
MICROBATCHES = 4
# declared bands (repro's): per-step |Δloss| vs the one-process
# reference (bf16 reassociation drift compounds across optimizer steps,
# so this sits above the one-shot numerics.LOSS_ATOL), and the
# accumulation-equivalence tolerance (pure reassociation + bf16 grad
# quantization — no sharding in that comparison).
TRAIN_LOSS_ATOL = 0.08
ACCUM_ATOL = 5e-3


def train_faithful_assignments(g, per_axis: Sequence[dict]) -> List[dict]:
    """The solved per-axis assignments with every weight-gradient tensor
    replicated (its reduction is an all-reduce; the slice into the state
    layout is local); the ``.opt`` / ``.master`` / ``.err`` state
    tensors and the rest as solved."""
    out = []
    for assign in per_axis:
        a = dict(assign)
        for name, ts in g.tensors.items():
            if ts.kind != "grad":
                continue
            base = name[2:].split("#")[0].split(".sum")[0]
            if base in g.tensors and g.tensors[base].kind == "weight":
                a[name] = REPLICATE
        out.append(a)
    return out


def _oracle_graph():
    """Micro train graph (input grads + master + error feedback) small
    enough for the brute-force oracle, with a batch the cut arities do
    not divide so real conversions are priced."""
    from ..core.builders import FP32, GraphBuilder

    b = GraphBuilder("opt-ext-oracle")
    x0 = b.inp("x0", ("batch", "h0"), (2, 6), bytes_per_elem=FP32)
    b.new_group()
    w = b.weight("W1", ("h0", "h1"), (6, 8), role="W1",
                 bytes_per_elem=FP32)
    x1 = b.act("x1", ("batch", "h1"), (2, 8), role="x1",
               bytes_per_elem=FP32)
    b.einsum(x0, w, x1, grads=(True, True))
    b.add_backward(x1, master_fp32=True, error_feedback=True)
    return b.g


def _solver_consistency() -> Dict[str, object]:
    from ..core.cost import graph_cost
    from ..core.solver import solve_one_cut, solve_one_cut_bruteforce

    g = _oracle_graph()
    rec: Dict[str, object] = {"arities": {}}
    ok = True
    for arity in (2, 4):
        sol = solve_one_cut(g, arity)
        reprice = graph_cost(g, sol.assignment, arity, mem_scale=1.0)
        oracle = solve_one_cut_bruteforce(g, arity, workers=0)
        a_ok = (abs(sol.cost - reprice) <= 1e-6 * max(1.0, abs(sol.cost))
                and abs(sol.cost - oracle.cost)
                <= 1e-6 * max(1.0, abs(oracle.cost)))
        rec["arities"][str(arity)] = {
            "solve": sol.cost, "reprice": reprice,
            "oracle": oracle.cost, "ok": bool(a_ok),
        }
        ok &= a_ok
    rec["ok"] = bool(ok)
    return rec


def trajectory(eng_a, eng_b, dcfg, steps: int):
    """``steps`` steps of two engines from ``init_state(0)`` on the same
    host batches: (losses a, losses b, the final states)."""
    from ..data.pipeline import host_batch

    s_a, s_b = eng_a.init_state(0), eng_b.init_state(0)
    la, lb = [], []
    for step in range(steps):
        batch = host_batch(dcfg, step)
        s_a, m_a = eng_a.step(s_a, batch)
        s_b, m_b = eng_b.step(s_b, batch)
        la.append(float(m_a["loss"]))
        lb.append(float(m_b["loss"]))
    return la, lb, s_a, s_b


def run_train_cell(mesh=None, *, numerics: bool = True) -> Dict[str, object]:
    """``numerics=False`` (the CLI's --no-numerics) keeps the
    calibration and solver-consistency gates but skips the executed
    trajectory / accumulation runs."""
    import torch

    from ..analysis import comm
    from ..configs.base import ShapeConfig, get_arch
    from ..core.builders import build_graph
    from ..core.plan import ShardingPlan
    from ..core.solver import composed_cost, solution_breakdown, solve_mesh
    from ..data.pipeline import DataConfig, host_batch
    from ..models.model import LM
    from ..models.sharding import place
    from ..optim.adamw import AdamWConfig
    from ..train.engine import EngineConfig, TrainEngine
    from .numerics import mesh_device

    if mesh is None:
        from ..launch.mesh import make_mesh
        mesh = make_mesh(MESH_SHAPE, MESH_AXES, "cpu")
    dev = mesh_device(mesh)
    cfg = get_arch(TRAIN_ARCH).reduced()
    shape = ShapeConfig("conf_train_engine", SEQ, BATCH, "train")
    rec: Dict[str, object] = {
        "cell": "train-engine", "arch": TRAIN_ARCH, "kind": "train",
        "mesh": dict(zip(MESH_AXES, MESH_SHAPE)),
        "steps": STEPS,
        "loss_atol": TRAIN_LOSS_ATOL, "accum_atol": ACCUM_ATOL,
        "reduced_config": {"n_layers": cfg.n_layers,
                           "d_model": cfg.d_model,
                           "seq_len": SEQ, "global_batch": BATCH},
    }
    try:
        axes = verify_axes()
        t0 = time.time()
        g = build_graph(cfg, shape, master_fp32=True)
        sol = solve_mesh(g, axes)
        plan = ShardingPlan.from_graph_solution(sol, g)
        rec["solve_s"] = time.time() - t0

        executed = train_faithful_assignments(g, sol.per_axis)
        breakdown = solution_breakdown(g, axes, executed)
        rec["predicted"] = {
            "wire_bytes_total": breakdown["total"],
            "raw_solver_bytes": composed_cost(g, axes, sol.per_axis),
            "by_kind": breakdown["by_kind"],
            "by_phase": breakdown["by_phase"],
            "by_role": breakdown["by_role"],
        }

        ecfg = EngineConfig(optim=AdamWConfig(lr=2e-3, warmup_steps=2,
                                              total_steps=1000))
        eng_sh = TrainEngine(LM(cfg, plan=plan, mesh=mesh), ecfg,
                             device=dev, mesh=mesh)
        dcfg = DataConfig(seed=0, vocab=cfg.vocab, seq_len=SEQ,
                          global_batch=BATCH)

        # (c) wire bytes of one executed engine step (on a state of its
        # own: the step updates it in place)
        t0 = time.time()
        state = eng_sh.init_state(0)
        pl = eng_sh.batch_placements()
        batch = {k: place(torch.from_numpy(v).to(dev), mesh, pl[k])
                 for k, v in host_batch(dcfg, 0).items()}
        _, st = comm.record(eng_sh.step, state, batch)
        del state
        rec["measure_s"] = time.time() - t0
        rec["measured"] = {
            # the calibrated step is the plain (microbatches=1) engine
            # step; accumulation is gated numerically, not byte-wise
            "microbatches": 1,
            "counts": st.counts,
            "wire_bytes_total": st.wire_bytes_per_device * N_DEVICES,
            "wire_by_kind_total": {k: v * N_DEVICES
                                   for k, v in st.wire_by_kind.items()},
        }
        rec["calibration"] = calibration_pass(
            breakdown["total"], rec["measured"]["wire_bytes_total"])
        # the whole point of the optimizer-state extension: the sharded
        # update's collectives are individually attributed
        rec["calibration"]["update_phase_bytes"] = \
            breakdown["by_phase"].get("update", 0.0)
        rec["calibration"]["update_attributed"] = bool(
            breakdown["by_phase"].get("update", 0.0) > 0.0)

        gates = [rec["calibration"]["ok"],
                 rec["calibration"]["update_attributed"]]
        if numerics:
            eng_ref = TrainEngine(LM(cfg), ecfg, device=dev)
            # (a) plan-sharded trainer vs one-process reference
            t0 = time.time()
            ref_losses, sh_losses, _, _ = trajectory(eng_ref, eng_sh, dcfg,
                                                     STEPS)
            rec["exec_s"] = time.time() - t0
            max_dloss = max(abs(a - b)
                            for a, b in zip(ref_losses, sh_losses))
            rec["trajectory"] = {
                "ref_losses": ref_losses, "sharded_losses": sh_losses,
                "max_abs_dloss": max_dloss, "tol": TRAIN_LOSS_ATOL,
                "ok": bool(max_dloss < TRAIN_LOSS_ATOL),
            }

            # (b) grad accumulation == full batch (one process)
            eng_acc = TrainEngine(
                LM(cfg), EngineConfig(microbatches=MICROBATCHES,
                                      optim=ecfg.optim), device=dev)
            full_l, acc_l, s_full, s_acc = trajectory(eng_ref, eng_acc,
                                                      dcfg, 2)
            d_acc = max(abs(a - b) for a, b in zip(full_l, acc_l))
            from .. import tree
            pf = tree.leaves(s_full["master"])[0]
            pa = tree.leaves(s_acc["master"])[0]
            rec["accumulation"] = {
                "microbatches": MICROBATCHES,
                "full_losses": full_l, "micro_losses": acc_l,
                "max_abs_dloss": d_acc,
                "master_leaf_max_abs_diff": float((pf - pa).abs().max()),
                "tol": ACCUM_ATOL,
                "ok": bool(d_acc < ACCUM_ATOL),
            }
            gates += [rec["trajectory"]["ok"], rec["accumulation"]["ok"]]

        # (d) solver integrity after the optimizer-state graph extension
        rec["solver_consistency"] = _solver_consistency()
        gates.append(rec["solver_consistency"]["ok"])
        rec["status"] = "ok" if all(gates) else "fail"
    except Exception as e:
        import traceback
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=8)
    return rec
