"""The port's trace frontend (src/repro_torch/trace/): FX capture into the
named-dims IR, repeated-block folding, and autoshard onto DTensors, on
the CPU.

repro's own capture (``repro.trace``) runs here once two names JAX 0.9
moved are pointed back for the test's duration (the ``repro_capture``
fixture: ``jax.core.Literal`` and its siblings, now in
``jax.extend.core``, and the pjit primitive's handler, now that the
primitive is named ``jit``); nothing of src/repro is edited.  So the port
is held to:
- repro's capture of the same program: a JAX function and its torch
  transcription give the same op kinds and the same one-cut optimum
  (to 1e-9), case by case (repro's tests/test_trace.py cases, the
  masked select, a dead product, a loop and a stacked loop); the
  attention fork the port adds is held to repro's own XLA attention;
- repro's capture of its reduced forwards on the trace cell's shapes,
  which first reproduces repro's committed record (experiments/
  conformance/CONFORMANCE.json, jax 0.4.37), and against which the
  port's family ratios and op counts are held within stated factors;
- every case of repro's tests/test_trace.py, on the torch counterpart of
  its function (a Python loop where repro has ``lax.scan``);
- the MLP fixture's per-axis one-cut costs 0.831275008 / 0.824838144 at
  repro's 16 GB capacity term, to 1e-9 relative, and the same costs from
  repro's solver on the captured graph rebuilt in repro's
  ``core.graph.Graph``;
- repro's family bands for the captured reduced forwards (dense, moe,
  xlstm) against the builders' prefill graphs;
- the brute-force oracle.

Folding: the op count and the op sequence of a captured forward do not
depend on the depth (dense 2 vs 4 layers, xLSTM 2 vs 4 pairs at 8
tokens) or on the xLSTM's sequence length (16 vs 32, one pair); each
op's repeat is its count of
loop iterations, so it is either the same at both sizes (outside the
loops) or scales with the folded loop's trip count.  (An xLSTM of one
pair has no layer loop to fold: its single pair is lowered as is.)

One spawn of 8 gloo ranks (module fixture) runs autoshard on the (4, 2)
mesh against the serial function (the MLP fixture and the reduced
llama3.2-3b forward) and on a one-rank mesh.  The trace cell and the
fuzz's trace legs run through the verify CLI in
tests/test_torch_verify.py."""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import random

import pytest
import torch

from repro_torch.core.costterms import CapacityTerm
from repro_torch.core.cost import graph_cost
from repro_torch.core.solver import (solve_mesh, solve_one_cut,
                                     solve_one_cut_bruteforce)
from repro_torch.core.tiling import Part
from repro_torch.trace import capture
from repro_torch.verify import trace_cell

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

ROOT = os.path.join(os.path.dirname(__file__), "..")
R_HBM = 16e9                 # repro's HBM per device (its capacity term)
# repro's per-axis one-cut costs of the MLP fixture (CONFORMANCE.json)
REPRO_MLP = {"data": 0.831275008, "model": 0.824838144}


def _t(*shape):
    return torch.ones(*shape)


def _graph(fn, *args, **kw):
    return capture(fn, *args, **kw).graph


# -- repro's tests/test_trace.py, case by case ----------------------------------

def test_mlp_structure():
    def mlp(x, w1, w2):
        return torch.tanh(x @ w1) @ w2

    tr = capture(mlp, _t(8, 4), _t(4, 16), _t(16, 2), weight_argnums=(1, 2))
    g = tr.graph
    # tanh collapses into an alias; only the two matmuls remain
    assert [op.kind for op in g.ops] == ["einsum", "einsum"]
    assert not tr.unknown_primitives
    x, w1, w2 = (g.tensors[t] for t in tr.in_tensors)
    assert w1.kind == "weight" and x.kind == "input"
    # dim unification: x's col == w1's row; w1's col == w2's row
    assert x.dims[1] == w1.dims[0]
    assert w1.dims[1] == w2.dims[0]


@pytest.mark.parametrize("route", ["einsum", "bmm", "matmul-3d"])
def test_einsum_classes_batched(route):
    """A batched product is one einsum with one dim of each class,
    whichever torch spelling (einsum's bmm and its views included)."""
    fn = {"einsum": lambda a, b: torch.einsum("bij,bjk->bik", a, b),
          "bmm": torch.bmm, "matmul-3d": lambda a, b: a @ b}[route]
    g = _graph(fn, _t(4, 8, 16), _t(4, 16, 2))
    (op,) = [op for op in g.ops if op.kind == "einsum"]
    assert [len(c) for c in g.einsum_dim_classes(op)] == [1, 1, 1, 1]
    assert [op.kind for op in g.ops] == ["einsum"]


def test_self_attention_fork_no_duplicate_dims():
    # q @ k^T with q and k derived from one x: both seq axes carry the same
    # dim; the fork keeps the score matrix's two seq axes distinct, also
    # after P @ V contracts the key axis with V's (the queries') seq axis
    def attn(x, wq, wk, wv):
        q, k, v = x @ wq, x @ wk, x @ wv
        return torch.softmax(q @ k.T, -1) @ v

    g = _graph(attn, _t(8, 16), _t(16, 16), _t(16, 16), _t(16, 16))
    for ts in g.tensors.values():
        assert len(set(ts.dims)) == len(ts.dims), ts
    scores = [op for op in g.ops if op.kind == "einsum"][3]      # q @ k^T
    batch, _, _, contract = g.einsum_dim_classes(scores)
    assert batch == () and len(contract) == 1, scores


def test_transpose_is_alias():
    g = _graph(lambda x, w: (x.T @ w).T, _t(4, 8), _t(4, 2))
    assert [op.kind for op in g.ops] == ["einsum"]


def test_reshape_merge_units_and_zero_cost():
    # (B, H, hd) -> (B, H*hd) @ w: a cut of the merged dim must not split
    # head granules, and partitioning heads straight through the merge is
    # free
    def f(x, w):
        b, h, hd = x.shape
        return x.reshape(b, h * hd) @ w

    g = _graph(f, _t(4, 8, 16), _t(128, 2))
    assert any(16 in ts.units.values() for ts in g.tensors.values()), \
        "merge tie lost the head-granule units"
    assert solve_one_cut(g, 4, mem_scale=0.0).cost == 0.0


def test_multi_axis_reduce_chains():
    g = _graph(lambda x: torch.sum(x), _t(4, 8, 2))
    assert [op.kind for op in g.ops] == ["reduce"] * 3


def _shared_loop(x, w):
    for _ in range(7):
        x = torch.tanh(x @ w)
    return x


def _stacked_loop(x, ws):
    for w in ws.unbind(0):
        x = x @ w
    return x


@pytest.mark.parametrize("fn,shapes,trips", [
    (_shared_loop, ((8, 16), (16, 16)), 7),
    (_stacked_loop, ((8, 16), (5, 16, 16)), 5)], ids=["loop", "stacked"])
def test_loop_repeat_detection(fn, shapes, trips):
    """A Python loop unrolled by the trace folds into one body with
    repeat = trip count (repro's scan): a shared weight, or the stacked
    weights' per-iteration slices tied to the stack; partitioning the
    batch straight through the loop is free."""
    tr = capture(fn, *(_t(*s) for s in shapes))
    mms = [op for op in tr.graph.ops if op.kind == "einsum"]
    assert len(mms) == 1 and mms[0].repeat == float(trips)
    assert [f[2] for f in tr.folds] == [trips]
    assert solve_one_cut(tr.graph, 4, mem_scale=0.0).cost == 0.0


def test_unknown_primitive_fallback():
    tr = capture(lambda x: torch.i0(x) * 2.0, _t(4, 4))
    assert "i0" in tr.unknown_primitives
    assert tr.out_tensors[0] is not None


def test_softmax_batch_partition_free():
    g = _graph(lambda x: torch.softmax(x, -1), _t(8, 16))
    sol = solve_one_cut(g, 4, mem_scale=0.0)
    assert sol.cost == 0.0
    assert any(isinstance(t, Part) for t in sol.assignment.values())


def test_out_dims_follow_alias_view():
    tr = capture(lambda x: (x @ x.T).T, _t(8, 4))
    (od,) = tr.out_dims
    assert len(od) == 2
    assert set(od) == set(tr.graph.tensors[tr.out_tensors[0]].dims)


@pytest.mark.parametrize("arity", [2, 4])
def test_mlp_oracle_equality(arity):
    def mlp(x, w1, w2, w3):
        h = torch.tanh(x @ w1)
        h = torch.tanh(h @ w2)
        return h @ w3

    tr = capture(mlp, _t(16, 8), _t(8, 16), _t(16, 16), _t(16, 4),
                 weight_argnums=(1, 2, 3))
    sol = solve_one_cut(tr.graph, arity)
    oracle = solve_one_cut_bruteforce(tr.graph, arity, workers=0)
    assert sol.cost == pytest.approx(oracle.cost, rel=1e-9)


def test_opless_weight_penalty_matches_bruteforce():
    # an argument no op consumes must still be priced consistently
    # between DP and oracle (the solver charges its cheapest choice)
    tr = capture(lambda x, w, unused: x @ w, _t(8, 16), _t(16, 4),
                 _t(64, 64), weight_argnums=(1, 2))
    sol = solve_one_cut(tr.graph, 4)
    oracle = solve_one_cut_bruteforce(tr.graph, 4, workers=0)
    assert sol.cost == pytest.approx(oracle.cost, rel=1e-9)
    assert graph_cost(tr.graph, sol.assignment, 4, mem_scale=1.0) == \
        pytest.approx(sol.cost, rel=1e-9)


def test_solved_graph_prices_consistently():
    tr = capture(lambda x, w: torch.softmax(x @ w, -1).sum(0), _t(8, 8),
                 _t(8, 32))
    sol = solve_one_cut(tr.graph, 2)
    assert graph_cost(tr.graph, sol.assignment, 2, mem_scale=1.0) == \
        pytest.approx(sol.cost, rel=1e-9)


# -- the same programs through repro's own capture ----------------------------------

# repro's capture reads jax.core.Literal / Var / ..., which JAX 0.9 moved
# to jax.extend.core, and keeps its handler for the pjit primitive, which
# JAX 0.9 names "jit", under the old name (without it every jitted call,
# jnp.where or jnp.cumsum, falls back); the fixture points the old names at
# the new ones for the test's duration (src/repro is not edited)
_MOVED = ("Literal", "Var", "ClosedJaxpr", "Jaxpr", "JaxprEqn", "DropVar")


def _repro_capture_module(monkeypatch):
    pytest.importorskip("jax")
    import importlib

    import jax.core as jc
    import jax.extend.core as jec
    for n in _MOVED:
        if not hasattr(jc, n) and hasattr(jec, n):
            monkeypatch.setattr(jc, n, getattr(jec, n), raising=False)
    mod = importlib.import_module("repro.trace.capture")
    monkeypatch.setattr(mod._Capture, "_p_jit", mod._Capture._p_pjit,
                        raising=False)
    return mod


@pytest.fixture
def repro_capture(monkeypatch):
    return _repro_capture_module(monkeypatch).capture


def _jax_cases():
    """(JAX function, its torch transcription, shapes, weight argnums):
    each jnp / lax call maps onto the torch call that computes the same
    thing (a scan onto a Python loop)."""
    import jax
    import jax.numpy as jnp

    def j_loop(x, w):
        return jax.lax.scan(lambda c, _: (jnp.tanh(c @ w), None), x, None,
                            length=7)[0]

    def t_loop(x, w):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x

    def j_stacked(x, ws):
        return jax.lax.scan(lambda c, w: (c @ w, None), x, ws)[0]

    def t_stacked(x, ws):
        for w in ws.unbind(0):
            x = x @ w
        return x

    def t_where(m, x):
        return torch.where(m, x, torch.zeros((), device=x.device)) @ x

    return {
        "mlp": (lambda x, a, b, c: jnp.tanh(jnp.tanh(x @ a) @ b) @ c,
                lambda x, a, b, c: torch.tanh(torch.tanh(x @ a) @ b) @ c,
                [(16, 8), (8, 16), (16, 16), (16, 4)], (1, 2, 3)),
        "bmm": (lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                [(4, 8, 16), (4, 16, 2)], ()),
        "transpose": (lambda x, w: (x.T @ w).T, lambda x, w: (x.T @ w).T,
                      [(4, 8), (4, 2)], ()),
        "merge": (lambda x, w: x.reshape(4, 128) @ w,
                  lambda x, w: x.reshape(4, 128) @ w,
                  [(4, 8, 16), (128, 2)], (1,)),
        "reduce": (jnp.sum, torch.sum, [(4, 8, 2)], ()),
        "softmax": (lambda x, w: jax.nn.softmax(x @ w, -1).sum(0),
                    lambda x, w: torch.softmax(x @ w, -1).sum(0),
                    [(8, 8), (8, 32)], ()),
        "norm": (lambda x, g: x * jax.lax.rsqrt(
                     jnp.mean(x * x, -1, keepdims=True) + 1e-6) * g,
                 lambda x, g: x * torch.rsqrt(
                     (x * x).mean(-1, keepdim=True) + 1e-6) * g,
                 [(8, 32), (32,)], (1,)),
        "cumsum": (lambda x, w: jnp.cumsum(x @ w, 1),
                   lambda x, w: torch.cumsum(x @ w, 1),
                   [(8, 16), (16, 32)], (1,)),
        "where": (lambda m, x: jnp.where(m, x, 0.0) @ x, t_where,
                  [(1, 16), (16, 16)], ()),
        "dead": (lambda x, w, u: (x @ w, x @ u)[0],
                 lambda x, w, u: (x @ w, x @ u)[0],
                 [(8, 16), (16, 4), (16, 32)], (1, 2)),
        "loop": (j_loop, t_loop, [(8, 16), (16, 16)], ()),
        "stacked": (j_stacked, t_stacked, [(8, 16), (5, 16, 16)], ()),
    }


_CASES = ["mlp", "bmm", "transpose", "merge", "reduce", "softmax", "norm",
          "cumsum", "where", "dead", "loop", "stacked"]


@pytest.mark.parametrize("case", _CASES)
def test_same_program_captures_as_repros(case, repro_capture):
    """A JAX function through repro's capture and its torch transcription
    through the port's give the same op kinds in the same order and the
    same one-cut optimum, to 1e-9 relative, at 2 and 4 ways, without and
    with the capacity term (repro's 16 GB).  "dead": an unused product
    is priced on both sides (a jaxpr keeps it; eager torch runs it);
    "where": a select whose mask broadcasts is an op on both sides."""
    import jax.numpy as jnp
    from repro.core import solver as rsolver
    jf, tf, shapes, wn = _jax_cases()[case]
    boolean = case == "where"
    rt = repro_capture(jf, *(jnp.ones(s, bool if boolean and i == 0
                                      else jnp.float32)
                             for i, s in enumerate(shapes)),
                       weight_argnums=wn)
    tr = capture(tf, *(torch.ones(s, dtype=torch.bool if boolean and i == 0
                                  else torch.float32)
                       for i, s in enumerate(shapes)), weight_argnums=wn)
    assert [op.kind for op in tr.graph.ops] == \
        [op.kind for op in rt.graph.ops]
    assert [op.repeat for op in tr.graph.ops] == \
        [op.repeat for op in rt.graph.ops]
    terms = (CapacityTerm(hbm=R_HBM),)
    for n in (2, 4):
        for ms in (0.0, 1.0):
            theirs = rsolver.solve_one_cut(rt.graph, n, mem_scale=ms).cost
            mine = solve_one_cut(tr.graph, n, mem_scale=0.0,
                                 terms=terms if ms else ()).cost
            assert mine == pytest.approx(theirs, rel=1e-9, abs=1e-12), \
                (n, ms, mine, theirs)


@pytest.mark.parametrize("shape", [(1, 32, 1, 1, 16, 32), (1, 64, 2, 1, 32, 64),
                                   (2, 32, 4, 2, 16, 64), (1, 128, 1, 1, 8, 16)],
                         ids=["s32", "s64-gqa", "b2-gqa", "s128"])
def test_attention_fork_prices_like_repros_attention(shape, repro_capture):
    """The fork of the P @ V operand's paired axis (capture._dot), a rule
    repro's ``_p_dot_general`` lacks, checked against repro's own
    graph: a self-attention on projections of one x (non-causal, so no
    mask) through repro's XLA attention (its KV-chunk scan keeps the key
    axis apart by construction) and through the port's attention (the
    plain softmax, whose key axis only the fork keeps apart) have the
    same one-cut optimum at 2 and 4 ways, less repro's rank-0 ops (a
    scalar each, 4 B, which a torch trace does not emit).  Without the
    fork a sequence cut of the port's attention prices as free (the
    reduced llama3.2-3b's family ratio drops to 6e-5)."""
    import jax.numpy as jnp
    from repro.core import solver as rsolver
    from repro.models.attention import flash_attention_xla

    from repro_torch.models.attention import attention
    b, s, h, kv, hd, d = shape

    def proj(x, wq, wk, wv):
        return ((x @ wq).reshape(b, s, h, hd), (x @ wk).reshape(b, s, kv, hd),
                (x @ wv).reshape(b, s, kv, hd))
    shapes = [(b, s, d), (d, h * hd), (d, kv * hd), (d, kv * hd)]
    rt = repro_capture(lambda *a: flash_attention_xla(*proj(*a),
                                                      causal=False),
                       *(jnp.ones(x, jnp.float32) for x in shapes),
                       weight_argnums=(1, 2, 3))
    tr = capture(lambda *a: attention(*proj(*a), causal=False),
                 *(torch.ones(x) for x in shapes), weight_argnums=(1, 2, 3))
    scalars = 4.0 * sum(rt.graph.tensors[op.output].shape == ()
                        for op in rt.graph.ops)
    for n in (2, 4):
        theirs = rsolver.solve_one_cut(rt.graph, n, mem_scale=0.0).cost
        mine = solve_one_cut(tr.graph, n, mem_scale=0.0).cost
        assert theirs - scalars <= mine <= theirs, (n, mine, theirs)
        if b == 1:        # no batch cut: a cut moves K or V
            assert mine > 0.0


# -- the MLP fixture against repro's record and solver -----------------------------

def _mlp_per_axis(g, axes, sol, solve):
    out = {}
    for ax, assign in zip(sol.axes, sol.per_axis):
        out[ax.name] = solve(g, ax.size)
        g = g.divided(assign, ax.size)
    return out


def _to_repro(g):
    """The port's graph rebuilt in repro's ``core.graph.Graph``."""
    from repro.core.graph import Graph
    from repro.core.tiling import Part as RPart, REPLICATE as RREP

    from repro_torch.core.tiling import REPLICATE
    rg = Graph(g.name, g.allow_uneven)
    for n, t in g.tensors.items():
        rg.tensor(n, t.dims, t.shape, t.bytes_per_elem, t.kind, t.role,
                  dict(t.units))
    for op in g.ops:
        if op.kind == "einsum":
            rg.einsum(op.name, *op.inputs, op.output, op.repeat)
        elif op.kind == "ewise":
            rg.ewise(op.name, op.inputs, op.output, op.repeat,
                     align_dims=op.attrs.get("align_dims"),
                     update=bool(op.attrs.get("update")))
        elif op.kind == "reduce":
            rg.reduce(op.name, op.inputs[0], op.output, op.attrs["axis"],
                      op.repeat)
        else:
            forms = [({k: RREP if v is REPLICATE else RPart(v.dim)
                       for k, v in form.items()}, pen)
                     for form, pen in op.attrs["forms"]]
            rg.custom(op.name, op.inputs, op.output, forms, op.repeat)
    return rg


def test_mlp_costs_are_repros_record_and_solver():
    """The captured MLP fixture (3 einsums, as repro's record) solves on
    the verification axes, at repro's 16 GB capacity term, to repro's
    committed per-axis one-cut costs, to 1e-9 relative, and repro's own
    solver on the same graph (rebuilt in repro's IR, its default 16 GB)
    gives them too."""
    from repro_torch.trace.demo import mlp_fixture
    from repro_torch.verify.calibration import verify_axes
    fn, args, wn = mlp_fixture()
    tr = capture(fn, *args, weight_argnums=wn)
    assert [op.kind for op in tr.graph.ops] == ["einsum"] * 3
    terms = (CapacityTerm(hbm=R_HBM),)
    axes = verify_axes()
    sol = solve_mesh(tr.graph, axes, mem_scale=0.0, terms=terms)
    mine = _mlp_per_axis(tr.graph, axes, sol, lambda g, n: solve_one_cut(
        g, n, beam="auto", mem_scale=0.0, terms=terms).cost)
    for k, v in REPRO_MLP.items():
        assert mine[k] == pytest.approx(v, rel=1e-9), (k, mine)
    with open(os.path.join(ROOT, "experiments", "conformance",
                           "CONFORMANCE.json")) as f:
        rec = json.load(f)["trace"]["mlp"]
    assert {r["axis"]: r["solved"] for r in rec["per_axis"]} == REPRO_MLP
    assert rec["ops"] == len(tr.graph.ops)
    pytest.importorskip("jax")
    from repro.core import solver as rsolver
    rg = _to_repro(tr.graph)
    rsol = rsolver.solve_mesh(rg, [rsolver.MeshAxis(a.name, a.size)
                                   for a in axes])
    theirs = _mlp_per_axis(rg, axes, rsol, lambda g, n: rsolver.
                           solve_one_cut(g, n, beam="auto").cost)
    for k, v in REPRO_MLP.items():
        assert theirs[k] == pytest.approx(v, rel=1e-9), (k, theirs)


# -- the families, folding, counters --------------------------------------------

@functools.lru_cache(maxsize=None)
def _port_family(family, arch):
    """The trace cell's family record (shared by the tests below)."""
    from repro_torch.verify.calibration import verify_axes
    return trace_cell._family_record(family, arch, verify_axes())


@pytest.mark.parametrize("family,arch", trace_cell.TRACE_FAMILIES,
                         ids=[f for f, _ in trace_cell.TRACE_FAMILIES])
def test_family_ratio_within_repros_band(family, arch):
    """The captured reduced forward's solved cost over the builder's
    prefill graph's, on the verification axes, within repro's band
    (repro's committed ratio is printed beside it, not gated); every op
    lowered by a rule (no fallback)."""
    rec = _port_family(family, arch)
    print(family, rec["ratio"], "repro", rec["repro_ratio"], rec["ops"])
    assert rec["ok"], rec
    assert rec["unknown_primitives"] == []


def _one_trip_scan(mod, monkeypatch):
    """repro's ``_p_scan`` with a scan of one trip lowered as the
    straight-line code a torch trace records for a loop of one
    iteration: the xs slice and ys stack ties are kept, the loop-back
    op (and the unification of the carry's dims with the carry-out's)
    is not, since nothing flows from the one iteration's carry-out into
    a next one.  Longer scans are lowered by repro's own rule."""
    cls = mod._Capture
    scan = cls._p_scan

    def one_trip(self, eqn, invals, repeat):
        p = eqn.params
        if int(p["length"]) != 1:
            return scan(self, eqn, invals, repeat)
        nc, ncarry = p["num_consts"], p["num_carry"]
        body_in = list(invals[:nc + ncarry])
        for x in invals[nc + ncarry:]:
            if x.tensor is None or x.ndim == 0:
                body_in.append(x)
                continue
            sl = self.tensor("xslice", x.dims[1:], x.shape[1:], x.dtype)
            self.tie(x, sl, [(i + 1, i) for i in range(sl.ndim)], repeat)
            body_in.append(sl)
        out = self.lower_closed(p["jaxpr"], body_in, repeat)
        outs = list(out[:ncarry])
        for y, ov in zip(out[ncarry:], eqn.outvars[ncarry:]):
            shape = tuple(ov.aval.shape)
            if y.tensor is None:
                outs.append(self.leaf("ys", shape, ov.aval.dtype,
                                      kind="activation"))
                continue
            st = self.tensor("ystack", (self.dt.new(shape[0]),) + y.dims,
                             shape, ov.aval.dtype)
            self.tie(y, st, [(i, i + 1) for i in range(y.ndim)], repeat)
            outs.append(st)
        return outs
    monkeypatch.setattr(cls, "_p_scan", one_trip)


def _repro_family(mod, arch, axes, built=None):
    import jax
    from repro.configs import get_arch as repro_arch
    from repro.core.builders import build_graph
    from repro.configs.base import ShapeConfig
    from repro.core.solver import MeshAxis, solve_mesh as repro_solve
    from repro.models.model import LM as ReproLM
    cfg = repro_arch(arch).reduced()
    model = ReproLM(cfg)
    # shapes and dtypes only: the capture traces, it never runs
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    toks = jax.ShapeDtypeStruct((trace_cell.BATCH, trace_cell.SEQ),
                                jax.numpy.int32)
    raxes = [MeshAxis(a.name, a.size) for a in axes]
    tr = mod.capture(lambda p, t: model.forward(p, t)[0], params, toks,
                     weight_argnums=(0,), name=arch)
    traced = repro_solve(tr.graph, raxes, beam=trace_cell.TRACE_BEAM)
    if built is None:
        built = repro_solve(build_graph(cfg, ShapeConfig(
            "tr", trace_cell.SEQ, trace_cell.BATCH, "prefill")),
            raxes).total_bytes
    return {"ops": len(tr.graph.ops), "builder_bytes": built,
            "traced_bytes": traced.total_bytes,
            "ratio": traced.total_bytes / max(built, 1.0),
            "unknown_primitives": list(tr.unknown_primitives)}


# the port's family held to repro's on the same shapes: its ratio within
# this factor of repro's either way, its op count within these fractions
FAMILY_FACTOR = 2.0
FAMILY_OPS = (2 / 3, 1.0)


@pytest.mark.parametrize("family,arch", trace_cell.TRACE_FAMILIES,
                         ids=[f for f, _ in trace_cell.TRACE_FAMILIES])
def test_family_held_to_repros_capture(family, arch, monkeypatch):
    """repro's own capture of its reduced forward (the shim above), on
    the trace cell's shapes, axes and beam, first reproduces repro's
    committed record (CONFORMANCE.json, jax 0.4.37): the traced bytes
    and op count exactly for dense and moe; for xlstm to 1e-3, since
    JAX 0.9 splits the mLSTM gates with a ``split`` primitive repro has
    no rule for (one fallback op).  Then the port's captured forward is
    held to it, with repro's one-trip scans lowered as straight-line code
    (``_one_trip_scan``): its ratio within ``FAMILY_FACTOR`` of repro's,
    its op count within ``FAMILY_OPS`` of repro's.

    The two forwards are different programs that the same-program tests
    above hold to repro's capture op for op.  What remains is theirs
    (measured here, ratio port / repro): dense 0.583 / 0.378: the
    plain attention's causal mask is two ops (``le``, ``&``) where
    repro's is one, and its K enters the score product transposed;
    moe 6.61 / 8.49; xlstm 1.50 / 1.79: repro's SSD scan carries its one
    chunk in a one-trip ``lax.scan`` whose loop-back repro prices (2.91
    with it), the port's chunk loop is one straight-line iteration.  The
    port's graphs are smaller: no scalar arithmetic (a torch trace keeps
    Python scalars as constants) and no online-softmax carry, since the
    plain attention is one softmax where repro's XLA path scans KV
    chunks."""
    from repro_torch.verify.calibration import verify_axes
    mod = _repro_capture_module(monkeypatch)
    axes = verify_axes()
    with open(os.path.join(ROOT, "experiments", "conformance",
                           "CONFORMANCE.json")) as f:
        rec = {r["family"]: r for r in json.load(f)["trace"]["families"]}
    plain = _repro_family(mod, arch, axes)
    rel = 1e-3 if family == "xlstm" else 1e-9
    assert plain["traced_bytes"] == pytest.approx(
        rec[family]["traced_bytes"], rel=rel), plain
    if family != "xlstm":
        assert plain["ops"] == rec[family]["ops"], plain
    _one_trip_scan(mod, monkeypatch)
    theirs = _repro_family(mod, arch, axes, plain["builder_bytes"])
    mine = _port_family(family, arch)
    print(family, "port", mine["ratio"], mine["ops"], "repro",
          plain["ratio"], plain["ops"], "one-trip", theirs["ratio"],
          theirs["ops"])
    factor = mine["ratio"] / theirs["ratio"]
    assert 1 / FAMILY_FACTOR <= factor <= FAMILY_FACTOR, (mine, theirs)
    lo, hi = FAMILY_OPS
    assert lo * theirs["ops"] <= mine["ops"] <= hi * theirs["ops"], \
        (mine["ops"], theirs["ops"])


def _op_seq(cfg, seq=trace_cell.SEQ):
    g = trace_cell.capture_forward(cfg, seq=seq).graph
    return [(op.kind, op.repeat) for op in g.ops]


def _scales(small, big, factor):
    """Same op sequence; each repeat equal, or ``factor`` times (an op
    inside the folded loop)."""
    assert len(small) == len(big)
    for (k0, r0), (k1, r1) in zip(small, big):
        assert k0 == k1 and r1 in (r0, r0 * factor), (k0, r0, r1)
    return sum(r1 == r0 * factor != r0 for (_, r0), (_, r1)
               in zip(small, big))


@pytest.mark.parametrize("arch,field,sizes,other", [
    ("llama3.2-3b", "n_layers", (2, 4), 32),
    ("xlstm-125m", "n_layers", (4, 8), 8),
    ("xlstm-125m", "seq", (16, 32), 2)], ids=["dense-depth",
                                             "xlstm-depth", "xlstm-seq"])
def test_folding_does_not_grow_with_depth_or_length(arch, field, sizes,
                                                    other):
    """``other``: the sequence length of a depth case, the layer count of
    a length case."""
    from repro_torch.configs.base import get_arch
    base = get_arch(arch).reduced()
    if field == "seq":
        cfg = dataclasses.replace(base, n_layers=other)
        small, big = (_op_seq(cfg, seq=s) for s in sizes)
    else:
        small, big = (_op_seq(dataclasses.replace(base, n_layers=n),
                              seq=other) for n in sizes)
    assert _scales(small, big, sizes[1] // sizes[0]) > 0


def test_capture_leaves_the_kernel_counters():
    """A capture of a forward that runs the plain attention on meta
    tensors leaves ``ops``' counters as it found them."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops as kops
    kops.reset_plain_calls()
    kops.plain_calls["flash_attention_fwd_ref"] = 3
    before = [dict(c) for c in (kops.plain_calls, kops.bwd_recomputes,
                                kops.plan_fallbacks, kops.all_to_all)]
    trace_cell.capture_forward(get_arch("qwen2-1.5b").reduced())
    after = [dict(c) for c in (kops.plain_calls, kops.bwd_recomputes,
                               kops.plan_fallbacks, kops.all_to_all)]
    kops.reset_plain_calls()
    assert after == before


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_round_trip_never_solves_above_the_original(seed):
    """The fuzz's trace leg: the graph's torch program captured back
    solves to at most the original graph's one-cut optimum."""
    from repro_torch.verify import fuzz
    g = fuzz.random_graph(random.Random(seed))
    res = fuzz.FuzzResult(0, [])
    tr = fuzz._check_trace(g, (2, 4)[seed % 2], res)
    assert res.trace_checked == 1 and res.failures == []
    assert not tr.unknown_primitives


def test_cli_refuses_missing_cards():
    """``--device cuda`` (the default) on a machine with fewer cards than
    the mesh stops with an error; no fallback to the CPU."""
    from repro_torch.trace.__main__ import main
    if torch.cuda.device_count() < 8:
        assert main(["--mesh", "4x2"]) == 2


# -- autoshard on gloo ranks -----------------------------------------------------

def _rank_main(rank, world, path):
    import numpy as np
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs.base import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import LM
    from repro_torch.trace import autoshard
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    out = {"mlp": trace_cell._mlp_record(mesh)}
    cfg = get_arch("llama3.2-3b").reduced()
    model = LM(cfg)
    params = model.init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 32)))

    def fwd(p, t):
        return model.forward(p, t)[0]
    ash = autoshard(fwd, mesh, params, toks, weight_argnums=(0,))
    with torch.no_grad():
        got = ash(params, toks)
        ref = fwd(params, toks)
    out["lm"] = {"err": float((got.full_tensor().float()
                               - ref.float()).abs().max()),
                 "placements": [str(p) for p in got.placements],
                 "cut": any(isinstance(p, Part) for a in
                            ash.solution.per_axis for p in a.values())}
    one = DeviceMesh("cpu", [0], mesh_dim_names=("d",))
    if rank == 0:
        def mlp(x, w):
            return torch.tanh(x @ w)
        x, w = torch.ones(8, 4), torch.ones(4, 16) * 0.1
        a1 = autoshard(mlp, one, x, w, weight_argnums=(1,))
        y = a1(x, w)
        out["one"] = {"err": float((y.full_tensor() - mlp(x, w)).abs()
                                   .max()),
                      "bytes": a1.predicted_bytes,
                      "roles": set(a1.plan.role_cuts)
                      == set(a1.traced.graph.tensors),
                      "describe": "autoshard" in a1.describe()}
        torch.save(out, path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.launch.mesh import spawn
    path = tmp_path_factory.mktemp("trace_ranks") / "out.pt"
    spawn(_rank_main, 8, "cpu", (str(path),))
    return torch.load(path, weights_only=False)


def test_autoshard_single_device(ranks):
    rec = ranks["one"]
    assert rec["err"] <= 1e-6
    assert rec["bytes"] >= 0.0 and rec["roles"] and rec["describe"]


def test_autoshard_mlp_matches_serial_on_4x2(ranks):
    """The MLP fixture: the solved one-cut cost equals the oracle at both
    axes of the (4, 2) mesh, and the DTensor-placed run is within
    EXEC_ATOL of the serial function."""
    rec = ranks["mlp"]
    assert rec["oracle_ok"] and rec["exec_ok"], rec
    assert rec["ops"] == 3


def test_autoshard_lm_forward_matches_serial_on_4x2(ranks):
    """The reduced llama3.2-3b forward (bf16), captured, solved on the
    (4, 2) mesh and run on DTensors (the attention through
    ``attention_sharded``), against the serial forward within the
    conformance logits band."""
    from repro_torch.verify.numerics import LOGITS_ATOL
    rec = ranks["lm"]
    assert rec["cut"]
    assert rec["err"] <= LOGITS_ATOL, rec
