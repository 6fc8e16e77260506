"""The port's conformance package (src/repro_torch/verify/) on the CPU,
against repro's ``repro.verify`` on the same seeds, and the planned
projection route (``models/sharding.matmul``) on 8 gloo ranks.

- ``CELLS``, the verification mesh, the bands and the pseudo-cells'
  constants are repro's, field for field; ``calibration_pass`` gives
  repro's record on a grid; ``--list`` prints repro's rows.
- ``fuzz.random_graph`` draws repro's graphs for seeds 0-19 (the Python
  ``random`` stream is consumed as repro's), and the oracle and
  permutation verdicts of ``check_graph`` are repro's; ``executor.
  execute`` gives repro's values on those graphs within ``EXEC_ATOL``.
- Each cell's predicted bytes (``solution_breakdown`` of the as-executed
  projection) are repro's under repro's axes and HBM (the solver is a
  copy), both sides solved at beam 32 (at "auto" a train cell's solve
  takes 25-40 s a side on a CPU).
- The serial side of one dense and one hybrid cell (f32 copies of their
  configs, repro's weights through ``convert.py``) is within the serving
  bands of tests/test_torch_hybrid_serve.py: the prefill logits of
  ``gqa-prefill`` at the f32 band (1e-5 + 1e-5 |repro|), the 4 decode
  steps of ``hybrid-decode`` run free at 1e-3 (its bf16 conv history and
  K/V rings may round an f32 value to the neighbouring bf16 value).
- One spawn of 8 gloo ranks (module fixture):
  - the projection route of a prefill's ``x`` cut on batch and seq
    (placements (S(0), S(1)), (S(1), R) against a weight cut on its
    output dim, forward and backward, (S(0), S(1)) against a weight cut
    on its output dim on the seq cut's mesh dim (the seq cut gathered
    first), and, without autograd, (S(1), S(2)) and (S(1), R) against a
    weight cut on its input dim), bit-equal
    to DTensor's
    ``x @ w``
    where this torch runs it (2.13), and to each rank's local product
    everywhere; torch 2.11 refuses ``x @ w`` there ("Attempted to
    flatten multiple dimensions"), which is what the route is for;
  - the mutation check: fuzz graphs executed sharded on the ``(4,)``
    "fz" mesh of the first 4 ranks pass the execution invariant, and
    with a deliberately wrong leaf placement (every rank handed rank 0's
    slice of each cut leaf) every graph that has a cut leaf fails it;
    both with DTensor's einsum and with every einsum sent, as torch 2.11
    sends a refused one, through the executor's local route;
  - the dense-train cell's step under its solved plan, its measured wire
    bytes under their cap (``WIRE_CAPS``).
- One run of ``python -m repro_torch.verify --device cpu --cells
  dense-decode,xlstm-train,xlstm-decode,trace --fuzz 10 --json --out
  ''`` (its own 8 gloo ranks), as tests/test_verify_smoke.py runs
  repro's: ``pass``, each cell's calibration, numerics and wire-byte cap,
  the DP gate on ``xlstm-train``, the trace cell, and the fuzz's trace
  legs.

repro is imported inside the tests that compare with it, so on a machine
without JAX (the card's) the rank and CLI tests still run."""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.solver import solve_one_cut
from repro_torch.verify import (calibration, cells, compute_cell, executor,
                                fuzz, numerics, pipeline_cell, serve_cell,
                                serve_paged_cell, train_cell)

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SEEDS = range(20)
R_HBM = 16e9                 # repro's HBM per device (its capacity term)
F32_TOL = 1e-5
FREE_TOL = 1e-3


def _repro():
    return pytest.importorskip("jax")


# -- registry, bands, constants ------------------------------------------------

def test_cells_mesh_and_bands_are_repros():
    _repro()
    from repro.verify import calibration as rcal
    from repro.verify import cells as rcells
    from repro.verify import compute_cell as rcomp
    from repro.verify import fuzz as rfuzz
    from repro.verify import numerics as rnum
    from repro.verify import pipeline_cell as rpipe
    from repro.verify import serve_cell as rserve
    from repro.verify import serve_paged_cell as rpaged
    from repro.verify import train_cell as rtrain
    assert [dataclasses.asdict(c) for c in cells.CELLS] == \
        [dataclasses.asdict(c) for c in rcells.CELLS]
    assert (cells.MESH_SHAPE, cells.MESH_AXES, cells.N_DEVICES) == \
        (rcells.MESH_SHAPE, rcells.MESH_AXES, rcells.N_DEVICES)
    assert calibration.MESH_SHAPE is cells.MESH_SHAPE
    for mine, theirs, names in [
            (numerics, rnum, ("LOSS_ATOL", "LOGITS_ATOL", "DECODE_STEPS")),
            (calibration, rcal, ("RATIO_LO", "RATIO_HI", "ABS_FLOOR",
                                 "DP_SLACK")),
            (fuzz, rfuzz, ("EXEC_ATOL", "_DIM_SIZES", "_MAX_BRUTE_COMBOS")),
            (serve_cell, rserve, ("SERVE_ARCH", "SLOTS", "MAX_LEN", "CHUNK",
                                  "DECODE_STEPS")),
            (serve_paged_cell, rpaged, ("FAMILIES", "SLOTS", "MAX_LEN",
                                        "BLOCK_LEN", "BUDGET", "N_REQ",
                                        "SPEC_K", "DECODE_STEPS")),
            (train_cell, rtrain, ("TRAIN_ARCH", "BATCH", "SEQ", "STEPS",
                                  "MICROBATCHES", "TRAIN_LOSS_ATOL",
                                  "ACCUM_ATOL")),
            (pipeline_cell, rpipe, ("LAYERS", "D_MODEL", "BATCH", "N_MICRO",
                                    "STEPS", "STAGE_COUNTS",
                                    "PIPE_LOSS_ATOL")),
            (compute_cell, rcomp, ("CAL_CELLS",))]:
        for n in names:
            assert getattr(mine, n) == getattr(theirs, n), n
    assert [c.name for c in cells.get_cells(["xlstm-decode", "dense-train"])
            ] == ["xlstm-decode", "dense-train"]
    with pytest.raises(KeyError, match="unknown cells"):
        cells.get_cells(["nope"])


GRID = [(p, m) for p in (0.0, 1e3, 2e5, 256e3, 3e5, 1e6, 1e8)
        for m in (0.0, 1e3, 5e4, 2.5e5, 1e6, 1.1e6, 4e6, 4.1e6, 4e8)]


def test_calibration_pass_is_repros_on_a_grid():
    _repro()
    from repro.verify.calibration import calibration_pass as ref
    for p, m in GRID:
        assert calibration.calibration_pass(p, m) == ref(p, m), (p, m)


def test_list_rows_are_repros(capsys):
    _repro()
    from repro_torch.verify.__main__ import main
    assert main(["--list"]) == 0
    got = capsys.readouterr().out
    want = subprocess.run(
        [sys.executable, "-m", "repro.verify", "--list"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert want.returncode == 0
    assert got == want.stdout


# -- fuzz graphs, verdicts and the executor ------------------------------------

def _graph_record(g):
    return ([(n, t.dims, tuple(t.shape), t.kind, t.role, t.bytes_per_elem)
             for n, t in g.tensors.items()],
            [(o.name, o.kind, tuple(o.inputs), o.output,
              {k: v for k, v in o.attrs.items()}) for o in g.ops])


@pytest.mark.parametrize("seed", SEEDS)
def test_random_graphs_and_verdicts_are_repros(seed):
    """The same seed draws the same graph, and after the permuted clone
    the same next graph (the stream stays in step); the solver's cost
    and the oracle and permutation verdicts are repro's (the oracle only
    where its enumeration is under 3,000 tilings: the rest take seconds
    to a minute a side)."""
    _repro()
    from repro.core import solver as rsolver
    from repro.verify import fuzz as rfuzz
    rng_t, rng_j = random.Random(seed), random.Random(seed)
    g, rg = fuzz.random_graph(rng_t), rfuzz.random_graph(rng_j)
    assert _graph_record(g) == _graph_record(rg)
    arity = (2, 4)[seed % 2]
    brute = fuzz.brute_combo_count(g, arity) <= 3000
    assert brute == (rfuzz.brute_combo_count(rg, arity) <= 3000)
    legs = ("oracle",) if brute else ()
    res = fuzz.FuzzResult(0, [])
    fuzz.check_graph(g, arity, rng_t, res, legs=legs)
    assert res.failures == []
    sol = rsolver.solve_one_cut(rg, arity, beam="auto")
    sol2 = rsolver.solve_one_cut(rfuzz.permuted_clone(rg, rng_j), arity,
                                 beam="auto")
    assert abs(sol.cost - sol2.cost) <= 1e-9 * max(sol.cost, 1.0)
    if brute:
        oracle = rsolver.solve_one_cut_bruteforce(rg, arity, workers=0)
        assert abs(sol.cost - oracle.cost) <= 1e-9 * max(sol.cost, 1.0)
        assert (res.oracle_checked, res.permutation_checked) == (1, 1)
    mine = solve_one_cut(g, arity, beam="auto", mem_scale=0.0).cost
    theirs = rsolver.solve_one_cut(rg, arity, beam="auto",
                                   mem_scale=0.0).cost
    assert mine == pytest.approx(theirs, rel=1e-12)
    assert _graph_record(fuzz.random_graph(rng_t)) == \
        _graph_record(rfuzz.random_graph(rng_j))


@pytest.mark.parametrize("seed", SEEDS)
def test_executor_values_are_repros(seed):
    """``execute`` on numpy leaf values (``random_values``) against
    repro's on the same values, every tensor within EXEC_ATOL of its
    scale."""
    _repro()
    from repro.verify import executor as rexec
    g = fuzz.random_graph(random.Random(seed))
    vals = executor.random_values(g, seed)
    assert sorted(vals) == sorted(executor.leaf_tensors(g))
    assert executor.sink_tensors(g) == rexec.sink_tensors(g)
    got = executor.execute(g, vals)
    want = rexec.execute(g, vals)
    assert set(got) == set(want)
    for t in want:
        ref = np.asarray(want[t], np.float32)
        scale = max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
        np.testing.assert_allclose(got[t].numpy(), ref, rtol=0,
                                   atol=fuzz.EXEC_ATOL * scale, err_msg=t)


# -- predicted bytes -------------------------------------------------------------

@pytest.mark.parametrize("spec", cells.CELLS, ids=lambda c: c.name)
def test_predicted_bytes_are_repros(spec):
    """The cell's graph, its solve (MoE pins included) and the
    as-executed breakdown under repro's ICI axes and 16 GB HBM: repro's
    total, kinds and axes."""
    _repro()
    from repro.core.builders import build_graph as r_build
    from repro.core.solver import MeshAxis as RAxis
    from repro.core.solver import solution_breakdown as r_breakdown
    from repro.core.solver import solve_mesh as r_solve
    from repro.launch.mesh import ICI_BW, ICI_LINKS_PER_AXIS
    from repro.verify import calibration as rcal
    from repro.verify import cells as rcells

    from repro_torch.core.builders import build_graph
    from repro_torch.core.costterms import CapacityTerm
    from repro_torch.core.solver import MeshAxis, solution_breakdown, \
        solve_mesh
    bw = ICI_BW * ICI_LINKS_PER_AXIS
    rspec = rcells.get_cells([spec.name])[0]
    rg = r_build(rspec.cfg(), rspec.shape())
    raxes = [RAxis(n, s, bw) for n, s in zip(cells.MESH_AXES,
                                             cells.MESH_SHAPE)]
    rsol = r_solve(rg, raxes, beam=32,
                   fixed_per_axis=rcal._moe_pins(rg, rspec.cfg(), raxes))
    want = r_breakdown(rg, raxes,
                       rcal.faithful_assignments(rg, rsol.per_axis))
    g = build_graph(spec.cfg(), spec.shape())
    axes = [MeshAxis(n, s, bw) for n, s in zip(cells.MESH_AXES,
                                               cells.MESH_SHAPE)]
    sol = solve_mesh(g, axes, beam=32, mem_scale=0.0,
                     terms=(CapacityTerm(scale=1.0, hbm=R_HBM),),
                     fixed_per_axis=calibration._moe_pins(g, spec.cfg(),
                                                          axes))
    got = solution_breakdown(g, axes,
                             calibration.faithful_assignments(g,
                                                              sol.per_axis))
    assert got["total"] == pytest.approx(want["total"], rel=1e-9)
    for k in ("by_kind", "by_axis"):
        assert set(got[k]) == set(want[k])
        for n in want[k]:
            assert got[k][n] == pytest.approx(want[k][n], rel=1e-9), (k, n)


# -- the serial side against repro's LM -------------------------------------

def _f32_pair(spec):
    jax = _repro()
    from repro.models.model import LM as JaxLM
    from repro_torch.convert import params_from_jax
    from repro_torch.models.model import LM
    from repro.configs import get_arch as jax_arch
    jcfg = dataclasses.replace(jax_arch(spec.arch).reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(spec.cfg(), dtype="float32")
    jm = JaxLM(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    return jax, jm, jp, LM(tcfg), tp


def test_dense_prefill_serial_side_is_repros():
    """``gqa-prefill``'s batch (``numerics._batch``) through the port's
    serial forward and repro's: the logits in the f32 band."""
    spec = cells.get_cells(["gqa-prefill"])[0]
    jax, jm, jp, tm, tp = _f32_pair(spec)
    toks = numerics._batch(tm.cfg, spec.shape(), "cpu")["tokens"]
    with torch.no_grad():
        got = tm.forward(tp, toks)[0].numpy()
    want = np.asarray(jax.jit(jm.forward)(jp, jax.numpy.asarray(
        toks.numpy()))[0])
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_hybrid_decode_serial_side_is_repros():
    """``hybrid-decode``'s 4 decode steps (the tokens ``run_numerics``
    feeds) run free on both sides from zero caches: the logits within
    1e-3, the positions equal."""
    spec = cells.get_cells(["hybrid-decode"])[0]
    jax, jm, jp, tm, tp = _f32_pair(spec)
    b, s = spec.batch, spec.seq_len
    g = torch.Generator(device="cpu").manual_seed(0)
    toks = torch.randint(0, tm.cfg.vocab, (numerics.DECODE_STEPS, b),
                         generator=g)
    step = jax.jit(jm.decode_step)
    jc, tc = jm.init_cache(b, s), tm.init_cache(b, s, device="cpu")
    worst = 0.0
    with torch.no_grad():
        for i in range(numerics.DECODE_STEPS):
            lj, jc = step(jp, jc, jax.numpy.asarray(toks[i].numpy()))
            lt, tc = tm.decode_step(tp, tc, toks[i])
            worst = max(worst, float(np.abs(lt.numpy()
                                            - np.asarray(lj)).max()))
    assert worst < FREE_TOL
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


# -- 8 gloo ranks: the projection route and the mutation check ----------------

MUT_SEEDS = range(12)


ROUTE_CASES = {"x(S0,S1)-w(R,R)": ["S(0)", "S(1)"],
               "x(S1,R)-w(R,S1)": ["S(1)", "S(2)"],
               "x(S0,S1)-w(R,S1)": ["S(0)", "S(2)"],
               "x(S1,S2)-w(R,S0)-no-grad": ["S(1)", "P(sum)"],
               "x(S1,R)-w(R,S0)-no-grad": ["S(1)", "P(sum)"],
               "x(S0,S2)-w(R,S0)-to(S0,S1)": ["S(0)", "S(1)"]}


def _route_cases():
    """(name, x placements, w placements, with autograd, the placements
    of a stream the output is added to after the product, or None) on
    the (4, 2) mesh."""
    from torch.distributed.tensor import Replicate, Shard
    return [("x(S0,S1)-w(R,R)", [Shard(0), Shard(1)],
             [Replicate(), Replicate()], True, None),
            ("x(S1,R)-w(R,S1)", [Shard(1), Replicate()],
             [Replicate(), Shard(1)], True, None),
            # x cut on seq and w on its output dim over one mesh dim: no
            # local rule, x's seq cut gathered (torch 2.11 refused the
            # product here in the hybrid family's planned training)
            ("x(S0,S1)-w(R,S1)", [Shard(0), Shard(1)],
             [Replicate(), Shard(1)], True, None),
            ("x(S1,S2)-w(R,S0)-no-grad", [Shard(1), Shard(2)],
             [Replicate(), Shard(0)], False, None),
            ("x(S1,R)-w(R,S0)-no-grad", [Shard(1), Replicate()],
             [Replicate(), Shard(0)], False, None),
            # the MLP's down projection under a Megatron plan with the
            # activations cut on seq: a pending sum scattered onto seq,
            # so its gradient arrives cut on seq (torch 2.11 refused the
            # product's backward here in the hybrid family's training)
            ("x(S0,S2)-w(R,S0)-to(S0,S1)", [Shard(0), Shard(2)],
             [Replicate(), Shard(0)], True, [Shard(0), Shard(1)])]


@contextlib.contextmanager
def _flatten_refused():
    """Make DTensor refuse a view that flattens a cut dim other than the
    group's first, as torch 2.11 does ("Attempted to flatten multiple
    dimensions"); torch 2.13 runs that view with a ``_StridedShard``
    output, which is what this refuses.  Where DTensor has no such
    placement (2.11) the refusal is its own and nothing is patched."""
    try:
        from torch.distributed.tensor._ops import _view_ops as vo
        from torch.distributed.tensor.placement_types import _StridedShard
        real = vo.propagate_shape_and_sharding
    except (ImportError, AttributeError):
        yield
        return

    def refuse(*a, **kw):
        res = real(*a, **kw)
        if any(isinstance(p, _StridedShard) for p in res[1]):
            raise RuntimeError("Attempted to flatten multiple dimensions "
                               f"(emulated): {a[0]} -> {res[1]}")
        return res
    vo.propagate_shape_and_sharding = refuse
    try:
        yield
    finally:
        vo.propagate_shape_and_sharding = real


def _route(mesh):
    """Each case's route against DTensor's ``x @ w`` (where this torch
    runs it) and each rank's local product: forward, and both grads
    where the case has autograd."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.sharding import matmul
    def run(f, xpl, wpl, grad, to):
        x = distribute_tensor(x_full, mesh, xpl).requires_grad_(grad)
        w = distribute_tensor(w_full, mesh, wpl).requires_grad_(grad)
        with torch.set_grad_enabled(grad):
            y = f(x, w)
            if to is not None:
                # a residual add of a stream placed ``to``: DTensor takes
                # y there below autograd, so y's gradient arrives so
                y = y + distribute_tensor(torch.zeros(y.shape), mesh, to)
        vals = (y.full_tensor(),)
        if grad:
            (y * distribute_tensor(dy_full, mesh, y.placements)).sum() \
                .backward()
            vals += (x.grad.full_tensor(), w.grad.full_tensor())
        return x, w, y, vals

    out = {}
    for name, xpl, wpl, grad, to in _route_cases():
        # the last case at a seq of its own: DTensor caches its sharding
        # decisions by shapes and placements, and an earlier case's
        # views would answer the refused one without running its rule
        s = 16 if to is None else 8
        gen = torch.Generator().manual_seed(0)
        x_full = torch.randn(8, s, 32, generator=gen)
        w_full = torch.randn(32, 24, generator=gen)
        dy_full = torch.randn(8, s, 24, generator=gen)
        rec = {}
        with _flatten_refused():
            x, w, y, got = run(matmul, xpl, wpl, grad, to)
        rec["placements"] = [str(p) for p in y.placements]
        xl = x.redistribute(mesh, [
            Shard(2) if isinstance(p, Replicate) and isinstance(q, Shard)
            and q.dim == 0 else Replicate() if isinstance(p, Shard)
            and p.dim == 1 and isinstance(q, Shard) else p
            for p, q in zip(xpl, wpl)])
        if to is not None:
            with torch.no_grad():
                y = matmul(x, w)
        rec["local"] = torch.equal(y.to_local(),
                                   xl.to_local() @ w.to_local())
        xp = x_full.clone().requires_grad_()
        wp = w_full.clone().requires_grad_()
        (xp @ wp * dy_full).sum().backward()
        rec["plain_err"] = max(float((a - b).abs().max()) for a, b in
                               zip(got, (xp @ wp, xp.grad, wp.grad)))
        try:
            want = run(lambda a, b: a @ b, xpl, wpl, grad, to)[3]
            rec["dtensor"] = all(torch.equal(a, b)
                                 for a, b in zip(got, want))
        except Exception as e:      # torch 2.11: the flatten refusal
            rec["dtensor"] = f"refused: {type(e).__name__}: {e}"
        out[name] = rec
    return out


def _mutation(rank):
    """The execution invariant on fuzz graphs on the "fz" mesh, as is and
    with every rank handed rank 0's slice of each cut leaf: per graph,
    (cut leaves, failures as is, failures mutated)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Shard

    from repro_torch.models.sharding import from_local, place
    mesh = DeviceMesh("cpu", list(range(4)), mesh_dim_names=("fz",))
    if rank >= 4:
        return None
    cut = []

    def wrong(value, mesh, placements):
        p = placements[0]
        if isinstance(p, Shard) and value.shape[p.dim] % 4 == 0:
            cut.append(1)
            return from_local(value.chunk(4, p.dim)[0].contiguous(), mesh,
                              placements, value.shape)
        return place(value, mesh, placements)

    from torch.distributed.tensor import DTensor
    real_einsum = torch.einsum

    def refusing(sub, *xs):
        # torch 2.11's refusal, of every einsum of DTensors
        if any(isinstance(x, DTensor) for x in xs):
            raise RuntimeError("Attempted to flatten multiple dimensions, "
                               "with dimension 1 being sharded")
        return real_einsum(sub, *xs)

    def other_error(sub, *xs):
        raise RuntimeError("not a flatten refusal")

    out = {"dtensor": [], "local": []}
    right = executor._place_leaf
    for seed in MUT_SEEDS:
        g = fuzz.random_graph(random.Random(seed))
        for route, einsum in (("dtensor", real_einsum),
                              ("local", refusing)):
            runs = []
            for placer in (right, wrong):
                cut.clear()
                executor._place_leaf = placer
                torch.einsum = einsum
                res = fuzz.FuzzResult(0, [])
                try:
                    fuzz._check_exec(g, seed, res, mesh, fuzz.EXEC_ATOL)
                except Exception as e:   # a mutated run may not even run
                    res.failures.append(repr(e))
                finally:
                    executor._place_leaf = right
                    torch.einsum = real_einsum
                runs.append((len(cut), res.failures,
                             res.exec_local_einsums))
            out[route].append((runs[1][0], runs[0][1], runs[1][1],
                               runs[0][2]))
    torch.einsum = other_error
    try:
        fuzz._check_exec(fuzz.random_graph(random.Random(0)), 0,
                         fuzz.FuzzResult(0, []), mesh, fuzz.EXEC_ATOL)
        out["other_error"] = None
    except RuntimeError as e:
        out["other_error"] = str(e)
    finally:
        torch.einsum = real_einsum
    return out


def _dense_train_plan():
    """The dense-train cell's as-executed plan (calibration's), solved at
    beam 256: the plan the CLI solves at beam "auto" (the same role cuts,
    in ~1 s where "auto" takes ~25 s on this CPU)."""
    from repro_torch.core.builders import build_graph
    from repro_torch.core.plan import ShardingPlan
    from repro_torch.core.solver import TilingSolution, solve_mesh
    spec = cells.get_cells(["dense-train"])[0]
    cfg, shape = spec.cfg(), spec.shape()
    g = build_graph(cfg, shape)
    axes = calibration.verify_axes()
    sol = solve_mesh(g, axes, beam=256)
    ex = calibration.faithful_assignments(g, sol.per_axis)
    return ShardingPlan.from_graph_solution(
        TilingSolution(list(axes), ex, [0.0] * len(axes), 0.0, 0.0), g)


def _rank_main(rank, world, path, dense_plan):
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    out = {"route": _route(mesh), "mutation": _mutation(rank)}
    spec = cells.get_cells(["dense-train"])[0]
    out["dense_train"] = calibration._measure(spec.cfg(), spec.shape(),
                                              dense_plan, mesh)
    if rank == 0:
        torch.save(out, path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.launch.mesh import spawn
    path = tmp_path_factory.mktemp("verify_ranks") / "out.pt"
    spawn(_rank_main, 8, "cpu", (str(path), _dense_train_plan()))
    return torch.load(path, weights_only=False)


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_projection_route_is_the_dtensor_product(ranks, case):
    """The route's output keeps the cut (batch and seq over the mesh, or
    seq and the weight's output cut; without autograd a contracted cut
    gives a pending sum; x's seq cut over the mesh dim that cuts the
    weight's output is gathered first; a pending sum's gradient that
    arrives cut on seq is gathered on seq), each rank's shard is its
    local product bit for bit, the route runs with DTensor refusing
    every flatten of a cut dim other than the first (as torch 2.11
    does: ``_flatten_refused``), and the forward (and both grads) are
    DTensor's ``x @ w`` bit for bit where this torch runs it (2.13);
    torch 2.11 refuses it with the flatten error.  Against one process's product the values are
    within f32 summation order (the weight's grad sums the ranks' rows
    in another order)."""
    rec = ranks["route"][case]
    assert rec["placements"] == ROUTE_CASES[case]
    assert rec["local"] is True
    if isinstance(rec["dtensor"], str):
        assert "flatten" in rec["dtensor"], rec["dtensor"]
    else:
        assert rec["dtensor"] is True
    assert rec["plain_err"] < 1e-4


@pytest.mark.parametrize("route", ["dtensor", "local"])
def test_wrong_leaf_placement_fails_the_exec_invariant(ranks, route):
    """As is, every graph passes the execution invariant; with the
    wrong placement every graph that has a leaf cut evenly over the 4
    ranks fails it (and there are such graphs).  "dtensor": the einsums
    as DTensor runs them, those this torch refuses through the local
    route (none on 2.13, some on 2.11); "local": every einsum of
    DTensors refused with torch 2.11's flatten error, so each runs
    sharded through ``executor.local_einsum`` and is counted."""
    recs = ranks["mutation"][route]
    assert all(ok == [] for _, ok, _, _ in recs)
    cut = [bad for n, _, bad, _ in recs if n]
    assert len(cut) >= 3
    assert all(bad for bad in cut)
    n_local = [n for _, _, _, n in recs]
    forced = [n for _, _, _, n in ranks["mutation"]["local"]]
    if route == "local":
        assert all(n > 0 for n in n_local)
    else:
        # only the einsums this torch refuses (none on 2.13, some on 2.11)
        assert all(n <= f for n, f in zip(n_local, forced))


def test_exec_leg_raises_other_einsum_errors(ranks):
    """Only torch 2.11's flatten refusal sends an einsum to the local
    route: any other error of an op reaches the caller."""
    assert ranks["mutation"]["other_error"] == "not a flatten refusal"


# the measured wire bytes of one executed step of each cell the 8-rank
# tests run, capped at what this port measured on 8 gloo ranks, each
# rounded up by at most 5% (the per-collective tables: PERF.md §6).
# dense-train's equals repro's *executed* bytes to 0.3% (9,451,120: its
# compiled step counted with the layer loop's trip count,
# experiments/conformance/repro_executed_bytes.py; repro's record counts
# each collective of the program text once, 3,580,528); xlstm-decode
# moves 22,656 bytes since its decode steps update each rank's own heads
# (sharding.step_rows(heads=True); 153,728 before)
WIRE_CAPS = {"dense-train": 9_600_000,      # measured 9,479,816
             "dense-decode": 57_000,        # 55,296
             "xlstm-train": 10_300_000,     # 10,034,824
             "xlstm-decode": 23_500}        # 22,656


def test_dense_train_wire_bytes_under_cap(ranks):
    """The dense-train step under its solved plan (beam 256, the CLI's
    plan) moves at most WIRE_CAPS["dense-train"]; its all-reduces are the
    f32 gradient sums that repro issues too (ten over the flattened 8
    ranks, for the four layers' replicated weights)."""
    rec = ranks["dense_train"]
    assert rec["wire_bytes_total"] <= WIRE_CAPS["dense-train"], rec
    assert rec["counts"]["all-reduce"] == 13
    grads = [r for r in rec["by_site"] if "_reduce_flat" in r["site"]]
    assert sum(r["count"] for r in grads) == 10


# -- the CLI on 8 gloo ranks -------------------------------------------------------

def test_cli_cell_and_fuzz_smoke():
    """``python -m repro_torch.verify --device cpu --cells
    dense-decode,xlstm-train,xlstm-decode,trace --fuzz 10 --json --out
    ''``: repro's smoke (tests/test_verify_smoke.py) on the port's 8 gloo
    ranks, each cell's measured wire bytes under WIRE_CAPS, with the
    trace cell: the dense, moe and xlstm ratios within repro's bands, the
    MLP's solved cost equal to the oracle at both axes and its sharded
    output within EXEC_ATOL; the fuzz's trace legs count, and no round
    trip solves above its original graph."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.verify", "--device", "cpu",
         "--cells", "dense-decode,xlstm-train,xlstm-decode,trace",
         "--fuzz", "10", "--json", "--out", ""], capture_output=True,
        text=True, timeout=600, env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr[-4000:] + out.stdout[-2000:]
    rep = json.loads(out.stdout)
    assert rep["pass"] is True
    assert rep["meta"]["n_devices"] == 8 and rep["meta"]["device"] == "cpu"
    by = {c["cell"]: c for c in rep["cells"]}
    assert set(by) == {"dense-decode", "xlstm-train", "xlstm-decode"}
    for c in by.values():
        assert c["status"] == "ok"
        assert c["calibration"]["ok"]
        assert c["numerics"]["ok"]
        assert c["measured"]["wire_bytes_total"] <= WIRE_CAPS[c["cell"]], \
            (c["cell"], c["measured"])
    assert by["xlstm-train"]["dp_baseline"]["gated"]
    assert by["xlstm-train"]["dp_baseline"]["ok"]
    assert not by["dense-decode"]["dp_baseline"]["gated"]
    fz = rep["fuzz"]
    assert fz["ok"] and fz["n"] == 10
    assert fz["oracle_checked"] >= 6
    assert fz["exec_checked"] >= 1
    assert fz["trace_checked"] == 10
    assert fz["trace_exec_checked"] == fz["exec_checked"]
    assert "serve" not in rep
    tr = rep["trace"]
    assert tr["status"] == "ok", tr
    from repro_torch.verify.trace_cell import FAMILY_BANDS
    assert [f["family"] for f in tr["families"]] == list(FAMILY_BANDS)
    for f in tr["families"]:
        lo, hi = FAMILY_BANDS[f["family"]]
        assert lo <= f["ratio"] <= hi, f
    mlp = tr["mlp"]
    assert mlp["oracle_ok"] and mlp["exec_ok"]
    assert [a["axis"] for a in mlp["per_axis"]] == ["data", "model"]
    assert mlp["max_abs_err"] <= fuzz.EXEC_ATOL * max(1.0, mlp["scale"])


def test_cli_refuses_trace_and_missing_cards():
    """The trace cell is a cell the CLI takes (an unknown name beside it
    still raises before any rank starts); --device cuda on a machine with
    fewer than 8 cards stops with an error that names the count and
    --device cpu (no fallback)."""
    from repro_torch.verify.__main__ import PSEUDO, main
    assert "trace" in PSEUDO
    with pytest.raises(KeyError, match="nope"):
        main(["--cells", "trace,nope", "--device", "cpu"])
    if torch.cuda.device_count() < cells.N_DEVICES:
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.verify", "--cells",
             "dense-decode", "--fuzz", "0"], capture_output=True, text=True,
            timeout=120, env=dict(os.environ, PYTHONPATH=SRC))
        assert out.returncode == 2
        assert f"has {torch.cuda.device_count()}" in out.stderr
        assert "--device cpu" in out.stderr
