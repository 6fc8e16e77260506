"""The port's solver copy (``repro_torch.core``) against repro's solver.

The same architecture and shape go through both packages' ``build_graph``
and ``solve_mesh``; the per-axis assignments must be equal and the byte
totals equal to 1e-9 relative.  The port's defaults are the H100's (80 GB
HBM, NVLink bandwidths), so the port's solves here take repro's constants,
read from repro's modules: every axis' bandwidth, and the capacity term's
HBM size (through a ``CapacityTerm`` in place of ``mem_scale``'s default,
the same penalty table).  The small ``mlp_graph`` graphs are held to the
brute-force oracle, as ``benchmarks/solver_bench.py`` holds repro's."""
from __future__ import annotations

import pytest

from repro.configs.base import SHAPES as R_SHAPES
from repro.configs.base import ShapeConfig as RShape
from repro.configs.base import get_arch as r_arch
from repro.core.builders import build_graph as r_build
from repro.core.builders import mlp_graph as r_mlp
from repro.core.plan import ShardingPlan as RPlan
from repro.core.cost import HBM_PER_DEV as R_HBM
from repro.core.solver import MeshAxis as RAxis
from repro.core.solver import solve_mesh as r_solve
from repro.core.solver import solve_one_cut_bruteforce as r_brute
from repro.launch.mesh import ICI_BW, ICI_LINKS_PER_AXIS
from repro_torch.configs.base import SHAPES, ShapeConfig, get_arch
from repro_torch.core import costterms, solver
from repro_torch.core.builders import build_graph, mlp_graph
from repro_torch.core.cost import HBM_PER_DEV, graph_cost
from repro_torch.core.costterms import CapacityTerm
from repro_torch.core.plan import ShardingPlan
from repro_torch.core.solver import (MeshAxis, solve_mesh, solve_one_cut,
                                     solve_one_cut_bruteforce)
from repro_torch.launch import mesh as tmesh

REL = 1e-9
ARCHS = ["qwen2-1.5b", "llama3.2-3b", "zamba2-2.7b"]
SERVE = ("serve16x2048", 2048, 16, "decode")
CASES = ([(a, s, m) for a in ARCHS for s in ("decode_32k", SERVE)
          for m in ((4, 2), (2, 4), (16, 16))]
         + [(a, "train_4k", (4, 2)) for a in ARCHS])


def _ids(case):
    a, s, m = case
    return f"{a}-{s if isinstance(s, str) else s[0]}-{m[0]}x{m[1]}"


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= REL * max(1.0, abs(a), abs(b))


def _canon(assign):
    return {t: repr(c) for t, c in assign.items()}


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_solve_mesh_matches_repro(case):
    arch, shape, mesh = case
    if isinstance(shape, str):
        r_shape, t_shape = R_SHAPES[shape], SHAPES[shape]
    else:
        r_shape, t_shape = RShape(*shape), ShapeConfig(*shape)
    bw = ICI_BW * ICI_LINKS_PER_AXIS
    names = ("data", "model")
    rg = r_build(r_arch(arch), r_shape)
    ref = r_solve(rg, [RAxis(n, s, bw) for n, s in zip(names, mesh)])
    g = build_graph(get_arch(arch), t_shape)
    got = solve_mesh(g, [MeshAxis(n, s, bw) for n, s in zip(names, mesh)],
                     mem_scale=0.0,
                     terms=(CapacityTerm(scale=1.0, hbm=R_HBM),))
    assert [_canon(a) for a in got.per_axis] == \
        [_canon(a) for a in ref.per_axis]
    assert _close(got.total_bytes, ref.total_bytes), \
        (got.total_bytes, ref.total_bytes)
    assert all(_close(a, b) for a, b in zip(got.per_axis_bytes,
                                            ref.per_axis_bytes))
    assert _close(got.total_seconds, ref.total_seconds)
    # the role cuts a plan is made of, too
    assert ShardingPlan.from_graph_solution(got, g).role_cuts == \
        RPlan.from_graph_solution(ref, rg).role_cuts


# small MLPs the exhaustive search covers in well under a second: two
# layers with their backward, three layers forward only
ORACLE = [(dict(hidden=[8, 8]), 2), (dict(hidden=[8, 8]), 4),
          (dict(hidden=[8, 16, 8], with_backward=False), 2),
          (dict(hidden=[8, 16, 8], with_backward=False), 4)]


@pytest.mark.parametrize("kw,arity", ORACLE,
                         ids=[f"{len(k['hidden']) - 1}layer-{a}"
                              for k, a in ORACLE])
def test_one_cut_matches_the_bruteforce_oracle(kw, arity):
    """solver_bench's oracle check on small MLPs: the DP's cost, re-priced
    by graph_cost, equals the exhaustive search's, in both packages."""
    g = mlp_graph(batch=16, **kw)
    opt = solve_one_cut(g, arity, mem_scale=1.0)
    ref = solve_one_cut_bruteforce(g, arity, mem_scale=1.0, workers=1)
    cost = graph_cost(g, opt.assignment, arity, mem_scale=1.0)
    assert _close(cost, ref.cost)
    assert _close(opt.cost, ref.cost)
    # repro's oracle on its own graph prices the same (its HBM: 16 GB)
    r_ref = r_brute(r_mlp(batch=16, **kw), arity, mem_scale=1.0, workers=1)
    t_ref = solve_one_cut_bruteforce(
        g, arity, mem_scale=0.0, workers=1,
        terms=(CapacityTerm(scale=1.0, hbm=R_HBM),))
    assert _close(t_ref.cost, r_ref.cost)


def test_hopper_defaults_replace_the_tpu_ones():
    """The copy's defaults are the H100's datasheet values, and every
    solver axis of a single-host mesh rides NVLink."""
    assert HBM_PER_DEV == 80e9
    assert CapacityTerm().hbm == 80e9
    assert costterms.DEFAULT_PEAK_FLOPS == 989e12
    assert solver.DEFAULT_PEAK_FLOPS == 989e12
    assert (costterms.HOPPER_LANE, costterms.HOPPER_SUBLANE) == (8, 64)
    assert MeshAxis("data", 2).bandwidth == 900e9
    axes = tmesh.solver_axes((4, 2))
    assert [(a.name, a.size, a.bandwidth) for a in axes] == \
        [("data", 4, 900e9), ("model", 2, 900e9)]
