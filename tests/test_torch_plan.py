"""The port's ShardingPlan and placements against repro's (the analogue of
tests/test_plan.py).

The port's ``pspec`` is a plain tuple with the entries of repro's
``PartitionSpec``; ``models/sharding.py`` turns it into DTensor
placements.  Held here: every role of solved llama3.2-3b and qwen2-1.5b
plans and of ``manual_megatron_plan``, entry for entry; stacked axes,
unknown roles and ``for_pool``; every param and cache leaf's placements
against repro's ``leaf_pspec``; and, on a (4, 2) mesh, each rank's local
slice under a stacked ("data", "model") cut against the slice JAX's
``NamedSharding`` gives the device at the same mesh position (computed
in a subprocess with 8 host devices; the ranks are simulated with
torch's fake process group, which runs no collective)."""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as RShape
from repro.configs.base import get_arch as r_arch
from repro.core.builders import build_graph as r_build
from repro.core.plan import ShardingPlan as RPlan
from repro.core.plan import manual_megatron_plan as r_megatron
from repro.core.solver import MeshAxis as RAxis
from repro.core.solver import TilingSolution as RSol
from repro.core.solver import solve_mesh as r_solve
from repro.core.tiling import Part as RPart
from repro.models import sharding as r_sharding
from repro_torch.configs.base import get_arch
from repro_torch.core.plan import (CACHE_ROLES, ShardingPlan,
                                   manual_megatron_plan)
from repro_torch.models import sharding
from repro_torch.models.model import LM

NAMES = ("data", "model")

# physical dim tuples each role is read with: the param and cache rules'
# (with the stacked layer axis), and the activations' of models/model.py
PHYS = sorted({dims for _, _, dims in sharding.RULES + sharding.CACHE_RULES}
              | {("layer",) + dims for _, _, dims in sharding.RULES}
              | {("batch", "d_model"), ("batch", "seq", "d_model"),
                 ("batch", "heads"), ("batch", "seq", "heads"),
                 ("vocab",), ("batch", "vocab"), ("batch", "seq", "vocab"),
                 ("batch", "seq_kv", "kv_heads", "hd")})


@functools.lru_cache(maxsize=None)
def _solved(arch, shape, mesh):
    g = r_build(r_arch(arch), RShape(*shape))
    sol = r_solve(g, [RAxis(n, s) for n, s in zip(NAMES, mesh)])
    return RPlan.from_graph_solution(sol, g)


PLANS = {
    "llama3.2-3b-decode-4x2": lambda: _solved(
        "llama3.2-3b", ("serve16x2048", 2048, 16, "decode"), (4, 2)),
    "qwen2-1.5b-decode-2x4": lambda: _solved(
        "qwen2-1.5b", ("serve16x2048", 2048, 16, "decode"), (2, 4)),
    "qwen2-1.5b-decode32k-16x16": lambda: _solved(
        "qwen2-1.5b", ("decode_32k", 32768, 128, "decode"), (16, 16)),
    "qwen2-1.5b-train-4x2": lambda: _solved(
        "qwen2-1.5b", ("train_4k", 4096, 256, "train"), (4, 2)),
    "megatron": lambda: r_megatron(NAMES, ["data"], "model"),
}


def _port(rplan) -> ShardingPlan:
    return ShardingPlan(tuple(rplan.mesh_axis_names),
                        {r: dict(c) for r, c in rplan.role_cuts.items()})


@pytest.mark.parametrize("name", sorted(PLANS))
def test_pspec_matches_repro_for_every_role(name):
    rplan = PLANS[name]()
    plan = _port(rplan)
    if name == "megatron":
        mine = manual_megatron_plan(NAMES, ["data"], "model")
        assert mine.role_cuts == rplan.role_cuts
    for role in list(rplan.role_cuts) + ["not-a-role"]:
        for dims in PHYS:
            want = tuple(rplan.pspec(role, dims))
            assert plan.pspec(role, dims) == want, (role, dims)
    assert plan.describe() == rplan.describe()


def test_stacked_axes_unknown_roles_and_defaults():
    from repro_torch.core.solver import MeshAxis, TilingSolution
    from repro_torch.core.tiling import Part, REPLICATE
    axes = [MeshAxis("a", 2), MeshAxis("b", 2)]
    sol = TilingSolution(axes, [{"x": Part("batch")}, {"x": Part("batch")}],
                         [0.0, 0.0], 0.0, 0.0)
    plan = ShardingPlan.from_solution(sol, {"x": "x"})
    rsol = RSol([RAxis("a", 2), RAxis("b", 2)],
                [{"x": RPart("batch")}, {"x": RPart("batch")}],
                [0.0, 0.0], 0.0, 0.0)
    rplan = RPlan.from_solution(rsol, {"x": "x"})
    assert plan.pspec("x", ("batch", "d_model")) == (("a", "b"),) == \
        tuple(rplan.pspec("x", ("batch", "d_model")))
    assert plan.pspec("x", ("seq", "d_model")) == () == \
        tuple(rplan.pspec("x", ("seq", "d_model")))
    assert plan.pspec("nope", ("batch",)) == ()
    assert plan.pspec("nope", ("batch",), default=("a",)) == ("a",)
    assert not plan.has_role("nope") and plan.has_role("x")
    sol2 = TilingSolution(axes, [{"x": REPLICATE}, {"x": Part("heads")}],
                          [0.0, 0.0], 0.0, 0.0)
    plan2 = ShardingPlan.from_solution(sol2, {"x": "qkv"})
    assert plan2.pspec("qkv", ("batch", "heads", "hd")) == (None, "b")
    assert set(CACHE_ROLES) == {"kv_cache", "ssm_state", "block_table"}


@pytest.mark.parametrize("n_slots", [8, 6, 4, 3, 1])
def test_for_pool_matches_repro(n_slots):
    """A slot count the mesh does not divide drops the batch cuts that
    stop dividing it, in mesh order, exactly as repro's."""
    rplan = PLANS["llama3.2-3b-decode-4x2"]().with_override(
        "kv_cache", {"data": "batch", "model": "batch"})
    plan = _port(rplan)
    sizes = {"data": 4, "model": 2}
    got, want = plan.for_pool(n_slots, sizes), rplan.for_pool(n_slots, sizes)
    assert got.role_cuts == want.role_cuts
    for role in want.role_cuts:
        for dims in PHYS:
            assert got.pspec(role, dims) == tuple(want.pspec(role, dims))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def _placements_of(spec, ndim):
    """What repro's PartitionSpec means on a ("data", "model") mesh, one
    entry per mesh dim: the tensor dim it cuts, or None."""
    out = [None] * len(NAMES)
    for i, e in enumerate(tuple(spec)[:ndim]):
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            out[NAMES.index(a)] = i
    return out


@pytest.mark.parametrize("name", sorted(PLANS))
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llama3.2-3b"])
def test_leaf_placements_agree_with_pspec(name, arch):
    """Every param leaf (RULES) and linear-cache leaf (CACHE_RULES) of
    the reduced model: Shard(i) on exactly the mesh dims repro's
    leaf_pspec puts on dim i, Replicate() on the others."""
    from torch.distributed.tensor import Replicate, Shard
    rplan = PLANS[name]()
    plan = _port(rplan)
    model = LM(get_arch(arch).reduced())
    params = model.init(0, device="cpu")
    cache = model.init_cache(8, 32, device="cpu")
    trees = ((params, sharding.RULES, r_sharding.RULES),
             (cache, sharding.CACHE_RULES, r_sharding.CACHE_RULES))
    for tree, rules, r_rules in trees:
        pl = sharding.tree_placements(plan, tree, NAMES, rules)
        for path, leaf in _leaves(tree):
            want = _placements_of(
                r_sharding.leaf_pspec(rplan, path, leaf.ndim, r_rules),
                leaf.ndim)
            got = sharding.leaf_placements(plan, path, leaf.ndim, NAMES,
                                           rules)
            assert got == [Replicate() if d is None else Shard(d)
                           for d in want], (path, got, want)
            node = pl
            for k in path.split("/"):
                node = node[k]
            assert node == got


@pytest.mark.parametrize("name", sorted(PLANS))
def test_batch_placements_agree_with_batch_pspec(name):
    from torch.distributed.tensor import Replicate, Shard
    rplan = PLANS[name]()
    plan = _port(rplan)

    def want(spec, ndim):
        return [Replicate() if d is None else Shard(d)
                for d in _placements_of(spec, ndim)]
    r_train = r_sharding.batch_pspec(rplan, "train")
    assert sharding.batch_placements(plan, NAMES, "train") == {
        k: want(v, 2) for k, v in r_train.items()}
    assert sharding.batch_placements(plan, NAMES, "prefill") == \
        want(r_sharding.batch_pspec(rplan, "prefill"), 2)
    assert sharding.batch_placements(plan, NAMES, "decode") == \
        want(r_sharding.batch_pspec(rplan, "decode"), 1)
    assert sharding.batch_placements(None, NAMES, "decode") == \
        [Replicate(), Replicate()]


def test_stacked_order_against_the_mesh_is_refused():
    with pytest.raises(ValueError, match="mesh order"):
        sharding.spec_placements((("model", "data"),), NAMES)


_JAX_SLICES = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
out = {}
for name, spec, shape in json.loads(sys.argv[1]):
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    idx = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    rows = []
    for i in range(4):
        for j in range(2):
            sl = idx[mesh.devices[i, j]]
            rows.append([[s.start or 0, s.stop if s.stop is not None else n]
                         for s, n in zip(sl, shape)])
    out[name] = rows
print(json.dumps(out))
"""

SLICE_CASES = [
    ("stacked dim 0", [["data", "model"]], [8 * 3, 5]),
    ("stacked dim 1", [None, ["data", "model"]], [3, 8 * 2]),
    ("one axis a dim", ["model", "data"], [6, 12]),
    ("data only", ["data"], [8, 2]),
]


def test_local_slices_match_jax_named_sharding():
    """Each of 8 ranks on a (4, 2) mesh holds, under the port's
    placements, the slice JAX gives the device at its mesh position (the
    first named axis of a stacked entry major)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run(
        [sys.executable, "-c", _JAX_SLICES, json.dumps(SLICE_CASES)],
        env=env, capture_output=True, text=True, timeout=120, check=True)
    jax_slices = json.loads(res.stdout.strip().splitlines()[-1])
    assert not dist.is_initialized()
    for r in range(8):
        dist.init_process_group("fake", store=FakeStore(), rank=r,
                                world_size=8)
        try:
            mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=NAMES)
            coord = mesh.get_coordinate()
            for name, spec, shape in SLICE_CASES:
                spec = tuple(tuple(e) if isinstance(e, list) else e
                             for e in spec)
                full = torch.arange(int(np.prod(shape))).reshape(shape)
                pl = sharding.spec_placements(spec, NAMES)
                loc = distribute_tensor(full, mesh, pl,
                                        src_data_rank=None).to_local()
                want = jax_slices[name][coord[0] * 2 + coord[1]]
                ref = full[tuple(slice(a, b) for a, b in want)]
                assert torch.equal(loc, ref), (name, r, coord)
                off = sharding.global_offset(
                    distribute_tensor(full, mesh, pl, src_data_rank=None))
                assert list(off) == [a for a, _ in want]
        finally:
            dist.destroy_process_group()
