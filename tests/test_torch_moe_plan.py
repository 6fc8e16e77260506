"""The MoE family under sharding plans on 8 gloo ranks, a (4, 2) ("data",
"model") mesh, with expert parallelism: training (``moe_ffn_sharded``:
routing on each rank's tokens, the dispatch buffer through an all-to-all
over the expert axis and back) and serving (``moe_ffn_placed``: the
global formula, each rank running its own experts), against the
single-process port and against repro's engine / ``Server`` under the
same ``normalize_moe_plan``-ed plans on 8 host devices.

The model is the reduced moonshot-v1-16b-a3b in f32 with 16 experts
(top-2, ``d_ff_expert`` 64), so that ``expert_parallel_axis`` cuts the
experts on "model" (the published-config reduction keeps 4, which is
never cut).  Two capacity factors: 8.0 keeps every choice, 1.0 drops
(the capacity of a rank's 64 tokens is 8 against a mean load of 8).
One spawn of 8 ranks for the file, torch on one thread a rank; beside
it one subprocess with 8 forced host devices runs repro on the port's
``init(0)`` weights as numpy.

Training plans (batch ``host_batch`` seed 0, 16 x 16 tokens):

  ``megatron`` ``manual_megatron_plan``: batch on data, experts on model;
               the two model ranks of a data shard hold the same tokens
               and both exchange them (``shard_map``'s program), the
               output's cotangent halved as its transpose halves it;
  ``batch8``   megatron with the activations cut on batch over both
               axes: every rank routes its own 2 rows, and the
               all-to-all carries other tokens each way;
  ``solved``   the port's solve of this cell (beam 32): it cuts the
               activations on d_model, which routing cannot use: the
               layer gathers them (``plan_fallbacks["moe"]``).  repro's
               ``shard_map`` raises on that plan (its local router
               product sees d / 8 columns), so it is held to one process
               only.

Routing, capacity and the aux are per shard of tokens, as in repro, so
the single-process reference is the port's unplanned loss and gradient
averaged over the shards' rows (a token-mean loss and a mean of the
ranks' aux are both such averages).  The first batch's loss and every
gradient leaf within 1e-5 of it, with or without drops, and within 1e-4
of repro's ``jax.value_and_grad`` under the same plan; one engine step
of 2 microbatches (each a contiguous half of the batch, as repro splits
it: the aux rides each microbatch) within 1e-5 of the reference's loss
and gradient norm and within 1e-4 of repro's engine step.

Serving plans (capacity factor 1.0; 8 slots x 48, chunks of 8; the
linear tier and the paged tier with ``spec_k`` 4): the solved decode
plan (activations and cache cut on batch over both axes, experts on
model) and megatron.  Streams, dispatch counters and retirements equal
the unplanned port's and repro's under the same plan, with no fallback.
The gathered route: the experts' weights placed cut on their hidden dim
(``e_ff``, a cut ``LM`` refuses in a plan) are gathered at every MoE
call, counted, and the streams do not move.  Every rank imports only
torch and the port."""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs.base import MoECfg, ShapeConfig, get_arch
from repro_torch.core.plan import manual_megatron_plan
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.kernels import ops
from repro_torch.launch.compile import normalize_moe_plan
from repro_torch.launch.mesh import solver_axes, spawn
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.serve import ServeConfig, Server
from repro_torch.train.engine import EngineConfig, TrainEngine

ARCH = "moonshot-v1-16b-a3b"
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
MESH = (4, 2)
NAMES = ("data", "model")
FACTORS = (8.0, 1.0)
PLANNED_ATOL = 1e-5
REPRO_ATOL = 1e-4
OPT = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=1000)
DCFG = DataConfig(seed=0, vocab=256, seq_len=16, global_batch=16)
MICRO = 2
SHAPE = ShapeConfig("train16x16", DCFG.seq_len, DCFG.global_batch, "train")
SCFG = ServeConfig(slots=8, max_len=48, prefill_chunk=8)
TIERS = {"linear": {}, "paged-spec": dict(paged=True, block_len=8,
                                          spec_k=4)}
DSHAPE = ShapeConfig("serve8x48", SCFG.max_len, SCFG.slots, "decode")
PROMPTS = [[3, 17, 99, 5, 8, 2, 41], [7] * 3, list(range(20, 39)),
           [11, 12], [200] + list(range(1, 11)), list(range(100, 130))]
GEN = 6
BEAM = 32
# the rows of the batch each rank routes: batch cut 4 ways by megatron,
# 8 ways by batch8; the solved plan's activations are gathered whole
SHARDS = {"megatron": 4, "batch8": 8, "solved": 1}


def _cfg(factor):
    return dataclasses.replace(
        get_arch(ARCH).reduced(), dtype="float32",
        moe=MoECfg(16, 2, 64, capacity_factor=factor))


def _full(g):
    from torch.distributed.tensor import DTensor
    return (g.full_tensor() if isinstance(g, DTensor) else g).detach()


def _engine(model):
    return TrainEngine(model, EngineConfig(optim=OPT, microbatches=MICRO),
                       device="cpu")


def _grads(eng, state, batch):
    """Loss and full gradient of ``batch`` as one microbatch."""
    params = state["params"]
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    batch = (eng._micro_batches(batch, 1)[0] if eng.sharded
             else eng._batch(batch))
    loss, grads = eng._grads(params, leaves, batch)
    return float(loss), {tree.key(p): _full(g)
                         for (p, _), g in zip(tree.flatten(params), grads)}


def _train(model):
    """First-batch loss and grads, then one engine step's (loss, gnorm),
    the all-to-all and fallback counts of the whole run."""
    ops.reset_plain_calls()
    eng = _engine(model)
    state = eng.init_state(0)
    loss, grads = _grads(eng, state, host_batch(DCFG, 0))
    _, m = eng.step(state, host_batch(DCFG, 0))
    return dict(loss=loss, grads=grads, hist=(float(m["loss"]),
                                              float(m["gnorm"])),
                a2a=dict(ops.all_to_all), fallbacks=dict(ops.plan_fallbacks))


def _reference(cfg, shards):
    """One process, per shard of tokens: the first batch's loss and grads
    averaged over ``shards`` equal row blocks, and one step's (loss,
    gnorm) from each of the 2 contiguous microbatches so averaged."""
    eng = _engine(LM(cfg))
    state = eng.init_state(0)
    batch = host_batch(DCFG, 0)

    def averaged(rows, n):
        m = len(rows["tokens"]) // n
        parts = [_grads(eng, state, {k: v[i * m:(i + 1) * m]
                                     for k, v in rows.items()})
                 for i in range(n)]
        return (sum(p[0] for p in parts) / n,
                {k: sum(p[1][k] for p in parts) / n for k in parts[0][1]})
    loss, grads = averaged(batch, shards)
    half = DCFG.global_batch // MICRO
    micro = [averaged({k: v[i * half:(i + 1) * half]
                       for k, v in batch.items()}, shards)
             for i in range(MICRO)]
    gstep = {k: sum(g[k] for _, g in micro) / MICRO for k in grads}
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                 for g in gstep.values())))
    return dict(loss=loss, grads=grads,
                hist=(sum(x for x, _ in micro) / MICRO, gnorm))


def serve(model, params, tier):
    ops.reset_plain_calls()
    srv = Server(model, params, dataclasses.replace(SCFG, **TIERS[tier]))
    for p in PROMPTS:
        srv.submit(p, max_new_tokens=GEN)
    streams = srv.run()
    return dict(streams=streams, prefill=srv.prefill_dispatches,
                decode=srv.decode_dispatches, verify=srv.verify_dispatches,
                finished=dict(srv.finished),
                fallbacks=dict(ops.plan_fallbacks),
                a2a=dict(ops.all_to_all))


def _rank_main(rank, world, plans, path):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import place_tree
    mesh = make_mesh(MESH, NAMES, "cpu")
    out = {}
    for factor in FACTORS:
        cfg = _cfg(factor)
        for name, plan in plans["train"].items():
            out[("train", factor, name)] = _train(
                LM(cfg, plan=plan, mesh=mesh))
    cfg = _cfg(1.0)
    params = LM(cfg).init(0, device="cpu")
    for name, plan in plans["serve"].items():
        for tier in TIERS:
            out[("serve", name, tier)] = serve(
                LM(cfg, plan=plan, mesh=mesh), params, tier)
    # the experts placed cut on e_ff: gathered at every call
    plan = plans["serve"]["megatron"]
    e_ff = plan.with_override("moe_up", {"data": None, "model": "e_ff"})
    e_ff = e_ff.with_override("moe_down", {"data": None, "model": "e_ff"})
    placed = place_tree(params, mesh, e_ff.for_pool(SCFG.slots,
                                                    dict(zip(NAMES, MESH))))
    out[("serve", "e_ff", "linear")] = serve(
        LM(cfg, plan=plan, mesh=mesh), placed, "linear")
    out["e_ff_placements"] = tuple(
        map(str, placed["layers"]["moe"]["w_up"].placements))
    if rank == 0:
        torch.save(out, path)


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    from repro_torch.launch import compile as t_compile
    cache = t_compile.CACHE_DIR
    t_compile.CACHE_DIR = str(tmp_path_factory.mktemp("plans"))
    try:
        from repro_torch.launch.compile import (plan_from_record,
                                                solve_cell_plan)
        cfg = _cfg(8.0)

        def solved(shape, **kw):
            return normalize_moe_plan(plan_from_record(solve_cell_plan(
                cfg, shape, solver_axes(MESH, NAMES), "test",
                use_cache=False, beam=BEAM, graph_kwargs=kw)), cfg)
        meg = normalize_moe_plan(
            manual_megatron_plan(NAMES, ["data"], "model"), cfg)
        batch8 = meg.with_override("x", {"data": "batch", "model": "batch"})
        yield {"train": {"megatron": meg, "batch8": batch8,
                         "solved": solved(SHAPE, master_fp32=True)},
               "serve": {"solved": solved(DSHAPE), "megatron": meg}}
    finally:
        t_compile.CACHE_DIR = cache


def _numpy_tree(t):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in t.items()}


def _repro_main(params_path, plans_path, out_path):
    """repro's side, in a process with 8 host devices, on the port's
    weights: under each train plan (but ``solved``) and capacity factor
    the first batch's loss and gradient and one engine step's (loss,
    gnorm); its Server under each serve plan and with none."""
    import jax
    import jax.numpy as jnp

    from repro.compat import make_compat_mesh, use_mesh
    from repro.configs import get_arch as r_arch
    from repro.core.plan import ShardingPlan as RPlan
    from repro.data.pipeline import DataConfig as RDataConfig
    from repro.data.pipeline import host_batch as r_host_batch
    from repro.models.model import LM as RLM
    from repro.optim.adamw import AdamWConfig as RAdamWConfig
    from repro.optim.adamw import init_state
    from repro.runtime.serve import ServeConfig as RServeConfig
    from repro.runtime.serve import Server as RServer
    from repro.train.engine import EngineConfig as REngineConfig
    from repro.train.engine import TrainEngine as RTrainEngine

    mesh = make_compat_mesh(MESH, NAMES)
    dcfg = RDataConfig(seed=DCFG.seed, vocab=DCFG.vocab,
                       seq_len=DCFG.seq_len, global_batch=DCFG.global_batch)
    with open(plans_path, "rb") as f:
        cuts = pickle.load(f)

    def r_cfg(factor):
        cfg = dataclasses.replace(r_arch(ARCH).reduced(), dtype="float32")
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=16, capacity_factor=factor))

    def keyed(t):
        return {"/".join(str(k.key) for k in path): np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}
    out = {}
    batch = r_host_batch(dcfg, 0)
    for factor in FACTORS:
        cfg = r_cfg(factor)
        with open(params_path, "rb") as f:
            np_params = pickle.load(f)
        for name, role_cuts in cuts["train"].items():
            if name == "solved":
                continue
            model = RLM(cfg, plan=RPlan(NAMES, role_cuts), mesh=mesh)
            eng = RTrainEngine(model, REngineConfig(
                optim=RAdamWConfig(lr=OPT.lr, warmup_steps=2,
                                   total_steps=1000),
                microbatches=MICRO), mesh=mesh)
            params = jax.tree_util.tree_map(jnp.asarray, np_params)
            state = {"params": params, "opt": init_state(params),
                     "master": jax.tree_util.tree_map(
                         lambda p: jnp.array(p, jnp.float32, copy=True),
                         params)}
            state = jax.device_put(state, eng.state_shardings())
            with use_mesh(mesh):
                loss, grads = jax.jit(jax.value_and_grad(model.loss))(
                    state["params"], {k: jnp.asarray(v)
                                      for k, v in batch.items()})
            _, m = eng.step(state, batch)
            out[("train", factor, name)] = dict(
                loss=float(loss), grads=keyed(grads),
                hist=(float(m["loss"]), float(m["gnorm"])))
    cfg = r_cfg(1.0)
    for name, role_cuts in dict(cuts["serve"], plain=None).items():
        plan = None if role_cuts is None else RPlan(NAMES, role_cuts)
        m = None if plan is None else mesh
        for tier, kw in TIERS.items():
            params = jax.tree_util.tree_map(jnp.asarray, np_params)
            scfg = RServeConfig(slots=SCFG.slots, max_len=SCFG.max_len,
                                prefill_chunk=SCFG.prefill_chunk, **kw)
            srv = RServer(RLM(cfg, plan=plan, mesh=m), params, scfg,
                          mesh=m)
            for p in PROMPTS:
                srv.submit(p, max_new_tokens=GEN)
            out[("serve", name, tier)] = dict(
                streams=srv.run(), prefill=srv.prefill_dispatches,
                decode=srv.decode_dispatches,
                verify=srv.verify_dispatches, finished=dict(srv.finished))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(plans, tmp_path_factory):
    """(the single-process port, the 8 ranks, repro), the ranks and
    repro's subprocess running side by side."""
    tmp = tmp_path_factory.mktemp("moe_ranks")
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(_numpy_tree(LM(_cfg(1.0)).init(0, device="cpu")), f)
    with open(tmp / "plans.pkl", "wb") as f:
        pickle.dump({kind: {k: v.role_cuts for k, v in ps.items()}
                     for kind, ps in plans.items()}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(tmp / "params.pkl"),
         str(tmp / "plans.pkl"), str(tmp / "repro.pkl")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        spawn(_rank_main, MESH[0] * MESH[1], "cpu",
              (plans, str(tmp / "out.pt")))
        ref = {(f, s): _reference(_cfg(f), s) for f in FACTORS
               for s in set(SHARDS.values())}
        cfg = _cfg(1.0)
        params = LM(cfg).init(0, device="cpu")
        for tier in TIERS:
            ref[("serve", tier)] = serve(LM(cfg), params, tier)
        _, err = proc.communicate(timeout=900)
    finally:
        torch.set_num_threads(n)
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    with open(tmp / "repro.pkl", "rb") as f:
        rep = pickle.load(f)
    return ref, torch.load(tmp / "out.pt", weights_only=False), rep


# -- training -----------------------------------------------------------------

@pytest.mark.parametrize("factor", FACTORS, ids=["keep", "drop"])
@pytest.mark.parametrize("name", ["megatron", "batch8", "solved"])
def test_first_batch_and_step_match_one_process_and_repro(runs, name,
                                                          factor):
    """The first batch's loss and every gradient leaf, and one engine
    step's (loss, gnorm): within 1e-5 of the per-shard single process,
    within 1e-4 of repro under the same plan (but ``solved``, which
    repro cannot run)."""
    ref, out, rep = runs
    got, one = out[("train", factor, name)], ref[(factor, SHARDS[name])]
    assert abs(got["loss"] - one["loss"]) <= PLANNED_ATOL
    np.testing.assert_allclose(got["hist"], one["hist"], atol=PLANNED_ATOL,
                               rtol=0)
    for k, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), one["grads"][k].numpy(),
                                   atol=PLANNED_ATOL, rtol=0, err_msg=k)
    if name == "solved":
        return
    want = rep[("train", factor, name)]
    assert abs(got["loss"] - want["loss"]) <= REPRO_ATOL
    np.testing.assert_allclose(got["hist"], want["hist"], atol=REPRO_ATOL,
                               rtol=0)
    assert set(got["grads"]) == set(want["grads"])
    for k, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), want["grads"][k],
                                   atol=REPRO_ATOL, rtol=0, err_msg=k)


def test_training_exchanges_over_the_expert_axis(runs):
    """Every run's experts are cut on model, so each MoE layer exchanges
    its buffer with the other model rank and back: 4 layers x (the first
    batch's forward and remat, then the step's 2 microbatches' forward
    and remat) = 24 of each.  megatron and batch8 gather nothing; the
    solved plan gathers its d_model-cut activations at each of those
    calls.  The placed experts' weights are cut on model."""
    _, out, _ = runs
    for factor in FACTORS:
        for name in SHARDS:
            got = out[("train", factor, name)]
            assert got["a2a"] == {"moe_dispatch": 24, "moe_combine": 24}
            want = 24 if name == "solved" else 0
            assert got["fallbacks"] == dict.fromkeys(got["fallbacks"], 0) \
                | {"moe": want}, name


# -- serving ------------------------------------------------------------------

def _same_run(got, want):
    assert got["streams"] == want["streams"]
    assert all(len(t) == GEN for t in got["streams"].values())
    for k in ("prefill", "decode", "verify", "finished"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("name", ["solved", "megatron"])
def test_serves_like_one_process_and_repro(runs, name, tier):
    """Under each plan, both tiers: the streams, dispatch counters and
    retirements of the unplanned port and of repro's Server under the
    same plan, with no fallback and no all-to-all (serving runs the
    global formula)."""
    ref, out, rep = runs
    got = out[("serve", name, tier)]
    _same_run(got, ref[("serve", tier)])
    _same_run(got, rep[("serve", name, tier)])
    assert not any(got["fallbacks"].values())
    assert not any(got["a2a"].values())
    if "spec" in tier:
        assert got["verify"] > 0


def test_plain_server_matches_repros(runs):
    ref, _, rep = runs
    for tier in TIERS:
        _same_run(ref[("serve", tier)], rep[("serve", "plain", tier)])


def test_experts_cut_on_e_ff_are_gathered(runs):
    """Experts placed cut on their hidden dim: every MoE call (4 layers x
    every decode step and prefill chunk) gathers them, counted in
    ``plan_fallbacks["moe"]``; the streams are the unplanned ones."""
    ref, out, _ = runs
    got = out[("serve", "e_ff", "linear")]
    assert out["e_ff_placements"] == ("R", "S(3)")
    _same_run(got, ref[("serve", "linear")])
    L = _cfg(1.0).n_layers
    assert got["fallbacks"]["moe"] == L * (got["prefill"] + got["decode"])
    assert sum(got["fallbacks"].values()) == got["fallbacks"]["moe"]


def test_placing_whole_local_shards_keeps_the_storage():
    """On a mesh dim of size 1 a cut leaves each rank the whole tensor:
    ``sharding.place`` then holds the tensor's own storage, as for a
    replicated leaf, where ``distribute_tensor`` copied it (moonshot's
    17.7 GB expert stack under the (1, 1) plan ran the card out of
    memory).  A cut of a dim of size 2 still keeps the half.  Rank 0 of
    a (1, 2) mesh on torch's fake process group; then ``place_tree`` on
    one card's (1, 1) mesh (on more ranks it takes rank 0's values)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.models.sharding import place, place_tree
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=NAMES)
        t = torch.arange(24.0).reshape(4, 6)
        whole = place(t, mesh, [Shard(0), Replicate()])
        assert whole.to_local().data_ptr() == t.data_ptr()
        assert tuple(whole.shape) == (4, 6)
        half = place(t, mesh, [Replicate(), Shard(0)])
        assert torch.equal(half.to_local(), t[:2])
    finally:
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=NAMES)
        cfg = _cfg(8.0)
        plan = normalize_moe_plan(manual_megatron_plan(
            NAMES, ["data"], "model"), cfg)
        w = torch.zeros(2, 16, 8, 4)
        tree_ = place_tree({"layers": {"moe": {"w_up": w}}}, mesh,
                           plan.with_override("moe_up", {"data": "expert",
                                                         "model": None}))
        got = tree_["layers"]["moe"]["w_up"]
        assert tuple(map(str, got.placements)) == ("S(1)", "R")
        assert got.to_local().data_ptr() == w.data_ptr()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _repro_main(sys.argv[1], sys.argv[2], sys.argv[3])
