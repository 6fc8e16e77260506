"""The SSM family under a sharding plan on 8 gloo ranks, a (4, 2) ("data",
"model") mesh: xLSTM and the pure-Mamba branch trained (the first batch's
loss and gradient, and one engine step) and served (each layer's state
placed under ``ssm_state``, the decode step's state update on local
rows, the scan prefill on the slot's owner), against the single-process
port and against repro's ``jax.value_and_grad`` / ``Server`` under the
same plans on 8 host devices.

Configs, in f32: the reduced xlstm-125m with d_model 96 (so that the
sLSTM up-projection's int(96 * 4/3) = 128 columns divide by the model
axis: repro's device_put refuses the reduced d 64's 85 cut by 2), 2
sLSTM + 2 mLSTM blocks; the pure-Mamba branch of tests/test_torch_xlstm.py
(the reduced zamba2-2.7b with family "ssm" and no shared block).  One
spawn of 8 ranks for the file, torch on one thread a rank; beside it one
subprocess with 8 forced host devices runs repro on the port's ``init(0)``
weights as numpy.  Plans (solved at beam 32 by the port's solver):

  xlstm ``solved``   train: ``ssm_in`` cut on inner over data (both
                     blocks' fused projections arrive cut on their output
                     axis and are gathered, counted in
                     ``plan_fallbacks["xlstm"]``), the activations on
                     batch over model; decode: the state and the
                     activations on batch over both axes, nothing else
                     cut;
  xlstm ``megatron`` ``manual_megatron_plan``: batch on data, ``ssm_in``
                     / ``ssm_out`` on inner and sLSTM's w_up / w_down on
                     d_ff over model (a Megatron pair of DTensor
                     matmuls); the decode state cut on batch and inner, so
                     each step gathers it for the update (counted);
  ssm ``solved``     the pure-Mamba branch's own solves: nothing gathers.

Bands, with the gaps measured on this CPU: the first batch's loss within
1e-5 of one process, and every leaf of its gradient within 1e-5 x
max(1, the leaf's largest |g|) of one process (the same arithmetic, the
cut batch summed in another order, and under megatron the row-parallel
products, sLSTM's w_down on d_ff and mLSTM's w_out on inner, summing
their halves over the model axis, a rounding the sLSTM recurrence
carries into the embedding's gradient: measured 1.2e-6 solved, 9.7e-6
megatron on the embedding's |g| <= 2.03, 1.3e-7 pure SSM) and within
1e-4 of repro's under the same plan (tests/test_torch_train.py's band;
measured 9.0e-6, 4.4e-5, 3.1e-6); one engine step of 2
microbatches: loss and gradient norm within 1e-5, the f32 master within
5e-5 (tests/test_torch_train_plan.py's bands).  Serving (8 slots x 48,
chunks of 8, five requests of 2-19 prompt tokens, 6 greedy tokens):
streams, retirements and dispatch counters equal the unplanned port's
and repro's under the same plan; every sampled logits row within 1e-4 of
the unplanned port's and of repro's (the state is f32 in both packages;
the planned step sums in another order and the recurrence carries it:
measured 1.05e-5 and 1.08e-5 at most).  ~60 s alone (8 rank processes and
one JAX subprocess).  Every rank imports only torch and the port."""
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
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.core.plan import manual_megatron_plan
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.kernels import ops
from repro_torch.launch.mesh import solver_axes, spawn
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.serve import ServeConfig, Server
from repro_torch.train.engine import EngineConfig, TrainEngine

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
MESH = (4, 2)
NAMES = ("data", "model")
PLANNED_ATOL = 1e-5
PARAM_ATOL = 5e-5
REPRO_ATOL = 1e-4
SERVED_ATOL = 1e-4
OPT = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=1000)
DCFG = DataConfig(seed=0, vocab=256, seq_len=16, global_batch=16)
MICRO = 2
SHAPE = ShapeConfig("train16x16", DCFG.seq_len, DCFG.global_batch, "train")
SCFG = ServeConfig(slots=8, max_len=48, prefill_chunk=8)
DSHAPE = ShapeConfig("serve8x48", SCFG.max_len, SCFG.slots, "decode")
PROMPTS = [[3, 17, 99, 5, 8, 2, 41], [7] * 3, list(range(20, 39)),
           [11, 12], [200] + list(range(1, 11))]
GEN = 6
BEAM = 32
CASES = (("xlstm", "solved"), ("xlstm", "megatron"), ("ssm", "solved"))


def _cfg(get, family):
    """The test's config of ``family`` from one package's registry."""
    if family == "xlstm":
        return dataclasses.replace(get("xlstm-125m").reduced(),
                                   dtype="float32", d_model=96)
    return dataclasses.replace(get("zamba2-2.7b").reduced(), dtype="float32",
                               family="ssm", attn_every=0)


def _full(t):
    from torch.distributed.tensor import DTensor
    return {tree.key(p): (v.full_tensor() if isinstance(v, DTensor)
                          else v).detach().clone()
            for p, v in tree.flatten(t)}


def _train(model, step: bool):
    """The first batch's loss, full gradient and plan fallbacks, then
    (``step``) one engine step of MICRO microbatches: its (loss, gnorm),
    the master after it and the state's placements."""
    from torch.distributed.tensor import DTensor
    eng = TrainEngine(model, EngineConfig(optim=OPT, microbatches=MICRO),
                      device="cpu")
    state = eng.init_state(0)
    params = state["params"]
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    batch = host_batch(DCFG, 0)
    batch = (eng._micro_batches(batch, 1)[0] if eng.sharded
             else eng._batch(batch))
    ops.reset_plain_calls()
    loss, grads = eng._grads(params, leaves, batch)
    out = dict(loss=float(loss), fallbacks=dict(ops.plan_fallbacks), grads={
        tree.key(p): (g.full_tensor() if isinstance(g, DTensor) else g)
        for (p, _), g in zip(tree.flatten(params), grads)})
    if step:
        state, m = eng.step(state, host_batch(DCFG, 0))
        out.update(hist=(float(m["loss"]), float(m["gnorm"])),
                   master=_full(state["master"]),
                   placements={tree.key(p): tuple(map(str, v.placements))
                               for p, v in tree.flatten(state)
                               if hasattr(v, "placements")})
    return out


def serve(model, params):
    """PROMPTS through a Server: streams, counters, retirements, every
    logits row sampling read, the plan fallbacks and the state's
    placements."""
    logs = []

    class Recording(Server):
        def _admit(self, req, slot, method="chunked"):
            ev = super()._admit(req, slot, method)
            logs.append(self.prefill_logits[slot].copy())
            return ev

        def decode_once(self, forced_tokens=None):
            ev = super().decode_once(forced_tokens)
            if ev:
                logs.append(self.last_logits.cpu().numpy().copy())
            return ev

    ops.reset_plain_calls()
    srv = Recording(model, params, SCFG)
    for p in PROMPTS:
        srv.submit(p, max_new_tokens=GEN)
    streams = srv.run()
    cache = {tree.key(p): v for p, v in tree.flatten(srv.cache)}
    return dict(streams=streams, prefill=srv.prefill_dispatches,
                decode=srv.decode_dispatches, finished=dict(srv.finished),
                fallbacks=dict(ops.plan_fallbacks), logits=logs,
                plain=dict(ops.plain_calls),
                cache={k: (tuple(map(str, v.placements)),
                           tuple(v.to_local().shape))
                       for k, v in cache.items() if hasattr(v, "placements")})


def _rank_main(rank, world, plans, path):
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(MESH, NAMES, "cpu")
    out = {}
    for fam, name in CASES:
        cfg = _cfg(get_arch, fam)
        out[("train", fam, name)] = _train(
            LM(cfg, plan=plans["train"][fam, name], mesh=mesh),
            step=(fam, name) == ("xlstm", "solved"))
        out[("serve", fam, name)] = serve(
            LM(cfg, plan=plans["serve"][fam, name], mesh=mesh),
            LM(cfg).init(0, device="cpu"))
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

        def solved(fam, shape, **kw):
            return plan_from_record(solve_cell_plan(
                _cfg(get_arch, fam), shape, solver_axes(MESH, NAMES), "test",
                use_cache=False, beam=BEAM, graph_kwargs=kw))
        meg = manual_megatron_plan(NAMES, ["data"], "model")
        yield {"train": {("xlstm", "solved"): solved("xlstm", SHAPE,
                                                     master_fp32=True),
                         ("xlstm", "megatron"): meg,
                         ("ssm", "solved"): solved("ssm", SHAPE,
                                                   master_fp32=True)},
               "serve": {("xlstm", "solved"): solved("xlstm", DSHAPE),
                         ("xlstm", "megatron"): meg,
                         ("ssm", "solved"): solved("ssm", DSHAPE)}}
    finally:
        t_compile.CACHE_DIR = cache


def _numpy_tree(t):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in t.items()}


def _repro_main(params_path, plans_path, out_path):
    """repro's side, in a process with 8 host devices, on the port's
    weights: under each train plan the first batch's loss and gradient
    (the params placed as its engine places them); its Server under each
    serve plan and with none."""
    import jax
    import jax.numpy as jnp

    from repro.compat import make_compat_mesh, use_mesh
    from repro.configs import get_arch as r_arch
    from repro.core.plan import ShardingPlan as RPlan
    from repro.data.pipeline import DataConfig as RDataConfig
    from repro.data.pipeline import host_batch as r_host_batch
    from repro.models.model import LM as RLM
    from repro.optim.adamw import init_state
    from repro.runtime.serve import ServeConfig as RServeConfig
    from repro.runtime.serve import Server as RServer
    from repro.train.engine import EngineConfig as REngineConfig
    from repro.train.engine import TrainEngine as RTrainEngine

    mesh = make_compat_mesh(MESH, NAMES)
    dcfg = RDataConfig(seed=DCFG.seed, vocab=DCFG.vocab,
                       seq_len=DCFG.seq_len, global_batch=DCFG.global_batch)
    with open(params_path, "rb") as f:
        np_params = pickle.load(f)
    with open(plans_path, "rb") as f:
        cuts = pickle.load(f)

    def keyed(t):
        return {"/".join(str(k.key) for k in path): np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}
    out = {}
    for (fam, name), role_cuts in cuts["train"].items():
        cfg = _cfg(r_arch, fam)
        model = RLM(cfg, plan=RPlan(NAMES, role_cuts), mesh=mesh)
        eng = RTrainEngine(model, REngineConfig(microbatches=MICRO),
                           mesh=mesh)
        params = jax.tree_util.tree_map(jnp.asarray, np_params[fam])
        state = {"params": params, "opt": init_state(params),
                 "master": jax.tree_util.tree_map(
                     lambda p: jnp.array(p, jnp.float32, copy=True),
                     params)}
        state = jax.device_put(state, eng.state_shardings())
        batch = r_host_batch(dcfg, 0)
        with use_mesh(mesh):
            loss, grads = jax.jit(jax.value_and_grad(model.loss))(
                state["params"], {k: jnp.asarray(v)
                                  for k, v in batch.items()})
        out[("train", fam, name)] = dict(loss=float(loss),
                                         grads=keyed(grads))
    for (fam, name), role_cuts in cuts["serve"].items():
        cfg = _cfg(r_arch, fam)
        plan = None if role_cuts is None else RPlan(NAMES, role_cuts)
        m = None if plan is None else mesh
        logs = []

        class Recording(RServer):
            def _admit(self, req, slot, method="chunked"):
                ev = super()._admit(req, slot, method)
                logs.append(self.prefill_logits[slot].copy())
                return ev

            def decode_once(self, forced_tokens=None):
                ev = super().decode_once(forced_tokens)
                if ev:
                    logs.append(np.asarray(self.last_logits).copy())
                return ev

        params = jax.tree_util.tree_map(jnp.asarray, np_params[fam])
        scfg = RServeConfig(slots=SCFG.slots, max_len=SCFG.max_len,
                            prefill_chunk=SCFG.prefill_chunk)
        srv = Recording(RLM(cfg, plan=plan, mesh=m), params, scfg, mesh=m)
        for p in PROMPTS:
            srv.submit(p, max_new_tokens=GEN)
        out[("serve", fam, name)] = dict(
            streams=srv.run(), prefill=srv.prefill_dispatches,
            decode=srv.decode_dispatches, finished=dict(srv.finished),
            logits=logs)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(plans, tmp_path_factory):
    """(the single-process port per family, the 8 ranks, repro), the
    ranks and repro's subprocess running side by side."""
    tmp = tmp_path_factory.mktemp("xlstm_ranks")
    params = {fam: LM(_cfg(get_arch, fam)).init(0, device="cpu")
              for fam in ("xlstm", "ssm")}
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump({k: _numpy_tree(v) for k, v in params.items()}, f)
    with open(tmp / "plans.pkl", "wb") as f:
        pickle.dump({"train": {k: v.role_cuts
                               for k, v in plans["train"].items()},
                     "serve": {**{k: v.role_cuts
                                  for k, v in plans["serve"].items()},
                               **{(fam, "plain"): None
                                  for fam in ("xlstm", "ssm")}}}, f)
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
        ref = {}
        for fam in ("xlstm", "ssm"):
            cfg = _cfg(get_arch, fam)
            ref[("train", fam)] = _train(LM(cfg), step=fam == "xlstm")
            ref[("serve", fam)] = serve(LM(cfg), params[fam])
        spawn(_rank_main, MESH[0] * MESH[1], "cpu",
              (plans, str(tmp / "out.pt")))
        _, err = proc.communicate(timeout=600)
    finally:
        torch.set_num_threads(n)
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    with open(tmp / "repro.pkl", "rb") as f:
        rep = pickle.load(f)
    return ref, torch.load(tmp / "out.pt", weights_only=False), rep


def _ids(case):
    return "-".join(case)


# -- training -----------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_first_batch_matches_one_process_and_repro(runs, case):
    """The first batch's loss within 1e-5 of the single-process port and
    every leaf of its gradient within 1e-5 x max(1, its largest |g|);
    both within 1e-4 of repro's under the same plan."""
    ref, out, rep = runs
    fam, _ = case
    got, one = out[("train",) + case], ref[("train", fam)]
    want = rep[("train",) + case]
    assert abs(got["loss"] - one["loss"]) <= PLANNED_ATOL
    assert abs(got["loss"] - want["loss"]) <= REPRO_ATOL
    assert set(got["grads"]) == set(one["grads"]) == set(want["grads"])
    for k, g in got["grads"].items():
        want_one = one["grads"][k].numpy()
        scale = max(1.0, float(np.abs(want_one).max()))
        np.testing.assert_allclose(g.numpy(), want_one,
                                   atol=PLANNED_ATOL * scale, rtol=0,
                                   err_msg=k)
        np.testing.assert_allclose(g.numpy(), want["grads"][k],
                                   atol=REPRO_ATOL, rtol=0, err_msg=k)


def test_engine_step_places_the_state_by_role(runs):
    """One engine step of 2 microbatches under xLSTM's solved plan: loss
    and gradient norm within 1e-5 of one process, the f32 master within
    5e-5; the state placed role by role: the fused projections and their
    master under ``ssm_in`` / ``ssm_in.master`` (inner over data;
    d_model over model too for the master), r_gates and the norms whole
    (``norm``), sLSTM's w_up whole (the graph has no ``w_up`` role)."""
    ref, out, _ = runs
    got, one = out[("train", "xlstm", "solved")], ref[("train", "xlstm")]
    np.testing.assert_allclose(got["hist"], one["hist"], atol=PLANNED_ATOL,
                               rtol=0)
    for k, v in got["master"].items():
        np.testing.assert_allclose(v.numpy(), one["master"][k].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)
    pl = got["placements"]
    assert pl["params/slstm/w_gates"] == ("S(2)", "R")
    assert pl["params/mlstm/w_in"] == ("S(2)", "R")
    assert pl["master/mlstm/w_in"] == ("S(2)", "S(1)")
    assert pl["opt/m/slstm/w_gates"] == ("S(2)", "S(1)")
    for k in ("params/slstm/r_gates", "params/mlstm/norm",
              "params/slstm/ln", "params/slstm/w_up"):
        assert pl[k] == ("R", "R"), k


def test_fused_projection_cuts_are_gathered_and_counted(runs):
    """The solved and megatron train plans cut ``ssm_in`` on inner: each
    block's fused projection is gathered before its parts are sliced,
    once a block in the forward and once in its remat (2 pairs of 2
    blocks): 8, in ``plan_fallbacks["xlstm"]`` and nowhere else.  The
    pure-Mamba branch's solved plan gathers nothing."""
    _, out, _ = runs
    for name in ("solved", "megatron"):
        fb = out[("train", "xlstm", name)]["fallbacks"]
        assert fb["xlstm"] == 2 * 2 * 2, name
        assert sum(fb.values()) == fb["xlstm"], name
    assert sum(out[("train", "ssm", "solved")]["fallbacks"].values()) == 0


# -- serving ------------------------------------------------------------------

def _check_streams(want, got):
    assert got["streams"] == want["streams"]
    assert all(len(t) == GEN for t in got["streams"].values())
    assert (got["prefill"], got["decode"], got["finished"]) == \
        (want["prefill"], want["decode"], want["finished"])
    assert len(got["logits"]) == len(want["logits"])


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_serves_like_one_process_and_repro(runs, case):
    """Under each plan: the streams, dispatch counters and retirements of
    the unplanned port and of repro's Server under the same plan; every
    sampled logits row within 1e-4 of the unplanned port's and of
    repro's."""
    ref, out, rep = runs
    fam, _ = case
    got, one = out[("serve",) + case], ref[("serve", fam)]
    _check_streams(one, got)
    _check_streams(rep[("serve",) + case], got)
    gap = max(float(np.abs(a - b).max())
              for a, b in zip(got["logits"], one["logits"]))
    err = max(float(np.abs(a - b).max())
              for a, b in zip(got["logits"], rep[("serve",) + case]["logits"]))
    assert gap <= SERVED_ATOL, gap
    assert err <= SERVED_ATOL, err
    assert not any(got["plain"].values())


def test_plain_servers_match_repros(runs):
    """The unplanned port against repro's unplanned Server on the same
    weights: the streams the planned runs are held to are repro's."""
    ref, _, rep = runs
    for fam in ("xlstm", "ssm"):
        _check_streams(rep[("serve", fam, "plain")], ref[("serve", fam)])


def test_serving_state_is_placed_and_fallbacks_counted(runs):
    """The solved decode plans cut the state on batch over both axes: one
    slot a rank, no fallback.  megatron cuts it on batch and inner (the
    heads): both fused projections arrive cut on inner and are gathered,
    2 a pair a step; a decode dispatch updates each rank's own heads of
    the state (``sharding.step_rows(heads=True)``), while a prompt
    token's scan step (one row, on its owner ranks) gathers h, c and n in
    the sLSTM and C in the mLSTM too: 6 a pair a step."""
    ref, out, _ = runs
    solved = out[("serve", "xlstm", "solved")]
    assert sum(solved["fallbacks"].values()) == 0
    assert solved["cache"]["mlstm/C"] == (("S(1)", "S(1)"),
                                          (2, 1, 4, 48, 48))
    assert solved["cache"]["slstm/h"] == (("S(1)", "S(1)"), (2, 1, 4, 24))
    ssm = out[("serve", "ssm", "solved")]
    assert sum(ssm["fallbacks"].values()) == 0
    assert ssm["cache"]["mamba/ssm"] == (("S(1)", "S(1)"), (4, 1, 16, 8, 8))
    meg = out[("serve", "xlstm", "megatron")]
    assert meg["cache"]["mlstm/C"] == (("S(1)", "S(2)"), (2, 2, 2, 48, 48))
    decode = ref[("serve", "xlstm")]["decode"]
    prompt = sum(map(len, PROMPTS))
    assert meg["fallbacks"]["xlstm"] == 2 * (2 * decode + 6 * prompt)
    assert sum(meg["fallbacks"].values()) == meg["fallbacks"]["xlstm"]


if __name__ == "__main__":
    _repro_main(sys.argv[1], sys.argv[2], sys.argv[3])
