"""The hybrid family (zamba2) under a sharding plan on 8 gloo ranks, a
(4, 2) ("data", "model") mesh: training (the SSD scan on local batch
shards, the shared block's attention through ``attention_sharded``) and
serving (each layer's Mamba state and the shared block's rings placed
under ``ssm_state`` / ``kv_cache``, the decode step's state update and
the ring's write and decode attention on local shards, the scan prefill
on the slot's owner), against the single-process port and against
repro's ``TrainEngine`` / ``Server`` under the same plans on 8 host
devices.

The model is the reduced zamba2-2.7b in f32 (4 Mamba layers of 16 SSM
heads, the shared block after every 2 with 4 heads of hd 16).  One spawn
of 8 ranks for the file, torch on one thread a rank; beside it one
subprocess with 8 forced host devices runs repro on the port's
``init(0)`` weights as numpy.  Training plans (batch ``host_batch``
seed 0, 16 x 16 tokens):

  ``solved``   the port's solve of this train cell (f32 master in the
               graph; beam 32): every activation cut on batch over both
               axes, so the SSD scan sees 1 row of a microbatch's 8;
  ``megatron`` ``manual_megatron_plan``: batch on data, ``ssm_in`` /
               ``ssm_out`` on inner over model, so ``w_in``'s [z | x]
               axis is cut in halves and ``zx`` is gathered before its
               split (``mamba._inner_whole``, recorded);
  ``fallback`` megatron with the activations and the queries (``x``,
               ``wq.out``) cut on seq over model: the shared block's
               attention has no local rule there (every call gathers,
               counted) and the SSD scan takes the batch cut of data
               alone.

Each: the first batch's loss and gradient (every leaf) within 1e-5 of one
process (the same arithmetic, the cut batch summed in another order) and
within 1e-4 of repro's ``jax.value_and_grad`` of its loss under the same
plan, its params placed by its engine (tests/test_torch_train.py's
training band: XLA's reductions against torch's); ``solved`` and
``megatron`` also one engine step of 2 microbatches (loss and gradient
norm within 1e-5 of one process, the f32 master within 5e-5:
tests/test_torch_train_plan.py's bands; repro's engine step is held to
the port's in tests/test_torch_hybrid.py).

Serving plans (8 slots x 48, chunks of 8, five requests of 2-19 prompt
tokens and 6 greedy tokens; then ``forced``: 4 prefills on 4 slots and 4
decode steps of fixed tokens): the solved decode plan (cache and state
cut on batch over both axes: nothing gathers), ``megatron`` (the state
cut on batch and on inner: the decode step's update gathers the state,
counted) and ``fallback`` (megatron with the rings cut on seq_kv: every
attention call gathers too).  Streams, retirements and dispatch counters
equal the unplanned port's and repro's under the same plan; the
teacher-forced logits within 1e-5 of the unplanned port's while the
slot's bf16 state (conv history, K/V rings) is bit-equal in both runs,
within 1e-3 once one of its entries rounded the other way (the planned
step sums its f32 values in another order on one or two rows a rank; 13
of the 36 forced rows stay bit-equal in state under each plan, measured
on this CPU); every sampled logits row within 1e-3 of repro's (one bf16
rounding the other way moves a row by up to ~7e-4,
tests/test_torch_hybrid_serve.py).
Every rank imports only torch and the port."""
from __future__ import annotations

import contextlib
import dataclasses
import json
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

ARCH = "zamba2-2.7b"
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
MESH = (4, 2)
NAMES = ("data", "model")
PLANNED_ATOL = 1e-5
PARAM_ATOL = 5e-5
REPRO_ATOL = 1e-4
FORCED_ATOL = 1e-5
SERVED_ATOL = 1e-3
LR = 3e-4
OPT = AdamWConfig(lr=LR, warmup_steps=2, total_steps=1000)
DCFG = DataConfig(seed=0, vocab=256, seq_len=16, global_batch=16)
MICRO = 2
SHAPE = ShapeConfig("train16x16", DCFG.seq_len, DCFG.global_batch, "train")
SCFG = ServeConfig(slots=8, max_len=48, prefill_chunk=8)
DSHAPE = ShapeConfig("serve8x48", SCFG.max_len, SCFG.slots, "decode")
PROMPTS = [[3, 17, 99, 5, 8, 2, 41], [7] * 3, list(range(20, 39)),
           [11, 12], [200] + list(range(1, 11))]
GEN = 6
FORCED = [[5, 6, 7], [9] * 10, [1, 2], list(range(30, 42))]
BEAM = 32


def _cfg():
    return dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32")


def _full(t):
    from torch.distributed.tensor import DTensor
    return {tree.key(p): (v.full_tensor() if isinstance(v, DTensor)
                          else v).detach().clone()
            for p, v in tree.flatten(t)}


def _engine(model):
    return TrainEngine(model, EngineConfig(optim=OPT, microbatches=MICRO),
                       device="cpu")


def _first_grads(eng, state):
    """The first batch's loss and full gradient, as one microbatch."""
    from torch.distributed.tensor import DTensor
    params = state["params"]
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    batch = host_batch(DCFG, 0)
    batch = (eng._micro_batches(batch, 1)[0] if eng.sharded
             else eng._batch(batch))
    loss, grads = eng._grads(params, leaves, batch)
    return float(loss), {
        tree.key(p): (g.full_tensor() if isinstance(g, DTensor) else g)
        for (p, _), g in zip(tree.flatten(params), grads)}


def _train(model, step: bool):
    """First-batch loss and grads, then (``step``) one engine step: its
    (loss, gnorm) and the state after it."""
    eng = _engine(model)
    state = eng.init_state(0)
    loss, grads = _first_grads(eng, state)
    out = dict(loss=loss, grads=grads)
    if step:
        state, m = eng.step(state, host_batch(DCFG, 0))
        out.update(hist=(float(m["loss"]), float(m["gnorm"])),
                   master=_full(state["master"]),
                   placements={tree.key(p): tuple(map(str, v.placements))
                               for p, v in tree.flatten(state)
                               if hasattr(v, "placements")})
    return out


def serve(model, params):
    """PROMPTS through a Server (streams, counters, retirements, every
    logits row sampling read), then ``forced``: FORCED admitted into
    slots 0-3 and 4 decode steps of fixed tokens (logits rows)."""
    logs, forced = [], []

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
    rec = dict(streams=streams, prefill=srv.prefill_dispatches,
               decode=srv.decode_dispatches, finished=dict(srv.finished),
               fallbacks=dict(ops.plan_fallbacks), logits=logs)
    srv = Server(model, srv.params, SCFG)
    states = []
    for slot, p in enumerate(FORCED):
        srv.admit(p, slot, max_new_tokens=100)
        forced.append(srv.prefill_logits[slot].copy())
        states.append(_bf16_state(srv.cache))
    toks = np.arange(SCFG.slots) * 7 + 1
    for i in range(4):
        srv.decode_once(forced_tokens=toks + i)
        forced.append(srv.last_logits.cpu().numpy().copy())
        states.append(_bf16_state(srv.cache))
    rec.update(forced=forced, forced_states=states)
    cache = srv.cache
    rec["cache"] = {k: (tuple(map(str, v.placements)),
                        tuple(v.to_local().shape))
                    for k, v in (("mamba/ssm", cache["mamba"]["ssm"]),
                                 ("mamba/conv", cache["mamba"]["conv"]),
                                 ("shared/k", cache["shared"]["k"]))
                    if hasattr(v, "placements")}
    return rec


def _bf16_state(cache):
    """The bf16 leaves of a hybrid cache (conv history, K/V rings),
    gathered whole, as float32 numpy."""
    full = _full(cache)
    return {k: full[k].float().numpy()
            for k in ("mamba/conv", "shared/k", "shared/v")}


@contextlib.contextmanager
def _recording():
    """Wrap ``mamba.ssd_dispatch`` (called inside the block's region) and
    ``mamba._inner_whole`` to record the local batch shapes the scan
    runs on and every gather of ``zx``'s inner axis; restored on exit."""
    from repro_torch.models import mamba
    seen = {"scan": [], "gathered": []}
    scan, whole = mamba.ssd_dispatch, mamba._inner_whole

    def rec_scan(xh, *a):
        seen["scan"].append(tuple(xh.shape))
        return scan(xh, *a)

    def rec_whole(t, dim):
        out = whole(t, dim)
        if out is not t:
            seen["gathered"].append((tuple(map(str, t.placements)),
                                     tuple(map(str, out.placements))))
        return out
    mamba.ssd_dispatch, mamba._inner_whole = rec_scan, rec_whole
    try:
        yield seen
    finally:
        mamba.ssd_dispatch, mamba._inner_whole = scan, whole


def _rank_main(rank, world, plans, path):
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(MESH, NAMES, "cpu")
    cfg = _cfg()
    out = {}
    for name in ("solved", "megatron", "fallback"):
        ops.reset_plain_calls()
        with _recording() as seen:
            res = _train(LM(cfg, plan=plans["train"][name], mesh=mesh),
                         step=name != "fallback")
        res.update(scan=seen["scan"], gathered=seen["gathered"],
                   fallbacks=dict(ops.plan_fallbacks))
        out[("train", name)] = res
    for name, plan in plans["serve"].items():
        out[("serve", name)] = serve(LM(cfg, plan=plan, mesh=mesh),
                                     LM(cfg).init(0, device="cpu"))
    if rank == 0:
        torch.save(out, path)


def _megatron(make, x=None, kv=None):
    plan = make(NAMES, ["data"], "model")
    if x is not None:
        for role in ("x", "wq.out"):
            plan = plan.with_override(role, {"data": "batch", "model": x})
    if kv is not None:
        plan = plan.with_override("kv_cache", {"data": "batch", "model": kv})
    return plan


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    from repro_torch.launch import compile as t_compile
    cache = t_compile.CACHE_DIR
    t_compile.CACHE_DIR = str(tmp_path_factory.mktemp("plans"))
    try:
        from repro_torch.launch.compile import (plan_from_record,
                                                solve_cell_plan)

        def solved(shape, **kw):
            return plan_from_record(solve_cell_plan(
                _cfg(), shape, solver_axes(MESH, NAMES), "test",
                use_cache=False, beam=BEAM, graph_kwargs=kw))
        yield {"train": {"solved": solved(SHAPE, master_fp32=True),
                         "megatron": _megatron(manual_megatron_plan),
                         "fallback": _megatron(manual_megatron_plan,
                                               x="seq")},
               "serve": {"solved": solved(DSHAPE),
                         "megatron": _megatron(manual_megatron_plan),
                         "fallback": _megatron(manual_megatron_plan,
                                               kv="seq_kv")}}
    finally:
        t_compile.CACHE_DIR = cache


def _numpy_tree(t):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in t.items()}


def _repro_main(params_path, plans_path, out_path):
    """repro's side, in a process with 8 host devices, on the port's
    weights: under each train plan the first batch's loss and gradient
    (``jax.value_and_grad`` of its loss, the params placed as its engine
    places them); its Server under each serve plan."""
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
    cfg = dataclasses.replace(r_arch(ARCH).reduced(), dtype="float32")
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
    for name, role_cuts in cuts["train"].items():
        model = RLM(cfg, plan=RPlan(NAMES, role_cuts), mesh=mesh)
        eng = RTrainEngine(model, REngineConfig(microbatches=MICRO),
                           mesh=mesh)
        params = jax.tree_util.tree_map(jnp.asarray, np_params)
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
        out[("train", name)] = dict(loss=float(loss), grads=keyed(grads))
    for name, role_cuts in cuts["serve"].items():
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

        params = jax.tree_util.tree_map(jnp.asarray, np_params)
        scfg = RServeConfig(slots=SCFG.slots, max_len=SCFG.max_len,
                            prefill_chunk=SCFG.prefill_chunk)
        srv = Recording(RLM(cfg, plan=plan, mesh=m), params, scfg, mesh=m)
        for p in PROMPTS:
            srv.submit(p, max_new_tokens=GEN)
        out[("serve", name)] = dict(
            streams=srv.run(), prefill=srv.prefill_dispatches,
            decode=srv.decode_dispatches, finished=dict(srv.finished),
            logits=logs)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(plans, tmp_path_factory):
    """(the single-process port, the 8 ranks, repro), the ranks and
    repro's subprocess running side by side."""
    tmp = tmp_path_factory.mktemp("hybrid_ranks")
    cfg = _cfg()
    params = LM(cfg).init(0, device="cpu")
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(_numpy_tree(params), f)
    with open(tmp / "plans.pkl", "wb") as f:
        pickle.dump({"train": {k: v.role_cuts
                               for k, v in plans["train"].items()},
                     "serve": dict({k: v.role_cuts
                                    for k, v in plans["serve"].items()},
                                   plain=None)}, f)
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
        with _recording() as seen:
            ref = {"train": _train(LM(cfg), step=True)}
        ref.update(scan=seen["scan"], serve=serve(LM(cfg), params))
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


# -- training -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["solved", "megatron", "fallback"])
def test_first_batch_matches_one_process_and_repro(runs, name):
    """The first batch's loss and every leaf of its gradient: within 1e-5
    of the single-process port, within 1e-4 of repro's under the same
    plan."""
    ref, out, rep = runs
    got, one, want = out[("train", name)], ref["train"], rep[("train", name)]
    assert abs(got["loss"] - one["loss"]) <= PLANNED_ATOL
    assert abs(got["loss"] - want["loss"]) <= REPRO_ATOL
    assert set(got["grads"]) == set(one["grads"]) == set(want["grads"])
    for k, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), one["grads"][k].numpy(),
                                   atol=PLANNED_ATOL, rtol=0, err_msg=k)
        np.testing.assert_allclose(g.numpy(), want["grads"][k],
                                   atol=REPRO_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["solved", "megatron"])
def test_engine_step_matches_one_process(runs, name):
    """One engine step of 2 microbatches (state placed role by role, the
    gradient in the moments' layout, the bucketed reshard): loss and
    gradient norm within 1e-5 of one process, the f32 master within
    5e-5; the moments and master of ``w_in`` in their solved roles."""
    ref, out, _ = runs
    got, one = out[("train", name)], ref["train"]
    np.testing.assert_allclose(got["hist"], one["hist"], atol=PLANNED_ATOL,
                               rtol=0)
    for k, v in got["master"].items():
        np.testing.assert_allclose(v.numpy(), one["master"][k].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)
    pl = got["placements"]
    if name == "solved":
        # ssm_in.opt / .master: d_model over data (the moments ZeRO-cut)
        assert pl["opt/m/mamba/w_in"] == ("S(1)", "R")
        assert pl["master/mamba/w_in"] == ("S(1)", "R")
    else:
        assert pl["opt/m/mamba/w_in"] == ("R", "S(2)")


def test_ssd_runs_on_local_batch_rows(runs):
    """The SSD scan's inputs [B, S, H, P] on each rank: the first
    batch's 16 rows and each microbatch's 8, cut 8 ways by the solved
    plan (batch over data and model) and 4 ways by megatron and the
    fallback plan (batch over data); heads and sequence whole.  Each of
    the 4 layers runs it once in the forward and once in its remat."""
    ref, out, _ = runs
    h, p = 16, 8
    assert set(ref["scan"]) == {(16, 16, h, p), (8, 16, h, p)}
    for name, deg in (("solved", 8), ("megatron", 4), ("fallback", 4)):
        scans = out[("train", name)]["scan"]
        rows = [16 // deg] * 8
        if name != "fallback":
            rows += [8 // deg] * 16
        assert sorted(s[0] for s in scans) == sorted(rows), name
        assert {s[1:] for s in scans} == {(16, h, p)}, name


def test_w_in_halves_are_gathered_before_the_split(runs):
    """megatron cuts ``w_in`` [d, z | x] on inner over model: each model
    rank holds one half, so ``zx`` arrives cut on its inner axis and is
    gathered explicitly before ``_split_proj`` (once a layer in the
    forward and once in its remat, for each of 3 passes); the solved
    plan leaves w_in whole and nothing is gathered.  The fallback plan
    gathers every shared-block attention call (2 applications, forward
    and remat), the others none."""
    _, out, _ = runs
    meg = out[("train", "megatron")]
    assert meg["placements"]["params/mamba/w_in"] == ("R", "S(2)")
    assert meg["gathered"] and all(
        src == ("S(0)", "S(2)") and dst == ("S(0)", "R")
        for src, dst in meg["gathered"])
    assert len(meg["gathered"]) == 4 * 2 * 3
    solved = out[("train", "solved")]
    assert solved["gathered"] == []
    assert solved["placements"]["params/mamba/w_in"] == ("R", "R")
    assert out[("train", "fallback")]["fallbacks"]["attention"] == 2 * 2
    for name in ("solved", "megatron"):
        assert sum(out[("train", name)]["fallbacks"].values()) == 0, name


# -- serving ------------------------------------------------------------------

def _flipped_slots(got, want):
    """The slots whose bf16 state (conv history, K/V rings) differs
    between two runs' snapshots: an f32 value a few ulps apart rounded to
    the neighbouring bf16 value there."""
    out = set()
    for k in ("mamba/conv", "shared/k", "shared/v"):
        d = got[k] != want[k]
        out |= set(np.nonzero(d.reshape(d.shape[0], d.shape[1], -1)
                              .any(axis=(0, 2)))[0].tolist())
    return out


def _check_forced(got, want):
    """Teacher-forced logits (a prefill row per slot 0-3, then 4 decode
    steps of [8, V]) against ``want``'s: a row whose slot's bf16 state has
    been bit-equal in both runs up to and including that event within
    1e-5, a row of a slot where one rounded the other way within 1e-3.
    Returns (rows held at 1e-5, rows in all)."""
    n, flipped, strict, rows_all = len(FORCED), set(), 0, 0
    for i, (a, b) in enumerate(zip(got["forced"], want["forced"])):
        flipped |= _flipped_slots(got["forced_states"][i],
                                  want["forced_states"][i])
        rows = [i] if i < n else range(a.shape[0])
        a, b = a.reshape(len(rows), -1), b.reshape(len(rows), -1)
        for j, r in enumerate(rows):
            tol = SERVED_ATOL if r in flipped else FORCED_ATOL
            err = float(np.abs(a[j] - b[j]).max())
            assert err <= tol, (i, r, err, sorted(flipped))
            strict += r not in flipped
            rows_all += 1
    return strict, rows_all


def _check_streams(want, got):
    assert got["streams"] == want["streams"]
    assert all(len(t) == GEN for t in got["streams"].values())
    assert (got["prefill"], got["decode"], got["finished"]) == \
        (want["prefill"], want["decode"], want["finished"])
    assert len(got["logits"]) == len(want["logits"])


@pytest.mark.parametrize("name", ["solved", "megatron", "fallback"])
def test_serves_like_one_process_and_repro(runs, name):
    """Under each plan: the streams, dispatch counters and retirements of
    the unplanned port and of repro's Server under the same plan; the
    teacher-forced logits against the unplanned port's by
    ``_check_forced``'s rule (1e-5 while a slot's bf16 state is
    bit-equal, 1e-3 after), every sampled logits row within 1e-3 of
    repro's."""
    ref, out, rep = runs
    got = out[("serve", name)]
    _check_streams(ref["serve"], got)
    _check_streams(rep[("serve", name)], got)
    strict, _ = _check_forced(got, ref["serve"])
    assert strict > 0
    err = max(float(np.abs(a - b).max())
              for a, b in zip(got["logits"], rep[("serve", name)]["logits"]))
    assert err <= SERVED_ATOL, err


def test_serving_state_is_placed_and_fallbacks_counted(runs):
    """The solved decode plan cuts the state and the rings on batch over
    both axes: one slot a rank, no fallback.  megatron cuts the SSM state
    on batch and inner, the conv state on batch and its [xs | B | C]
    axis, so each Mamba decode step gathers both (2 a layer a step:
    every decode dispatch and every prompt token's scan step); the
    fallback plan's seq_kv ring cut gathers each shared application."""
    ref, out, _ = runs
    L, n_shared = _cfg().n_layers, 2
    solved = out[("serve", "solved")]
    assert sum(solved["fallbacks"].values()) == 0
    assert solved["cache"]["mamba/ssm"] == (("S(1)", "S(1)"),
                                           (4, 1, 16, 8, 8))
    assert solved["cache"]["mamba/conv"] == (("S(1)", "S(1)"),
                                            (4, 1, 3, 144))
    assert solved["cache"]["shared/k"] == (("S(1)", "S(1)"),
                                          (2, 1, 48, 4, 16))
    steps = ref["serve"]["decode"] + sum(map(len, PROMPTS))
    meg = out[("serve", "megatron")]
    assert meg["cache"]["mamba/ssm"] == (("S(1)", "S(2)"), (4, 2, 8, 8, 8))
    assert meg["cache"]["mamba/conv"] == (("S(1)", "S(3)"), (4, 2, 3, 72))
    assert meg["fallbacks"]["mamba_state"] == 2 * L * steps
    assert sum(meg["fallbacks"].values()) == 2 * L * steps
    fb = out[("serve", "fallback")]
    assert fb["fallbacks"]["attend_cache"] == n_shared * steps
    assert fb["cache"]["shared/k"] == (("S(1)", "S(2)"), (2, 2, 24, 4, 16))


def test_plain_server_matches_repros(runs):
    """The unplanned port against repro's unplanned Server on the same
    weights: the streams the planned runs are held to are repro's."""
    ref, _, rep = runs
    _check_streams(rep[("serve", "plain")], ref["serve"])


# -- the CLI ------------------------------------------------------------------

def test_launch_train_hybrid_under_a_plan(tmp_path, capfd, monkeypatch):
    """``python -m repro_torch.launch.train --arch zamba2-2.7b --reduced
    --mesh 2x2 --plan auto --device cpu`` spawns 4 gloo ranks and trains
    the hybrid family under the plan cached just before (solved at beam
    32 under the name the CLI gives it; the parent's solver raises for the
    duration of the call); rank 0 writes the record."""
    from repro_torch.launch import compile as t_compile
    from repro_torch.launch import train as launch_train
    cfg = get_arch(ARCH).reduced()
    shape = ShapeConfig("trainr4x16", 16, 4, "train")
    t_compile.solve_cell_plan(
        cfg, shape, solver_axes((2, 2), NAMES), "mesh2x2_mp",
        use_cache=False, beam=BEAM, graph_kwargs={"master_fp32": True,
                                                  "error_feedback": False})

    def refuse(*a, **kw):
        raise AssertionError("solved again instead of taking the cache")
    out = tmp_path / "rec.json"
    with monkeypatch.context() as m:
        m.setattr(t_compile, "solve_mesh", refuse)
        m.setattr(t_compile, "solve_mesh_capacity", refuse)
        assert launch_train.main(
            ["--arch", ARCH, "--reduced", "--device", "cpu", "--mesh", "2x2",
             "--plan", "auto", "--steps", "2", "--batch", "4", "--seq", "16",
             "--json-out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["meta"]["arch"] == ARCH and rec["meta"]["mesh"] == "2x2"
    assert len(rec["losses"]) == 2 and np.isfinite(rec["losses"]).all()
    assert "ssm_in.master" in rec["plan"]["role_cuts"]
    assert "train plan" in capfd.readouterr().out


if __name__ == "__main__":
    _repro_main(sys.argv[1], sys.argv[2], sys.argv[3])
