"""The trainer under a solved sharding plan on 8 gloo ranks, against the
single-process port and against repro's ``TrainEngine`` under the same
plan on 8 host devices.

The model is a test-built config: the reduced llama3.2-3b (4 layers,
d_model 64, 4 heads of 16) with ``n_kv_heads=2`` in f32, so that a heads
cut by 2 can run the attention on local shards (the stock reduced configs
have one KV head).  Batches are ``host_batch`` (seed 0) of 16 x 16
tokens, 2 microbatches a step.  One spawn of 8 ranks for the file, torch
on one thread a rank; at the same time one subprocess with 8 forced host
devices runs repro's engine on the port's ``init(0)`` weights as numpy.
The ranks run, in turn:

  ``solved``   the (4, 2) train plan the port's solver gives this cell
               (master_fp32 in the graph): activations on ``batch``, the
               moments and master ZeRO-cut under ``<w>.opt`` /
               ``<w>.master``; 2 steps;
  ``megatron`` ``manual_megatron_plan`` at (4, 2): batch on data, heads,
               d_ff and vocab on model, so the attention runs on local
               (batch, heads) shards; 2 steps;
  ``fallback`` ``manual_megatron_plan`` at (2, 4): 2 KV heads do not
               divide by 4, so every attention call gathers; 2 steps;
  ``nomaster`` the solved plan with no f32 master: AdamW updates the
               whole params from the moments' cut; 2 steps;
  ``adamw``    ``apply_updates`` alone on small trees whose params,
               grads and moments sit in different placements, 3 steps,
               against repro's on the gathered tensors (1e-6);
  ``int8``     error-feedback int8 under the plan solved with the
               residuals in the graph, with the ``.opt`` cuts replaced by
               replication, so that the int8 values ride an all-gather
               into the gradient's layout; 3 steps (repro's compressed
               engine runs the same plan);
  ``elastic``  3 steps at (4, 2), a checkpoint, and a restore onto the
               (2, 4) mesh under its own solved plan, then one more step;
  ``unplanned`` ``train`` on the (4, 2) mesh with no plan, a checkpoint
               each of 2 steps: only rank 0 writes.

Bands, each with its reason:
  planned vs one process, f32: the first batch's gradient (every leaf),
      the losses and the gradient norms within 1e-5 -- the same
      arithmetic, the cut batch summed in another order (a gradient's
      difference stays near 1e-8 absolute);
  the params and master after 2 steps: 5e-5 -- AdamW's first steps take
      an element whose gradient nearly cancels (|g| near its eps of 1e-8)
      through g / (|g| + eps), which turns a difference of ~1e-9 in g into
      up to a few 1e-2 of the step; at lr 3e-4 one element of 32,768
      moved 1.8e-5 under the megatron plan (the rest stayed under 1e-5);
  planned port vs repro under the same plan: 1e-4, the training band of
      tests/test_torch_train.py (repro's XLA attention and XLA's
      reduction order against the port's);
  int8 under the plan vs the single-process compressed port and vs
      repro's compressed engine under the same plan, 3 steps: the losses,
      the gradient norms and each parameter's change from init within
      1e-4 -- a reduction-order difference moves a few values across an
      int8 rounding boundary (one quantum of the bucket's scale), which
      AdamW turns into a different step for those elements: measured on
      this CPU, 8.0e-5 worst in the change (9 elements of the master
      past 1e-6 against repro) and 3.7e-5 in a gradient norm, where the
      changes themselves have a median of 6.2e-4 and a maximum of 9.9e-4;
  elastic restore: bit for bit (the checkpoint stores f32 and bf16 values
      exactly).
The plan records of ``launch/compile.solve_cell_plan`` are held to
repro's, solved with repro's constants, at 1e-9 relative."""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.core.plan import ShardingPlan, manual_megatron_plan
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.kernels import ops
from repro_torch.launch.mesh import spawn, solver_axes
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.engine import EngineConfig, TrainEngine

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
NAMES = ("data", "model")
PLANNED_ATOL = 1e-5
PARAM_ATOL = 5e-5
REPRO_ATOL = 1e-4
INT8_ATOL = 1e-4
LR = 3e-4
OPT = AdamWConfig(lr=LR, warmup_steps=2, total_steps=1000)
DCFG = DataConfig(seed=0, vocab=256, seq_len=16, global_batch=16)
MICRO = 2
SHAPE = ShapeConfig("train16x16", DCFG.seq_len, DCFG.global_batch, "train")
# the solver's beam in these tests: at "auto" a solve of the reduced train
# graph takes ~17 s on this CPU, at 32 under a second (and both packages
# are given the same beam)
BEAM = 32


def _cfg():
    return dataclasses.replace(get_arch("llama3.2-3b").reduced(),
                               n_kv_heads=2, dtype="float32")


def _full(state):
    """Every leaf of a (possibly placed) state as a full CPU tensor."""
    from torch.distributed.tensor import DTensor
    return {tree.key(p): (v.full_tensor() if isinstance(v, DTensor)
                          else v).detach().clone()
            for p, v in tree.flatten(state)}


def _placements(state):
    return {tree.key(p): tuple(map(str, v.placements))
            for p, v in tree.flatten(state)}


def _run(engine, steps, state=None, start=0):
    """``steps`` steps from ``state`` (or ``init_state(0)``): the state
    and [(loss, gnorm)]."""
    if state is None:
        state = engine.init_state(0)
    out = []
    for step in range(start, start + steps):
        state, m = engine.step(state, host_batch(DCFG, step))
        out.append((float(m["loss"]), float(m["gnorm"])))
    return state, out


def _first_grads(eng, state):
    """The full gradient of the first batch (the step's raw grads, pending
    sums reduced), one process or planned."""
    from torch.distributed.tensor import DTensor
    params = state["params"]
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    batch = host_batch(DCFG, 0)
    batch = (eng._micro_batches(batch, 1)[0] if eng.sharded
             else eng._batch(batch))
    _, grads = eng._grads(params, leaves, batch)
    return {tree.key(p): (g.full_tensor() if isinstance(g, DTensor) else g)
            for (p, _), g in zip(tree.flatten(params), grads)}


def _engine(model, cls=TrainEngine, **kw):
    return cls(model, EngineConfig(optim=OPT, microbatches=MICRO, **kw),
               device="cpu")


class _WireCounter(TrainEngine):
    """Counts the collectives of each int8 reshard (``on_wire``) with
    ``CommDebugMode``, by collective, with the dtypes that went through."""
    wire: dict = {}
    dtypes: set = set()

    def _to_grads(self, placements, i, q):
        from torch.distributed.tensor.debug import CommDebugMode
        type(self).dtypes.add(str(q.dtype))
        with CommDebugMode() as cm:
            out = super()._to_grads(placements, i, q)
        for op, n in cm.get_comm_counts().items():
            name = str(op).split(".")[-1]
            type(self).wire[name] = type(self).wire.get(name, 0) + n
        return out


# AdamW on placed trees: each leaf's (param, grad and moments) placements
# on the (4, 2) mesh; "w" has its moments cut and its param whole (the
# update's write-back path), "a" its param and moments cut on other dims,
# "ln_f" everything whole (the norm counts one copy of it)
OPT_SHAPES = {"w": (8, 6), "ln_f": (6,), "layers": {"a": (2, 8, 4)}}
OPT_PLACEMENTS = {"w": ("RR", "S0S1"), "ln_f": ("RR", "RR"),
                  "layers": {"a": ("RS2", "S1R")}}


def _opt_tree(seed):
    rng = np.random.default_rng(seed)

    def make(t):
        return ({k: make(v) for k, v in t.items()} if isinstance(t, dict)
                else rng.standard_normal(t).astype(np.float32))
    return make(OPT_SHAPES)


def _adamw_on_ranks(mesh, steps=3):
    """Port's ``apply_updates`` on DTensor trees placed as
    OPT_PLACEMENTS: the gradient norms and the gathered params, m, v."""
    from torch.distributed.tensor import Replicate

    from repro_torch.models.sharding import place
    from repro_torch.optim import adamw

    def placed(t, which):
        return tree.tree_map(
            lambda a, codes: place(torch.from_numpy(a), mesh,
                                   _codes(codes[which])), t, OPT_PLACEMENTS)

    params = placed(_opt_tree(0), 0)
    state = {"step": place(torch.zeros((), dtype=torch.int32), mesh,
                           [Replicate(), Replicate()]),
             "m": placed(tree.tree_map(np.zeros_like, _opt_tree(0)), 1),
             "v": placed(tree.tree_map(np.zeros_like, _opt_tree(0)), 1)}
    norms = []
    for step in range(steps):
        grads = placed(_opt_tree(step + 1), 1)
        _, _, gnorm = adamw.apply_updates(params, grads, state, OPT)
        norms.append(float(gnorm))
    return dict(norms=norms, params=_full(params), m=_full(state["m"]),
                v=_full(state["v"]))


def _codes(code):
    """"RS2" -> [Replicate(), Shard(2)]: one letter (and dim) a mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    out, i = [], 0
    while i < len(code):
        if code[i] == "R":
            out.append(Replicate())
            i += 1
        else:
            out.append(Shard(int(code[i + 1])))
            i += 2
    return out


def _rank_main(rank, world, plans, ckpt_dir, path):
    """One rank: every run of the module docstring; rank 0 saves the
    results."""
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    cfg = _cfg()
    mesh42 = make_mesh((4, 2), NAMES, "cpu")
    mesh24 = make_mesh((2, 4), NAMES, "cpu")
    out = {"adamw": _adamw_on_ranks(mesh42)}
    for name, mesh in (("solved", mesh42), ("megatron", mesh42),
                       ("fallback", mesh24)):
        eng = _engine(LM(cfg, plan=plans[name], mesh=mesh))
        state = eng.init_state(0)
        grads = _first_grads(eng, state)
        ops.reset_plain_calls()
        state, hist = _run(eng, 2, state)
        out[name] = dict(hist=hist, state=_full(state), grads=grads,
                         placements=_placements(state),
                         fallbacks=dict(ops.plan_fallbacks))
    # no f32 master: AdamW writes the whole params back from the moments'
    # cut (the update's write-back path)
    eng = _engine(LM(cfg, plan=plans["solved"], mesh=mesh42),
                  master_fp32=False)
    state, hist = _run(eng, 2)
    out["nomaster"] = dict(hist=hist, state=_full(state),
                           placements=_placements(state))
    eng = _engine(LM(cfg, plan=plans["int8"], mesh=mesh42), _WireCounter,
                  grad_compression=True)
    state, hist = _run(eng, 3)
    out["int8"] = dict(hist=hist, state=_full(state),
                       placements=_placements(state),
                       wire=dict(_WireCounter.wire),
                       dtypes=sorted(_WireCounter.dtypes))
    # elastic: 4x2 -> checkpoint -> 2x4
    eng = _engine(LM(cfg, plan=plans["solved"], mesh=mesh42))
    state, hist = _run(eng, 3)
    eng.save(ckpt_dir, 3, state)
    saved = _full(state)
    eng24 = _engine(LM(cfg, plan=plans["solved24"], mesh=mesh24))
    restored, _, step = eng24.restore(ckpt_dir)
    want_pl = {tree.key(p): tuple(map(str, q))
               for p, q in tree.flatten(eng24.state_placements())}
    back = _full(restored)
    local = {tree.key(p): tuple(v.to_local().shape)
             for p, v in tree.flatten(restored)}
    _, more = _run(eng24, 1, restored, start=step)
    out["elastic"] = dict(
        hist=hist, step=step, more=more, local=local,
        equal={k: torch.equal(back[k], saved[k]) for k in saved},
        dtypes={k: (back[k].dtype, saved[k].dtype) for k in saved},
        placements=_placements(restored), want=want_pl)
    out["unplanned"] = _unplanned_writes(cfg, mesh42, ckpt_dir + "_unplanned")
    if rank == 0:
        torch.save(out, path)


def _unplanned_writes(cfg, mesh, directory):
    """``train`` on a mesh without a plan (every rank the whole model), a
    checkpoint each of 2 steps: the steps each rank wrote, every rank's
    list, and the steps committed."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.runtime.train_loop import TrainConfig, train
    writes, real = [], ckpt._write

    def counted(directory, final, step, leaves, extra):
        writes.append(step)
        real(directory, final, step, leaves, extra)
    ckpt._write = counted
    try:
        train(LM(cfg), DCFG, TrainConfig(steps=2, ckpt_every=1,
                                         ckpt_dir=directory, optim=OPT),
              device="cpu", mesh=mesh)
    finally:
        ckpt._write = real
    every = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(every, writes)
    return dict(writes=every, committed=sorted(os.listdir(directory)))


def _solve(cfg, mesh, **graph_kwargs):
    from repro_torch.launch.compile import plan_from_record, solve_cell_plan
    return plan_from_record(solve_cell_plan(
        cfg, SHAPE, solver_axes(mesh, NAMES), f"test{mesh}",
        use_cache=False, beam=BEAM, graph_kwargs=graph_kwargs))


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    from repro_torch.launch import compile as t_compile
    cache = t_compile.CACHE_DIR
    t_compile.CACHE_DIR = str(tmp_path_factory.mktemp("plans"))
    try:
        yield _plans()
    finally:
        t_compile.CACHE_DIR = cache


def _plans():
    cfg = _cfg()
    ef = _solve(cfg, (4, 2), master_fp32=True, error_feedback=True)
    # the .opt cuts replicated: grads (and moments) whole on every rank,
    # residuals cut under their own .err roles, so the int8 reshard from
    # the residuals' layout into the grads' is an all-gather
    for role, cuts in list(ef.role_cuts.items()):
        if role.endswith(".opt"):
            ef = ef.with_override(role, {a: None for a in cuts})
    return {"solved": _solve(cfg, (4, 2), master_fp32=True),
            "solved24": _solve(cfg, (2, 4), master_fp32=True),
            "megatron": manual_megatron_plan(NAMES, ["data"], "model"),
            "fallback": manual_megatron_plan(NAMES, ["data"], "model"),
            "int8": ef}


def _numpy_tree(t):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in t.items()}


def _repro_main(params_path, plans_path, out_path):
    """repro's side, in a process with 8 host devices: its TrainEngine
    under each given plan on the port's weights, 2 steps (3, compressed,
    under ``int8``); losses, norms and the f32 master weights pickled."""
    import jax
    import jax.numpy as jnp

    from repro.compat import make_compat_mesh
    from repro.configs import get_arch as r_arch
    from repro.core.plan import ShardingPlan as RPlan
    from repro.data.pipeline import DataConfig as RDataConfig
    from repro.data.pipeline import host_batch as r_host_batch
    from repro.models.model import LM as RLM
    from repro.optim.adamw import AdamWConfig as RAdamWConfig
    from repro.optim.adamw import init_state
    from repro.optim.compression import init_error
    from repro.train.engine import EngineConfig as REngineConfig
    from repro.train.engine import TrainEngine as RTrainEngine

    mesh = make_compat_mesh((4, 2), NAMES)
    cfg = dataclasses.replace(r_arch("llama3.2-3b").reduced(), n_kv_heads=2,
                              dtype="float32")
    dcfg = RDataConfig(seed=DCFG.seed, vocab=DCFG.vocab,
                       seq_len=DCFG.seq_len, global_batch=DCFG.global_batch)
    with open(params_path, "rb") as f:
        np_params = pickle.load(f)
    with open(plans_path, "rb") as f:
        cuts = pickle.load(f)
    out = {}
    for name, role_cuts in cuts.items():
        plan = RPlan(NAMES, role_cuts)
        int8 = name == "int8"
        eng = RTrainEngine(
            RLM(cfg, plan=plan, mesh=mesh),
            REngineConfig(optim=RAdamWConfig(lr=LR, warmup_steps=2,
                                             total_steps=1000),
                          microbatches=MICRO, grad_compression=int8),
            mesh=mesh)
        params = jax.tree_util.tree_map(jnp.asarray, np_params)
        state = {"params": params, "opt": init_state(params),
                 "master": jax.tree_util.tree_map(
                     lambda p: jnp.array(p, jnp.float32, copy=True),
                     params)}
        if int8:
            state["err"] = init_error(params)
        state = jax.device_put(state, eng.state_shardings())
        hist = []
        for step in range(3 if int8 else 2):
            state, m = eng.step(state, r_host_batch(dcfg, step))
            hist.append((float(m["loss"]), float(m["gnorm"])))
        out[name] = dict(hist=hist, master={
            "/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in
            jax.tree_util.tree_flatten_with_path(state["master"])[0]})
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(plans, tmp_path_factory):
    """(the single-process port's runs, the 8 ranks' runs, repro's runs
    under the solved and megatron plans), the ranks and repro's
    subprocess running side by side."""
    tmp = tmp_path_factory.mktemp("train_ranks")
    cfg = _cfg()
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(_numpy_tree(LM(cfg).init(0, device="cpu")), f)
    with open(tmp / "plans.pkl", "wb") as f:
        pickle.dump({k: plans[k].role_cuts
                     for k in ("solved", "megatron", "int8")}, f)
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
        for name, steps, kw in (("plain", 2, {}),
                                ("nomaster", 2, dict(master_fp32=False)),
                                ("int8", 3, dict(grad_compression=True))):
            eng = _engine(LM(cfg), **kw)
            state = eng.init_state(0)
            init = _full(state)
            grads = _first_grads(eng, state)
            state, hist = _run(eng, steps, state)
            ref[name] = dict(hist=hist, state=_full(state), grads=grads,
                             init=init)
        spawn(_rank_main, 8, "cpu",
              (plans, str(tmp / "ckpt"), str(tmp / "out.pt")))
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


def _close_states(got, want, atol, prefix=("params/", "master/")):
    keys = [k for k in want if k.startswith(prefix)]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   want[k].float().numpy(), atol=atol,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["solved", "megatron", "fallback"])
def test_planned_step_matches_one_process(runs, name):
    """Under the plan against the single-process port: the first batch's
    gradient, and 2 steps of 2 microbatches' losses and gradient norms
    within 1e-5; the params and master after them within 5e-5."""
    ref, out, _ = runs
    got, want = out[name], ref["plain"]
    assert set(got["grads"]) == set(want["grads"])
    for k, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k].numpy(), g.numpy(),
                                   atol=PLANNED_ATOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(got["hist"], want["hist"], atol=PLANNED_ATOL,
                               rtol=0)
    _close_states(got["state"], want["state"], PARAM_ATOL)
    assert got["hist"][-1][0] < got["hist"][0][0]


def test_planned_step_without_master_matches_one_process(runs):
    """The solved plan with no f32 master: the update reads the whole
    params in the moments' cut and writes them back; losses and norms
    within 1e-5, params within 5e-5 of the single-process port."""
    ref, out, _ = runs
    got, want = out["nomaster"], ref["nomaster"]
    np.testing.assert_allclose(got["hist"], want["hist"], atol=PLANNED_ATOL,
                               rtol=0)
    assert not any(k.startswith("master/") for k in got["state"])
    assert got["placements"]["params/layers/mlp/wg"] == ("R", "R")
    assert got["placements"]["opt/m/layers/mlp/wg"] == ("S(1)", "R")
    _close_states(got["state"], want["state"], PARAM_ATOL)


@pytest.mark.parametrize("name", ["solved", "megatron"])
def test_planned_step_matches_repro(runs, name):
    """The same 2 steps against repro's TrainEngine under the same plan
    on 8 host devices: losses, norms and master weights within 1e-4."""
    _, out, rep = runs
    got, want = out[name], rep[name]
    np.testing.assert_allclose(got["hist"], want["hist"], atol=REPRO_ATOL,
                               rtol=0)
    for k, v in want["master"].items():
        np.testing.assert_allclose(got["state"][f"master/{k}"].numpy(), v,
                                   atol=REPRO_ATOL, rtol=0, err_msg=k)


def test_adamw_on_placed_trees_matches_repro(runs):
    """3 AdamW steps on DTensor trees whose params, grads and moments sit
    in different placements (the write-back path, a leaf replicated on
    every rank) against repro's ``apply_updates`` on the gathered
    tensors: the gradient norms and params, m and v within 1e-6 (the same
    f32 formulas; tests/test_torch_train.py's optimizer band)."""
    import jax
    import jax.numpy as jnp

    from repro.optim import adamw as r_adamw
    _, out, _ = runs
    got = out["adamw"]
    params = jax.tree_util.tree_map(jnp.asarray, _opt_tree(0))
    state = r_adamw.init_state(params)
    ropt = r_adamw.AdamWConfig(lr=LR, warmup_steps=2, total_steps=1000)
    for step in range(3):
        params, state, gnorm = r_adamw.apply_updates(
            params, jax.tree_util.tree_map(jnp.asarray, _opt_tree(step + 1)),
            state, ropt)
        assert abs(float(gnorm) - got["norms"][step]) <= 1e-5 * max(
            1.0, float(gnorm))
    for name, want in (("params", params), ("m", state["m"]),
                       ("v", state["v"])):
        flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
                for path, leaf in
                jax.tree_util.tree_flatten_with_path(want)[0]}
        assert set(flat) == set(got[name])
        for k, v in flat.items():
            np.testing.assert_allclose(got[name][k].numpy(), v, atol=1e-6,
                                       rtol=1e-5, err_msg=f"{name}/{k}")


def test_optimizer_state_is_zero_sharded(plans, runs):
    """Under the solved plan the weights are whole on every rank, and the
    moments and the master are cut as their ``.opt`` / ``.master`` roles
    say (each leaf's stacked layer axis is never cut)."""
    _, out, _ = runs
    plan, pl = plans["solved"], out["solved"]["placements"]
    assert plan.role_cuts["w_gate"] == {"data": None, "model": None}
    assert plan.role_cuts["w_gate.opt"] == {"data": "d_model", "model": None}
    assert plan.role_cuts["w_gate.master"] == {"data": "d_model",
                                               "model": None}
    assert pl["params/layers/mlp/wg"] == ("R", "R")
    for tag in ("opt/m", "opt/v", "master"):
        # [L, d_model, d_ff]: d_model over data
        assert pl[f"{tag}/layers/mlp/wg"] == ("S(1)", "R"), tag
    assert pl["opt/step"] == ("R", "R")
    cut = [k for k, v in pl.items() if k.startswith("opt/m/") and
           v != ("R", "R")]
    assert len(cut) >= 7, cut


def test_attention_fallbacks(runs):
    """Megatron at (4, 2) cuts batch over data and heads over model (4
    heads and 2 KV heads, both divisible by 2): no gather.  At (2, 4) the
    2 KV heads do not divide by 4: every attention call gathers, once in
    the forward and once in the layer's recompute, each microbatch."""
    _, out, _ = runs
    L = _cfg().n_layers
    for name in ("solved", "megatron"):
        assert out[name]["fallbacks"]["attention"] == 0, name
        assert out[name]["placements"]["params/layers/attn/wq"] == \
            (("R", "R") if name == "solved" else ("R", "S(2)"))
    assert out["fallback"]["fallbacks"] == {
        "attend_cache": 0, "prefill_attention": 0,
        "attention": 2 * L * MICRO * 2, "attend_paged": 0, "rescore": 0,
        "copy_block": 0}


def test_int8_compression_under_the_plan(runs):
    """Error-feedback int8 under a plan, 3 steps, against the
    single-process compressed port and against repro's compressed
    TrainEngine under the same plan: the losses and gradient norms, and
    each parameter's change from its initial value (params and master),
    within 1e-4.  The change is held, not the value: a state the steps
    left alone must fail, so the test asserts the change's median is
    over 5x the band.  The grads are reduced in f32 into the residuals'
    layout, and only the int8 values move into the gradient's: here an
    all-gather a leaf that the residuals cut (CommDebugMode)."""
    ref, out, rep = runs
    got, want, init = out["int8"], ref["int8"], ref["int8"]["init"]
    np.testing.assert_allclose(got["hist"], want["hist"], atol=INT8_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got["hist"], rep["int8"]["hist"],
                               atol=INT8_ATOL, rtol=0)
    keys = [k for k in want["state"] if k.startswith(("params/", "master/"))]
    assert any(k.startswith("master/") for k in keys)

    def change(state, k):
        return np.asarray(state[k], np.float32) - init[k].float().numpy()

    moved = np.concatenate([np.abs(change(want["state"], k)).ravel()
                            for k in keys])
    assert np.median(moved) > 5 * INT8_ATOL, np.median(moved)
    for k in keys:
        np.testing.assert_allclose(change(got["state"], k),
                                   change(want["state"], k), atol=INT8_ATOL,
                                   rtol=0, err_msg=k)
    repro_master = {f"master/{k}": v for k, v in rep["int8"]["master"].items()}
    assert set(repro_master) == {k for k in keys if k.startswith("master/")}
    for k, v in repro_master.items():
        np.testing.assert_allclose(change(got["state"], k),
                                   change({k: v}, k), atol=INT8_ATOL,
                                   rtol=0, err_msg=k)
    assert got["dtypes"] == ["torch.int8"]
    assert set(got["wire"]) == {"all_gather_into_tensor"}, got["wire"]
    assert got["wire"]["all_gather_into_tensor"] > 0
    assert got["placements"]["err/layers/mlp/wg"] != ("R", "R")
    assert got["placements"]["opt/m/layers/mlp/wg"] == ("R", "R")


def test_elastic_restore_4x2_to_2x4(runs):
    """3 steps at (4, 2), saved; restored onto (2, 4) under that mesh's
    solved plan: params, opt and master bit for bit, each leaf on its
    (2, 4) placements, and one more step gives a finite loss."""
    _, out, _ = runs
    got = out["elastic"]
    assert got["step"] == 3
    assert {k.split("/")[0] for k in got["equal"]} == {"params", "opt",
                                                      "master"}
    assert all(got["equal"].values()), [k for k, v in got["equal"].items()
                                        if not v]
    assert all(a == b for a, b in got["dtypes"].values())
    assert got["placements"] == got["want"]
    assert any("S(" in str(v) for v in got["want"].values())
    # [L, d_model, d_ff] cut on d_model over data: 2 rows of 64 -> 32
    for tag in ("opt/m", "opt/v", "master"):
        assert got["local"][f"{tag}/layers/mlp/wg"] == (4, 32, 128), tag
    assert got["local"]["params/layers/mlp/wg"] == (4, 64, 128)
    assert np.isfinite(got["more"][0][0])


def test_mesh_without_a_plan_writes_from_rank_0_only(runs):
    """Under a mesh with no plan every rank trains the whole model and
    calls ``save``; rank 0 alone writes each step, and both are
    committed."""
    _, out, _ = runs
    got = out["unplanned"]
    assert got["writes"] == [[1, 2]] + [[]] * 7
    assert got["committed"] == ["step_00000001", "step_00000002"]


# ---------------------------------------------------------------------------
# the plan records against repro's
# ---------------------------------------------------------------------------

RECORD_CASES = [(mesh, kw) for mesh in ((4, 2), (2, 4))
                for kw in (dict(master_fp32=True), dict(master_fp32=False),
                           dict(master_fp32=True, error_feedback=True))]
RECORD_SHAPE = ("train8x64", 64, 8, "train")


def _repro_axes(mesh):
    from repro.core.solver import MeshAxis as RAxis
    from repro.launch.mesh import ICI_BW, ICI_LINKS_PER_AXIS
    return [RAxis(n, s, ICI_BW * ICI_LINKS_PER_AXIS)
            for n, s in zip(NAMES, mesh)]


def _port_axes(mesh):
    """The port's axes at repro's bandwidth (repro's constants)."""
    from repro.launch.mesh import ICI_BW, ICI_LINKS_PER_AXIS
    from repro_torch.core.solver import MeshAxis
    return [MeshAxis(n, s, ICI_BW * ICI_LINKS_PER_AXIS)
            for n, s in zip(NAMES, mesh)]


def _same_solution(got, g, ref, rg):
    from repro.core.plan import ShardingPlan as RPlan
    assert ShardingPlan.from_graph_solution(got, g).role_cuts == \
        RPlan.from_graph_solution(ref, rg).role_cuts
    for a, b in ((got.total_bytes, ref.total_bytes),
                 (got.total_seconds, ref.total_seconds)):
        assert abs(a - b) <= 1e-9 * max(1.0, abs(b)), (a, b)
    assert np.allclose(got.per_axis_bytes, ref.per_axis_bytes, rtol=1e-9,
                       atol=0)


@pytest.mark.parametrize(
    "mesh,graph_kwargs", RECORD_CASES,
    ids=[f"{m[0]}x{m[1]}-{'mp' if kw['master_fp32'] else 'nomp'}"
         f"{'-ef' if kw.get('error_feedback') else ''}"
         for m, kw in RECORD_CASES])
def test_train_plan_record_matches_repro(mesh, graph_kwargs):
    """The reduced llama3.2-3b train graph built with the trainer's
    ``graph_kwargs`` and solved by both packages with repro's constants
    (as tests/test_torch_solver.py does): the same role cuts, with the
    ``.opt`` / ``.master`` / ``.err`` roles, and the same byte and second
    totals (1e-9 relative), at the same beam."""
    from repro.configs import get_arch as r_arch
    from repro.configs.base import ShapeConfig as RShape
    from repro.core.builders import build_graph as r_build
    from repro.core.cost import HBM_PER_DEV as R_HBM
    from repro.core.solver import solve_mesh as r_solve
    from repro_torch.core.builders import build_graph
    from repro_torch.core.costterms import CapacityTerm
    from repro_torch.core.solver import solve_mesh
    rg = r_build(r_arch("llama3.2-3b").reduced(), RShape(*RECORD_SHAPE),
                 **graph_kwargs)
    ref = r_solve(rg, _repro_axes(mesh), beam=BEAM)
    g = build_graph(get_arch("llama3.2-3b").reduced(),
                    ShapeConfig(*RECORD_SHAPE), **graph_kwargs)
    got = solve_mesh(g, _port_axes(mesh), beam=BEAM, mem_scale=0.0,
                     terms=(CapacityTerm(scale=1.0, hbm=R_HBM),))
    _same_solution(got, g, ref, rg)
    roles = set(ShardingPlan.from_graph_solution(got, g).role_cuts)
    assert "w_gate.opt" in roles
    assert ("w_gate.master" in roles) == graph_kwargs["master_fp32"]
    assert ("w_gate.err" in roles) == bool(graph_kwargs.get(
        "error_feedback"))


CAPACITY_CASES = [((4, 2), 0.7), ((2, 4), 0.7), ((4, 2), 0.2)]


@pytest.mark.parametrize("mesh,budget_frac", CAPACITY_CASES,
                         ids=[f"{m[0]}x{m[1]}-{f}"
                              for m, f in CAPACITY_CASES])
def test_capacity_solve_matches_repro(mesh, budget_frac):
    """``solve_mesh_capacity`` on the full-width llama3.2-3b ``train_4k``
    graph with the f32 master, both packages at repro's 16 GB: the same
    cuts and totals (1e-9 relative).  The port prices its penalty at the
    ``hbm`` it is given, as repro's does at its own 16 GB.  At a budget of
    0.2 the plan the first penalty gives does not fit, so the penalty is
    escalated and the polish runs."""
    from repro.configs import SHAPES as R_SHAPES
    from repro.configs import get_arch as r_arch
    from repro.core.builders import build_graph as r_build
    from repro.core.cost import HBM_PER_DEV as R_HBM
    from repro.core.solver import persistent_bytes_per_device as r_bytes
    from repro.core.solver import solve_mesh as r_solve
    from repro.core.solver import solve_mesh_capacity as r_capacity
    from repro_torch.configs.base import SHAPES
    from repro_torch.core.builders import build_graph
    from repro_torch.core.solver import solve_mesh_capacity
    rg = r_build(r_arch("llama3.2-3b"), R_SHAPES["train_4k"],
                 master_fp32=True)
    ref = r_capacity(rg, _repro_axes(mesh), budget_frac=budget_frac,
                     beam=BEAM)
    g = build_graph(get_arch("llama3.2-3b"), SHAPES["train_4k"],
                    master_fp32=True)
    got = solve_mesh_capacity(g, _port_axes(mesh), hbm=R_HBM,
                              budget_frac=budget_frac, beam=BEAM)
    _same_solution(got, g, ref, rg)
    first = r_solve(rg, _repro_axes(mesh), beam=BEAM)
    fits = r_bytes(rg, _repro_axes(mesh), first.per_axis) <= \
        budget_frac * R_HBM
    assert fits == (budget_frac > 0.5)


@pytest.mark.parametrize("capacity", [False, True],
                         ids=["solve_mesh", "capacity"])
def test_solve_cell_plan_forwards_its_arguments(capacity, tmp_path,
                                                monkeypatch):
    """``solve_cell_plan``'s record is the port's own solve of the graph
    built with ``graph_kwargs``, at ``beam``, through
    ``solve_mesh_capacity`` when ``capacity`` is set (the card's
    defaults), and it is cached under the given name."""
    from repro_torch.core.builders import build_graph
    from repro_torch.core.solver import solve_mesh, solve_mesh_capacity
    from repro_torch.launch import compile as t_compile
    monkeypatch.setattr(t_compile, "CACHE_DIR", str(tmp_path))
    kw = dict(master_fp32=True, error_feedback=True)
    axes = solver_axes((4, 2), NAMES)
    rec = t_compile.solve_cell_plan(_cfg(), SHAPE, axes, "m", beam=BEAM,
                                    capacity=capacity, graph_kwargs=kw)
    g = build_graph(_cfg(), SHAPE, **kw)
    sol = (solve_mesh_capacity if capacity else solve_mesh)(g, axes,
                                                            beam=BEAM)
    assert rec["role_cuts"] == \
        ShardingPlan.from_graph_solution(sol, g).role_cuts
    assert "w_gate.err" in rec["role_cuts"]
    assert rec["total_bytes"] == sol.total_bytes
    with open(t_compile.plan_cache_path(_cfg().name, SHAPE.name, "m")) as f:
        assert json.load(f)["role_cuts"] == rec["role_cuts"]


def test_compute_config_is_folded_into_the_cache_name(tmp_path,
                                                      monkeypatch):
    """A compute-aware solve caches under a name that carries the compute
    config's token, and records the plan's compute seconds."""
    from repro_torch.core.costterms import ComputeConfig
    from repro_torch.launch import compile as t_compile
    monkeypatch.setattr(t_compile, "CACHE_DIR", str(tmp_path))
    cc = ComputeConfig()
    rec = t_compile.solve_cell_plan(
        _cfg(), SHAPE, solver_axes((2, 2), NAMES), "m", beam=BEAM,
        compute=cc)
    assert rec["compute_seconds"] > 0
    assert os.path.exists(t_compile.plan_cache_path(
        _cfg().name, SHAPE.name, f"m_{cc.token()}"))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu", "--mesh",
       "2x2", "--batch", "4", "--seq", "16"]


def test_launch_train_spawns_gloo_ranks(tmp_path, capfd):
    """``python -m repro_torch.launch.train --mesh 2x2 --plan auto
    --device cpu`` without a launcher solves the plan (here found in the
    cache, solved just before at a narrow beam under the name the CLI
    gives it), spawns its 4 gloo ranks, prints the plan and trains; rank 0
    writes the record."""
    from repro_torch.launch import compile as t_compile
    from repro_torch.launch import train as launch_train
    # what the CLI solves: the reduced tag, --batch x --seq, "_mp" for the
    # f32 master; a beam of 32 here takes a second where "auto" takes many
    cfg = get_arch("llama3.2-3b").reduced()
    t_compile.solve_cell_plan(
        cfg, ShapeConfig("trainr4x16", 16, 4, "train"),
        solver_axes((2, 2), NAMES), "mesh2x2_mp", use_cache=False,
        beam=BEAM, graph_kwargs={"master_fp32": True,
                                 "error_feedback": False})
    out = tmp_path / "rec.json"
    t0 = time.time()
    assert launch_train.main(CLI + ["--plan", "auto", "--steps", "3",
                                    "--json-out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["meta"]["mesh"] == "2x2" and rec["meta"]["device"] == "cpu"
    assert len(rec["losses"]) == 3 and np.isfinite(rec["losses"]).all()
    assert rec["plan"]["mesh_axes"] == ["data", "model"]
    assert "w_gate.master" in rec["plan"]["role_cuts"]
    assert "train plan" in capfd.readouterr().out
    assert time.time() - t0 < 120


def test_launch_train_mesh_without_plan_checkpoints_once(tmp_path, capfd):
    """``--mesh 2x2`` without ``--plan`` trains unsharded on 4 ranks, each
    the whole model; only rank 0 writes a checkpoint and prunes old ones
    (the others wait at the barrier), so every step is committed once and
    no temporary directory is left.  A second run resumes from the
    newest step."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import train as launch_train
    d, out = tmp_path / "ckpt", tmp_path / "rec.json"
    args = CLI + ["--ckpt-dir", str(d), "--ckpt-every", "1", "--json-out",
                  str(out)]
    assert launch_train.main(args + ["--steps", "4"]) == 0
    assert "UNSHARDED" in capfd.readouterr().out
    losses = json.loads(out.read_text())["losses"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert sorted(os.listdir(d)) == [f"step_{s:08d}" for s in (2, 3, 4)]
    for s in (2, 3, 4):
        with open(d / f"step_{s:08d}" / "manifest.json") as f:
            assert json.load(f)["extra"]["loss"] == losses[s - 1]
    assert launch_train.main(args + ["--steps", "5"]) == 0
    assert len(json.loads(out.read_text())["losses"]) == 1
    assert ckpt.latest_step(str(d)) == 5


def test_launch_train_plan_refusals():
    """Without ``--device cpu`` the planned CLI needs the card; the hybrid
    family under ``--plan auto`` is refused before any rank starts,
    naming its ROADMAP item; ``--plan`` needs ``--mesh``."""
    from repro_torch.launch import train as launch_train
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            launch_train.main(["--arch", "llama3.2-3b", "--reduced",
                               "--mesh", "2x2", "--plan", "auto"])
    with pytest.raises(NotImplementedError, match="ROADMAP A.1"):
        launch_train.main(["--arch", "zamba2-2.7b", "--reduced", "--device",
                           "cpu", "--mesh", "2x2", "--plan", "auto"])
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "llama3.2-3b", "--reduced", "--device",
                           "cpu", "--plan", "auto"])


def test_hybrid_model_refuses_a_plan():
    plan = manual_megatron_plan(NAMES, ["data"], "model")
    with pytest.raises(NotImplementedError, match="ROADMAP A.1"):
        LM(get_arch("zamba2-2.7b").reduced(), plan=plan)


def test_unplanned_engine_keeps_its_mesh_out():
    """A mesh without a plan trains unsharded (repro's rule): plain
    tensors, no placements."""
    eng = TrainEngine(LM(_cfg()), EngineConfig(optim=OPT), device="cpu",
                      mesh=object())
    assert not eng.sharded
    with pytest.raises(ValueError, match="plan"):
        eng.state_placements()
    with pytest.raises(ValueError, match="mesh"):
        TrainEngine(LM(_cfg(), plan=ShardingPlan(NAMES, {})),
                    EngineConfig(optim=OPT), device="cpu")


if __name__ == "__main__":
    _repro_main(sys.argv[1], sys.argv[2], sys.argv[3])
