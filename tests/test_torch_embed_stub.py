"""The embedding-stub backbones (musicgen-large, internvl2-76b) in the port
against repro on the CPU, on the same weights (repro's init, carried by
``params_from_jax``) and numpy inputs: the configs, the stub frontends
(``data/pipeline.vision_patch_embeds`` / ``audio_frame_embeds``), the
forward and the loss from ``embeds``, one AdamW step of the engine, the
decode step on [B, D] embeds; and the training step under a solved plan
on 8 gloo ranks, a (4, 2) ("data", "model") mesh, against one process.

Configs, in f32: the reduced musicgen-large (4 layers, d 64, 4 / 4 heads
of hd 16, vocab 256) and the reduced internvl2-76b (4 layers, d 64, 4 / 1
heads of hd 16, rope 1e6).  Neither ties its embeddings, so an embeds
batch leaves ``embed`` unused: its gradient is exactly zero, as
``jax.grad`` gives it, and AdamW still decays it.

Bands, each with its reason and the gap measured on this CPU:
  logits: 1e-3 (the f32 serving band of tests/test_torch_model.py;
      measured 3.0e-6);
  a decode step's logits: u R max|logits|, u = 2^-24, while the row's
      bf16 K/V entries are bit-equal on both sides.  A sum of n f32 terms
      in two orders differs by at most ~n u sum|x_i| (Higham's gamma_n);
      to first order, each stage passing its relative error on at unit
      gain, the logits differ by at most u R max|logits|, R the
      reduction lengths along the chain from the embeds to a logit: per
      layer d_model in the two norms, QKV and gate / up (4 d), hd in the
      scores, the max_len positions twice (softmax, P V), n_heads hd in
      the output product, d_ff in the down product; 2 d_model in the
      final norm and the head.  Here (d 64, 4 layers, 4 heads of 16,
      d_ff 128, max_len 16) R = 4 x 496 + 128 = 2112, u R = 1.26e-4 of
      the row's largest logit (3.1e-4 to 4.6e-4 here; measured at most
      1.8e-6, and 2.0e-6 on the run that writes repro's rounding);
  loss and every grad: 1e-4 (tests/test_torch_train.py's band);
  params after one AdamW step at lr 3e-4: 5e-5 (tests/
      test_torch_train_plan.py's: AdamW's first step is g / (|g| + eps),
      so an element whose grad is within the two libraries' summation
      gap of zero may step the other way; measured 1.1e-5);
  under the plan against one process: loss and every leaf of the grad
      within 1e-5 (x max(1, its largest |g|)), one engine step's loss and
      gnorm 1e-5, its master 5e-5 (the same arithmetic, the cut batch
      summed in another order).
One spawn of 8 ranks for the file, torch on one thread a rank; every
rank imports only torch and the port."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import (DataConfig, audio_frame_embeds,
                                       host_batch, vision_patch_embeds)
from repro_torch.launch.mesh import solver_axes, spawn
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamWConfig, schedule
from repro_torch.train.engine import EngineConfig, TrainEngine

ARCHS = ("musicgen-large", "internvl2-76b")
FRONTEND = {"musicgen-large": "audio_frame_embeds",
            "internvl2-76b": "vision_patch_embeds"}
F32_ATOL = 1e-3
U = 2.0 ** -24                  # f32 unit roundoff
DECODE_LEN = 16
GRAD_ATOL = 1e-4
PARAM_ATOL = 5e-5
PLANNED_ATOL = 1e-5
OPT = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=1000)
MESH = (4, 2)
NAMES = ("data", "model")
B, S, MICRO = 16, 16, 2
BEAM = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread avoids oversubscribing the cores
    that the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(get, arch):
    return dataclasses.replace(get(arch).reduced(), dtype="float32")


def _embeds(cfg, b, s, seed=0):
    fn = {"audio_frame_embeds": audio_frame_embeds,
          "vision_patch_embeds": vision_patch_embeds}[FRONTEND[cfg.name]]
    return fn(cfg, b, s, seed)


def _batch(cfg, b=B, s=S, seed=0):
    """An embeds batch: the stub frontend's [b, s, d] and host_batch's
    labels."""
    labels = host_batch(DataConfig(seed=seed, vocab=cfg.vocab, seq_len=s,
                                   global_batch=b), 0)["labels"]
    return {"embeds": _embeds(cfg, b, s, seed), "labels": labels}


# -- the configs and the frontends ----------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_repros(arch):
    """Field for field (the nested configs are None) and in
    ``param_count``; ``LM`` builds at full width."""
    from repro.configs import get_arch as jax_arch
    mine, theirs = get_arch(arch), jax_arch(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.param_count() == theirs.param_count()
    assert mine.embed_stub and not mine.tie_embeddings
    assert "lm_head" in LM(mine).param_shapes()


@pytest.mark.parametrize("fn", sorted(set(FRONTEND.values())))
@pytest.mark.parametrize("seed", [0, 7])
def test_stub_frontend_is_repros_bit_for_bit(fn, seed):
    from repro.configs import get_arch as jax_arch
    from repro.data import pipeline as jax_pipeline
    from repro_torch.data import pipeline
    for arch in ARCHS:
        got = getattr(pipeline, fn)(get_arch(arch), 3, 5, seed)
        want = getattr(jax_pipeline, fn)(jax_arch(arch), 3, 5, seed)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# -- against repro ---------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(repro's model and params, the port's model and params) on repro's
    reduced f32 init."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_arch as jax_arch
    from repro.models.model import LM as JaxLM
    from repro_torch.convert import params_from_jax
    arch = request.param
    jm = JaxLM(_cfg(jax_arch, arch))
    jp = jm.init(jax.random.PRNGKey(0))
    np_tree = jax.tree_util.tree_map(np.asarray, jp)
    tcfg = _cfg(get_arch, arch)
    return jm, jp, np_tree, LM(tcfg), params_from_jax(np_tree, tcfg, "cpu")


def _jax_keys(t):
    import jax
    return {"/".join(str(p.key) for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}


def test_params_carry_with_no_new_leaf(pair):
    """``params_from_jax`` carries repro's tree for both configs: the same
    keys, shapes and values; no leaf is added for the stub frontend."""
    _, _, np_tree, tm, tp = pair
    want = _jax_keys(np_tree)
    got = {tree.key(p): v for p, v in tree.flatten(tp)}
    assert set(got) == set(want)
    assert set(tp) == {"embed", "layers", "ln_f", "lm_head"}
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_forward_from_embeds_matches_repro(pair):
    import jax.numpy as jnp
    jm, jp, _, tm, tp = pair
    e = _embeds(tm.cfg, 2, 12, seed=3)
    lj, _ = jm.forward(jp, embeds=jnp.asarray(e))
    with torch.no_grad():
        lt, aux = tm.forward(tp, embeds=torch.from_numpy(e))
    assert lt.shape == (2, 12, tm.cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=F32_ATOL)


def test_loss_and_grads_match_repro_embed_grad_zero(pair):
    """The loss of an embeds batch and every grad within 1e-4 of repro's;
    ``embed``'s grad exactly zero in both."""
    import jax
    import jax.numpy as jnp
    jm, jp, _, tm, tp = pair
    batch = _batch(tm.cfg, 4, 12)
    lj, gj = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    eng = TrainEngine(tm, EngineConfig(optim=OPT), device="cpu")
    params = tree.tree_map(lambda p: p.clone().requires_grad_(True), tp)
    leaves = tree.leaves(params)
    lt, gt = eng._grads(params, leaves, eng._batch(batch))
    assert abs(float(lj) - float(lt)) <= GRAD_ATOL
    want = _jax_keys(gj)
    got = {tree.key(p): g.numpy() for (p, _), g in
           zip(tree.flatten(params), gt)}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=GRAD_ATOL,
                                   err_msg=k)
    assert not want["embed"].any() and not got["embed"].any()
    assert np.abs(got["lm_head"]).max() > 0


def test_adamw_step_matches_repro(pair):
    """One engine step (f32 master) on an embeds batch: loss within 1e-4,
    params within 5e-5 of repro's; the unused ``embed`` decayed by
    lr * wd * p, as repro decays it."""
    import jax
    import jax.numpy as jnp
    from repro.optim import adamw as jax_adamw
    from repro.optim.adamw import init_state
    from repro.train.engine import EngineConfig as JaxEngineConfig
    from repro.train.engine import TrainEngine as JaxTrainEngine
    jm, jp, _, tm, tp = pair
    batch = _batch(tm.cfg, 4, 12, seed=1)
    jopt = jax_adamw.AdamWConfig(**dataclasses.asdict(OPT))
    jeng = JaxTrainEngine(jm, JaxEngineConfig(optim=jopt))
    jstate = {"params": jp, "opt": init_state(jp),
              "master": jax.tree_util.tree_map(
                  lambda p: jnp.array(p, jnp.float32, copy=True), jp)}
    jstate, jm_ = jeng.step(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    eng = TrainEngine(tm, EngineConfig(optim=OPT), device="cpu")
    state = eng.init_state(params=tree.tree_map(torch.clone, tp))
    state, m = eng.step(state, batch)
    assert abs(float(m["loss"]) - float(jm_["loss"])) <= GRAD_ATOL
    want = _jax_keys(jstate["params"])
    for (p, v) in tree.flatten(state["params"]):
        np.testing.assert_allclose(v.detach().numpy(), want[tree.key(p)],
                                   atol=PARAM_ATOL, err_msg=tree.key(p))
    e0 = tp["embed"]
    lr = float(schedule(OPT, torch.ones((), dtype=torch.int32)))
    np.testing.assert_allclose(
        state["params"]["embed"].detach().numpy(),
        (e0 - lr * OPT.weight_decay * e0).numpy(), rtol=1e-6, atol=0)


def _kv_band(cfg, logits):
    """The f32 band of a decode step's logits row while the row's bf16
    cache entries are bit-equal on both sides: u R max|logits| (the
    module docstring's derivation, max_len DECODE_LEN)."""
    per_layer = (4 * cfg.d_model + cfg.hd + 2 * DECODE_LEN
                 + cfg.n_heads * cfg.hd + cfg.d_ff)
    reduction = cfg.n_layers * per_layer + 2 * cfg.d_model
    return U * reduction * float(np.abs(logits).max())


def _forcing_writer(tm, want, forced):
    """``tm._linear_writer`` that writes, where the port's new K or V
    entry rounds to another bf16 value than repro's (``want``: repro's
    cache after the step, f32 [L, B, S, KV, hd]), repro's value instead,
    and appends (layer, the port's f32 values, repro's) to ``forced``."""
    orig = tm._linear_writer

    def writer(kv, pos, active, b, slot=None):
        attend = orig(kv, pos, active, b, slot)
        rows, at = torch.arange(b), pos.long()

        def attend_forced(li, q, k, v):
            new = []
            for name, x in (("k", k), ("v", v)):
                w = torch.from_numpy(want[name][li][rows, at])
                flip = x.to(torch.bfloat16).float() != w
                if flip.any():
                    forced.append((li, x[flip].numpy(), w[flip].numpy()))
                new.append(torch.where(flip, w, x))
            return attend(li, q, *new)
        return attend_forced
    return writer


def test_decode_step_on_embeds_matches_repro(pair, monkeypatch):
    """Four decode steps fed [B, D] embeds, from an empty cache, run free
    on both sides: a row's logits within u R max|logits| (``_kv_band``)
    of repro's while every bf16 K/V entry the row has written is
    bit-equal to repro's.  An f32 K or V value a few ulps from repro's
    can round to the neighbouring bf16 value, and the row then moves by
    up to ~2e-3 (1.83e-3 measured at the fourth step of musicgen-large's
    third row on an AVX-512 AMD EPYC: the step attends the entries it
    has just written, and the later layers carry the difference on).
    So the port runs free a second time, writing repro's bf16 value
    wherever its own rounded the other way: each entry so replaced, in
    every layer and step, lies within one bf16 rounding (2^-7 of the
    larger) plus the f32 band of a K or V value (u 2 d_model times the
    row's largest entry) of repro's; the port's cache is then bit-equal
    to repro's after every step, every row's logits are within
    ``_kv_band`` of repro's, and the rows that replaced nothing give
    the first run's logits bit for bit.  The same steps fed the embed
    table's rows for tokens as [B, D] embeds give the token steps'
    logits bit for bit."""
    import jax.numpy as jnp
    jm, jp, _, tm, tp = pair
    cfg = tm.cfg
    b = 3
    e = _embeds(cfg, 4, b, seed=5)              # [steps, B, D]
    jc = jm.init_cache(b, DECODE_LEN)
    tc = tm.init_cache(b, DECODE_LEN, device="cpu")
    fc = tm.init_cache(b, DECODE_LEN, device="cpu")
    flipped = set()
    with torch.no_grad():
        for i in range(4):
            lj, jc = jm.decode_step(jp, jc, jnp.asarray(e[i]))
            lj = np.asarray(lj)
            want = {k: np.asarray(jc["kv"][k], np.float32) for k in ("k", "v")}
            lt, tc = tm.decode_step(tp, tc, torch.from_numpy(e[i]))
            forced = []
            monkeypatch.setattr(tm, "_linear_writer",
                                _forcing_writer(tm, want, forced))
            lf, fc = tm.decode_step(tp, fc, torch.from_numpy(e[i]))
            monkeypatch.undo()
            for c in (tc, fc):
                np.testing.assert_array_equal(c["pos"].numpy(),
                                              np.asarray(jc["pos"]))
            for k in ("k", "v"):
                np.testing.assert_array_equal(fc["kv"][k].float().numpy(),
                                              want[k])
            for li, got, ref in forced:
                band = (2.0 ** -7 * np.maximum(np.abs(got), np.abs(ref))
                        + U * 2 * cfg.d_model
                        * float(np.abs(want["k"][li]).max()
                                + np.abs(want["v"][li]).max()))
                assert np.all(np.abs(got - ref) <= band), (i, li)
            for r in range(b):
                if any(not np.array_equal(tc["kv"][k][:, r].float().numpy(),
                                          want[k][:, r]) for k in ("k", "v")):
                    flipped.add(r)
                tol = _kv_band(cfg, lj[r])
                np.testing.assert_allclose(lf[r].numpy(), lj[r], atol=tol,
                                           rtol=0, err_msg=str((i, r)))
                if r not in flipped:
                    np.testing.assert_allclose(lt[r].numpy(), lj[r],
                                               atol=tol, rtol=0,
                                               err_msg=str((i, r)))
                    assert torch.equal(lt[r], lf[r]), (i, r)
        toks = torch.tensor([[5, 9, 200], [0, 17, 3]], dtype=torch.int32)
        c1 = tm.init_cache(b, 16, device="cpu")
        c2 = tm.init_cache(b, 16, device="cpu")
        for t in toks:
            l1, c1 = tm.decode_step(tp, c1, t)
            l2, c2 = tm.decode_step(tp, c2, tp["embed"][t.long()])
            assert torch.equal(l1, l2)


# -- under a solved plan on 8 gloo ranks -------------------------------------------

def _train(model, step: bool):
    """The first batch's loss and full gradient, then (``step``) one
    engine step of MICRO microbatches: (loss, gnorm) and the master."""
    from torch.distributed.tensor import DTensor
    eng = TrainEngine(model, EngineConfig(optim=OPT, microbatches=MICRO),
                      device="cpu")
    state = eng.init_state(0)
    params = state["params"]
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    batch = _batch(model.cfg)
    first = (eng._micro_batches(batch, 1)[0] if eng.sharded
             else eng._batch(batch))
    loss, grads = eng._grads(params, leaves, first)
    out = dict(loss=float(loss), grads={
        tree.key(p): (g.full_tensor() if isinstance(g, DTensor)
                      else g).detach().clone()
        for (p, _), g in zip(tree.flatten(params), grads)})
    if step:
        state, m = eng.step(state, batch)
        out["hist"] = (float(m["loss"]), float(m["gnorm"]))
        out["master"] = {
            tree.key(p): (v.full_tensor() if isinstance(v, DTensor)
                          else v).detach().clone()
            for p, v in tree.flatten(state["master"])}
        if eng.sharded:
            out["embeds_placements"] = tuple(
                map(str, eng.batch_placements()["embeds"]))
    return out


def _model_api(model):
    """The model API fed plain (unplaced) embeds: the forward's logits on
    [4, S, D] embeds and one decode step's on [4, D] embeds, from the
    params of ``init(0)`` (placed under the model's plan, if any)."""
    from repro_torch.models.common import whole
    from repro_torch.models.sharding import (CACHE_RULES, place_tree,
                                             zeros_tree)
    params = LM(model.cfg).init(0, device="cpu")
    cache_shapes = model.cache_shapes(4, S)
    if model.plan is None:
        cache = LM(model.cfg).init_cache(4, S, device="cpu")
    else:
        params = place_tree(params, model.mesh, model.plan)
        cache = zeros_tree(cache_shapes, model.mesh, model.plan, CACHE_RULES,
                           device="cpu")
    e = torch.from_numpy(_embeds(model.cfg, 4, S, seed=4))
    with torch.no_grad():
        logits, _ = model.forward(params, embeds=e)
        step, _ = model.decode_step(params, cache, e[:, 0])
    return whole(logits).detach().clone(), whole(step).detach().clone()


def _rank_main(rank, world, plans, path):
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(MESH, NAMES, "cpu")
    out = {}
    for arch in ARCHS:
        model = LM(_cfg(get_arch, arch), plan=plans[arch], mesh=mesh)
        out[arch] = _train(model, step=True)
        out[arch]["api"] = _model_api(model)
    if rank == 0:
        torch.save(out, path)


@pytest.fixture(scope="module")
def planned(tmp_path_factory):
    """(one process, the 8 ranks) for each config; the plans solved at
    beam 32 by the port's solver for the (4, 2) mesh, f32 master in the
    graph."""
    from repro_torch.launch import compile as t_compile
    cache = t_compile.CACHE_DIR
    t_compile.CACHE_DIR = str(tmp_path_factory.mktemp("plans"))
    try:
        from repro_torch.launch.compile import (plan_from_record,
                                                solve_cell_plan)
        shape = ShapeConfig(f"train{B}x{S}", S, B, "train")
        plans = {arch: plan_from_record(solve_cell_plan(
            _cfg(get_arch, arch), shape, solver_axes(MESH, NAMES), "test",
            use_cache=False, beam=BEAM,
            graph_kwargs={"master_fp32": True})) for arch in ARCHS}
    finally:
        t_compile.CACHE_DIR = cache
    tmp = tmp_path_factory.mktemp("embed_stub_ranks")
    ref = {}
    for arch in ARCHS:
        ref[arch] = _train(LM(_cfg(get_arch, arch)), step=True)
        ref[arch]["api"] = _model_api(LM(_cfg(get_arch, arch)))
    spawn(_rank_main, MESH[0] * MESH[1], "cpu", (plans, str(tmp / "out.pt")))
    return plans, ref, torch.load(tmp / "out.pt", weights_only=False)


@pytest.mark.parametrize("arch", ARCHS)
def test_planned_first_batch_matches_one_process(planned, arch):
    """The first embeds batch under the solved (4, 2) plan: its loss
    within 1e-5 of one process and every leaf of its gradient within 1e-5
    x max(1, the leaf's largest |g|); ``embed``'s exactly zero."""
    plans, ref, out = planned
    got, one = out[arch], ref[arch]
    assert abs(got["loss"] - one["loss"]) <= PLANNED_ATOL
    assert set(got["grads"]) == set(one["grads"])
    for k, g in got["grads"].items():
        want = one["grads"][k].numpy()
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g.numpy(), want,
                                   atol=PLANNED_ATOL * scale, rtol=0,
                                   err_msg=k)
    assert not got["grads"]["embed"].any()
    assert plans[arch].role_cuts.get("x"), plans[arch].role_cuts


@pytest.mark.parametrize("arch", ARCHS)
def test_planned_engine_step_matches_one_process(planned, arch):
    """One engine step of 2 microbatches of embeds under the plan: loss
    and gnorm within 1e-5 of one process, the f32 master within 5e-5;
    the embeds placed as the tokens are, d_model whole."""
    plans, ref, out = planned
    got, one = out[arch], ref[arch]
    np.testing.assert_allclose(got["hist"], one["hist"], atol=PLANNED_ATOL,
                               rtol=0)
    for k, v in got["master"].items():
        np.testing.assert_allclose(v.numpy(), one["master"][k].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)
    assert "S(2)" not in got["embeds_placements"]


@pytest.mark.parametrize("arch", ARCHS)
def test_planned_model_api_places_plain_embeds(planned, arch):
    """The model API under the plan fed plain embeds (the same on every
    rank): the forward places [B, S, D] under the prefill placements and
    the decode step [B, D] under the decode ones; logits within 1e-5
    (the forward) and 1e-3 (a decode step: its K/V are bf16) of one
    process."""
    _, ref, out = planned
    (lf, ld), (wf, wd) = out[arch]["api"], ref[arch]["api"]
    np.testing.assert_allclose(lf.numpy(), wf.numpy(), atol=PLANNED_ATOL,
                               rtol=0)
    np.testing.assert_allclose(ld.float().numpy(), wd.float().numpy(),
                               atol=F32_ATOL, rtol=0)


# -- the CLIs ------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_and_train_on_cpu(arch, tmp_path):
    """``launch.serve --arch <stub> --reduced --device cpu`` serves token
    ids through the embed table (as repro's Server does) and
    ``launch.train`` trains token batches (as repro's launcher does);
    without ``--device cpu`` (no card here) both raise."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    out = tmp_path / "s.json"
    assert launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                              "--prompt-len", "12", "--gen", "4",
                              "--json-out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["meta"]["arch"] == arch and rec["generated_tokens"] == 16
    out = tmp_path / "t.json"
    assert launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                              "--steps", "3", "--batch", "4", "--seq", "16",
                              "--json-out", str(out)]) == 0
    losses = json.loads(out.read_text())["losses"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    if not torch.cuda.is_available():
        for main in (launch_serve.main, launch_train.main):
            with pytest.raises(RuntimeError, match="cuda"):
                main(["--arch", arch, "--reduced"])
