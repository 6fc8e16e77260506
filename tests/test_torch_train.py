"""The port's training slice (src/repro_torch: LM.loss, optim/, train/,
data/, checkpoint/, runtime/train_loop.py, launch/train.py) against
repro's on the CPU, on the same weights and the same numpy batches.

Bands, each with its reason:
  loss and grads, f32 model: atol 1e-4 -- the same arithmetic up to
      summation order (repro's XLA attention vs the port's plain version);
  loss, bf16 model: 0.05 -- repro's LOSS_ATOL (verify/numerics.py) for the
      bf16 loss of one model computed two ways;
  optimizer and compression: 1e-6 / exact int8 -- the same f32 formulas;
  5-step trajectory: TRAIN_LOSS_ATOL 0.08 on the losses and 2e-2 on the
      f32 master weights (verify/train_cell.py, tests/test_train_engine.py:
      bf16 rounding drift compounds over optimizer steps);
  microbatch accumulation vs the full batch: ACCUM_ATOL 5e-3 on the
      losses, 2e-2 on the master weights (same files);
  kill and resume: bit-exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")     # the card's machine has no JAX
jnp = jax.numpy

from repro.checkpoint import ckpt as jax_ckpt
from repro.configs import get_arch as jax_arch
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import host_batch as jax_host_batch
from repro.models.model import LM as JaxLM
from repro.optim import adamw as jax_adamw
from repro.optim import compression as jax_comp
from repro.train.engine import EngineConfig as JaxEngineConfig
from repro.train.engine import TrainEngine as JaxTrainEngine
from repro.verify.numerics import LOSS_ATOL
from repro.verify.train_cell import ACCUM_ATOL, TRAIN_LOSS_ATOL
from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import BatchFeed, DataConfig, host_batch
from repro_torch.launch import train as launch_train
from repro_torch.models.model import LM
from repro_torch.optim import adamw, compression
from repro_torch.runtime.train_loop import TrainConfig, train
from repro_torch.train.engine import EngineConfig, TrainEngine

OPT = adamw.AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=1000)
JAX_OPT = jax_adamw.AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=1000)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread avoids oversubscribing the cores
    that the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _jax_keys(t):
    return {"/".join(str(p.key) for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}


def _port_keys(t):
    return {tree.key(p): np.array(v.detach().float().numpy())   # a copy
            for p, v in tree.flatten(t)}


def _batch(cfg, b=4, s=12, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


# ---------------------------------------------------------------------------
# loss and grads
# ---------------------------------------------------------------------------

# (arch, sequence length): 12 tokens for each config, and 40 tokens, past
# the reduced danube's window of 16, so that the window masks keys in the
# forward and in the backward (the ids of the 12-token cases are the
# architectures' names alone)
LOSS_CASES = [(a, 12) for a in ("qwen2-1.5b", "llama3.2-3b",
                                "h2o-danube-3-4b")] + \
    [(a, 40) for a in ("qwen2-1.5b", "llama3.2-3b", "h2o-danube-3-4b")]


@pytest.mark.parametrize("arch,seq", LOSS_CASES,
                         ids=[a if s == 12 else f"{a}-s{s}"
                              for a, s in LOSS_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_repro(arch, seq, dtype):
    jcfg = dataclasses.replace(jax_arch(arch).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_arch(arch).reduced(), dtype=dtype)
    jm, tm = JaxLM(jcfg), LM(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(_np_tree(jp), tcfg, device="cpu")
    batch = _batch(tcfg, s=seq)
    lj, gj = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [p.requires_grad_(True) for p in tree.leaves(tp)]
    lt = tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    gt = torch.autograd.grad(lt, leaves)
    if dtype == "bfloat16":
        assert abs(float(lj) - float(lt.detach())) <= LOSS_ATOL
        return
    assert abs(float(lj) - float(lt.detach())) <= 1e-4
    want = _jax_keys(gj)
    got = {tree.key(p): g.numpy() for (p, _), g in zip(tree.flatten(tp), gt)}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# optimizer and compression
# ---------------------------------------------------------------------------

def _opt_trees(seed=0):
    """Keys inserted out of sorted order; 1-d and 2-d leaves."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (3, 5), "ln_f": (5,), "layers": {"ln1": (2, 5),
                                                    "bq": (2, 4),
                                                    "a": (2, 3, 4)},
              "emb": (7, 5)}

    def make(s):
        return ({k: make(v) for k, v in s.items()} if isinstance(s, dict)
                else rng.standard_normal(s).astype(np.float32))
    return make(shapes), make(shapes)


def test_apply_updates_matches_repro():
    params, _ = _opt_trees(0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax_adamw.init_state(jp)
    # the port updates in place: give it its own copies, since jnp.asarray
    # may alias the numpy buffers that JAX reads asynchronously
    tp = tree.tree_map(lambda a: torch.from_numpy(a.copy()), params)
    ts = adamw.init_state(tp)
    jax_update = jax.jit(lambda p, g, s: jax_adamw.apply_updates(
        p, g, s, JAX_OPT))
    for step in range(3):
        grads, _ = _opt_trees(step + 1)
        jp, js, jn = jax_update(
            jp, jax.tree_util.tree_map(jnp.asarray, grads), js)
        tp, ts, tn = adamw.apply_updates(
            tp, tree.tree_map(torch.from_numpy, grads), ts, OPT)
        assert abs(float(jn) - float(tn)) <= 1e-5
    assert int(ts["step"]) == int(js["step"]) == 3
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    for want, got in ((jp, tp), (js["m"], ts["m"]), (js["v"], ts["v"])):
        w, g = _jax_keys(want), _port_keys(got)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=1e-5,
                                       err_msg=k)


def test_weight_decay_applies_to_ndim_ge_2_only():
    """With zero grads only the decay moves a param: the stacked [L, d]
    norms and biases decay, the [d] final norm does not (repro's rule)."""
    params, _ = _opt_trees(0)
    tp = tree.tree_map(torch.from_numpy, params)
    before = _port_keys(tp)
    zeros = tree.tree_map(torch.zeros_like, tp)
    adamw.apply_updates(tp, zeros, adamw.init_state(tp), OPT)
    after = _port_keys(tp)
    # step 1 of warmup 2: warm = (1 + 1) / 2 = 1, and the cosine has not
    # started, so lr is the peak
    lr = OPT.lr
    for k in before:
        decay = OPT.weight_decay if before[k].ndim >= 2 else 0.0
        np.testing.assert_allclose(after[k], before[k] * (1 - lr * decay),
                                   rtol=1e-6, err_msg=k)
    assert not np.array_equal(after["layers/ln1"], before["layers/ln1"])
    np.testing.assert_array_equal(after["ln_f"], before["ln_f"])


def test_quantize_matches_repro():
    g = np.random.default_rng(9).standard_normal((6, 7)).astype(np.float32)
    g[0, 0] = 2.5 * np.abs(g).max()            # ties of round-half-even
    qj, sj = jax_comp.quantize(jnp.asarray(g))
    qt, st = compression.quantize(torch.from_numpy(g))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert float(st) == float(sj)
    np.testing.assert_array_equal(compression.dequantize(qt, st).numpy(),
                                  np.asarray(jax_comp.dequantize(qj, sj)))


def test_compress_bucketed_matches_repro_in_sorted_key_order():
    grads, errs = _opt_trees(4)
    sizes = [a.size * 4 for a in jax.tree_util.tree_leaves(grads)]
    assert [list(b) for b in compression.bucket_slices(sizes, 3)] == \
        jax_comp.bucket_slices(sizes, 3)
    wire_j, wire_t = {}, {}

    def tap(store):
        def on_wire(i, q):
            store[i] = np.asarray(q)
            return q
        return on_wire

    gj, ej = jax_comp.compress_bucketed(
        jax.tree_util.tree_map(jnp.asarray, grads),
        jax.tree_util.tree_map(jnp.asarray, errs), 3, on_wire=tap(wire_j))
    gt, et = compression.compress_bucketed(
        tree.tree_map(torch.from_numpy, grads),
        tree.tree_map(torch.from_numpy, errs), 3, on_wire=tap(wire_t))
    assert sorted(wire_j) == sorted(wire_t)
    for i in wire_j:
        assert wire_t[i].dtype == np.int8
        np.testing.assert_array_equal(wire_t[i], wire_j[i])
    for want, got in ((gj, gt), (ej, et)):
        w, g = _jax_keys(want), _port_keys(got)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _engines(batch=8, **kw):
    jm = JaxLM(jax_arch("qwen2-1.5b").reduced())
    tcfg = get_arch("qwen2-1.5b").reduced()
    dcfg = DataConfig(seed=0, vocab=tcfg.vocab, seq_len=16,
                      global_batch=batch)
    return jm, LM(tcfg), tcfg, dcfg


def _port_run(model, cfg, dcfg, params, steps, **kw):
    eng = TrainEngine(model, EngineConfig(optim=OPT, **kw), device="cpu")
    state = eng.init_state(params=params)
    losses = []
    for step in range(steps):
        state, m = eng.step(state, host_batch(dcfg, step))
        losses.append(float(m["loss"]))
    return state, losses


def test_engine_trajectory_matches_repro():
    jm, tm, tcfg, dcfg = _engines()
    jeng = JaxTrainEngine(jm, JaxEngineConfig(optim=JAX_OPT))
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    params = params_from_jax(_np_tree(jstate["params"]), tcfg, device="cpu")
    jdcfg = JaxDataConfig(seed=0, vocab=tcfg.vocab, seq_len=16,
                          global_batch=8)
    jl = []
    for step in range(5):
        jstate, m = jeng.step(jstate, jax_host_batch(jdcfg, step))
        jl.append(float(m["loss"]))
    tstate, tl = _port_run(tm, tcfg, dcfg, params, 5)
    np.testing.assert_allclose(tl, jl, atol=TRAIN_LOSS_ATOL)
    assert tl[-1] < tl[0]
    w, g = _jax_keys(jstate["master"]), _port_keys(tstate["master"])
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=2e-2, err_msg=k)


@pytest.mark.parametrize("n_micro", [2, 4])
def test_accumulation_equals_full_batch(n_micro):
    _, tm, tcfg, dcfg = _engines()
    params = tm.init(0, device="cpu")
    copy = tree.tree_map(lambda p: p.clone(), params)
    s_full, l_full = _port_run(tm, tcfg, dcfg, params, 3)
    s_mic, l_mic = _port_run(tm, tcfg, dcfg, copy, 3, microbatches=n_micro)
    np.testing.assert_allclose(l_mic, l_full, atol=ACCUM_ATOL)
    w, g = _port_keys(s_full["master"]), _port_keys(s_mic["master"])
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=2e-2, err_msg=k)


def test_batch_must_divide_microbatches():
    _, tm, tcfg, _ = _engines()
    dcfg = DataConfig(seed=0, vocab=tcfg.vocab, seq_len=8, global_batch=6)
    eng = TrainEngine(tm, EngineConfig(optim=OPT, microbatches=4),
                      device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        eng.step(eng.init_state(0), host_batch(dcfg, 0))


def test_compressed_engine_keeps_an_error_tree():
    _, tm, tcfg, dcfg = _engines(batch=4)
    state, losses = _port_run(tm, tcfg, dcfg, tm.init(0, device="cpu"), 3,
                              grad_compression=True, buckets=4)
    assert np.isfinite(losses).all()
    assert set(state) == {"params", "opt", "master", "err"}
    assert any(float(e.abs().max()) > 0 for e in tree.leaves(state["err"]))


def test_resume_is_bit_exact(tmp_path):
    """A run killed at its first checkpoint and resumed reproduces the
    uninterrupted trajectory exactly."""
    _, tm, tcfg, _ = _engines()
    dcfg = DataConfig(seed=0, vocab=tcfg.vocab, seq_len=16, global_batch=4)

    def cfg(steps, d):
        return TrainConfig(steps=steps, ckpt_every=3, log_every=2,
                           optim=OPT, ckpt_dir=str(tmp_path / d))

    full = train(tm, dcfg, cfg(6, "a"), device="cpu")
    train(tm, dcfg, cfg(3, "b"), device="cpu")
    resumed = train(tm, dcfg, cfg(6, "b"), device="cpu")
    assert [h["step"] for h in resumed["history"]] == [3, 4, 5]
    assert ([h["loss"] for h in resumed["history"]]
            == [h["loss"] for h in full["history"][3:]])
    for a, b in zip(tree.leaves(full["state"]), tree.leaves(resumed["state"])):
        assert torch.equal(a.detach(), b.detach())
    assert ckpt.latest_step(str(tmp_path / "b")) == 6


def test_repro_checkpoint_restores_into_the_port(tmp_path):
    """A checkpoint of a JAX engine state, written by repro's ckpt.save,
    restores into the port engine's state tree with equal values."""
    jm, tm, tcfg, _ = _engines()
    jeng = JaxTrainEngine(jm, JaxEngineConfig(optim=JAX_OPT,
                                              grad_compression=True))
    jstate = jeng.init_state(jax.random.PRNGKey(1))
    jstate["opt"]["step"] = jnp.asarray(7, jnp.int32)
    jax_ckpt.save(str(tmp_path), 7, jstate, extra={"loss": 1.5})
    eng = TrainEngine(tm, EngineConfig(optim=OPT, grad_compression=True),
                      device="cpu")
    state, extra, step = eng.restore(str(tmp_path))
    assert step == 7 and extra == {"loss": 1.5}
    assert int(state["opt"]["step"]) == 7
    want, got = _jax_keys(jstate), _port_keys(state)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert state["params"]["embed"].dtype == torch.bfloat16
    # and the port's checkpoint has repro's keys and dtypes
    path = ckpt.save(str(tmp_path / "port"), 7, state)
    back, _ = jax_ckpt.restore(str(tmp_path / "port"), 7, jstate)
    for k, v in _jax_keys(back).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert path.endswith("step_00000007")


# ---------------------------------------------------------------------------
# data, feed and the launcher
# ---------------------------------------------------------------------------

def test_host_batch_is_repros():
    for seed, step, b in ((0, 0, 8), (3, 17, 4)):
        want = jax_host_batch(JaxDataConfig(seed=seed, vocab=300, seq_len=33,
                                            global_batch=b), step)
        got = host_batch(DataConfig(seed=seed, vocab=300, seq_len=33,
                                    global_batch=b), step)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_batch_feed_yields_steps_in_order():
    dcfg = DataConfig(seed=2, vocab=64, seq_len=5, global_batch=2)
    with BatchFeed(dcfg, start_step=4) as feed:
        for step in (4, 5, 6):
            got = feed.get()
            np.testing.assert_array_equal(got["tokens"].numpy(),
                                          host_batch(dcfg, step)["tokens"])


def test_batch_feed_reraises_a_producer_error():
    bad = DataConfig(global_batch=3, n_hosts=2)
    feed = BatchFeed(bad)
    try:
        with pytest.raises(ValueError, match="divisible"):
            feed.get()
    finally:
        feed.close()
    assert not feed._thread.is_alive()


def test_launch_train_on_cpu(tmp_path):
    out = tmp_path / "r.json"
    assert launch_train.main(["--arch", "qwen2-1.5b", "--reduced",
                              "--device", "cpu", "--steps", "3", "--batch",
                              "2", "--seq", "8", "--json-out",
                              str(out)]) == 0
    import json
    rec = json.loads(out.read_text())
    assert len(rec["losses"]) == 3 and np.isfinite(rec["losses"]).all()
    assert rec["tokens_per_step"] == 16
    for key in ("first_loss", "last_loss", "mean_step_s", "tokens_per_s",
                "breakdown_s"):
        assert key in rec


def test_launch_train_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--arch", "qwen2-1.5b", "--reduced",
                           "--steps", "1"])
