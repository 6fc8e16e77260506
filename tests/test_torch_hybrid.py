"""The port's hybrid family (zamba2: models/mamba.py, the hybrid branches
of models/model.py, the engine's ``kernels`` routing, launch/train.py)
against repro's on the CPU, on the same weights and numpy batches, at the
reduced zamba2-2.7b (4 Mamba layers, d 64, 16 SSM heads of P 8, N 8,
chunk 8, the shared block after every 2 layers, hd 16).

Bands, each with its reason:
  f32 logits, loss and every param grad: atol 1e-4 -- the same arithmetic
      up to summation order (the shared block's grad is the sum over its
      applications on both sides);
  bf16 logits 0.25 and loss 0.05: repro's LOGITS_ATOL and LOSS_ATOL
      (verify/numerics.py) for one bf16 model computed two ways;
  3-step trajectory: TRAIN_LOSS_ATOL 0.08 (verify/train_cell.py): bf16
      rounding drift compounds over optimizer steps;
  checkpoint restore: exact.
"""
import dataclasses
import functools
import json

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
from repro.train.engine import EngineConfig as JaxEngineConfig
from repro.train.engine import TrainEngine as JaxTrainEngine
from repro.verify.numerics import LOGITS_ATOL, LOSS_ATOL
from repro.verify.train_cell import TRAIN_LOSS_ATOL
from repro_torch import tree
from repro_torch.configs import MoECfg, XLSTMCfg, get_arch
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models.model import LM
from repro_torch.optim import adamw
from repro_torch.runtime.serve import ServeConfig, Server
from repro_torch.train.engine import EngineConfig, TrainEngine

ARCH = "zamba2-2.7b"
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


def _cfgs(dtype="bfloat16"):
    return (dataclasses.replace(jax_arch(ARCH).reduced(), dtype=dtype),
            dataclasses.replace(get_arch(ARCH).reduced(), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _jax_init(dtype):
    """repro's jitted init for the reduced config in ``dtype``, compiled
    once for the module (the init does not depend on the SSD route)."""
    return jax.jit(JaxLM(_cfgs(dtype)[0]).init)


@functools.lru_cache(maxsize=None)
def _jax_params(dtype, seed):
    return _jax_init(dtype)(jax.random.PRNGKey(seed))


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _jax_keys(t):
    return {"/".join(str(p.key) for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}


def _port_keys(t):
    return {tree.key(p): np.array(v.detach().float().numpy())
            for p, v in tree.flatten(t)}


def _batch(cfg, b=2, s=20, seed=0):
    """S = 20 is 2.5 chunks of 8: the carry and the pad are exercised."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def test_repro_param_tree_converts():
    """params_from_jax walks LM(cfg).param_shapes(): repro's hybrid tree
    goes through it unchanged, key for key and shape for shape."""
    _, tcfg = _cfgs()
    jp = _jax_params("bfloat16", 0)
    tp = params_from_jax(_np_tree(jp), tcfg, device="cpu")
    assert sorted(tp["mamba"]) == ["A_log", "D", "conv_w", "dt_bias", "ln",
                                   "norm", "w_bcdt", "w_in", "w_out"]
    assert sorted(tp["shared"]) == ["attn", "ln1", "ln2", "mlp"]
    assert "lm_head" in tp and "layers" not in tp
    want, got = _jax_keys(jp), _port_keys(tp)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tp["mamba"]["conv_w"].dtype == torch.bfloat16
    assert tp["mamba"]["A_log"].dtype == torch.float32


def test_init_follows_repros_rules():
    _, tcfg = _cfgs()
    p = LM(tcfg).init(0, device="cpu")
    m = p["mamba"]
    conv = m["conv_w"].float()
    assert torch.equal(conv[:, -1], torch.ones_like(conv[:, -1]))
    assert not conv[:, :-1].any()
    for k in ("A_log", "dt_bias"):
        assert not m[k].any()
    for k in ("D", "norm", "ln"):
        assert torch.equal(m[k], torch.ones_like(m[k]))
    assert torch.equal(p["shared"]["ln1"], torch.ones(tcfg.d_model))
    w = m["w_in"].float()
    assert 0.8 < float(w.std() * tcfg.d_model ** 0.5) < 1.2   # 1/sqrt(fan_in)


@pytest.mark.parametrize("impl,jax_impl", [("kernel", "pallas"),
                                           ("chunked", "xla")])
def test_f32_loss_logits_and_grads_match_repro(impl, jax_impl):
    jcfg, tcfg = _cfgs("float32")
    jm, tm = JaxLM(jcfg, ssd_impl=jax_impl), LM(tcfg, ssd_impl=impl)
    jp = _jax_params("float32", 0)
    tp = params_from_jax(_np_tree(jp), tcfg, device="cpu")
    batch = _batch(tcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    lj, gj = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    logits_j = jax.jit(lambda p, t: jm.forward(p, t)[0])(jp, jb["tokens"])
    leaves = [p.requires_grad_(True) for p in tree.leaves(tp)]
    ops.reset_plain_calls()
    lt = tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    gt = torch.autograd.grad(lt, leaves)
    # the kernel route ran the plain scan in the forward and its remat
    # recompute, and the chunked scan once per layer in the backward
    L = tcfg.n_layers
    assert ops.plain_calls["ssd_ref"] == (2 * L if impl == "kernel" else 0)
    assert ops.bwd_recomputes["ssd_chunk_scan"] == (L if impl == "kernel"
                                                    else 0)
    assert abs(float(lj) - float(lt.detach())) <= 1e-4
    with torch.no_grad():
        logits_t, _ = tm.forward(tp, torch.from_numpy(batch["tokens"]))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=1e-4)
    want = _jax_keys(gj)
    got = {tree.key(p): g.numpy() for (p, _), g in zip(tree.flatten(tp), gt)}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    assert float(np.abs(got["shared/attn/wq"]).max()) > 0


def test_bf16_logits_and_loss_match_repro():
    jcfg, tcfg = _cfgs("bfloat16")
    jm, tm = JaxLM(jcfg, ssd_impl="xla"), LM(tcfg)
    jp = _jax_params("bfloat16", 1)
    tp = params_from_jax(_np_tree(jp), tcfg, device="cpu")
    batch = _batch(tcfg, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits_j = jax.jit(lambda p, t: jm.forward(p, t)[0])(jp, jb["tokens"])
    lj = jax.jit(jm.loss)(jp, jb)
    with torch.no_grad():
        logits_t, _ = tm.forward(tp, torch.from_numpy(batch["tokens"]))
        lt = tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    gap = np.abs(logits_t.float().numpy()
                 - np.asarray(logits_j, np.float32)).max()
    assert gap <= LOGITS_ATOL
    assert abs(float(lj) - float(lt)) <= LOSS_ATOL


def test_engine_trajectory_matches_repro():
    """3 steps of the engine (2 microbatches, f32 master) against repro's
    with its SSD scan on the Pallas route: the port's engine on the
    kernel route (the plain scan on the CPU)."""
    jcfg, tcfg = _cfgs()
    jeng = JaxTrainEngine(JaxLM(jcfg), JaxEngineConfig(
        optim=JAX_OPT, microbatches=2, kernels="pallas"))
    assert jeng.model.ssd_impl == "pallas"
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    params = params_from_jax(_np_tree(jstate["params"]), tcfg, device="cpu")
    jdcfg = JaxDataConfig(seed=0, vocab=tcfg.vocab, seq_len=16,
                          global_batch=4)
    jl = []
    for step in range(3):
        jstate, m = jeng.step(jstate, jax_host_batch(jdcfg, step))
        jl.append(float(m["loss"]))
    eng = TrainEngine(LM(tcfg), EngineConfig(optim=OPT, microbatches=2,
                                             kernels="kernel"), device="cpu")
    assert eng.model.ssd_impl == "kernel"
    state = eng.init_state(params=params)
    dcfg = DataConfig(seed=0, vocab=tcfg.vocab, seq_len=16, global_batch=4)
    ops.reset_plain_calls()
    tl = []
    for step in range(3):
        state, m = eng.step(state, host_batch(dcfg, step))
        tl.append(float(m["loss"]))
    L = tcfg.n_layers
    assert ops.plain_calls["ssd_ref"] == 3 * 2 * 2 * L
    assert ops.bwd_recomputes["ssd_chunk_scan"] == 3 * 2 * L
    np.testing.assert_allclose(tl, jl, atol=TRAIN_LOSS_ATOL)
    assert tl[-1] < tl[0]


def test_engine_routes_kernels():
    _, tcfg = _cfgs()
    model = LM(tcfg)
    assert model.ssd_impl == "auto"
    for kernels, want in (("auto", "auto"), ("kernel", "kernel"),
                          ("chunked", "chunked")):
        eng = TrainEngine(model, EngineConfig(kernels=kernels), device="cpu")
        assert eng.model.ssd_impl == want
    with pytest.raises(ValueError, match="kernels"):
        TrainEngine(model, EngineConfig(kernels="pallas"), device="cpu")
    with pytest.raises(ValueError, match="ssd_impl"):
        LM(tcfg, ssd_impl="xla")


def test_compressed_sync_takes_the_hybrid_tree():
    """The int8 error-feedback sync, the optimizer and the f32 master walk
    the hybrid tree as they walk the dense one."""
    _, tcfg = _cfgs()
    eng = TrainEngine(LM(tcfg), EngineConfig(optim=OPT, grad_compression=True,
                                             buckets=3), device="cpu")
    state = eng.init_state(0)
    dcfg = DataConfig(seed=0, vocab=tcfg.vocab, seq_len=16, global_batch=2)
    losses = []
    for step in range(2):
        state, m = eng.step(state, host_batch(dcfg, step))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    keys = set(_port_keys(state["err"]))
    assert keys == set(_port_keys(state["params"]))
    assert "mamba/conv_w" in keys and "shared/mlp/wd" in keys
    assert float(state["err"]["mamba"]["w_in"].abs().max()) > 0


def test_repro_checkpoint_restores_into_the_port(tmp_path):
    jcfg, tcfg = _cfgs()
    jeng = JaxTrainEngine(JaxLM(jcfg), JaxEngineConfig(optim=JAX_OPT))
    jstate = jeng.init_state(jax.random.PRNGKey(1))
    jstate["opt"]["step"] = jnp.asarray(4, jnp.int32)
    jax_ckpt.save(str(tmp_path), 4, jstate, extra={"loss": 2.5})
    eng = TrainEngine(LM(tcfg), EngineConfig(optim=OPT), device="cpu")
    state, extra, step = eng.restore(str(tmp_path))
    assert step == 4 and extra == {"loss": 2.5}
    want, got = _jax_keys(jstate), _port_keys(state)
    assert set(want) == set(got)
    assert "params/shared/attn/wq" in got and "master/mamba/A_log" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and one step runs on the restored state
    dcfg = DataConfig(seed=0, vocab=tcfg.vocab, seq_len=8, global_batch=2)
    state, m = eng.step(state, host_batch(dcfg, 4))
    assert np.isfinite(float(m["loss"])) and int(state["opt"]["step"]) == 5


def test_serving_paths_raise_for_the_hybrid_family():
    """What stays refused now that the hybrid family serves on the linear
    tier (tests/test_torch_hybrid_serve.py): the paged tier and the
    speculative re-score, as in repro, for it and for the other recurrent
    families (xLSTM, the pure-SSM branch, which now build); and what is
    not ported: the hybrid layout with xlstm or with experts."""
    _, tcfg = _cfgs()
    model = LM(tcfg)
    params = model.init(0, device="cpu")
    with pytest.raises(ValueError, match="paged KV cache unsupported"):
        model.init_cache_paged(1, 16, 3, 8, device="cpu")
    with pytest.raises(ValueError, match="paged KV cache unsupported"):
        Server(model, params, ServeConfig(slots=1, max_len=16, paged=True))
    cache = model.init_cache(1, 16, device="cpu")
    with pytest.raises(ValueError, match="re-score unsupported"):
        model.decode_rescore(params, cache, torch.zeros(1, dtype=torch.long),
                             torch.zeros(1, dtype=torch.long),
                             torch.zeros(1, dtype=torch.long))
    with pytest.raises(ValueError, match="recurrent state"):
        model.prefill_chunk(params, cache, torch.zeros(4, dtype=torch.long),
                            0, 4, impl="parallel")
    # the combinations not ported keep raising
    for other in (dict(xlstm=XLSTMCfg()), dict(moe=MoECfg(4, 2, 64))):
        with pytest.raises(NotImplementedError, match="not ported"):
            LM(dataclasses.replace(tcfg, **other))
    # the pure-SSM branch and xLSTM build, with the same refusals
    for rec in (dataclasses.replace(tcfg, family="ssm", attn_every=0),
                get_arch("xlstm-125m").reduced()):
        m = LM(rec)
        p = m.init(0, device="cpu")
        with pytest.raises(ValueError, match="paged KV cache unsupported"):
            m.init_cache_paged(1, 16, 3, 8, device="cpu")
        c = m.init_cache(1, 16, device="cpu")
        assert "kv" not in c and "shared" not in c
        with pytest.raises(ValueError, match="re-score unsupported"):
            m.decode_rescore(p, c, torch.zeros(1, dtype=torch.long),
                             torch.zeros(1, dtype=torch.long),
                             torch.zeros(1, dtype=torch.long))


def test_launch_train_hybrid_on_cpu(tmp_path):
    out = tmp_path / "r.json"
    assert launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                              "--steps", "3", "--batch", "2", "--seq", "16",
                              "--json-out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["meta"]["arch"] == ARCH
    assert len(rec["losses"]) == 3 and np.isfinite(rec["losses"]).all()


def test_launch_train_hybrid_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--arch", ARCH, "--reduced", "--steps", "1"])
