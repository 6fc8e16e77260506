"""The port's SSM family against repro's on the CPU, on the same weights
(repro's init, carried by ``params_from_jax``) and numpy batches: xLSTM
(models/xlstm.py; the reduced xlstm-125m: 2 sLSTM + 2 mLSTM blocks, d 64,
4 heads, sLSTM hd 16, mLSTM hd 32, up-projection 85) and the pure-Mamba
branch (a test-built config: the reduced zamba2-2.7b with family "ssm"
and no shared block, 4 Mamba2 layers of 16 heads of P 8, N 8, chunk 8).

Bands, each with the gap measured on this CPU:
  f32 logits against repro: 1e-3 (the serving band for f32; measured 1.6e-5
      xLSTM, 1.2e-5 pure SSM: the same arithmetic up to summation order);
  f32 loss and every param grad against repro: 1e-4 (the training band
      of tests/test_torch_train.py; measured 4.0e-5 and 4.7e-5 on grads
      up to 11.5);
  each block's forward against its step run token by token, and the
      forward's last-position logits against the decode step: 1e-5
      (measured 1.9e-6 on the logits: mLSTM's chunked scan sums
      log-sigmoids, the step multiplies sigmoids); over two of mLSTM's
      chunks of 256 (S = 300) 1e-4, against the step and against repro
      (measured 3.2e-5 and 3.7e-5; repro's own forward and step are
      3.8e-5 apart there);
  bf16 logits 0.25 and loss 0.05: repro's LOGITS_ATOL and LOSS_ATOL;
  the 3-step trajectory: TRAIN_LOSS_ATOL 0.08 (verify/train_cell.py);
  greedy streams, retirements and dispatch counters: equal.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")     # the card's machine has no JAX
jnp = jax.numpy

from repro.configs import get_arch as jax_arch
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import host_batch as jax_host_batch
from repro.models.model import LM as JaxLM
from repro.optim import adamw as jax_adamw
from repro.runtime.serve import ServeConfig as JaxServeConfig
from repro.runtime.serve import Server as JaxServer
from repro.train.engine import EngineConfig as JaxEngineConfig
from repro.train.engine import TrainEngine as JaxTrainEngine
from repro.verify.numerics import LOGITS_ATOL, LOSS_ATOL
from repro.verify.train_cell import TRAIN_LOSS_ATOL
from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import xlstm
from repro_torch.models.model import LM
from repro_torch.optim import adamw
from repro_torch.runtime.serve import ServeConfig, Server
from repro_torch.train.engine import EngineConfig, TrainEngine

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")
F32_ATOL = 1e-3
GRAD_ATOL = 1e-4
STEP_ATOL = 1e-5
LONG_ATOL = 1e-4
FAMILIES = ("xlstm", "ssm")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread avoids oversubscribing the cores
    that the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(get, family, dtype):
    """The reduced config of ``family`` in ``dtype`` from one package's
    registry (``get``): xlstm-125m's, or the pure-SSM branch built from
    zamba2-2.7b's (family "ssm", no shared block)."""
    if family == "xlstm":
        return dataclasses.replace(get("xlstm-125m").reduced(), dtype=dtype)
    return dataclasses.replace(get("zamba2-2.7b").reduced(), dtype=dtype,
                               family="ssm", attn_every=0)


@functools.lru_cache(maxsize=None)
def _pair(family, dtype="float32", seed=0):
    jcfg, tcfg = _cfg(jax_arch, family, dtype), _cfg(get_arch, family, dtype)
    jm = JaxLM(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    return jm, jp, LM(tcfg), tp


def _jax_keys(t):
    return {"/".join(str(p.key) for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}


def _batch(b=2, s=20, seed=0):
    """S = 20: 2.5 SSD chunks of 8 (the pure-SSM branch's carry and pad)."""
    toks = np.random.default_rng(seed).integers(0, 256, (b, s + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


# -- configs and params ---------------------------------------------------------

def test_xlstm_125m_is_repros_and_builds_at_full_width():
    """The port's xlstm-125m equals repro's field for field and in
    param_count; it builds at full width (12 layers, d 768, 4 heads,
    vocab 50304), with mLSTM's hd 2 d / H = 384 and sLSTM's d / H = 192;
    an mLSTM slot's state is 6 x 4 x 384 x 384 f32 = 14.2 MB."""
    cfg, want = get_arch("xlstm-125m"), jax_arch("xlstm-125m")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.param_count() == want.param_count()
    model = LM(cfg)
    shapes = model.param_shapes()
    assert shapes["slstm"]["r_gates"][0] == (6, 4, 192, 768)
    assert shapes["slstm"]["w_up"][0] == (6, 768, 1024)
    assert shapes["mlstm"]["w_in"][0] == (6, 768, 4 * 1536 + 8)
    cache = model.cache_shapes(16, 2048)
    assert cache["mlstm"]["C"] == ((6, 16, 4, 384, 384), torch.float32)
    assert cache["slstm"]["h"] == ((6, 16, 4, 192), torch.float32)
    assert 6 * 4 * 384 * 384 * 4 == 14_155_776
    assert "kv" not in cache


@pytest.mark.parametrize("family", FAMILIES)
def test_repro_param_tree_converts(family):
    """params_from_jax walks LM(cfg).param_shapes(): repro's xLSTM and
    pure-SSM trees go through it unchanged, key for key and value for
    value, in repro's dtypes."""
    jm, jp, tm, tp = _pair(family, "bfloat16")
    want = _jax_keys(jp)
    got = {tree.key(p): v.float().numpy() for p, v in tree.flatten(tp)}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if family == "xlstm":
        assert sorted(tp["slstm"]) == ["ln", "r_gates", "w_down", "w_gates",
                                       "w_up"]
        assert sorted(tp["mlstm"]) == ["ln", "norm", "w_in", "w_out"]
        assert tp["mlstm"]["norm"].dtype == torch.float32
        assert tp["slstm"]["r_gates"].dtype == torch.bfloat16
    else:
        assert "shared" not in tp and "mamba" in tp


def test_init_follows_repros_rules():
    """Unit norms, and 1/sqrt(fan_in) weights with r_gates' fan-in hd
    (repro's ``dense_init(..., in_axis=1)`` on [H, hd, 4 hd])."""
    cfg = _cfg(get_arch, "xlstm", "float32")
    p = LM(cfg).init(0, device="cpu")
    for blk, k in (("slstm", "ln"), ("mlstm", "ln"), ("mlstm", "norm")):
        assert torch.equal(p[blk][k], torch.ones_like(p[blk][k]))
    hd = cfg.d_model // cfg.n_heads
    r = p["slstm"]["r_gates"]
    assert 0.8 < float(r.std() * hd ** 0.5) < 1.2
    w = p["slstm"]["w_gates"]
    assert 0.8 < float(w.std() * cfg.d_model ** 0.5) < 1.2


# -- training ------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_f32_logits_loss_and_grads_match_repro(family):
    """Logits within 1e-3 of repro's, the loss and every grad within 1e-4.
    The pure-SSM branch on the port's kernel route (the plain scan on the
    CPU, twice a layer: the forward and the remat; the chunked scan in
    the backward) against repro's XLA route; xLSTM runs no SSD kernel
    route at all (mLSTM calls the chunked scan directly)."""
    jm, jp, tm, tp = _pair(family)
    if family == "ssm":
        tm = dataclasses.replace(tm, ssd_impl="kernel")
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    lj, gj = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    logits_j = jax.jit(lambda p, t: jm.forward(p, t)[0])(jp, jb["tokens"])
    tp = tree.tree_map(lambda t: t.detach().clone(), tp)   # not _pair's
    leaves = [p.requires_grad_(True) for p in tree.leaves(tp)]
    ops.reset_plain_calls()
    lt = tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    gt = torch.autograd.grad(lt, leaves)
    L = tm.cfg.n_layers
    want_scans = 2 * L if family == "ssm" else 0
    assert ops.plain_calls["ssd_ref"] == want_scans
    assert ops.bwd_recomputes["ssd_chunk_scan"] == want_scans // 2
    assert abs(float(lj) - float(lt.detach())) <= GRAD_ATOL
    with torch.no_grad():
        logits_t, _ = tm.forward(tp, torch.from_numpy(batch["tokens"]))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=F32_ATOL, rtol=0)
    want = _jax_keys(gj)
    got = {tree.key(p): g.numpy() for (p, _), g in zip(tree.flatten(tp), gt)}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=GRAD_ATOL, rtol=0,
                                   err_msg=k)
        assert float(np.abs(got[k]).max()) > 0, k


def test_bf16_logits_and_loss_match_repro():
    jm, jp, tm, tp = _pair("xlstm", "bfloat16", 1)
    batch = _batch(seed=1)
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
    """3 steps of the engine (2 microbatches, f32 master, bf16 compute) on
    the reduced xlstm-125m against repro's engine from the same state."""
    jcfg = _cfg(jax_arch, "xlstm", "bfloat16")
    tcfg = _cfg(get_arch, "xlstm", "bfloat16")
    opt = dict(lr=2e-3, warmup_steps=2, total_steps=1000)
    jeng = JaxTrainEngine(JaxLM(jcfg), JaxEngineConfig(
        optim=jax_adamw.AdamWConfig(**opt), microbatches=2))
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jstate["params"]), tcfg, device="cpu")
    jd = JaxDataConfig(seed=0, vocab=256, seq_len=16, global_batch=4)
    jl = []
    for step in range(3):
        jstate, m = jeng.step(jstate, jax_host_batch(jd, step))
        jl.append(float(m["loss"]))
    eng = TrainEngine(LM(tcfg), EngineConfig(
        optim=adamw.AdamWConfig(**opt), microbatches=2), device="cpu")
    state = eng.init_state(params=params)
    dcfg = DataConfig(seed=0, vocab=256, seq_len=16, global_batch=4)
    tl = []
    for step in range(3):
        state, m = eng.step(state, host_batch(dcfg, step))
        tl.append(float(m["loss"]))
    np.testing.assert_allclose(tl, jl, atol=TRAIN_LOSS_ATOL)
    assert tl[-1] < tl[0]
    assert set(tree.key(p) for p, _ in tree.flatten(state["master"])) == \
        set(tree.key(p) for p, _ in tree.flatten(state["params"]))


# -- the stepwise paths ----------------------------------------------------------

@pytest.mark.parametrize("block,s,band", [("mlstm", 13, STEP_ATOL),
                                          ("mlstm", 300, LONG_ATOL),
                                          ("slstm", 13, STEP_ATOL)])
def test_block_forward_matches_its_step(block, s, band):
    """Each block's training forward against its decode step run token by
    token from a zero state, at every position (mLSTM: the chunked scan
    over log_sigmoid of the forget gate against the step's product of
    sigmoids; sLSTM: one cell on both paths), within 1e-5 at S = 13; at S
    = 300 (two chunks of 256, the second partial: the carry between
    chunks) within 1e-4, as a chunk's prefix sum of up to 256
    log-sigmoids carries ~1e-7 x |sum| into every decay (measured 3.2e-5;
    repro's own forward is 3.8e-5 from its own step there)."""
    _, _, tm, tp = _pair("xlstm")
    cfg = tm.cfg
    p = {k: v[0] for k, v in tp[block].items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32))
    fwd = getattr(xlstm, f"{block}_forward")
    step = getattr(xlstm, f"{block}_step")
    shapes = getattr(xlstm, f"{block}_state_shapes")(cfg, 2)
    state = {k: torch.zeros(s, dtype=dt) for k, (s, dt) in shapes.items()}
    with torch.no_grad():
        want = fwd(p, x, cfg)
        got = torch.stack([step(p, x[:, t], state, cfg)
                           for t in range(x.shape[1])], 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=band, rtol=0)
    assert float(state[next(iter(state))].abs().max()) > 0


def test_blocks_match_repro_over_two_chunks():
    """Each block's f32 forward against repro's on the same layer weights
    at S = 300 (mLSTM's scan over two chunks): within 1e-4 (measured
    3.7e-5 mLSTM: the prefix sums, as above; 1.8e-7 sLSTM)."""
    from repro.models import xlstm as jax_xlstm
    jm, jp, tm, tp = _pair("xlstm")
    x = np.random.default_rng(5).standard_normal(
        (2, 300, tm.cfg.d_model)).astype(np.float32)
    for block in ("mlstm", "slstm"):
        jpl = jax.tree_util.tree_map(lambda a: a[0], jp[block])
        want = getattr(jax_xlstm, f"{block}_forward")(jpl, jnp.asarray(x),
                                                      jm.cfg)
        with torch.no_grad():
            got = getattr(xlstm, f"{block}_forward")(
                {k: v[0] for k, v in tp[block].items()}, torch.from_numpy(x),
                tm.cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LONG_ATOL, rtol=0, err_msg=block)


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_steps_match_the_forwards_last_position(family):
    """20 decode steps on a 2-slot cache against the forward of the same
    20 tokens: the last position's logits within 1e-5."""
    _, _, tm, tp = _pair(family)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 256,
                                                              (2, 20)))
    cache = tm.init_cache(2, 32, device="cpu")
    with torch.no_grad():
        for i in range(20):
            lg, _ = tm.decode_step(tp, cache, toks[:, i])
        lf, _ = tm.forward(tp, toks)
    np.testing.assert_allclose(lg.numpy(), lf[:, -1].numpy(),
                               atol=STEP_ATOL, rtol=0)
    assert cache["pos"].tolist() == [20, 20]


def test_reset_slot_zeroes_the_recurrent_state():
    """reset_slot zeroes one slot's C, h, c and n (and its position) and
    leaves the other slots' rows as they were."""
    _, _, tm, tp = _pair("xlstm")
    cache = tm.init_cache(3, 16, device="cpu")
    with torch.no_grad():
        tm.decode_step(tp, cache, torch.tensor([4, 5, 6]))
    before = {k: {n: t.clone() for n, t in v.items()}
              for k, v in cache.items() if k != "pos"}
    tm.reset_slot(cache, 1)
    for k in ("slstm", "mlstm"):
        for n, t in cache[k].items():
            assert not t[:, 1].any(), (k, n)
            assert t[:, 0].any() and torch.equal(t[:, 0], before[k][n][:, 0])
            assert torch.equal(t[:, 2], before[k][n][:, 2])
    assert cache["pos"].tolist() == [1, 0, 1]


# -- serving -----------------------------------------------------------------------

PROMPT_LENS = (5, 19, 12, 9)


def _serve(srv, prompts, gen=10):
    rids = [srv.submit(p, max_new_tokens=gen) for p in prompts]
    res = srv.run()
    return ([res[r] for r in rids], dict(srv.finished),
            (srv.prefill_dispatches, srv.decode_dispatches,
             srv.verify_dispatches))


@pytest.mark.parametrize("family,spec_k", [("xlstm", 1), ("xlstm", 4),
                                           ("ssm", 1)])
def test_server_matches_repro(family, spec_k):
    """Both packages' Server on the same f32 weights: 2 slots x 48, chunks
    of 8, 4 requests of 5-19 prompt tokens and 10 greedy tokens each, so
    both slots are reused (reset_slot must leave no stale state: the last
    stream equals the one it gives alone on a fresh pool).  spec_k 4
    drafts and accepts with no re-score, as repro.  Streams, retirements
    and dispatch counters equal repro's; no kernel's plain version is
    called (no attention; the pure-SSM decode steps its state)."""
    jm, jp, tm, tp = _pair(family)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in PROMPT_LENS]
    kw = dict(slots=2, max_len=48, prefill_chunk=8, spec_k=spec_k)
    want = _serve(JaxServer(jm, jp, JaxServeConfig(**kw)), prompts)
    ops.reset_plain_calls()
    got = _serve(Server(tm, tp, ServeConfig(**kw)), prompts)
    assert got == want
    assert got[2][2] == 0
    assert all(len(s) == 10 for s in got[0])
    assert not any(ops.plain_calls.values())
    alone = _serve(Server(tm, tp, ServeConfig(**kw)), prompts[-1:])
    assert alone[0][0] == got[0][-1]


@pytest.mark.parametrize("family", FAMILIES)
def test_paged_tier_and_rescore_are_refused(family):
    """As in repro: no paged pool and no speculative re-score for a
    recurrent state."""
    jm, jp, tm, tp = _pair(family)
    for cls, cfg_cls, m, p in ((JaxServer, JaxServeConfig, jm, jp),
                               (Server, ServeConfig, tm, tp)):
        with pytest.raises(ValueError, match="paged KV cache unsupported"):
            cls(m, p, cfg_cls(slots=2, max_len=32, paged=True))
    cache = tm.init_cache(2, 32, device="cpu")
    with pytest.raises(ValueError, match="re-score unsupported"):
        tm.decode_rescore(tp, cache, torch.zeros(2, dtype=torch.long),
                          torch.arange(2), torch.zeros(2, dtype=torch.long))
    with pytest.raises(ValueError, match="recurrent state"):
        tm.prefill_chunk(tp, cache, torch.zeros(4, dtype=torch.long), 0, 4,
                         impl="parallel")


# -- the CLIs ------------------------------------------------------------------------

def test_launch_serve_and_train_xlstm_on_cpu(tmp_path):
    """``python -m repro_torch.launch.serve --arch xlstm-125m --reduced
    --device cpu`` serves one request a slot, ``launch.train`` trains 3
    steps; without ``--device cpu`` (no card here) both raise."""
    out = tmp_path / "s.json"
    assert launch_serve.main(["--arch", "xlstm-125m", "--reduced", "--device",
                              "cpu", "--prompt-len", "12", "--gen", "6",
                              "--json-out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["meta"]["arch"] == "xlstm-125m"
    assert rec["requests"] == 4 and rec["generated_tokens"] == 24
    out = tmp_path / "t.json"
    assert launch_train.main(["--arch", "xlstm-125m", "--reduced", "--device",
                              "cpu", "--steps", "3", "--batch", "4", "--seq",
                              "16", "--json-out", str(out)]) == 0
    losses = json.loads(out.read_text())["losses"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    if not torch.cuda.is_available():
        for main in (launch_serve.main, launch_train.main):
            with pytest.raises(RuntimeError, match="cuda"):
                main(["--arch", "xlstm-125m", "--reduced"])
