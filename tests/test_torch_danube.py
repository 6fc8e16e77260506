"""h2o-danube-3-4b in the port against repro: the main path's one
sliding-window config (a ring cache of ``pos % S``, a scan-only prefill)
and its head dim of 120.

repro's ``LM(cfg).init(PRNGKey(0))`` tree goes through
``repro_torch.convert.params_from_jax``; both models see the same seeded
numpy inputs on the CPU (repro's XLA path, the port's plain versions).
Bands, max-abs:
  logits, f32: 1e-3 -- the arithmetic is the same up to summation order,
               but the KV cache is bf16 in both, so a K/V written from
               slightly different f32 values can round to a neighbouring
               bf16 value (tests/test_torch_model.py's band);
  logits, bf16: 0.25 -- repro's LOGITS_ATOL (verify/numerics.py);
  the plain attention at hd 120 against repro's Pallas kernels in
  interpret mode: 1e-4 -- both sides in f32, differing in summation order
  only (the forward's gap at hd 120 was 8.3e-7), the bwd with its own
  larger sums.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")     # the card's machine has no JAX
jnp = jax.numpy

from repro.configs import get_arch as jax_arch
from repro.kernels.flash_attention import (flash_attention_bwd,
                                           flash_attention_decode,
                                           flash_attention_fwd)
from repro.models.model import LM as JaxLM
from repro.runtime.serve import ServeConfig as JaxServeConfig
from repro.runtime.serve import Server as JaxServer
from repro.verify.numerics import LOGITS_ATOL
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ref
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.model import LM
from repro_torch.runtime.serve import ServeConfig, Server

ARCH = "h2o-danube-3-4b"
BAND = {"float32": 1e-3, "bfloat16": LOGITS_ATOL}
KERNEL_TOL = 1e-4

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread avoids oversubscribing the cores
    that the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(dtype, **overrides):
    jcfg = dataclasses.replace(jax_arch(ARCH).reduced(), dtype=dtype,
                               **overrides)
    tcfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype=dtype,
                               **overrides)
    jm = JaxLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    return jm, jp, LM(tcfg), tp


def _maxdiff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - b.float().numpy())))


def test_config_is_repros():
    want = dataclasses.asdict(jax_arch(ARCH))
    got = dataclasses.asdict(get_arch(ARCH))
    assert got == want
    cfg = get_arch(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab, cfg.swa_window, cfg.tie_embeddings) == \
        (24, 3840, 32, 8, 120, 10240, 32000, 4096, False)
    assert get_arch(ARCH).reduced().swa_window == 16


# -- the wrapping ring ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_wraps_the_ring_like_repro(dtype):
    """Two rows on a 64-position cache, whose ring holds the window's 16:
    row 0 steps from position 0, row 1 joins 5 steps later; 56 steps, so
    row 0 runs 40 past the window and both rings wrap.  Logits at every
    step in the band, and the rings hold the same K/V."""
    jm, jp, tm, tp = _pair(dtype)
    band = BAND[dtype]
    jc, tc = jm.init_cache(2, 64), tm.init_cache(2, 64, device="cpu")
    assert tc["kv"]["k"].shape[2] == 16
    rng = np.random.default_rng(7)
    worst = 0.0
    step_j = jax.jit(jm.decode_step)     # compiled once for the 56 steps
    for step in range(56):
        toks = rng.integers(0, jm.cfg.vocab, 2)
        act = np.array([True, step >= 5])
        lj, jc = step_j(jp, jc, jnp.asarray(toks), active=jnp.asarray(act))
        lt, tc = tm.decode_step(tp, tc, torch.from_numpy(toks),
                                active=torch.from_numpy(act))
        worst = max(worst, _maxdiff(lj, lt))
        assert worst <= band, step
    np.testing.assert_array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())
    assert tc["pos"].tolist() == [56, 51]
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["kv"][name].float().numpy(),
                                   np.asarray(jc["kv"][name], np.float32),
                                   atol=max(band, 0.05))


def test_server_streams_match_repro_past_the_window():
    """Both packages' Server, 2 slots of 64 positions (ring 16), chunks of
    8, prompts of 17-40 tokens: the scan prefill wraps the ring, and the
    greedy streams (and the retire reasons) are identical, f32."""
    jm, jp, tm, tp = _pair("float32")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jm.cfg.vocab,
                            size=int(rng.integers(17, 41))).tolist()
               for _ in range(4)]
    outs = []
    for srv in (JaxServer(jm, jp, JaxServeConfig(slots=2, max_len=64,
                                                 prefill_chunk=8)),
                Server(tm, tp, ServeConfig(slots=2, max_len=64,
                                           prefill_chunk=8))):
        rids = [srv.submit(p, max_new_tokens=12) for p in prompts]
        res = srv.run()
        outs.append(([res[r] for r in rids], dict(srv.finished)))
    assert outs[0] == outs[1]
    assert all(len(s) == 12 for s in outs[1][0])


def test_forward_at_head_dim_120_matches_repro():
    """The reduced config at danube's head dim (4 q heads of 120 on 1 KV
    head): the model's reshapes at 120, f32 logits in the band."""
    jm, jp, tm, tp = _pair("float32", head_dim=120)
    toks = np.random.default_rng(3).integers(0, jm.cfg.vocab, (2, 21))
    lj, _ = jm.forward(jp, jnp.asarray(toks))
    lt, _ = tm.forward(tp, torch.from_numpy(toks))
    assert _maxdiff(lj, lt) <= BAND["float32"]


# -- the plain attention at hd 120 against repro's Pallas kernels -----------

def _inputs(seed, b, s, h, kv, hd=120):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd),
                               (b, s, h, hd)))


@pytest.mark.parametrize("b,s,window,causal", [
    (1, 70, 16, True), (2, 48, 7, True), (1, 80, None, True),
    (2, 33, 16, False)])
def test_hd120_fwd_ref_matches_pallas(b, s, window, causal):
    """The forward at hd 120, 4 q / 2 KV heads, 16-row Pallas blocks that
    cut S raggedly."""
    q, k, v, _ = _inputs(s, b, s, 4, 2)
    kw = dict(causal=causal, window=window)
    o_j, lse_j = flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), block_q=16, block_k=16,
                                     interpret=True, **kw)
    o_t, lse_t = ref.flash_attention_fwd_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.parametrize("b,window", [(1, 16), (2, 7)])
def test_hd120_bwd_ref_matches_pallas(b, window):
    """dq, dk, dv at hd 120 (S 48: whole 16-row blocks, since repro's
    ragged dk/dv reads NaN padding in interpret mode, ROADMAP C)."""
    q, k, v, do = _inputs(100 + b, b, 48, 4, 2)
    kw = dict(causal=True, window=window, block_q=16, block_k=16,
              interpret=True)
    qj, kj, vj = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    o, lse = flash_attention_fwd(qj, kj, vj, **kw)
    want = flash_attention_bwd(qj, kj, vj, o, lse, jnp.asarray(do), **kw)
    got = ref.flash_attention_bwd_ref(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, do)),
        causal=True, window=window)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=KERNEL_TOL,
                                   rtol=KERNEL_TOL, err_msg=name)


@pytest.mark.parametrize("window", [None, 7, 16])
def test_hd120_decode_ref_matches_pallas(window):
    """Decode at hd 120 against a bf16 cache of 40 positions, lengths 0
    (exact zeros), 1, 17 and 40; the split-and-merge version too."""
    b, s, h, kv = 4, 40, 4, 2
    rng = np.random.default_rng(12)
    q = rng.standard_normal((b, h, 120)).astype(np.float32)
    kc, vc = (torch.from_numpy(rng.standard_normal((b, s, kv, 120)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    ln = np.array([0, 1, 17, s], np.int32)
    o_j = np.asarray(flash_attention_decode(
        jnp.asarray(q), jnp.asarray(kc.float().numpy(), jnp.bfloat16),
        jnp.asarray(vc.float().numpy(), jnp.bfloat16), jnp.asarray(ln),
        window=window, block_k=8, interpret=True))
    args = (torch.from_numpy(q), kc, vc, torch.from_numpy(ln))
    for o_t in (ref.flash_attention_decode_ref(*args, window=window),
                ref.flash_attention_decode_split_ref(*args, split=16,
                                                     window=window)):
        assert not o_t[0].any()
        np.testing.assert_allclose(o_t.numpy(), o_j, atol=KERNEL_TOL,
                                   rtol=KERNEL_TOL)


# -- the CLIs ---------------------------------------------------------------

def test_launch_serve_danube_on_cpu(tmp_path):
    """``launch.serve --arch h2o-danube-3-4b`` with no new flag: prompts of
    20 tokens through a ring of 16 (the scan prefill), the four serving
    metrics positive."""
    out = tmp_path / "serve.json"
    assert launch_serve.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--slots", "2",
        "--requests", "3", "--gen", "4", "--prompt-len", "20", "--chunk",
        "8", "--max-len", "48", "--json-out", str(out)]) == 0
    rec = json.loads(out.read_text())
    for key in ("prefill_tok_per_s", "decode_tok_per_s", "ttft_p50_s",
                "itl_p50_s"):
        assert rec[key] is not None and rec[key] > 0, key
    assert rec["requests"] == 3 and rec["generated_tokens"] == 12


def test_launch_train_runs_a_depth_cut(tmp_path):
    """``launch.train --arch h2o-danube-3-4b`` on the CPU, and ``run`` with
    a config in place of --arch's (the card's smoke trains danube cut in
    depth this way): the record names the config and its losses are
    finite and fall."""
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "24", "--lr", "3e-3"]
    assert launch_train.main(argv) == 0
    cut = dataclasses.replace(get_arch(ARCH).reduced(), n_layers=2)
    rec = launch_train.run(launch_train.build_argparser().parse_args(argv),
                           cfg=cut)
    assert rec["meta"]["arch"] == ARCH
    losses = rec["losses"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
