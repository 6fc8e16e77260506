"""Serving the hybrid family (zamba2) in the port against repro on the
CPU: ``models/mamba.mamba_step``, the hybrid cache and decode step of
``models/model.py``, the scan prefill, the ``Server`` and
``launch.serve``, at the reduced zamba2-2.7b (4 Mamba layers, d 64, 16
SSM heads of P 8, N 8, conv 4, the shared block after every 2 layers, 4
heads of hd 16).  repro's ``LM(cfg).init(PRNGKey(0))`` tree goes through
``repro_torch.convert.params_from_jax``, so both sides hold the same
weights; inputs are seeded numpy.

Bands, each with its reason:
  f32 values (logits, y, the SSM state): |port - repro| <= 1e-5 + 1e-5
      |repro| -- the same arithmetic up to summation order (XLA's matmuls
      and einsums against torch's);
  bf16 leaves (the conv state, the shared block's K/V rings; bf16 in
      repro whatever the model dtype): the f32 band plus one bf16
      rounding (|port - repro| <= 1e-5 + 2^-7 |repro|): an f32 value that
      differs in its last bits can round to the neighbouring bf16 value.
      Once that happens the two runs hold different states, so the
      decode step is held step by step from the same cache (repro's,
      copied).  Within a
      step the shared block attends the K/V it has just written, so a row
      whose new K or V rounded the other way moves by up to ~7e-4 in the
      same step: such a row is held at 1e-3 (FREE_TOL), the others at
      the f32 band, and every element of its new K/V must be within one
      bf16 rounding (2^-7 of the larger) and the f32 band of repro's (a
      rounding the other way, never a wrong value).  How many rows flip
      depends on the
      host's f32 summation order (1 row in 18 row-steps of the decode
      test on one host, 5 on an AVX-512 AMD EPYC), so it is not counted;
      run free, the logits drift
      apart by up to 5.0e-4 in 8 steps (measured on this CPU, seed 0);
  the K/V entries of a later shared application in the same step (or
      of a later position in a prefill chunk): the port computes what
      repro computes (the same roundings, intermediate by intermediate:
      the Mamba block's output, the residual sums, the norms and the
      projections agree to ~1e-6 until a flip), but a flip in
      application g moves that row's attention output, and the residual
      stream carries the move through the Mamba layers into application
      g + 1's input, so the entries written after a flip are those of
      another state.  The carried error is not bounded by a band: it is
      taken out.  Each step also runs teacher-forced (``_forced_step``):
      every new K/V entry is replaced by repro's before it is written and
      attended, so every application and position sees repro's inputs.
      There each entry the port computed is held at one bf16 rounding
      and the f32 band (no carried term), and the logits and SSM state
      at the f32 band.  In the free run an entry with no flip before it
      on its row (an earlier position, or an earlier application at its
      position) is the forced run's bit for bit, which makes every flip
      itself one rounding; an entry after a flip is the carried state,
      held at the output by the row's FREE_TOL logits band.  Measured
      (decode test, seed 1, step 4, row 2): one K element of
      application 0 rounded the other way (3.9e-3); in the forced run
      application 1's entries equal repro's and the logits are 2.1e-6
      from repro's; free, application 1's entries differ from the forced
      run's by up to 2.0e-3 (K) and 7.8e-3 (V), the logits by 6.8e-4
      (on another host two V entries came out 2.44e-4 and 6.1e-5 from
      repro's, two bf16 steps);
  stepwise decode against the port's own forward: repro's bf16 band
      (tests/test_models.py, rtol = atol = 0.15); in f32 the gap is
      8.30e-3 (measured, 8 steps; repro's own on the same weights and
      tokens 8.32e-3), held at 1e-2: the decode stores the conv history
      and K/V in bf16, the forward keeps them in f32;
  greedy streams and the Server's counters: equal.
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
from repro.models import mamba as jax_mamba
from repro.models.model import LM as JaxLM
from repro.runtime.serve import ServeConfig as JaxServeConfig
from repro.runtime.serve import Server as JaxServer
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import mamba
from repro_torch.models.model import LM
from repro_torch.runtime.serve import ServeConfig, Server

ARCH = "zamba2-2.7b"
F32_TOL = 1e-5
FREE_TOL = 1e-3
BF16_REL = 2.0 ** -7
STEPWISE_BAND = 0.15
F32_STEPWISE = 1e-2

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread avoids oversubscribing the cores
    that the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair(dtype="float32"):
    jcfg = dataclasses.replace(jax_arch(ARCH).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype=dtype)
    jm = JaxLM(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    return jm, jp, LM(tcfg), tp


@functools.lru_cache(maxsize=None)
def _jax_step(dtype="float32"):
    jm = _pair(dtype)[0]
    return jax.jit(jm.decode_step)


def _flat(t):
    """{"a/b": float32 numpy} of a nested dict of JAX or torch arrays."""
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update({f"{k}/{n}": a for n, a in _flat(v).items()})
        elif isinstance(v, torch.Tensor):
            out[k] = v.detach().float().numpy().copy()
        else:
            out[k] = np.array(v, np.float32)
    return out


def _port_cache(jc, like):
    """repro's cache as the port's, copied (an in-place write must not
    reach JAX's buffers), each leaf in the port's dtype."""
    return {k: _port_cache(v, like[k]) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32)).to(like[k].dtype)
            for k, v in jc.items()}


def _close_f32(got, want, what):
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL,
                               err_msg=what)


def _forced_step(tm, step, jc_after, rows):
    """The port's ``step()`` (on its own copy of the pre-step cache) with
    every new shared K/V entry replaced by repro's (``jc_after``, repro's
    cache after the step) before it is written and attended, so no
    rounding of an earlier entry reaches a later one.  Returns (step's
    logits, cache, {(application, cache row, position): (k, v) as the
    port computed them, bf16}); local row i of the step is cache row
    ``rows[i]``."""
    want = _flat(jc_after)
    rec = {}
    rows = list(rows)
    orig = tm._linear_writer

    def writer(kv, pos, active, b, slot=None):
        attend = orig(kv, pos, active, b, slot)
        at = (pos % kv["k"].shape[2]).tolist()
        ok = [True] * b if active is None else active.tolist()

        def forced(li, q, k, v):
            k, v = k.clone(), v.clone()
            for i in range(b):
                if not ok[i]:
                    continue
                key = (li, rows[i], at[i])
                rec[key] = tuple(t[i].to(torch.bfloat16).float().numpy()
                                 for t in (k, v))
                for t, name in ((k, "shared/k"), (v, "shared/v")):
                    t[i] = torch.from_numpy(want[name][key]).to(t.dtype)
            return attend(li, q, k, v)
        return forced

    tm._linear_writer = writer
    try:
        lt, tc = step()
    finally:
        del tm._linear_writer
    return lt, tc, rec


def _held_step(lt, lj, tc, jc, rows, forced):
    """One step (decode, or a prefill chunk's) held to repro's from the
    same cache: the logits ``lt`` / ``lj`` [R, V] of cache rows ``rows``,
    and ``forced``, ``_forced_step``'s run of the same step.
    The forced run: each new shared K/V entry the port computed within
    one bf16 rounding (2^-7 of the larger) and the f32 band of repro's,
    the logits and SSM state in the f32 band.  The free run: a row whose
    new shared K/V is bit-equal to repro's is held at the f32 band in its
    logits and SSM state, a row where one rounded the other way (a flip)
    at 1e-3 (FREE_TOL); each new K/V entry with no flip before it on its
    row (an earlier position, or an earlier application at its position)
    is the forced run's, bit for bit (module docstring)."""
    lf, tf, rec = forced
    got, want, frc = _flat(tc), _flat(jc), _flat(tf)
    assert set(got) == set(want) == set(frc)
    np.testing.assert_array_equal(got["pos"], want["pos"])
    np.testing.assert_array_equal(frc["pos"], want["pos"])
    kv = ("shared/k", "shared/v")
    for key, ents in rec.items():
        for k, a in zip(kv, ents):
            b = want[k][key]
            assert np.all(np.abs(a - b) <= BF16_REL * np.maximum(
                np.abs(a), np.abs(b)) + F32_TOL), (k, key)
    flips = {key for key in rec
             if any(not np.array_equal(got[k][key], want[k][key])
                    for k in kv)}
    for g, r, p in rec:
        if not any(r2 == r and (p2 < p or (p2 == p and g2 < g))
                   for g2, r2, p2 in flips):
            for k, a in zip(kv, rec[g, r, p]):
                np.testing.assert_array_equal(got[k][g, r, p], a,
                                              err_msg=str((k, g, r, p)))
    for r, lg_t, lg_j, lg_f in zip(rows, lt, lj, lf):
        _close_f32(lg_f, lg_j, f"forced logits, row {r}")
        _close_f32(frc["mamba/ssm"][:, r], want["mamba/ssm"][:, r],
                   f"forced SSM state, row {r}")
        tol = FREE_TOL if any(r2 == r for _, r2, _ in flips) else F32_TOL
        np.testing.assert_allclose(lg_t, lg_j, atol=tol, rtol=tol)
        np.testing.assert_allclose(got["mamba/ssm"][:, r],
                                   want["mamba/ssm"][:, r], atol=tol,
                                   rtol=tol)
        diff = np.abs(got["mamba/conv"][:, r] - want["mamba/conv"][:, r])
        assert np.all(diff <= BF16_REL * np.abs(want["mamba/conv"][:, r])
                      + tol), r


def _close_leaf(key, got, want):
    """A state leaf: the SSM state in the f32 band, a bf16 one in the f32
    band plus one bf16 rounding."""
    if key == "mamba/ssm":
        _close_f32(got, want, key)
    else:
        diff = np.abs(got - want)
        assert np.all(diff <= BF16_REL * np.abs(want) + F32_TOL), \
            (key, float(diff.max()), int((diff > 0).sum()))


# -- mamba_step ---------------------------------------------------------------

def test_mamba_state_is_repros():
    """``mamba_state_shapes`` / ``init_mamba_state``: repro's shapes, the
    SSM state in f32 and the conv history in bf16 for an f32 model."""
    jm, _, tm, _ = _pair()
    want = jax_mamba.init_mamba_state(jm.cfg, 3)
    got = mamba.init_mamba_state(tm.cfg, 3, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert got["ssm"].dtype == torch.float32
    assert got["conv"].dtype == torch.bfloat16
    assert not any(v.any() for v in got.values())


def test_mamba_step_matches_repro_over_6_steps():
    """Layer 0's ``mamba_step`` run free for 6 steps on 3 rows of seeded
    inputs, f32: y and the SSM state in the f32 band, the bf16 conv
    history equal or one rounding apart, at every step."""
    jm, jp, tm, tp = _pair()
    jparams = jax.tree_util.tree_map(lambda a: a[0], jp["mamba"])
    tparams = {k: v[0] for k, v in tp["mamba"].items()}
    jst = jax_mamba.init_mamba_state(jm.cfg, 3)
    tst = mamba.init_mamba_state(tm.cfg, 3, device="cpu")
    rng = np.random.default_rng(0)
    step = jax.jit(functools.partial(jax_mamba.mamba_step, cfg=jm.cfg))
    for i in range(6):
        x = rng.standard_normal((3, tm.cfg.d_model)).astype(np.float32)
        jy, jst = step(jparams, jnp.asarray(x), jst)
        ty = mamba.mamba_step(tparams, torch.from_numpy(x), tst, tm.cfg)
        _close_f32(ty.numpy(), np.asarray(jy), f"y, step {i}")
        _close_leaf("mamba/ssm", tst["ssm"].numpy(),
                    np.asarray(jst["ssm"]))
        _close_leaf("mamba/conv", tst["conv"].float().numpy(),
                    np.asarray(jst["conv"], np.float32))
    assert tst["conv"].dtype == torch.bfloat16


# -- the cache and the decode step -------------------------------------------

@pytest.mark.parametrize("max_len", [32, 70_000])
def test_cache_tree_is_repros(max_len):
    """``cache_shapes``: repro's hybrid tree (pos, the stacked Mamba state,
    one ring a shared application) and dtypes; past 65,536 positions the
    ring is min(max_len, 4096), below it max_len."""
    jm, _, tm, _ = _pair()
    want = jax.eval_shape(lambda: jm.init_cache(3, max_len))
    got = tm.cache_shapes(3, max_len)
    flat_want = {"/".join(str(k.key) for k in path):
                 (tuple(leaf.shape), str(leaf.dtype))
                 for path, leaf in
                 jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_got = {}
    for k, v in got.items():
        items = v.items() if isinstance(v, dict) else [(None, v)]
        for n, (shape, dt) in items:
            flat_got[k if n is None else f"{k}/{n}"] = (
                tuple(shape), str(dt).replace("torch.", ""))
    assert flat_got == flat_want
    assert flat_got["shared/k"][0][2] == (4096 if max_len > 65536
                                          else max_len)


def test_decode_step_matches_repro_step_by_step():
    """6 decode steps on 3 slots of a 32-position cache, row 1 inactive
    for the first 2 and row 2 every third step; each step starts both
    sides from the same cache (repro's, copied): the logits and every
    leaf by ``_held_step``'s rule.  An inactive row keeps its position
    and K/V, and its Mamba state churns, as in repro."""
    jm, jp, tm, tp = _pair()
    step = _jax_step()
    like = tm.init_cache(3, 32, device="cpu")
    jc = jm.init_cache(3, 32)
    rng = np.random.default_rng(1)
    for i in range(6):
        toks = rng.integers(0, tm.cfg.vocab, 3)
        act = np.array([True, i >= 2, i % 3 != 0])
        tc, tf = _port_cache(jc, like), _port_cache(jc, like)
        before = _flat(tc)
        lj, jc = step(jp, jc, jnp.asarray(toks), active=jnp.asarray(act))
        lt, tc = tm.decode_step(tp, tc, torch.from_numpy(toks),
                                active=torch.from_numpy(act))
        lf, tf, rec = _forced_step(tm, lambda: tm.decode_step(
            tp, tf, torch.from_numpy(toks), active=torch.from_numpy(act)),
            jc, range(3))
        _held_step(lt.numpy(), np.asarray(lj), tc, jc, range(3),
                   (lf.numpy(), tf, rec))
        got = _flat(tc)
        for r in np.nonzero(~act)[0]:
            assert got["pos"][r] == before["pos"][r]
            for k in ("shared/k", "shared/v"):
                np.testing.assert_array_equal(got[k][:, r], before[k][:, r])
            assert not np.array_equal(got["mamba/ssm"][:, r],
                                      before["mamba/ssm"][:, r])
    assert _flat(jc)["pos"].tolist() == [6, 4, 4]


def test_free_running_decode_stays_near_repro():
    """8 decode steps run free on both sides from zero caches: the
    logits stay within 1e-3 (one bf16 rounding apart in a state leaf
    moves them by up to ~5e-4 here), the positions are equal."""
    jm, jp, tm, tp = _pair()
    step = _jax_step()
    jc, tc = jm.init_cache(3, 32), tm.init_cache(3, 32, device="cpu")
    rng = np.random.default_rng(0)
    worst = 0.0
    for i in range(8):
        toks = rng.integers(0, tm.cfg.vocab, 3)
        act = np.array([True, i >= 2, i % 3 != 0])
        lj, jc = step(jp, jc, jnp.asarray(toks), active=jnp.asarray(act))
        lt, tc = tm.decode_step(tp, tc, torch.from_numpy(toks),
                                active=torch.from_numpy(act))
        worst = max(worst, float(np.abs(lt.numpy() - np.asarray(lj)).max()))
    assert worst < 1e-3
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_scan_prefill_chunk_matches_repro():
    """Two chunks of 8 into slot 1 of 3 (10 valid tokens: 8, then 2 of a
    padded chunk), each from the same cache on both sides: the last
    valid token's logits in the f32 band, every leaf by its rule, the
    other slots' rows untouched.  ``impl="parallel"`` raises on both."""
    jm, jp, tm, tp = _pair()
    like = tm.init_cache(3, 32, device="cpu")
    jc = jm.init_cache(3, 32)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, tm.cfg.vocab, 10)
    chunks = [(toks[:8], 8), (np.pad(toks[8:], (0, 6)), 2)]
    prefill = jax.jit(jm.prefill_chunk, static_argnums=(3, 4))
    for chunk, nv in chunks:
        tc, tf = _port_cache(jc, like), _port_cache(jc, like)
        before = _flat(tc)
        lj, jc = prefill(jp, jc, jnp.asarray(chunk), 1, nv)
        lt, tc = tm.prefill_chunk(tp, tc, torch.from_numpy(chunk), 1, nv)
        lf, tf, rec = _forced_step(tm, lambda: tm.prefill_chunk(
            tp, tf, torch.from_numpy(chunk), 1, nv), jc, [1])
        _held_step(lt[None].numpy(), np.asarray(lj)[None], tc, jc, [1],
                   (lf[None].numpy(), tf, rec))
        got = _flat(tc)
        for k in got:
            if k != "pos":
                for r in (0, 2):
                    np.testing.assert_array_equal(got[k][:, r],
                                                  before[k][:, r])
    assert got["pos"].tolist() == [0, 10, 0]
    with pytest.raises(ValueError, match="recurrent state"):
        tm.prefill_chunk(tp, tc, torch.from_numpy(toks[:8]), 0, 8,
                         impl="parallel")
    with pytest.raises(ValueError, match="recurrent state"):
        jm.prefill_chunk(jp, jc, jnp.asarray(toks[:8]), 0, 8,
                         impl="parallel")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_stepwise_decode_matches_the_forward(dtype):
    """repro's consistency test on the port alone (tests/test_models.py):
    8 tokens decoded one at a time against the parallel forward, at
    repro's band; in f32 at the measured gap's band."""
    _, _, tm, tp = _pair(dtype)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tm.cfg.vocab, (2, 8)))
    with torch.no_grad():
        full, _ = tm.forward(tp, toks)
    cache = tm.init_cache(2, 16, device="cpu")
    outs = []
    for i in range(8):
        lg, cache = tm.decode_step(tp, cache, toks[:, i])
        outs.append(lg)
    got = torch.stack(outs, 1).float().numpy()
    want = full.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=STEPWISE_BAND,
                                   atol=STEPWISE_BAND)
    else:
        assert float(np.abs(got - want).max()) < F32_STEPWISE


# -- the Server --------------------------------------------------------------

PROMPT_LENS = (5, 19, 12, 9)


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, size=n).tolist() for n in PROMPT_LENS]


def _serve(srv, prompts, gen=10):
    rids = [srv.submit(p, max_new_tokens=gen) for p in prompts]
    res = srv.run()
    return ([res[r] for r in rids], dict(srv.finished),
            (srv.prefill_dispatches, srv.decode_dispatches,
             srv.verify_dispatches))


@pytest.mark.parametrize("spec_k", [1, 4])
def test_server_matches_repro(spec_k):
    """Both packages' Server on the same f32 weights: 2 slots x 48, chunks
    of 8, 4 requests of 5-19 prompt tokens and 10 greedy tokens each, so
    both slots are reused after a request retires (reset_slot must leave
    no stale state: a reused slot's stream equals the one it gives alone).
    spec_k 4 drafts 4 tokens a round and accepts them with no re-score,
    as repro does.  Streams, retire reasons and the dispatch counters are
    equal."""
    jm, jp, tm, tp = _pair()
    prompts = _prompts()
    want = _serve(JaxServer(jm, jp, JaxServeConfig(
        slots=2, max_len=48, prefill_chunk=8, spec_k=spec_k)), prompts)
    ops.reset_plain_calls()
    got = _serve(Server(tm, tp, ServeConfig(
        slots=2, max_len=48, prefill_chunk=8, spec_k=spec_k)), prompts)
    assert got == want
    assert got[2][2] == 0                    # no re-score
    assert all(len(s) == 10 for s in got[0])
    # every decode step (spec_k a round) and every prompt token (a batch-1
    # scan step) calls the decode kernel (here its plain version) once a
    # shared application; nothing else runs attention
    n_shared = tm.cfg.n_layers // tm.cfg.attn_every
    steps = got[2][1] * spec_k + sum(PROMPT_LENS)
    assert ops.plain_calls["flash_attention_decode_ref"] == n_shared * steps
    assert ops.plain_calls["flash_attention_fwd_ref"] == 0
    # the last request, admitted into a reused slot, alone on a fresh pool
    alone = _serve(Server(tm, tp, ServeConfig(
        slots=2, max_len=48, prefill_chunk=8, spec_k=spec_k)), prompts[-1:])
    assert alone[0][0] == got[0][-1]


def test_paged_and_rescore_are_refused_as_in_repro():
    """The hybrid family has no paged tier (``paged_ok`` is false: repro's
    message, on both) and no speculative re-score."""
    jm, jp, tm, tp = _pair()
    for cls, cfg_cls, m, p in ((JaxServer, JaxServeConfig, jm, jp),
                               (Server, ServeConfig, tm, tp)):
        with pytest.raises(ValueError, match="paged KV cache unsupported"):
            cls(m, p, cfg_cls(slots=2, max_len=32, paged=True))
    cache = tm.init_cache(2, 32, device="cpu")
    with pytest.raises(ValueError, match="re-score unsupported"):
        tm.decode_rescore(tp, cache, torch.zeros(2, dtype=torch.long),
                          torch.arange(2), torch.zeros(2, dtype=torch.long))


def test_launch_serve_hybrid_on_cpu(tmp_path):
    """``python -m repro_torch.launch.serve --arch zamba2-2.7b --reduced
    --device cpu`` serves one request a slot and writes its record;
    ``--paged`` is refused with repro's message."""
    out = tmp_path / "r.json"
    assert launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                              "--prompt-len", "12", "--gen", "6",
                              "--json-out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["meta"]["arch"] == ARCH
    assert rec["requests"] == 4 and rec["generated_tokens"] == 24
    with pytest.raises(ValueError, match="paged KV cache unsupported"):
        launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--paged"])
