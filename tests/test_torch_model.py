"""The port's dense LM (src/repro_torch/models) against repro's LM on the
same weights.

repro's ``LM(cfg).init(PRNGKey(0))`` tree goes through
``repro_torch.convert.params_from_jax``; both models then see the same
seeded numpy inputs, on the CPU (repro's XLA path, the port's plain
versions).  Bands, max-abs over logits:
  f32 configs: 1e-3 -- the arithmetic is the same up to summation order,
               but the KV cache is bf16 in both, so a K/V written from
               slightly different f32 values can round to a neighbouring
               bf16 value;
  bf16 configs: 0.25 -- repro's LOGITS_ATOL (verify/numerics.py) for bf16
               logits of one model computed two ways.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")     # the card's machine has no JAX
jnp = jax.numpy

from repro.configs import get_arch as jax_arch
from repro.models.common import rms_norm as jax_rms_norm
from repro.models.common import rope as jax_rope
from repro.models.model import LM as JaxLM
from repro.verify.numerics import LOGITS_ATOL
from repro_torch.configs import MoECfg
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.models.common import rms_norm, rope
from repro_torch.models.model import LM

ARCHS = ["qwen2-1.5b", "llama3.2-3b", "h2o-danube-3-4b", "qwen2.5-32b"]
DTYPES = ["float32", "bfloat16"]
BAND = {"float32": 1e-3, "bfloat16": LOGITS_ATOL}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    arch, dtype = request.param
    jcfg = dataclasses.replace(jax_arch(arch).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_arch(arch).reduced(), dtype=dtype)
    jm = JaxLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(_np_tree(jp), tcfg, device="cpu")
    return jm, jp, LM(tcfg), tp, BAND[dtype]


def _maxdiff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - b.float().numpy())))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_identical(arch):
    cfg = get_arch(arch).reduced()
    jp = _np_tree(JaxLM(jax_arch(arch).reduced()).init(jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, cfg, device="cpu")
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    flat_t = {}

    def walk(t, path):
        for k, v in t.items():
            walk(v, path + (k,)) if isinstance(v, dict) else \
                flat_t.__setitem__(path + (k,), v)
    walk(tp, ())
    keys_j = {tuple(p.key for p in path) for path in flat_j}
    assert keys_j == set(flat_t)
    for path, a in flat_j.items():
        t = flat_t[tuple(p.key for p in path)]
        assert tuple(t.shape) == a.shape
        assert str(t.dtype).split(".")[-1] == a.dtype.name
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_repro(arch):
    """The port's own random init has repro's keys, shapes and dtypes."""
    shapes_j = jax.eval_shape(JaxLM(jax_arch(arch).reduced()).init,
                              jax.random.PRNGKey(0))
    tp = LM(get_arch(arch).reduced()).init(0, device="cpu")
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), tp)
    want = jax.tree_util.tree_map(lambda s: (s.shape, s.dtype.name),
                                  shapes_j)
    assert got == want


def test_convert_rejects_mismatched_tree():
    cfg = get_arch("qwen2-1.5b").reduced()
    jp = _np_tree(JaxLM(jax_arch("qwen2-1.5b").reduced()).init(
        jax.random.PRNGKey(0)))
    del jp["layers"]["attn"]["bq"]
    with pytest.raises(KeyError):
        params_from_jax(jp, cfg, device="cpu")
    jp = _np_tree(JaxLM(jax_arch("llama3.2-3b").reduced()).init(
        jax.random.PRNGKey(0)))
    with pytest.raises((KeyError, ValueError)):
        params_from_jax(jp, cfg, device="cpu")


def test_rope_and_rms_norm_match_repro_f32():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 5))
    a = jax_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    b = rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-6,
                               rtol=2e-6)
    g = rng.standard_normal(16).astype(np.float32)
    a = jax_rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5)
    b = rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                               rtol=1e-6)


def test_forward_logits(pair):
    jm, jp, tm, tp, band = pair
    toks = np.random.default_rng(0).integers(0, jm.cfg.vocab, (2, 11))
    lj, _ = jm.forward(jp, jnp.asarray(toks))
    lt, _ = tm.forward(tp, torch.from_numpy(toks))
    assert _maxdiff(lj, lt) <= band


def test_decode_steps_with_active_mask(pair):
    jm, jp, tm, tp, band = pair
    jc, tc = jm.init_cache(3, 16), tm.init_cache(3, 16, device="cpu")
    rng = np.random.default_rng(1)
    for step in range(6):
        toks = rng.integers(0, jm.cfg.vocab, 3)
        act = np.array([True, step % 2 == 0, step < 3])
        lj, jc = jm.decode_step(jp, jc, jnp.asarray(toks),
                                active=jnp.asarray(act))
        lt, tc = tm.decode_step(tp, tc, torch.from_numpy(toks),
                                active=torch.from_numpy(act))
        assert _maxdiff(lj, lt) <= band, step
    np.testing.assert_array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())
    # inactive rows wrote nothing past their position
    k = tc["kv"]["k"]
    assert not k[:, 2, 3:].any() and not k[:, 1, 3:].any()


@pytest.mark.parametrize("impl", ["parallel", "scan"])
def test_prefill_chunk(pair, impl):
    """Two chunks into slot 1 of a 12-slot cache; the second chunk's
    padded tail reaches past max_len (positions 12..15 are dropped).  A
    sliding-window config (a ring cache) has no parallel prefill: both
    packages refuse it."""
    jm, jp, tm, tp, band = pair
    jc, tc = jm.init_cache(2, 12), tm.init_cache(2, 12, device="cpu")
    rng = np.random.default_rng(2)
    if impl == "parallel" and jm.cfg.swa_window:
        chunk = rng.integers(0, jm.cfg.vocab, 8)
        with pytest.raises(ValueError, match="parallel prefill"):
            jm.prefill_chunk(jp, jc, jnp.asarray(chunk), 1, 8, impl=impl)
        with pytest.raises(ValueError, match="parallel prefill"):
            tm.prefill_chunk(tp, tc, torch.from_numpy(chunk), 1, 8,
                             impl=impl)
        return
    for n_valid in (8, 3):
        chunk = rng.integers(0, jm.cfg.vocab, 8)
        lj, jc = jm.prefill_chunk(jp, jc, jnp.asarray(chunk), 1, n_valid,
                                  impl=impl)
        lt, tc = tm.prefill_chunk(tp, tc, torch.from_numpy(chunk), 1,
                                  n_valid, impl=impl)
        assert _maxdiff(lj, lt) <= band
    np.testing.assert_array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())
    for name in ("k", "v"):
        kj = np.asarray(jc["kv"][name], np.float32)[:, :, :11]
        kt = tc["kv"][name].float().numpy()[:, :, :11]
        # bf16 cache entries of O(1) values; in the bf16 model the
        # projections themselves round differently, hence the wider band
        np.testing.assert_allclose(kt, kj, atol=max(band, 0.05))
        assert not tc["kv"][name][:, 0].any()     # slot 0 untouched


def test_reset_slot_zeroes_only_that_row():
    cfg = get_arch("qwen2-1.5b").reduced()
    tm = LM(cfg)
    tp = tm.init(0, device="cpu")
    cache = tm.init_cache(3, 16, device="cpu")
    for slot in (0, 1):
        tm.prefill_chunk(tp, cache, torch.arange(1, 7), slot, 6)
    before = cache["kv"]["k"].clone()
    tm.reset_slot(cache, 1)
    assert not cache["kv"]["k"][:, 1].any()
    torch.testing.assert_close(cache["kv"]["k"][:, 0], before[:, 0])
    assert cache["pos"].tolist() == [6, 0, 0]


def _port_cfg(jcfg):
    """repro's config as the port's ArchConfig (the port registers only
    the configs it runs), field for field."""
    from repro_torch.configs import ArchConfig, SSMCfg, XLSTMCfg
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(ArchConfig)}
    for key, cls in (("moe", MoECfg), ("ssm", SSMCfg), ("xlstm", XLSTMCfg)):
        if kw[key] is not None:
            kw[key] = cls(**dataclasses.asdict(kw[key]))
    return ArchConfig(**kw)


def test_unported_families_raise():
    """What stays refused: the embedding-stub frontends (VLM, audio), and a
    config that sets both the hybrid layout and xlstm (repro takes its
    hybrid branch first for it; no config has one, and it is not held to
    repro).  xlstm-125m, a pure SSM config (zamba2's widths, family "ssm",
    no shared block) and the MoE family are built."""
    cfg = get_arch("qwen2-1.5b").reduced()
    for name in ("internvl2-76b", "musicgen-large"):
        with pytest.raises(NotImplementedError, match="embed-stub"):
            LM(_port_cfg(jax_arch(name)))
    with pytest.raises(NotImplementedError, match="embed-stub"):
        LM(dataclasses.replace(cfg, embed_stub=True))
    hybrid = _port_cfg(jax_arch("zamba2-2.7b"))
    with pytest.raises(NotImplementedError, match="hybrid-xlstm"):
        LM(dataclasses.replace(hybrid, xlstm=_port_cfg(
            jax_arch("xlstm-125m")).xlstm))
    xl = LM(_port_cfg(jax_arch("xlstm-125m"))).param_shapes()
    assert {"slstm", "mlstm"} <= set(xl) and "layers" not in xl
    pure_ssm = dataclasses.replace(hybrid, family="ssm", attn_every=0)
    ps = LM(pure_ssm).param_shapes()
    assert "mamba" in ps and "shared" not in ps
    moe = dataclasses.replace(cfg, family="moe", moe=MoECfg(4, 2, 64))
    assert "moe" in LM(moe).param_shapes()["layers"]
    for name in ("moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b",
                 "qwen2.5-32b"):
        LM(get_arch(name))


def test_moe_plan_cutting_more_than_experts_raises():
    """The MoE layer runs whole rows on whole experts: a plan cutting the
    experts' hidden dim (``e_ff``) or the router is refused; the plan
    ``normalize_moe_plan`` pins is accepted."""
    from repro_torch.core.plan import manual_megatron_plan
    from repro_torch.launch.compile import normalize_moe_plan
    cfg = get_arch("moonshot-v1-16b-a3b")
    plan = manual_megatron_plan(("data", "model"), ["data"], "model")
    LM(cfg, plan=plan)
    for role in ("moe_up", "moe_down"):
        with pytest.raises(ValueError, match=role):
            LM(cfg, plan=plan.with_override(role, {"data": None,
                                                   "model": "e_ff"}))
    with pytest.raises(ValueError, match="moe_gate"):
        LM(cfg, plan=plan.with_override("moe_gate", {"data": "d_model",
                                                     "model": None}))
    bad = plan.with_override("moe_up", {"data": "d_model", "model": "e_ff"})
    fixed = normalize_moe_plan(bad, cfg)
    assert fixed.role_cuts["moe_up"] == {"data": None, "model": "expert"}
    LM(cfg, plan=fixed)


def test_entry_points_default_to_the_card():
    """init and init_cache run on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    tm = LM(get_arch("qwen2-1.5b").reduced())
    with pytest.raises(RuntimeError, match="cuda"):
        tm.init(0)
    with pytest.raises(RuntimeError, match="cuda"):
        tm.init_cache(1, 8)
