"""The port's MoE layer (src/repro_torch/models/moe.py) and its MoE models
(the MoE branch of models/model.py) against repro on the CPU.

The layer: ``_capacity`` equal to repro's over a grid of (tokens,
experts, top-k, capacity factor); ``moe_ffn`` on the same f32 inputs and
weights as repro's, at a capacity that keeps every choice and at ones
that drop (``capacity_factor`` 0.25, as tests/test_moe_routing.py, and
16 experts at 1.0): y and aux within 1e-5, the keep mask equal to the
one repro's routing lines compute, the four params' grads within 1e-4.
The models: the reduced moonshot-v1-16b-a3b and phi3.5-moe-42b-a6.6b
(4 experts, top-2) from repro's ``init`` through ``params_from_jax``:
forward logits, loss and every param's grad within 1e-4 in f32 and the
0.25 band in bf16 (repro's LOGITS_ATOL); decode steps and prefill chunks
within tests/test_torch_model.py's bands (1e-3 in f32: the bf16 KV
cache)."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")     # the card's machine has no JAX
jnp = jax.numpy

from repro.configs import get_arch as jax_arch
from repro.models import moe as jax_moe
from repro.models.model import LM as JaxLM
from repro.verify.numerics import LOGITS_ATOL
from repro_torch.configs import MoECfg, get_arch
from repro_torch.convert import params_from_jax
from repro_torch.models import moe
from repro_torch.models.model import LM

ARCHS = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"]
DTYPES = ["float32", "bfloat16"]
LAYER_ATOL = 1e-5
LAYER_GRAD_ATOL = 1e-4
BAND = {"float32": 1e-4, "bfloat16": LOGITS_ATOL}
SERVE_BAND = {"float32": 1e-3, "bfloat16": LOGITS_ATOL}
BF16_GRAD_REL = 8 * 2.0 ** -7
# (experts, top-k, capacity factor) of the layer cases: 60 tokens keep
# every choice at 8.0; at 0.25 the capacity is 8 of ~30 choices an
# expert, at 1.0 over 16 experts 15 of ~15
LAYER_CASES = {"keep": (4, 2, 8.0), "drop": (4, 2, 0.25),
               "drop16": (16, 4, 1.0)}


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny CPU ops run far faster on one intra-op thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype, moe_cfg=None):
    jcfg = dataclasses.replace(jax_arch(arch).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_arch(arch).reduced(), dtype=dtype)
    if moe_cfg is not None:
        e, k, cf = moe_cfg
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, n_experts=e, top_k=k, capacity_factor=cf))
        tcfg = dataclasses.replace(tcfg, moe=MoECfg(e, k, 64, cf))
    return jcfg, tcfg


@pytest.mark.parametrize("factor", [0.25, 1.0, 1.25, 8.0])
def test_capacity_matches_repro(factor):
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b", "float32")
    for tokens in (1, 7, 8, 9, 48, 60, 256, 1000, 4096, 8192):
        for e in (4, 16, 64):
            for k in (1, 2, 6):
                j = dataclasses.replace(jcfg, moe=dataclasses.replace(
                    jcfg.moe, n_experts=e, top_k=k, capacity_factor=factor))
                t = dataclasses.replace(tcfg, moe=MoECfg(e, k, 64, factor))
                assert moe._capacity(tokens, t) == \
                    jax_moe._capacity(tokens, j), (tokens, e, k)


def _jax_keep(p, x, cfg):
    """repro's keep mask (models/moe.py's routing lines, evaluated in JAX
    on repro's own ops: repro's ``moe_ffn`` does not return it)."""
    m = cfg.moe
    t = x.shape[0] * x.shape[1]
    xf = x.reshape(t, -1)
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], -1)
    _, eid = jax.lax.top_k(probs, m.top_k)
    flat_e = eid.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = jnp.searchsorted(sorted_e, jnp.arange(m.n_experts))
    ranks_sorted = jnp.arange(t * m.top_k) - starts[sorted_e]
    rank = jnp.zeros_like(ranks_sorted).at[order].set(ranks_sorted)
    return np.asarray(rank < jax_moe._capacity(t, cfg))


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_ffn_matches_repro(case):
    """y, aux and keep on the same f32 weights and tokens; the grads of
    router, w_gate, w_up and w_down of a weighted sum of y plus aux."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b", "float32", LAYER_CASES[case])
    jp = jax_moe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 20, 64)).astype(np.float32)
    w = rng.standard_normal((3, 20, 64)).astype(np.float32)
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in jp.items()}
    yj, aj = jax.jit(jax_moe.moe_ffn, static_argnums=2)(
        jp, jnp.asarray(x), jcfg)
    yt, at = moe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               atol=LAYER_ATOL, rtol=0)
    assert abs(float(at.detach()) - float(aj)) <= LAYER_ATOL
    cap = moe._capacity(60, tcfg)
    _, keep, dest, _ = moe.route(torch.from_numpy(x).reshape(60, 64),
                                 tp["router"], tcfg, cap)
    want = _jax_keep(jp, jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(keep.numpy(), want)
    assert (case == "keep") == bool(want.all())
    e = tcfg.moe.n_experts
    assert torch.equal(dest == e * cap, ~keep)

    def jloss(p):
        y, a = jax_moe.moe_ffn(p, jnp.asarray(x), jcfg)
        return jnp.sum(y * w) + a
    gj = jax.jit(jax.grad(jloss))(jp)
    y, a = moe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    gt = torch.autograd.grad((y * torch.from_numpy(w)).sum() + a,
                             list(tp.values()))
    for (k, _), g in zip(tp.items(), gt):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj[k]),
                                   atol=LAYER_GRAD_ATOL, rtol=0, err_msg=k)


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    arch, dtype = request.param
    jcfg, tcfg = _cfgs(arch, dtype)
    jm = JaxLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    return jm, jp, LM(tcfg), tp, dtype


def _maxdiff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - b.detach().float().numpy())))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_repro(arch):
    """The port's own random init has repro's keys, shapes and dtypes
    (the router f32, the experts [L, E, d, f] / [L, E, f, d])."""
    shapes_j = jax.eval_shape(JaxLM(jax_arch(arch).reduced()).init,
                              jax.random.PRNGKey(0))
    tp = LM(get_arch(arch).reduced()).init(0, device="cpu")
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), tp)
    want = jax.tree_util.tree_map(lambda s: (s.shape, s.dtype.name),
                                  shapes_j)
    assert got == want
    # fan-in d for the router, w_gate and w_up, d_ff_expert for w_down
    cfg = get_arch(arch).reduced()
    for k, fan in (("router", cfg.d_model), ("w_gate", cfg.d_model),
                   ("w_up", cfg.d_model), ("w_down", cfg.moe.d_ff_expert)):
        std = float(tp["layers"]["moe"][k].float().std())
        assert abs(std * fan ** 0.5 - 1) < 0.1, (k, std)


def test_forward_loss_and_grads(pair):
    """Logits and aux of the forward, the loss, and every param's grad
    (repro's ``jax.grad`` of its loss, remat and all)."""
    jm, jp, tm, tp, dtype = pair
    band = BAND[dtype]
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jm.cfg.vocab, (2, 11))
    labels = rng.integers(0, jm.cfg.vocab, (2, 11))
    lj, aj = jax.jit(jm.forward)(jp, jnp.asarray(toks))
    lt, at = tm.forward(tp, torch.from_numpy(toks))
    assert _maxdiff(lj, lt) <= band
    assert abs(float(aj) - float(at)) <= band
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    loss_j, gj = jax.jit(jax.value_and_grad(jm.loss))(jp, jbatch)
    leaves = [p.requires_grad_(True) for p in jax.tree_util.tree_leaves(tp)]
    loss_t = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                          "labels": torch.from_numpy(labels)})
    gt = torch.autograd.grad(loss_t, leaves)
    assert abs(float(loss_j) - float(loss_t.detach())) <= band
    flat_j = jax.tree_util.tree_leaves_with_path(gj)
    assert len(flat_j) == len(gt)
    for (path, g_j), g_t in zip(flat_j, gt):
        d = _maxdiff(g_j, g_t)
        assert d <= band, jax.tree_util.keystr(path)
        if dtype == "bfloat16":
            # the reduced model's grads are far below the absolute band,
            # so each leaf is also held to 8 bf16 eps of its largest |g|
            # (a zero or wrong grad is off by ~1 of it)
            top = float(np.max(np.abs(np.asarray(g_j, np.float32))))
            assert d <= BF16_GRAD_REL * top, jax.tree_util.keystr(path)


def test_decode_and_prefill_match_repro(pair):
    """Two prefill chunks into slot 1 of a 3-slot cache (the second's
    padded tail routed with it), then decode steps of all 3 rows with
    inactive ones (routed too), as repro routes them."""
    jm, jp, tm, tp, dtype = pair
    band = SERVE_BAND[dtype]
    jc, tc = jm.init_cache(3, 24), tm.init_cache(3, 24, device="cpu")
    rng = np.random.default_rng(2)
    for n_valid in (8, 3):
        chunk = rng.integers(0, jm.cfg.vocab, 8)
        lj, jc = jm.prefill_chunk(jp, jc, jnp.asarray(chunk), 1, n_valid)
        lt, tc = tm.prefill_chunk(tp, tc, torch.from_numpy(chunk), 1,
                                  n_valid)
        assert _maxdiff(lj, lt) <= band
    for step in range(4):
        toks = rng.integers(0, jm.cfg.vocab, 3)
        act = np.array([step % 2 == 0, True, step < 2])
        lj, jc = jm.decode_step(jp, jc, jnp.asarray(toks),
                                active=jnp.asarray(act))
        lt, tc = tm.decode_step(tp, tc, torch.from_numpy(toks),
                                active=torch.from_numpy(act))
        assert _maxdiff(lj, lt) <= band, step
    np.testing.assert_array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_identical(arch):
    cfg = get_arch(arch).reduced()
    jp = jax.tree_util.tree_map(
        np.asarray, JaxLM(jax_arch(arch).reduced()).init(
            jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, cfg, device="cpu")
    for path, a in jax.tree_util.tree_leaves_with_path(jp):
        t = tp
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32))
