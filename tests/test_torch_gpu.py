"""The port's CUDA kernels and its serving path on the card.

Every test here is marked ``gpu`` and needs a CUDA card; the fixture
decides whether one is present, so every pytest worker collects the same
tests and without a card they skip.  Run them on the card with

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_*.py

This file imports no JAX (the card's machine has none).  Tolerances:
bf16 outputs of a kernel and its plain version are the same f32 result
summed in another order, rounded to bf16 (ulp 2^-7 relative), so they
agree to 1e-2 x max(1, |o|); the f32 logsumexp to 1e-3; logits of the
bf16 model on the card against the CPU to 0.25 (repro's LOGITS_ATOL).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import LM
from repro_torch.runtime.serve import ServeConfig, Server

pytestmark = pytest.mark.gpu
LOGITS_ATOL = 0.25


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rel_err(out, want):
    d = (out.float() - want.float()).abs()
    return float((d / want.float().abs().clamp(min=1.0)).max())


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.parametrize("q_offset,window,hd", [
    (0, None, 128), (768, None, 128), (1900, None, 128), (0, 128, 128),
    (30, None, 16), (5, 9, 64)])
def test_fwd_kernel_matches_plain(cuda, q_offset, window, hd):
    g = torch.Generator(device=cuda).manual_seed(q_offset + hd)
    sq, sk, h, kv = (256, 2048, 12, 2) if hd == 128 else (40, 64, 4, 1)
    if window:
        sq = sk = 512 if hd == 128 else 64

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).bfloat16()

    q, k, v = rnd(1, sq, h, hd), rnd(1, sk, kv, hd), rnd(1, sk, kv, hd)
    off = torch.tensor([q_offset], dtype=torch.int32, device=cuda)
    before = fa.launches["flash_fwd"]
    o, lse = ops.flash_attention_fwd(q, k, v, window=window, q_offset=off)
    assert fa.launches["flash_fwd"] == before + 1
    o_r, lse_r = ref.flash_attention_fwd_ref(q, k, v, window=window,
                                             q_offset=q_offset)
    assert _rel_err(o, o_r) <= 1e-2
    assert float((lse - lse_r).abs().max()) <= 1e-3


@pytest.mark.parametrize("window,hd", [(None, 128), (256, 128), (7, 16)])
def test_decode_kernel_matches_plain(cuda, window, hd):
    g = torch.Generator(device=cuda).manual_seed(1)
    b, s, h, kv = (16, 2048, 12, 2) if hd == 128 else (4, 64, 4, 1)
    q = torch.randn(b, h, hd, generator=g, device=cuda).bfloat16()
    kc = torch.randn(b, s, kv, hd, generator=g, device=cuda).bfloat16()
    vc = torch.randn(b, s, kv, hd, generator=g, device=cuda).bfloat16()
    ln = np.random.default_rng(0).integers(1, s + 1, size=b)
    ln[0], ln[-1] = 1, s
    lengths = torch.tensor(ln, dtype=torch.int32, device=cuda)
    before = fa.launches["flash_decode"]
    o = ops.flash_attention_decode(q, kc, vc, lengths, window=window)
    assert fa.launches["flash_decode"] == before + 1
    o_r = ref.flash_attention_decode_ref(q, kc, vc, lengths, window=window)
    assert _rel_err(o, o_r) <= 1e-2


def _paged_case(dev, b, h, kv, hd, bl, mb, lengths, seed=0):
    """Pools with each row's blocks scattered over a shuffled pool (rows
    0 and 1 share their first block), table entries past a row's blocks
    on the null block 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    nb = b * mb + 1
    q = torch.randn(b, h, hd, generator=g, device=dev).bfloat16()
    kp = torch.randn(nb, bl, kv, hd, generator=g, device=dev).bfloat16()
    vp = torch.randn(nb, bl, kv, hd, generator=g, device=dev).bfloat16()
    perm = np.random.default_rng(seed).permutation(nb - 1) + 1
    table = np.zeros((b, mb), np.int32)
    for r, n in enumerate(lengths):
        owned = -(-int(n) // bl)
        table[r, :owned] = perm[r * mb:r * mb + owned]
    if b > 1 and min(lengths[:2]) > 0:
        table[1, 0] = table[0, 0]
    return (q, kp, vp, torch.tensor(table, device=dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("b,h,kv,hd,bl,mb", [
    (16, 12, 2, 128, 16, 128), (4, 4, 1, 16, 8, 8), (3, 8, 2, 64, 48, 4)])
def test_paged_decode_kernel_matches_plain(cuda, b, h, kv, hd, bl, mb):
    """Within one bf16 ulp of the plain version, bit-equal to
    flash_decode on the gathered view, and blind to poison (1e9, NaN)
    in every block the rows do not own, block 0 included."""
    rng = np.random.default_rng(b)
    lengths = rng.integers(1, mb * bl + 1, size=b)
    lengths[0], lengths[-1] = 0, mb * bl - 5          # empty and ragged
    q, kp, vp, table, ln = _paged_case(cuda, b, h, kv, hd, bl, mb,
                                       lengths.tolist())
    before = fa.launches["flash_paged_decode"]
    o = ops.flash_attention_paged_decode(q, kp, vp, table, ln)
    assert fa.launches["flash_paged_decode"] == before + 1
    o_r = ref.flash_attention_paged_decode_ref(q, kp, vp, table, ln)
    assert _rel_err(o, o_r) <= 1e-2
    assert float(o[0].float().abs().max()) == 0.0      # length 0 -> zeros
    view = [p[table.long()].reshape(b, mb * bl, kv, hd) for p in (kp, vp)]
    assert torch.equal(o, fa.flash_attention_decode(q, *view, ln))
    owned = set(table.flatten().tolist()) - {0}
    for poison in (1e9, float("nan")):
        dk, dv = kp.clone(), vp.clone()
        for blk in range(kp.shape[0]):
            if blk not in owned:
                dk[blk] = poison
                dv[blk] = poison
        assert torch.equal(
            fa.flash_attention_paged_decode(q, dk, dv, table, ln), o)


def test_paged_server_on_card_uses_only_the_kernels(cuda):
    cfg = get_arch("qwen2-1.5b").reduced()
    model = LM(cfg)
    params = model.init(0, device=cuda)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, 11).tolist() for _ in range(4)]
    lin = Server(model, params, ServeConfig(slots=2, max_len=48,
                                            prefill_chunk=8))
    for p in prompts:
        lin.submit(p, 30)
    want = lin.run()
    srv = Server(model, params, ServeConfig(slots=2, max_len=48,
                                            prefill_chunk=8, paged=True,
                                            block_len=8, n_blocks=7,
                                            spec_k=3))
    fa.reset_launches()
    ops.reset_plain_calls()
    for p in prompts:
        srv.submit(p, 30)
    assert srv.run() == want
    assert srv.preemptions > 0 and srv.verify_dispatches > 0
    assert fa.launches["flash_decode"] == 0
    assert fa.launches["flash_paged_decode"] > 0
    assert not any(ops.plain_calls.values())


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", [
    (2, 1000, 12, 2, 128, True, None), (1, 256, 12, 12, 128, False, None),
    (1, 512, 12, 2, 128, True, 128), (2, 100, 8, 2, 64, False, 50),
    (2, 33, 4, 1, 16, True, 9)])
def test_bwd_kernels_match_plain(cuda, b, s, h, kv, hd, causal, window):
    """dq, dk, dv of the CUDA backward against flash_attention_bwd_ref, at
    1e-2 x max(1, |ref|): the same f32 sums in another order, rounded to
    bf16."""
    g = torch.Generator(device=cuda).manual_seed(s + hd)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).bfloat16()

    q, k, v = rnd(b, s, h, hd), rnd(b, s, kv, hd), rnd(b, s, kv, hd)
    do = rnd(b, s, h, hd)
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    before = dict(fa.launches)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert fa.launches["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert fa.launches["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert _rel_err(a, w) <= 1e-2


def test_train_steps_on_card_use_only_the_kernels(cuda):
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.engine import EngineConfig, TrainEngine

    cfg = get_arch("qwen2-1.5b").reduced()
    eng = TrainEngine(LM(cfg), EngineConfig(
        microbatches=2, optim=AdamWConfig(lr=2e-3, warmup_steps=2)),
        device=cuda)
    state = eng.init_state(0)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    fa.reset_launches()
    ops.reset_plain_calls()
    losses = []
    for step in range(4):
        state, m = eng.step(state, host_batch(dcfg, step))
        losses.append(float(m["loss"]))
    L = cfg.n_layers
    assert fa.launches["flash_fwd"] == 4 * 2 * 2 * L
    assert fa.launches["flash_bwd_dq"] == fa.launches["flash_bwd_dkv"] \
        == 4 * 2 * L
    assert not any(ops.plain_calls.values())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 4, 4, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 8, 4, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(q, q.transpose(1, 2).contiguous()
                               .transpose(1, 2), q)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q, q.half(), q)


def test_reduced_model_card_matches_cpu(cuda):
    cfg = get_arch("qwen2-1.5b").reduced()
    model = LM(cfg)
    p_cpu = model.init(0, device="cpu")
    p_gpu = _tree_to(p_cpu, cuda)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, 10)
    caches = [model.init_cache(2, 32, device=d) for d in ("cpu", cuda)]
    out = []
    for p, c in zip((p_cpu, p_gpu), caches):
        dev = c["pos"].device
        lg, _ = model.prefill_chunk(p, c, torch.as_tensor(toks, device=dev),
                                    1, 10)
        lg2, _ = model.decode_step(p, c, torch.as_tensor([3, 4], device=dev),
                                   torch.as_tensor([False, True],
                                                   device=dev))
        out.append((lg.cpu(), lg2[1].float().cpu()))
    assert float((out[0][0] - out[1][0]).abs().max()) <= LOGITS_ATOL
    assert float((out[0][1] - out[1][1]).abs().max()) <= LOGITS_ATOL
    assert caches[1]["pos"].tolist() == [0, 11]


def test_server_on_card_uses_only_the_kernels(cuda):
    cfg = get_arch("qwen2-1.5b").reduced()
    model = LM(cfg)
    params = model.init(0, device=cuda)
    srv = Server(model, params, ServeConfig(slots=2, max_len=48,
                                            prefill_chunk=8))
    fa.reset_launches()
    ops.reset_plain_calls()
    rng = np.random.default_rng(3)
    rids = [srv.submit(rng.integers(0, cfg.vocab, 11).tolist(),
                       max_new_tokens=4) for _ in range(3)]
    res = srv.run()
    assert all(len(res[r]) == 4 for r in rids)
    assert fa.launches["flash_fwd"] == cfg.n_layers * srv.prefill_dispatches
    assert fa.launches["flash_decode"] == (cfg.n_layers
                                           * srv.decode_dispatches)
    assert not any(ops.plain_calls.values())


def test_launch_main_on_card(cuda, tmp_path):
    assert launch_serve.main(["--arch", "qwen2-1.5b", "--reduced",
                              "--requests", "3", "--gen", "3",
                              "--json-out", str(tmp_path / "r.json")]) == 0
