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


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,q_offset,window", [
    (1, 256, 2048, 12, 2, 128, 0, None), (1, 256, 2048, 12, 2, 128, 768, None),
    (1, 256, 2048, 12, 2, 128, 1900, None), (1, 512, 512, 12, 2, 128, 0, 128),
    (1, 40, 64, 4, 1, 16, 30, None), (1, 64, 64, 4, 1, 64, 5, 9),
    # the prefill chunk at more offsets, ragged S against the 64-row
    # tiles, g 8 at hd 64, hd 80 with a window
    (1, 256, 2048, 12, 2, 128, 256, None),
    (1, 256, 2048, 12, 2, 128, 1536, None),
    (1, 1000, 1000, 12, 2, 128, 0, None), (1, 1089, 1089, 8, 1, 64, 0, None),
    (1, 600, 600, 6, 1, 80, 0, 200)])
def test_fwd_kernel_matches_plain(cuda, b, sq, sk, h, kv, hd, q_offset,
                                  window):
    g = torch.Generator(device=cuda).manual_seed(q_offset + hd)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).bfloat16()

    q, k, v = rnd(b, sq, h, hd), rnd(b, sk, kv, hd), rnd(b, sk, kv, hd)
    off = torch.tensor([q_offset], dtype=torch.int32, device=cuda)
    before = dict(fa.launches)
    o, lse = ops.flash_attention_fwd(q, k, v, window=window, q_offset=off)
    assert fa.launches["flash_fwd"] == before["flash_fwd"] + 1
    assert fa.launches["flash_fwd_f32"] == before["flash_fwd_f32"]
    o_r, lse_r = ref.flash_attention_fwd_ref(q, k, v, window=window,
                                             q_offset=q_offset)
    assert _rel_err(o, o_r) <= 1e-2
    assert float((lse - lse_r).abs().max()) <= 1e-3


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,q_offset,causal,window", [
    (1, 256, 2048, 12, 2, 128, 768, True, None),
    (2, 1089, 1089, 8, 1, 64, 0, True, None),
    (1, 300, 700, 6, 6, 80, 333, False, 200),
    (2, 70, 150, 4, 2, 16, 80, True, 33)])
def test_fwd_kernel_is_deterministic(cuda, b, sq, sk, h, kv, hd, q_offset,
                                     causal, window):
    """Two launches on the same inputs give the same bits, within the
    plain version's band."""
    g = torch.Generator(device=cuda).manual_seed(sq + hd)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).bfloat16()

    q, k, v = rnd(b, sq, h, hd), rnd(b, sk, kv, hd), rnd(b, sk, kv, hd)
    off = torch.tensor([q_offset], dtype=torch.int32, device=cuda)
    kw = dict(causal=causal, window=window, q_offset=off)
    o_r, lse_r = ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                             window=window, q_offset=q_offset)
    one = fa.flash_attention_fwd(q, k, v, **kw)
    two = fa.flash_attention_fwd(q, k, v, **kw)
    assert all(torch.equal(x, y) for x, y in zip(one, two))
    assert _rel_err(one[0], o_r) <= 1e-2
    assert float((one[1] - lse_r).abs().max()) <= 1e-3


def test_fwd_f32_queries_take_the_f32_kernel(cuda):
    """f32 queries go to the f32 kernel (its own counter), within the same
    band of the plain version, at no offset and at a device offset."""
    g = torch.Generator(device=cuda).manual_seed(33)
    q = torch.randn(1, 300, 12, 128, generator=g, device=cuda)
    k, v = (torch.randn(1, 600, 2, 128, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    for off in (None, 300):
        offt = None if off is None else torch.tensor([off], dtype=torch.int32,
                                                     device=cuda)
        before = dict(fa.launches)
        o, lse = ops.flash_attention_fwd(q, k, v, q_offset=offt)
        assert fa.launches["flash_fwd_f32"] == before["flash_fwd_f32"] + 1
        assert fa.launches["flash_fwd"] == before["flash_fwd"]
        o_r, lse_r = ref.flash_attention_fwd_ref(q, k, v, q_offset=off)
        assert o.dtype == torch.float32 and _rel_err(o, o_r) <= 1e-2
        assert float((lse - lse_r).abs().max()) <= 1e-3


# every split phase 5 of chip_smoke.py times; the default at the serving
# shape (16 slots x 2048 positions) is 128
SPLITS = (None, 64, 128, 256, 512)


@pytest.mark.parametrize("window,hd,lengths", [
    (None, 128, None), (256, 128, None), (7, 16, None),
    # lengths at a split edge (128, 256), one past it, 1, the whole cache
    (None, 128, [128, 129, 1, 256, 257, 2048, 63, 65, 192, 1000, 1, 2047,
                 384, 511, 512, 513]),
    # windows that start inside a split and span two
    (200, 128, [300, 129, 1, 256, 2048, 500, 201, 199, 640, 1000, 1, 2047,
                384, 511, 512, 513])])
def test_decode_kernel_matches_plain(cuda, window, hd, lengths):
    """Within the plain version's band and, at every split, two launches
    give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(1)
    b, s, h, kv = (16, 2048, 12, 2) if hd == 128 else (4, 64, 4, 1)
    q = torch.randn(b, h, hd, generator=g, device=cuda).bfloat16()
    kc = torch.randn(b, s, kv, hd, generator=g, device=cuda).bfloat16()
    vc = torch.randn(b, s, kv, hd, generator=g, device=cuda).bfloat16()
    if lengths is None:
        ln = np.random.default_rng(0).integers(1, s + 1, size=b)
        ln[0], ln[-1] = 1, s
    else:
        ln = np.asarray(lengths)
    lengths = torch.tensor(ln, dtype=torch.int32, device=cuda)
    before = fa.launches["flash_decode"]
    o = ops.flash_attention_decode(q, kc, vc, lengths, window=window)
    assert fa.launches["flash_decode"] == before + 1
    o_r = ref.flash_attention_decode_ref(q, kc, vc, lengths, window=window)
    assert _rel_err(o, o_r) <= 1e-2
    for split in SPLITS:
        one = fa.flash_attention_decode(q, kc, vc, lengths, window=window,
                                        split=split)
        two = fa.flash_attention_decode(q, kc, vc, lengths, window=window,
                                        split=split)
        assert torch.equal(one, two), split
        assert _rel_err(one, o_r) <= 1e-2, split


def test_decode_bits_do_not_depend_on_the_batch(cuda):
    """A row gives the same bits alone in a 16-row batch and among 64 rows
    (a draft step and a verify re-score of speculative decoding), on both
    kernels."""
    g = torch.Generator(device=cuda).manual_seed(5)
    b, s, h, kv, hd = 64, 2048, 12, 2, 128
    q = torch.randn(b, h, hd, generator=g, device=cuda).bfloat16()
    kc = torch.randn(b, s, kv, hd, generator=g, device=cuda).bfloat16()
    vc = torch.randn(b, s, kv, hd, generator=g, device=cuda).bfloat16()
    ln = torch.tensor(np.random.default_rng(5).integers(1, s + 1, size=b),
                      dtype=torch.int32, device=cuda)
    full = fa.flash_attention_decode(q, kc, vc, ln)
    part = fa.flash_attention_decode(q[:16].contiguous(),
                                     kc[:16].contiguous(),
                                     vc[:16].contiguous(), ln[:16])
    assert torch.equal(full[:16], part)
    table = torch.arange(1, b * 128 + 1, dtype=torch.int32,
                         device=cuda).reshape(b, 128)
    kp, vp = (torch.cat([torch.zeros_like(c[:1, :16]),      # null block 0
                         c.reshape(b * 128, 16, kv, hd)]) for c in (kc, vc))
    full_p = fa.flash_attention_paged_decode(q, kp, vp, table, ln)
    part_p = fa.flash_attention_paged_decode(q[:16].contiguous(), kp, vp,
                                             table[:16].contiguous(),
                                             ln[:16])
    assert torch.equal(full_p[:16], part_p) and torch.equal(full_p, full)


def test_decode_on_two_streams_keeps_its_bits(cuda):
    """Launches left to overlap on two streams of one device give the bits
    of launches on one stream: each stream has its own arrival counters
    (the merging block of a row resets its counter, so two streams that
    shared one could merge a row before its partials were written)."""
    g = torch.Generator(device=cuda).manual_seed(9)
    b, s, h, kv, hd = 16, 2048, 12, 2, 128
    q = torch.randn(b, h, hd, generator=g, device=cuda).bfloat16()
    kc = torch.randn(b, s, kv, hd, generator=g, device=cuda).bfloat16()
    vc = torch.randn(b, s, kv, hd, generator=g, device=cuda).bfloat16()
    ln = torch.tensor(np.random.default_rng(9).integers(1, s + 1, size=b),
                      dtype=torch.int32, device=cuda)
    table = torch.arange(1, b * 128 + 1, dtype=torch.int32,
                         device=cuda).reshape(b, 128)
    kp, vp = (torch.cat([torch.zeros_like(c[:1, :16]),      # null block 0
                         c.reshape(b * 128, 16, kv, hd)]) for c in (kc, vc))
    want = fa.flash_attention_decode(q, kc, vc, ln)
    calls = (lambda: fa.flash_attention_decode(q, kc, vc, ln),
             lambda: fa.flash_attention_paged_decode(q, kp, vp, table, ln))
    cur = torch.cuda.current_stream(cuda)
    streams = [torch.cuda.Stream(cuda) for _ in calls]
    outs = [[] for _ in calls]
    for st in streams:
        st.wait_stream(cur)
    for _ in range(20):
        for st, call, out in zip(streams, calls, outs):
            with torch.cuda.stream(st):
                out.append(call())
    for st in streams:
        cur.wait_stream(st)
    torch.cuda.synchronize(cuda)
    assert all(torch.equal(o, want) for out in outs for o in out)
    for st in streams:
        assert (cuda, st.cuda_stream) in fa._dec_arrived


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


@pytest.mark.parametrize("b,h,kv,hd,bl,mb,lengths", [
    (16, 12, 2, 128, 16, 128, None), (4, 4, 1, 16, 8, 8, None),
    (3, 8, 2, 64, 48, 4, None),
    # split edges of the 2048 positions (default split 128), an empty row
    (8, 12, 2, 128, 16, 128, [0, 128, 129, 1, 256, 257, 2048, 1000])])
def test_paged_decode_kernel_matches_plain(cuda, b, h, kv, hd, bl, mb,
                                           lengths):
    """Within one bf16 ulp of the plain version, bit-equal to
    flash_decode on the gathered view at every split, the same bits over
    two launches, and blind to poison (1e9, NaN) in every block the rows
    do not own, block 0 included."""
    if lengths is None:
        rng = np.random.default_rng(b)
        lengths = rng.integers(1, mb * bl + 1, size=b)
        lengths[0], lengths[-1] = 0, mb * bl - 5      # empty and ragged
        lengths = lengths.tolist()
    q, kp, vp, table, ln = _paged_case(cuda, b, h, kv, hd, bl, mb, lengths)
    before = fa.launches["flash_paged_decode"]
    o = ops.flash_attention_paged_decode(q, kp, vp, table, ln)
    assert fa.launches["flash_paged_decode"] == before + 1
    o_r = ref.flash_attention_paged_decode_ref(q, kp, vp, table, ln)
    assert _rel_err(o, o_r) <= 1e-2
    assert float(o[0].float().abs().max()) == 0.0      # length 0 -> zeros
    view = [p[table.long()].reshape(b, mb * bl, kv, hd) for p in (kp, vp)]
    for split in SPLITS:
        one = fa.flash_attention_paged_decode(q, kp, vp, table, ln,
                                              split=split)
        assert torch.equal(one, fa.flash_attention_paged_decode(
            q, kp, vp, table, ln, split=split)), split
        assert torch.equal(one, fa.flash_attention_decode(q, *view, ln,
                                                          split=split)), split
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
    (2, 33, 4, 1, 16, True, 9), (1, 1089, 8, 1, 64, True, None),
    (1, 1089, 16, 2, 128, False, None), (1, 600, 6, 1, 80, True, 200),
    (1, 256, 32, 32, 80, True, None)])
def test_bwd_kernels_match_plain(cuda, b, s, h, kv, hd, causal, window):
    """dq, dk, dv of the CUDA backward against flash_attention_bwd_ref, at
    1e-2 x max(1, |ref|): the same f32 sums in another order (P and dS
    enter the tensor cores as hi + lo bf16 pairs), rounded to bf16.  The
    64-row tiles cut S = 1000 and 1089 raggedly, the windows start inside
    a tile, g runs over 1, 6 and 8."""
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


@pytest.mark.parametrize("h,kv,causal,window", [
    (12, 2, True, None), (8, 1, False, 200), (4, 4, True, 128)])
def test_bwd_kernels_are_deterministic(cuda, h, kv, causal, window):
    """Two launches on the same inputs give the same bits, at every split
    of the group in dk/dv (the f32 partials are summed in split order
    whichever block finishes last)."""
    g = torch.Generator(device=cuda).manual_seed(h * kv)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).bfloat16()

    b, s, hd = 2, 1089, 128
    q, k, v = rnd(b, s, h, hd), rnd(b, s, kv, hd), rnd(b, s, kv, hd)
    do = rnd(b, s, h, hd)
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    one = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    two = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, c) for a, c in zip(one, two))
    delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)[1]
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for sp in (d for d in range(1, h // kv + 1) if (h // kv) % d == 0):
        a = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, split=sp,
                                       **kw)
        c = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, split=sp,
                                       **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, c))
        assert _rel_err(a[0], want[1]) <= 1e-2
        assert _rel_err(a[1], want[2]) <= 1e-2


def test_bwd_f32_queries_take_the_f32_kernels(cuda):
    """f32 q/o/do go to the f32 kernels (their own counters), within the
    same band of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(32)
    q, do = (torch.randn(1, 300, 12, 128, generator=g, device=cuda)
             for _ in range(2))
    k, v = (torch.randn(1, 300, 2, 128, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    o, lse = fa.flash_attention_fwd(q, k, v)
    before = dict(fa.launches)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert fa.launches["flash_bwd_dq_f32"] == before["flash_bwd_dq_f32"] + 1
    assert fa.launches["flash_bwd_dkv_f32"] == \
        before["flash_bwd_dkv_f32"] + 1
    assert fa.launches["flash_bwd_dq"] == before["flash_bwd_dq"]
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and _rel_err(a, w) <= 1e-2


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
    assert fa.launches["flash_fwd_f32"] == 0
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
    q = torch.zeros(1, 8, 6, 16, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 16, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 6, 8, device=cuda)
    with pytest.raises(ValueError, match="split"):
        fa.flash_attention_bwd_dkv(q, k, k, lse, lse, q, split=2)
    kc = torch.zeros(1, 8192, 2, 16, device=cuda, dtype=torch.bfloat16)
    ln = torch.ones(1, dtype=torch.int32, device=cuda)
    for split in (96, 64):     # not a multiple of 64; 128 splits of 8192
        with pytest.raises(ValueError, match="split"):
            fa.flash_attention_decode(q[:, 0], kc, kc, ln, split=split)


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
    assert fa.launches["flash_fwd_f32"] == 0
    assert fa.launches["flash_decode"] == (cfg.n_layers
                                           * srv.decode_dispatches)
    assert not any(ops.plain_calls.values())


def test_launch_main_on_card(cuda, tmp_path):
    assert launch_serve.main(["--arch", "qwen2-1.5b", "--reduced",
                              "--requests", "3", "--gen", "3",
                              "--json-out", str(tmp_path / "r.json")]) == 0


# ---------------------------------------------------------------------------
# the hybrid slice: hd-80 attention, the SSD chunk scan, zamba2 training
# ---------------------------------------------------------------------------

# The SSD kernel and its plain version are both f32: sums of up to a chunk
# of terms (the sequential recurrence against the chunked form) in another
# order, so |err| <= 2e-4 x max(1, max|ref|).
SSD_TOL = 2e-4


def _ssd_inputs(dev, b, s, h, p, n, seed=0, a=1.0):
    """Inputs as mamba_forward draws them at init (dt_bias 0, identity
    conv) for a head with A = exp(A_log) = a: x, B, C = silu(normal),
    dt = softplus(normal), a_log = -a dt, xh = x dt.  At a = 1 cum
    reaches about -0.8 S within a chunk and the clip at -60 is active; at
    a = 0.01 (a long-memory head) it stays ~ -2 over a chunk of 256, so
    every key tile and the carried state show in y."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    dt = torch.nn.functional.softplus(rnd(b, s, h))
    xh = torch.nn.functional.silu(rnd(b, s, h, p)) * dt[..., None]
    bb = torch.nn.functional.silu(rnd(b, s, n))
    cc = torch.nn.functional.silu(rnd(b, s, n))
    return xh.contiguous(), (-a * dt).contiguous(), bb, cc


def _ssd_err(y, y_ref):
    return float((y - y_ref).abs().max()) / max(1.0,
                                                float(y_ref.abs().max()))


@pytest.mark.parametrize("b,s,h,p,n,chunk,a", [
    (2, 1024, 80, 64, 64, 256, 1.0),   # the training shape
    (2, 64, 16, 8, 8, 8, 1.0),         # reduced zamba2
    (1, 512, 8, 64, 64, 512, 1.0),     # chunk == S
    (1, 512, 8, 64, 64, 128, 1.0),
    (2, 64, 3, 16, 8, 96, 1.0),        # chunk > S: one chunk of 64
    # a long-memory head: the key tiles off the diagonal and the state
    # carried across chunks weigh as much as the diagonal tile
    (2, 1024, 80, 64, 64, 256, 0.01),
    (1, 1024, 8, 64, 64, 128, 0.01),
    (1, 512, 8, 64, 64, 512, 0.01),    # every key tile, no carry
    (2, 64, 16, 8, 8, 8, 0.01),
    # 16 chunks carried; a lone head in the last pair (H = 3); a ragged
    # second query tile (chunk 96); P and N padded to whole 16-byte rows
    (1, 4096, 16, 64, 64, 256, 0.01),
    (2, 1024, 3, 64, 64, 256, 0.01),
    (2, 960, 8, 64, 64, 96, 0.01),
    (2, 192, 5, 6, 10, 64, 0.01)])
def test_ssd_kernel_matches_plain(cuda, b, s, h, p, n, chunk, a):
    """Within the band of the sequential recurrence, and the same bits
    from a second launch."""
    from repro_torch.kernels import ssd

    xh, al, bb, cc = _ssd_inputs(cuda, b, s, h, p, n, seed=s + h, a=a)
    before = ssd.launches["ssd_chunk_scan"]
    y = ops.ssd_chunk_scan(xh, al, bb, cc, chunk=chunk)
    assert ssd.launches["ssd_chunk_scan"] == before + 1
    y_ref, _ = ref.ssd_ref(xh, al, bb, cc)
    assert bool(torch.isfinite(y).all())
    assert _ssd_err(y, y_ref) <= SSD_TOL
    assert torch.equal(y, ops.ssd_chunk_scan(xh, al, bb, cc, chunk=chunk))


def test_ssd_wrapper_refuses_a_misaligned_input(cuda):
    """A contiguous view 4 bytes past a 16-byte boundary: the kernel's
    tensor maps need 16-byte aligned bases, so the wrapper raises."""
    xh, al, bb, cc = _ssd_inputs(cuda, 1, 128, 4, 16, 16, seed=9)
    view = torch.empty(xh.numel() + 1, device=cuda)[1:].view(xh.shape)
    assert view.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="aligned"):
        ops.ssd_chunk_scan(view, al, bb, cc, chunk=64)


def test_ssd_dispatch_pads_and_grads_on_card(cuda):
    """S = 96 with chunk 64 through the dispatcher's pad, for a
    long-memory head (so the second chunk reads the carried state); the
    values against the plain version, the grads against autograd through the
    chunked scan (the backward is that scan, so they are equal)."""
    from repro_torch.kernels import ssd
    from repro_torch.models import mamba

    xh, al, bb, cc = _ssd_inputs(cuda, 2, 96, 4, 8, 8, seed=5, a=0.01)
    ins = [t.clone().requires_grad_(True) for t in (xh, al, bb, cc)]
    ops.reset_plain_calls()
    y = mamba.ssd_dispatch(*ins, 64, "kernel")
    assert y.shape == xh.shape
    assert _ssd_err(y.detach(), ref.ssd_ref(xh, al, bb, cc)[0]) <= SSD_TOL
    dy = torch.randn(y.shape, device=cuda)
    got = torch.autograd.grad(y, ins, dy)
    assert ops.bwd_recomputes["ssd_chunk_scan"] == 1
    ins2 = [t.clone().requires_grad_(True) for t in (xh, al, bb, cc)]
    want = torch.autograd.grad(ssd.ssd_scan(*ins2, 64)[0], ins2, dy)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)
    assert not any(ops.plain_calls.values())


def test_hd80_attention_kernels_match_plain(cuda):
    """zamba2's shared block: hd 80, 32 heads, g 1.  Forward (causal and
    at an offset), backward (dq, dk/dv), decode and paged decode against
    their plain versions in the bands above."""
    g = torch.Generator(device=cuda).manual_seed(80)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).bfloat16()

    q, k, v, do = (rnd(2, 1024, 32, 80) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_r, lse_r = ref.flash_attention_fwd_ref(q, k, v)
    assert _rel_err(o, o_r) <= 1e-2
    assert float((lse - lse_r).abs().max()) <= 1e-3
    for a, w in zip(fa.flash_attention_bwd(q, k, v, o, lse, do),
                    ref.flash_attention_bwd_ref(q, k, v, o, lse, do)):
        assert _rel_err(a, w) <= 1e-2
    qc = rnd(1, 256, 32, 80)
    off = torch.tensor([768], dtype=torch.int32, device=cuda)
    o, _ = fa.flash_attention_fwd(qc, k[:1].contiguous(), v[:1].contiguous(),
                                  q_offset=off)
    o_r, _ = ref.flash_attention_fwd_ref(qc, k[:1], v[:1], q_offset=768)
    assert _rel_err(o, o_r) <= 1e-2
    qd = rnd(2, 32, 80)
    ln = torch.tensor([700, 1024], dtype=torch.int32, device=cuda)
    assert _rel_err(fa.flash_attention_decode(qd, k, v, ln),
                    ref.flash_attention_decode_ref(qd, k, v, ln)) <= 1e-2
    qp, kp, vp, table, lp = _paged_case(cuda, 3, 32, 32, 80, 16, 8,
                                        [5, 128, 77])
    assert _rel_err(fa.flash_attention_paged_decode(qp, kp, vp, table, lp),
                    ref.flash_attention_paged_decode_ref(qp, kp, vp, table,
                                                         lp)) <= 1e-2


def test_hybrid_train_steps_on_card_use_only_the_kernels(cuda):
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.kernels import ssd
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.engine import EngineConfig, TrainEngine

    cfg = get_arch("zamba2-2.7b").reduced()
    eng = TrainEngine(LM(cfg), EngineConfig(
        microbatches=2, optim=AdamWConfig(lr=2e-3, warmup_steps=2)),
        device=cuda)
    state = eng.init_state(0)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    fa.reset_launches()
    ssd.reset_launches()
    ops.reset_plain_calls()
    losses = []
    for step in range(4):
        state, m = eng.step(state, host_batch(dcfg, step))
        losses.append(float(m["loss"]))
    L, apps = cfg.n_layers, cfg.n_layers // cfg.attn_every
    assert ssd.launches["ssd_chunk_scan"] == 4 * 2 * 2 * L
    assert ops.bwd_recomputes["ssd_chunk_scan"] == 4 * 2 * L
    assert fa.launches["flash_fwd"] == 4 * 2 * 2 * apps
    assert fa.launches["flash_fwd_f32"] == 0
    assert fa.launches["flash_bwd_dq"] == fa.launches["flash_bwd_dkv"] \
        == 4 * 2 * apps
    assert not any(ops.plain_calls.values())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# -- hd 120 (h2o-danube-3-4b: 32 q heads on 8 KV heads, window 4096) ------

def _rnd120(dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)
    return rnd


@pytest.mark.parametrize("b,sq,sk,q_offset,window,f32", [
    (2, 1024, 1024, 0, 4096, False),    # the danube training microbatch
    (1, 600, 600, 0, 200, False),       # a window that binds, inside a tile
    (1, 1089, 1089, 0, None, False),    # ragged S
    (1, 256, 2048, 1300, 512, False),   # an offset chunk under a window
    (1, 300, 300, 0, 200, True)])       # f32 queries: the f32 kernel
def test_hd120_fwd_kernel_matches_plain(cuda, b, sq, sk, q_offset, window,
                                        f32):
    """The hd-120 forward (S over 8 k-steps, the eighth on the zeros past
    column 120; P V on m64n120k16) within the plain version's bands, and
    two launches give the same bits."""
    rnd = _rnd120(cuda, sq + q_offset)
    q = rnd(b, sq, 32, 120, dtype=torch.float32 if f32 else torch.bfloat16)
    k, v = rnd(b, sk, 8, 120), rnd(b, sk, 8, 120)
    off = torch.tensor([q_offset], dtype=torch.int32, device=cuda)
    name = "flash_fwd_f32" if f32 else "flash_fwd"
    before = fa.launches[name]
    one = fa.flash_attention_fwd(q, k, v, window=window, q_offset=off)
    two = fa.flash_attention_fwd(q, k, v, window=window, q_offset=off)
    assert fa.launches[name] == before + 2
    assert all(torch.equal(x, y) for x, y in zip(one, two))
    o_r, lse_r = ref.flash_attention_fwd_ref(q, k, v, window=window,
                                             q_offset=q_offset)
    assert _rel_err(one[0], o_r) <= 1e-2
    assert float((one[1] - lse_r).abs().max()) <= 1e-3


@pytest.mark.parametrize("b,s,window,f32", [
    (2, 1024, 4096, False), (1, 600, 128, False), (1, 1089, 200, False),
    (1, 300, 200, True)])
def test_hd120_bwd_kernels_match_plain(cuda, b, s, window, f32):
    """The hd-120 backward (tiles staged at 128 columns, the last 8 zero;
    the row sums over 15 16-byte chunks a row) within 1e-2 x max(1, |ref|)
    of the plain version, at every split of the group of 4, each launch
    twice bit-equal."""
    rnd = _rnd120(cuda, s + 120)
    dt = torch.float32 if f32 else torch.bfloat16
    q, do = rnd(b, s, 32, 120, dtype=dt), rnd(b, s, 32, 120, dtype=dt)
    k, v = rnd(b, s, 8, 120), rnd(b, s, 8, 120)
    kw = dict(causal=True, window=window)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    one = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    two = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(x, y) for x, y in zip(one, two))
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for a, w in zip(one, want):
        assert a.dtype == w.dtype and _rel_err(a, w) <= 1e-2
    if f32:
        return
    delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)[1]
    for sp in (1, 2, 4):
        a = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, split=sp,
                                       **kw)
        c = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, split=sp,
                                       **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, c)), sp
        assert _rel_err(a[0], want[1]) <= 1e-2, sp
        assert _rel_err(a[1], want[2]) <= 1e-2, sp


@pytest.mark.parametrize("b,s,window,lengths,f32", [
    (8, 2048, 4096, None, False),       # the serving step: 8 slots x 2048
    (4, 4096, 4096, [4096, 4095, 1, 2049], False),   # a full ring
    (8, 2048, None, [128, 129, 1, 256, 257, 2048, 0, 1000], False),
    (8, 2048, 200, [300, 129, 1, 256, 2048, 500, 201, 199], False),
    (8, 2048, 4096, None, True)])       # f32 queries
def test_hd120_decode_kernel_matches_plain(cuda, b, s, window, lengths, f32):
    """The hd-120 decode (S over 8 k-steps on rows padded to 128 columns,
    P V on 15 n-tiles, the last from an x2 ldmatrix): within the plain
    version's band at the default split and at each of SPLITS, twice
    bit-equal, and exact zeros for a slot of length 0."""
    rnd = _rnd120(cuda, s + b)
    q = rnd(b, 32, 120, dtype=torch.float32 if f32 else torch.bfloat16)
    kc, vc = rnd(b, s, 8, 120), rnd(b, s, 8, 120)
    if lengths is None:
        lengths = np.random.default_rng(b).integers(1, s + 1, size=b)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    o_r = ref.flash_attention_decode_ref(q, kc, vc, ln, window=window)
    empty = ln == 0
    for split in SPLITS:
        one = fa.flash_attention_decode(q, kc, vc, ln, window=window,
                                        split=split)
        two = fa.flash_attention_decode(q, kc, vc, ln, window=window,
                                        split=split)
        assert torch.equal(one, two), split
        assert _rel_err(one, o_r) <= 1e-2, split
        assert not one[empty].any(), split


def test_hd120_paged_decode_matches_plain(cuda):
    """The paged decode's hd-120 instance (off the danube path: paged_ok
    excludes sliding-window configs) within the plain version's band and
    bit-equal to flash_decode on the gathered view."""
    b, mb, bl = 4, 8, 16
    q, kp, vp, table, ln = _paged_case(cuda, b, 32, 8, 120, bl, mb,
                                       [5, 128, 0, 77], seed=120)
    o = fa.flash_attention_paged_decode(q, kp, vp, table, ln)
    assert _rel_err(o, ref.flash_attention_paged_decode_ref(
        q, kp, vp, table, ln)) <= 1e-2
    view = [p[table.long()].reshape(b, mb * bl, 8, 120) for p in (kp, vp)]
    assert torch.equal(o, fa.flash_attention_decode(q, *view, ln))
    assert not o[2].any()


def test_danube_reduced_card_matches_cpu_past_the_window(cuda):
    """The reduced h2o-danube-3-4b (window 16) on the card against the CPU,
    bf16 weights: a scan prefill, then 40 decode steps, so that the ring
    of 16 wraps on the card; logits within LOGITS_ATOL."""
    cfg = get_arch("h2o-danube-3-4b").reduced()
    model = LM(cfg)
    p_cpu = model.init(0, device="cpu")
    p_gpu = _tree_to(p_cpu, cuda)
    rng = np.random.default_rng(20)
    toks = rng.integers(0, cfg.vocab, 10)
    caches = [model.init_cache(2, 64, device=d) for d in ("cpu", cuda)]
    worst = 0.0
    for p, c in zip((p_cpu, p_gpu), caches):
        dev = c["pos"].device
        model.prefill_chunk(p, c, torch.as_tensor(toks, device=dev), 1, 10)
    for _ in range(40):
        step = torch.as_tensor(rng.integers(0, cfg.vocab, 2))
        lg = [model.decode_step(p, c, step.to(c["pos"].device))[0]
              for p, c in zip((p_cpu, p_gpu), caches)]
        worst = max(worst, float((lg[0].float() - lg[1].float().cpu())
                                 .abs().max()))
    assert caches[1]["kv"]["k"].shape[2] == 16
    assert caches[1]["pos"].tolist() == [40, 50]
    assert worst <= LOGITS_ATOL


# -- the SSM family: the pure-Mamba branch and xlstm-125m ----------------

def _pure_ssm_cfg():
    """The pure-Mamba branch (no config has it): the reduced zamba2-2.7b
    with family "ssm" and no shared block."""
    import dataclasses
    return dataclasses.replace(get_arch("zamba2-2.7b").reduced(),
                               family="ssm", attn_every=0)


def test_pure_ssm_train_steps_on_card_use_only_the_kernel(cuda):
    """The pure-SSM branch's engine steps on the card: ssd_chunk_scan
    twice a layer a microbatch (the forward and the remat), the backward
    by the chunked scan, no attention kernel, no plain call."""
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.kernels import ssd
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.engine import EngineConfig, TrainEngine

    cfg = _pure_ssm_cfg()
    eng = TrainEngine(LM(cfg), EngineConfig(
        microbatches=2, optim=AdamWConfig(lr=2e-3, warmup_steps=2)),
        device=cuda)
    state = eng.init_state(0)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    fa.reset_launches()
    ssd.reset_launches()
    ops.reset_plain_calls()
    losses = []
    for step in range(4):
        state, m = eng.step(state, host_batch(dcfg, step))
        losses.append(float(m["loss"]))
    L = cfg.n_layers
    assert ssd.launches["ssd_chunk_scan"] == 4 * 2 * 2 * L
    assert ops.bwd_recomputes["ssd_chunk_scan"] == 4 * 2 * L
    assert not any(fa.launches.values())
    assert not any(ops.plain_calls.values())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("arch", ["pure-ssm", "xlstm-125m"])
def test_recurrent_families_on_card_match_cpu(cuda, arch):
    """The reduced pure-SSM branch and xlstm-125m on the card against the
    same bf16 weights on the CPU: the forward's logits (the pure-SSM
    branch's kernel route also against its chunked route on the card),
    then a scan prefill and 10 decode steps; xLSTM launches no kernel."""
    import dataclasses

    from repro_torch.kernels import ssd
    cfg = _pure_ssm_cfg() if arch == "pure-ssm" else get_arch(arch).reduced()
    model = LM(cfg)
    p_cpu = model.init(0, device="cpu")
    p_gpu = _tree_to(p_cpu, cuda)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24))
    fa.reset_launches()
    ssd.reset_launches()
    ops.reset_plain_calls()
    with torch.no_grad():
        lc = model.forward(p_cpu, torch.as_tensor(toks))[0].float()
        lg = model.forward(p_gpu, torch.as_tensor(toks, device=cuda))[0]
        assert float((lc - lg.float().cpu()).abs().max()) <= LOGITS_ATOL
        if arch == "pure-ssm":
            assert ssd.launches["ssd_chunk_scan"] == cfg.n_layers
            lk = dataclasses.replace(model, ssd_impl="chunked").forward(
                p_gpu, torch.as_tensor(toks, device=cuda))[0]
            assert float((lk.float() - lg.float()).abs().max()) \
                <= LOGITS_ATOL
        else:
            assert not any(ssd.launches.values())
        caches = [model.init_cache(2, 32, device=d) for d in ("cpu", cuda)]
        out = []
        for p, c in zip((p_cpu, p_gpu), caches):
            dev = c["pos"].device
            lp, _ = model.prefill_chunk(
                p, c, torch.as_tensor(toks[0, :9], device=dev), 1, 9)
            rows = [lp.float().cpu()]
            for i in range(10):
                ld, _ = model.decode_step(
                    p, c, torch.as_tensor(toks[:, 9 + i], device=dev))
                rows.append(ld.float().cpu())
            out.append(rows)
    for a, b in zip(*out):
        assert float((a - b).abs().max()) <= LOGITS_ATOL
    assert caches[1]["pos"].tolist() == [10, 19]
    assert not any(fa.launches.values())
    assert not any(ops.plain_calls.values())     # "auto" is chunked on the CPU
