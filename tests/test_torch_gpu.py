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
