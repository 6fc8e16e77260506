"""The port's serving engine (src/repro_torch/runtime/serve.py) and its
harness (launch/serve.py).

Against repro's Server on the same converted weights (reduced qwen2-1.5b,
on the CPU): greedy token streams identical in f32, and teacher-forced
decode logits within the bands of tests/test_torch_model.py (f32 1e-3:
summation order and bf16 cache rounding; bf16 0.25: repro's
LOGITS_ATOL).  Then the port's own counterparts of tests/test_serve.py:
co-residency invariance, freed slot == fresh server, retirement, chunked
== tokenwise prefill, and request validation.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")     # the card's machine has no JAX

from repro.configs import get_arch as jax_arch
from repro.models.model import LM as JaxLM
from repro.runtime.serve import ServeConfig as JaxServeConfig
from repro.runtime.serve import Server as JaxServer
from repro.verify.numerics import LOGITS_ATOL
from repro_torch.configs import MoECfg, XLSTMCfg, get_arch
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import LM
from repro_torch.runtime.serve import (Request, ServeConfig, Server,
                                       sample_tokens)

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")
BAND = {"float32": 1e-3, "bfloat16": LOGITS_ATOL}


def _pair(dtype):
    jcfg = dataclasses.replace(jax_arch("qwen2-1.5b").reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_arch("qwen2-1.5b").reduced(), dtype=dtype)
    jm = JaxLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    return jm, jp, LM(tcfg), tp


@pytest.fixture(scope="module")
def f32_pair():
    return _pair("float32")


@pytest.fixture(scope="module")
def dense():
    """The port alone, bf16 (the serving dtype), random init."""
    cfg = get_arch("qwen2-1.5b").reduced()
    model = LM(cfg)
    return cfg, model, model.init(0, device="cpu")


def _prompts(vocab, n, rng=None, lo=3, hi=12):
    rng = rng or np.random.default_rng(0)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


# -- against repro ------------------------------------------------------------

def test_greedy_streams_match_repro(f32_pair):
    jm, jp, tm, tp = f32_pair
    prompts = _prompts(jm.cfg.vocab, 5, np.random.default_rng(3), 3, 20)
    outs = []
    for srv in (JaxServer(jm, jp, JaxServeConfig(slots=2, max_len=48,
                                                 prefill_chunk=8)),
                Server(tm, tp, ServeConfig(slots=2, max_len=48,
                                           prefill_chunk=8))):
        rids = [srv.submit(p, max_new_tokens=6) for p in prompts]
        res = srv.run()
        outs.append(([res[r] for r in rids], dict(srv.finished)))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_teacher_forced_logits_match_repro(dtype, f32_pair):
    jm, jp, tm, tp = f32_pair if dtype == "float32" else _pair(dtype)
    band = BAND[dtype]
    rng = np.random.default_rng(4)
    prompts = _prompts(jm.cfg.vocab, 2, rng, 5, 14)
    j = JaxServer(jm, jp, JaxServeConfig(slots=3, max_len=32,
                                         prefill_chunk=4))
    t = Server(tm, tp, ServeConfig(slots=3, max_len=32, prefill_chunk=4))
    for slot, p in enumerate(prompts):
        j.admit(p, slot * 2)            # slots 0 and 2; slot 1 stays idle
        t.admit(p, slot * 2)
    np.testing.assert_allclose(t.prefill_logits, j.prefill_logits,
                               atol=band, rtol=0)
    for _ in range(5):
        forced = rng.integers(0, jm.cfg.vocab, 3)
        j.decode_once(forced)
        t.decode_once(forced)
        d = np.abs(np.asarray(j.last_logits) - t.last_logits.numpy())
        assert float(d[[0, 2]].max()) <= band
    np.testing.assert_array_equal(j.pos, t.pos)


# -- the port's own invariants ------------------------------------------------

class TestCoResidency:
    def test_outputs_invariant_to_co_resident_slots(self, dense):
        cfg, model, params = dense
        scfg = ServeConfig(slots=4, max_len=48)
        ps = _prompts(cfg.vocab, 4)
        alone = Server(model, params, scfg)
        alone.admit(ps[0], 0)
        out_alone = alone.generate(8)[0]
        co = Server(model, params, scfg)
        for s, p in enumerate(ps):
            co.admit(p, s)
        assert co.generate(8)[0] == out_alone

    def test_sampled_streams_invariant_to_co_residents(self, dense):
        cfg, model, params = dense
        scfg = ServeConfig(slots=2, max_len=48, prefill_chunk=8,
                           temperature=0.9, top_k=8, seed=3)
        p0, p1 = _prompts(cfg.vocab, 2)
        alone = Server(model, params, scfg)
        alone.admit(p0, 0)
        out_alone = alone.generate(6)[0]
        co = Server(model, params, scfg)
        co.admit(p0, 0)
        co.admit(p1, 1)
        assert co.generate(6)[0] == out_alone

    def test_mid_generation_admission_does_not_disturb(self, dense):
        cfg, model, params = dense
        scfg = ServeConfig(slots=2, max_len=48, prefill_chunk=4)
        p0, p1 = _prompts(cfg.vocab, 2)
        alone = Server(model, params, scfg)
        alone.admit(p0, 0)
        out_alone = alone.generate(8)[0]
        srv = Server(model, params, scfg)
        rid0 = srv.admit(p0, 0)
        for _ in range(3):
            srv.decode_once()
        srv.admit(p1, 1)
        srv.generate(8)
        assert srv.outputs[rid0][:8] == out_alone


class TestSlotRecycling:
    def test_freed_slot_behaves_like_fresh_server(self, dense):
        cfg, model, params = dense
        scfg = ServeConfig(slots=2, max_len=48)
        p_old, p_new = _prompts(cfg.vocab, 2, np.random.default_rng(7))
        srv = Server(model, params, scfg)
        srv.admit(p_old, 0)
        srv.generate(6)
        assert not srv.active[0]
        srv.admit(p_new, 0)
        out_recycled = srv.generate(6)[0]
        fresh = Server(model, params, scfg)
        fresh.admit(p_new, 0)
        assert out_recycled == fresh.generate(6)[0]

    def test_queue_backfills_freed_slots(self, dense):
        cfg, model, params = dense
        srv = Server(model, params,
                     ServeConfig(slots=2, max_len=48, prefill_chunk=8))
        rids = [srv.submit(p, max_new_tokens=4)
                for p in _prompts(cfg.vocab, 5, np.random.default_rng(3))]
        res = srv.run()
        assert all(len(res[r]) == 4 for r in rids)
        assert all(srv.finished[r] == "length" for r in rids)
        assert srv.pending() == {}


class TestRetirement:
    def test_halts_at_max_len(self, dense):
        cfg, model, params = dense
        max_len, p_len = 12, 5
        srv = Server(model, params, ServeConfig(slots=2, max_len=max_len,
                                                prefill_chunk=4))
        rid = srv.admit(list(range(1, p_len + 1)), 0)
        res = srv.run(max_steps=3 * max_len)
        assert len(res[rid]) == max_len - p_len + 1
        assert srv.finished[rid] == "max_len"
        assert srv.pos[0] <= max_len
        assert int(srv.cache["pos"][0]) == srv.pos[0]

    def test_retires_at_eos(self, dense):
        cfg, model, params = dense
        prompt = _prompts(cfg.vocab, 1)[0]
        probe = Server(model, params,
                       ServeConfig(slots=1, max_len=48, prefill_chunk=8))
        rid = probe.admit(prompt, 0, max_new_tokens=6)
        third = probe.run()[rid][2]
        srv = Server(model, params, ServeConfig(slots=1, max_len=48,
                                                prefill_chunk=8,
                                                eos_id=third))
        rid = srv.admit(prompt, 0, max_new_tokens=64)
        res = srv.run()
        assert srv.finished[rid] == "eos"
        assert res[rid][-1] == third and len(res[rid]) == 3

    def test_submit_validates(self, dense):
        cfg, model, params = dense
        srv = Server(model, params, ServeConfig(slots=1, max_len=8))
        with pytest.raises(ValueError):
            srv.submit(list(range(9)))
        with pytest.raises(ValueError):
            srv.submit([])

    def test_invalid_queued_request_is_rejected(self, dense):
        cfg, model, params = dense
        srv = Server(model, params, ServeConfig(slots=1, max_len=8))
        srv.waiting.append(Request(41, list(range(9))))
        ok = srv.submit([1, 2, 3], max_new_tokens=2)
        events = srv.admit_waiting()
        assert ("retire", 41, "rejected") in events
        assert srv.finished[41] == "rejected"
        srv.run()
        assert srv.finished[ok] == "length"

    def test_unported_options_raise(self):
        """The paged tier, speculative decoding, the MoE family and xLSTM
        are ported: xlstm set on a dense config builds an xLSTM model, as
        in repro (whose init takes its xLSTM branch before the dense
        one), which serves on the linear tier only.  A family that is not
        ported (a hybrid without its Mamba layers, the hybrid layout with
        xlstm) says so."""
        assert ServeConfig(paged=True).paged
        assert ServeConfig(spec_k=4).spec_k == 4
        cfg = get_arch("qwen2-1.5b").reduced()
        moe = dataclasses.replace(cfg, family="moe", moe=MoECfg(4, 2, 64))
        assert "moe" in LM(moe).param_shapes()["layers"]
        xl = LM(dataclasses.replace(cfg, xlstm=XLSTMCfg()))
        assert {"slstm", "mlstm"} <= set(xl.param_shapes())
        with pytest.raises(ValueError, match="paged KV cache unsupported"):
            xl.init_cache_paged(1, 16, 3, 8, device="cpu")
        with pytest.raises(NotImplementedError, match="hybrid"):
            LM(dataclasses.replace(cfg, family="hybrid", attn_every=2))
        with pytest.raises(NotImplementedError, match="not ported"):
            LM(dataclasses.replace(cfg, family="hybrid", attn_every=2,
                                   xlstm=XLSTMCfg()))


class TestChunkedPrefill:
    def test_chunked_equals_tokenwise(self, dense):
        """Chunk 8 vs chunk 1 on the CPU: bit-identical."""
        cfg, model, params = dense
        prompt = _prompts(cfg.vocab, 1, np.random.default_rng(5), 9, 14)[0]
        scfg = ServeConfig(slots=2, max_len=48, prefill_chunk=8)
        a = Server(model, params, scfg)
        a.admit(prompt, 0)
        b = Server(model, params, scfg)
        b.admit(prompt, 0, method="tokenwise")
        assert a.generate(6)[0] == b.generate(6)[0]
        np.testing.assert_array_equal(a.prefill_logits[0],
                                      b.prefill_logits[0])

    def test_parallel_prefill_close_to_scan(self, dense):
        cfg, model, params = dense
        prompt = _prompts(cfg.vocab, 1, np.random.default_rng(5), 9, 14)[0]
        logits = []
        for impl in ("parallel", "scan"):
            srv = Server(model, params, ServeConfig(
                slots=1, max_len=48, prefill_chunk=8, prefill_impl=impl))
            srv.admit(prompt, 0)
            logits.append(srv.prefill_logits[0])
        assert float(np.abs(logits[0] - logits[1]).max()) < 0.05

    def test_partial_final_chunk_padding_is_inert(self, dense):
        cfg, model, params = dense
        prompt = _prompts(cfg.vocab, 1, np.random.default_rng(9), 10, 11)[0]
        outs = []
        for chunk in (4, 16):
            srv = Server(model, params, ServeConfig(slots=1, max_len=48,
                                                    prefill_chunk=chunk))
            srv.admit(prompt, 0)
            outs.append(srv.generate(6)[0])
        assert outs[0] == outs[1]


class TestSampling:
    def test_greedy_is_argmax(self):
        logits = np.random.default_rng(0).normal(size=(5, 33))
        toks = sample_tokens(torch.from_numpy(logits))
        np.testing.assert_array_equal(toks.numpy(), logits.argmax(-1))

    def test_top_k_restricts_support(self):
        logits = torch.from_numpy(np.random.default_rng(1).normal(
            size=(8, 64)))
        top4 = np.argsort(logits.numpy(), -1)[:, -4:]
        for s in range(20):
            toks = sample_tokens(logits, torch.Generator().manual_seed(s),
                                 temperature=1.5, top_k=4).numpy()
            assert all(toks[b] in top4[b] for b in range(8))

    def test_sampling_deterministic_per_generator(self):
        logits = torch.from_numpy(np.random.default_rng(2).normal(
            size=(4, 32)))
        a = sample_tokens(logits, torch.Generator().manual_seed(7), 0.8)
        b = sample_tokens(logits, torch.Generator().manual_seed(7), 0.8)
        assert torch.equal(a, b)


# -- the harness ----------------------------------------------------------------

def test_launch_main_on_cpu(tmp_path):
    out = tmp_path / "serve.json"
    rc = launch_serve.main(["--arch", "qwen2-1.5b", "--reduced", "--device",
                            "cpu", "--slots", "2", "--requests", "3",
                            "--gen", "3", "--prompt-len", "6", "--chunk",
                            "4", "--max-len", "32", "--json-out", str(out)])
    assert rc == 0
    rec = json.loads(out.read_text())
    for key in ("prefill_tok_per_s", "decode_tok_per_s", "ttft_p50_s",
                "ttft_p95_s", "itl_p50_s", "itl_p95_s"):
        assert rec[key] is not None and rec[key] > 0, key
    assert rec["requests"] == 3 and rec["generated_tokens"] == 9
    assert rec["meta"]["device"] == "cpu"


def test_launch_main_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_serve.main(["--arch", "qwen2-1.5b", "--reduced"])
