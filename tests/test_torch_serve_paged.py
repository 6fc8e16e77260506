"""The port's paged serving tier (src/repro_torch/runtime/serve.py with
runtime/paged.py, and the paged branches of models/model.py).

Against repro's paged Server on the same converted weights (reduced
qwen2-1.5b, on the CPU): teacher-forced prefill and decode logits within
the bands of tests/test_torch_model.py (f32 1e-3: summation order and
bf16 cache rounding; bf16 0.25: repro's LOGITS_ATOL), and, in f32,
greedy streams identical together with every scheduler counter
(prefill, decode and verify dispatches, preemptions, prompt-cache hits)
in four scenarios: a shared prefix with a copy-on-write tail, a pool
tight enough to preempt, speculative decoding with and without the
verify pass, and chunked against tokenwise admission.  Then the port
against itself: the paged engine's streams equal the linear engine's,
bit for bit.
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
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import LM
from repro_torch.runtime.serve import ServeConfig, Server

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")
BAND = {"float32": 1e-3, "bfloat16": LOGITS_ATOL}
COUNTERS = ("prefill_dispatches", "decode_dispatches", "verify_dispatches",
            "preemptions", "prompt_cache_hits")


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny CPU ops run far faster on one intra-op thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# compiled repro servers, one per jit-relevant configuration: a new repro
# Server adopts the jits of the first one (Server.adopt_jits)
_JITS = {}


def _jax_server(jm, jp, **kw):
    scfg = JaxServeConfig(**kw)
    srv = JaxServer(jm, jp, scfg)
    key = (id(jm), scfg.slots, scfg.max_len, scfg.prefill_chunk,
           scfg.prefill_impl, scfg.temperature, scfg.top_k, scfg.paged,
           scfg.block_len, scfg.spec_k)
    if key in _JITS:
        srv.adopt_jits(_JITS[key])
    else:
        _JITS[key] = srv
    return srv


def _prompts(vocab, n, rng, lo=3, hi=12):
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _serve_both(pair, prompts, budget, **kw):
    """The same requests through repro's Server and the port's: -> (repro
    streams, port streams, repro server, port server)."""
    jm, jp, tm, tp = pair
    js = _jax_server(jm, jp, **kw)
    ts = Server(tm, tp, ServeConfig(**kw))
    outs = []
    for srv in (js, ts):
        rids = [srv.submit(p, budget) for p in prompts]
        res = srv.run()
        outs.append([res[r] for r in rids])
    return outs[0], outs[1], js, ts


def _assert_same_run(js, ts):
    for name in COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.finished == js.finished
    assert ts.pending() == {}


# -- against repro --------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_logits_match_repro(dtype, f32_pair):
    """Teacher-forced: the paged prefill logits and the paged decode
    step's logits within the bands of tests/test_torch_model.py."""
    jm, jp, tm, tp = f32_pair if dtype == "float32" else _pair(dtype)
    band = BAND[dtype]
    rng = np.random.default_rng(4)
    prompts = _prompts(jm.cfg.vocab, 2, rng, 9, 20)
    kw = dict(slots=3, max_len=32, prefill_chunk=4, paged=True, block_len=8)
    j = _jax_server(jm, jp, **kw)
    t = Server(tm, tp, ServeConfig(**kw))
    for slot, p in enumerate(prompts):
        j.admit(p, slot * 2)            # slots 0 and 2; slot 1 stays idle
        t.admit(p, slot * 2)
    np.testing.assert_allclose(t.prefill_logits, j.prefill_logits,
                               atol=band, rtol=0)
    for _ in range(6):
        forced = rng.integers(0, jm.cfg.vocab, 3)
        j.decode_once(forced)
        t.decode_once(forced)
        d = np.abs(np.asarray(j.last_logits) - t.last_logits.numpy())
        assert float(d[[0, 2]].max()) <= band
    np.testing.assert_array_equal(j.pos, t.pos)
    np.testing.assert_array_equal(j.table, t.table)
    np.testing.assert_array_equal(np.asarray(j.cache["block_table"]),
                                  t.cache["block_table"].numpy())


def test_shared_prefix_with_cow_tail_matches_repro(f32_pair):
    """Four requests: two share 1.5 blocks (the second copies the shared
    block on write), two more share two full blocks with them."""
    rng = np.random.default_rng(6)
    vocab = f32_pair[0].cfg.vocab
    pre = rng.integers(0, vocab, size=16).tolist()
    prompts = [pre[:12] + rng.integers(0, vocab, size=4).tolist()
               for _ in range(2)]
    prompts += [pre + rng.integers(0, vocab, size=int(n)).tolist()
                for n in (3, 5)]
    want, got, js, ts = _serve_both(f32_pair, prompts, 5, slots=2,
                                    max_len=32, prefill_chunk=8, paged=True,
                                    block_len=8)
    assert got == want
    _assert_same_run(js, ts)
    assert ts.prompt_cache_hits >= 12 + 16


def test_preemption_matches_repro(f32_pair):
    """Six requests on a pool of 12 usable blocks: decode-time growth
    preempts the youngest slot, and the resume re-links or recomputes."""
    rng = np.random.default_rng(0)
    prompts = _prompts(f32_pair[0].cfg.vocab, 6, rng)
    want, got, js, ts = _serve_both(f32_pair, prompts, 20, slots=6,
                                    max_len=32, prefill_chunk=8, paged=True,
                                    block_len=8, n_blocks=13)
    assert got == want
    _assert_same_run(js, ts)
    assert ts.preemptions > 0


@pytest.mark.parametrize("verify", [True, False])
def test_speculative_matches_repro(verify, f32_pair):
    rng = np.random.default_rng(1)
    prompts = _prompts(f32_pair[0].cfg.vocab, 4, rng)
    want, got, js, ts = _serve_both(f32_pair, prompts, 8, slots=2,
                                    max_len=32, prefill_chunk=8, paged=True,
                                    block_len=8, spec_k=4,
                                    spec_verify=verify)
    assert got == want
    _assert_same_run(js, ts)
    assert (ts.verify_dispatches > 0) == verify


def test_chunked_and_tokenwise_match_repro(f32_pair):
    jm, jp, tm, tp = f32_pair
    prompt = _prompts(jm.cfg.vocab, 1, np.random.default_rng(5), 9, 14)[0]
    kw = dict(slots=2, max_len=32, prefill_chunk=8, paged=True, block_len=8)
    runs = {}
    for method in ("chunked", "tokenwise"):
        j = _jax_server(jm, jp, **kw)
        t = Server(tm, tp, ServeConfig(**kw))
        j.admit(prompt, 0, method=method)
        t.admit(prompt, 0, method=method)
        runs[method] = (j.generate(6)[0], t.generate(6)[0],
                        j.prefill_logits[0], t.prefill_logits[0], j, t)
    for method, (jo, to, jl, tl, j, t) in runs.items():
        assert to == jo, method
        np.testing.assert_allclose(tl, jl, atol=BAND["float32"], rtol=0)
        assert t.prefill_dispatches == j.prefill_dispatches
    assert runs["chunked"][1] == runs["tokenwise"][1]


# -- the port against itself ----------------------------------------------------

def _run(model, params, scfg, prompts, budget):
    srv = Server(model, params, scfg)
    for p in prompts:
        srv.submit(p, budget)
    return srv.run(), srv


@pytest.mark.parametrize("extra", [
    dict(),
    dict(n_blocks=13),                          # preempts
    dict(spec_k=4),
    dict(n_blocks=13, spec_k=3, temperature=0.8, top_k=8, seed=5),
], ids=["greedy", "preempting", "speculative", "sampled-preempting-spec"])
def test_paged_equals_linear(extra, dense):
    """Block tables, prefix re-linking, copy-on-write, preemption and
    speculation move no token: the paged engine's streams are the linear
    engine's."""
    cfg, model, params = dense
    prompts = _prompts(cfg.vocab, 6, np.random.default_rng(0))
    sampling = {k: extra[k] for k in ("temperature", "top_k", "seed")
                if k in extra}
    ref, lin = _run(model, params, ServeConfig(slots=6, max_len=32,
                                               **sampling), prompts, 20)
    out, srv = _run(model, params, ServeConfig(
        slots=6, max_len=32, paged=True, block_len=8, **extra), prompts, 20)
    assert out == ref
    assert srv.finished == lin.finished
    if "n_blocks" in extra:
        assert srv.preemptions > 0
    if extra.get("spec_k", 1) > 1:
        assert srv.decode_dispatches < lin.decode_dispatches


def test_chunked_equals_tokenwise_paged(dense):
    """Chunk 8 vs chunk 1 through the paged pool, bf16: bit-identical
    logits and streams (tests/test_serve_paged.py's case)."""
    cfg, model, params = dense
    prompt = _prompts(cfg.vocab, 1, np.random.default_rng(5), 9, 14)[0]
    scfg = ServeConfig(slots=2, max_len=32, paged=True, block_len=8,
                       prefill_chunk=8)
    a = Server(model, params, scfg)
    a.admit(prompt, 0)
    b = Server(model, params, scfg)
    b.admit(prompt, 0, method="tokenwise")
    assert a.generate(6)[0] == b.generate(6)[0]
    np.testing.assert_array_equal(a.prefill_logits[0], b.prefill_logits[0])


def test_repeated_preemption_keeps_the_stream(dense):
    """A request preempted twice resumes with its outputs folded into its
    prompt once.  repro keeps the resume prompt as the request's prompt,
    so its second resume carries the first outputs twice and the stream
    leaves the linear engine's (ROADMAP C); the port's does not."""
    cfg, model, params = dense
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, 11).tolist() for _ in range(4)]
    ref, _ = _run(model, params, ServeConfig(slots=2, max_len=48,
                                             prefill_chunk=8), prompts, 30)
    srv = Server(model, params, ServeConfig(slots=2, max_len=48,
                                            prefill_chunk=8, paged=True,
                                            block_len=8, n_blocks=7))
    rids = [srv.submit(p, 30) for p in prompts]
    preempted = []
    while srv.waiting or srv.active.any():
        preempted += [rid for kind, rid, _ in srv.step() if kind == "preempt"]
    assert max(preempted.count(r) for r in rids) >= 2
    assert {r: srv.outputs[r] for r in rids} == ref
    assert set(srv.finished.values()) == {"length"}


def test_linear_speculative_equals_linear(dense):
    cfg, model, params = dense
    prompts = _prompts(cfg.vocab, 4, np.random.default_rng(2))
    ref, _ = _run(model, params, ServeConfig(slots=2, max_len=32), prompts, 8)
    out, srv = _run(model, params, ServeConfig(slots=2, max_len=32,
                                               spec_k=4), prompts, 8)
    assert out == ref and srv.verify_dispatches > 0


def test_prefix_cache_is_invisible(dense):
    cfg, model, params = dense
    rng = np.random.default_rng(4)
    pre = rng.integers(0, cfg.vocab, size=16).tolist()
    prompts = [pre + rng.integers(0, cfg.vocab, size=4).tolist()
               for _ in range(4)]
    runs = [_run(model, params, ServeConfig(
        slots=2, max_len=32, paged=True, block_len=8, prefix_cache=on),
        prompts, 3) for on in (True, False)]
    assert runs[0][0] == runs[1][0]
    assert runs[0][1].prefill_dispatches < runs[1][1].prefill_dispatches
    assert runs[0][1].prompt_cache_hits >= 16 * 3
    on = runs[0][1]
    on.trie.clear()
    assert on.pool.n_free == on.n_blocks - 1    # no reference leaked


def test_paged_cache_layout(dense):
    cfg, model, _ = dense
    cache = model.init_cache_paged(3, 32, 10, 8, device="cpu")
    assert cache["pos"].shape == (3,) and cache["pos"].dtype == torch.int32
    assert cache["block_table"].shape == (3, 4)
    assert cache["block_table"].dtype == torch.int32
    for k in ("k", "v"):
        assert cache["pages"][k].shape == (cfg.n_layers, 10, 8,
                                           cfg.n_kv_heads, cfg.hd)
        assert cache["pages"][k].dtype == torch.bfloat16


class TestValidation:
    def test_block_len_must_divide_max_len(self, dense):
        cfg, model, params = dense
        with pytest.raises(ValueError, match="block_len"):
            Server(model, params, ServeConfig(slots=2, max_len=30,
                                              paged=True, block_len=8))
        with pytest.raises(ValueError, match="block_len"):
            model.init_cache_paged(2, 30, 9, 8, device="cpu")

    def test_pool_must_hold_one_request(self, dense):
        cfg, model, params = dense
        with pytest.raises(ValueError, match="n_blocks"):
            Server(model, params, ServeConfig(slots=2, max_len=32,
                                              paged=True, block_len=8,
                                              n_blocks=4))

    def test_sliding_window_has_no_paged_cache(self, dense):
        cfg, _, _ = dense
        model = LM(dataclasses.replace(cfg, swa_window=8))
        with pytest.raises(ValueError, match="paged"):
            model.init_cache_paged(2, 32, 9, 8, device="cpu")


def test_launch_main_paged_on_cpu(tmp_path):
    out = tmp_path / "serve.json"
    rc = launch_serve.main(["--arch", "qwen2-1.5b", "--reduced", "--device",
                            "cpu", "--paged", "--n-blocks", "9", "--spec-k",
                            "4", "--slots", "4", "--requests", "6", "--gen",
                            "6", "--prompt-len", "12", "--chunk", "4",
                            "--max-len", "32", "--block-len", "8",
                            "--json-out", str(out)])
    assert rc == 0
    rec = json.loads(out.read_text())
    assert rec["requests"] == 6 and rec["generated_tokens"] == 36
    assert rec["meta"]["paged"] and rec["meta"]["n_blocks"] == 9
    assert rec["paged"]["preemptions"] > 0
    assert rec["paged"]["verify_dispatches"] > 0
    for key in ("prefill_dispatches", "decode_dispatches",
                "prompt_cache_hits"):
        assert rec["paged"][key] >= 0
