"""The port's ``Server`` on the MoE family (reduced moonshot-v1-16b-a3b,
4 experts top-2, f32) against repro's ``Server`` on the same converted
weights, on the CPU: greedy streams identical, and every scheduler
counter (prefill, decode and verify dispatches, preemptions, prompt-cache
hits) and retirement equal, on the linear tier and the paged tier, each
with and without speculative decoding (``spec_k`` 4: drafted steps and
the batched re-score).

The MoE layer's capacity is a function of the tokens of each call, so
the port must route what repro routes: all B slots of a decode step
(inactive ones too), a prefill chunk whole (its padded tail too), the
re-score's rows in repro's order.  The reduced config's capacity factor
of 8 drops nothing; a test-built copy at 1.0 drops choices in prefill
chunks and in re-scores (recorded and required here), which any
difference in the routed token sets would turn into other streams.  The
paged tier's streams equal the linear tier's, bit for bit."""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")     # the card's machine has no JAX

from repro.configs import get_arch as jax_arch
from repro.models.model import LM as JaxLM
from repro.runtime.serve import ServeConfig as JaxServeConfig
from repro.runtime.serve import Server as JaxServer
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.models import moe
from repro_torch.models.model import LM
from repro_torch.runtime.serve import ServeConfig, Server

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")
ARCH = "moonshot-v1-16b-a3b"
COUNTERS = ("prefill_dispatches", "decode_dispatches", "verify_dispatches",
            "preemptions", "prompt_cache_hits")
# 4 slots x 64, chunks of 16, 16-token blocks; 7 requests of 5-40 prompt
# tokens (two sharing a 20-token prefix), 10 greedy tokens each
KW = dict(slots=4, max_len=64, prefill_chunk=16)
TIERS = {"linear": {}, "linear-spec": dict(spec_k=4),
         "paged": dict(paged=True, block_len=16),
         "paged-spec": dict(paged=True, block_len=16, spec_k=4)}
GEN = 10


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny CPU ops run far faster on one intra-op thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts():
    rng = np.random.default_rng(3)
    out = [rng.integers(0, 256, size=int(n)).tolist()
           for n in (5, 40, 17, 9, 33)]
    prefix = rng.integers(0, 256, size=20).tolist()
    return out + [prefix + [1, 2, 3], prefix + [4, 5, 6, 7, 8, 9]]


@pytest.fixture(scope="module", params=[8.0, 1.0],
                ids=lambda f: f"factor{f:g}")
def pair(request):
    factor = request.param
    jcfg = dataclasses.replace(jax_arch(ARCH).reduced(), dtype="float32")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=factor))
    tcfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32")
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=factor))
    jm = JaxLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    return factor, jm, jp, LM(tcfg), tp


@contextlib.contextmanager
def _drops():
    """Record (call site, tokens routed, choices dropped) of every MoE
    call: "prefill" inside ``LM._prefill_chunk``, "rescore" inside
    ``LM._decode_rescore``, "decode" elsewhere."""
    seen, site = [], ["decode"]
    route = moe.route
    saved = {n: getattr(LM, n)
             for n in ("_prefill_chunk", "_decode_rescore")}

    def rec(xf, router, cfg, cap):
        out = route(xf, router, cfg, cap)
        seen.append((site[0], xf.shape[0], int((~out[1]).sum())))
        return out

    def at(name, fn):
        def wrapped(*a, **kw):
            site[0] = name
            try:
                return fn(*a, **kw)
            finally:
                site[0] = "decode"
        return wrapped
    moe.route = rec
    LM._prefill_chunk = at("prefill", saved["_prefill_chunk"])
    LM._decode_rescore = at("rescore", saved["_decode_rescore"])
    try:
        yield seen
    finally:
        moe.route = route
        for n, fn in saved.items():
            setattr(LM, n, fn)


def _run(srv, prompts):
    rids = [srv.submit(p, GEN) for p in prompts]
    res = srv.run()
    return [res[r] for r in rids]


@pytest.mark.parametrize("tier", list(TIERS))
def test_streams_and_counters_match_repro(pair, tier):
    factor, jm, jp, tm, tp = pair
    kw = dict(KW, **TIERS[tier])
    prompts = _prompts()
    js = JaxServer(jm, jp, JaxServeConfig(**kw))
    want = _run(js, prompts)
    ts = Server(tm, tp, ServeConfig(**kw))
    with _drops() as seen:
        got = _run(ts, prompts)
    assert got == want
    assert all(len(s) == GEN for s in got)
    for name in COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.finished == js.finished
    if "spec" in tier:
        assert ts.verify_dispatches > 0
    sizes, drops = {}, {}
    for where, n, d in seen:
        sizes.setdefault(where, set()).add(n)
        drops[where] = drops.get(where, 0) + d
    # a decode step routes every slot, a prefill chunk all its tokens
    assert sizes["decode"] == {KW["slots"]}
    assert sizes["prefill"] == {KW["prefill_chunk"]}
    assert ("rescore" in sizes) == ("spec" in tier)
    if factor == 8.0:
        assert not any(drops.values())
    else:
        assert drops["prefill"] > 0
        assert "spec" not in tier or drops["rescore"] > 0
    if tier.startswith("paged"):
        lin = Server(tm, tp, ServeConfig(**dict(KW, **TIERS[
            tier.replace("paged", "linear")])))
        assert _run(lin, prompts) == got
