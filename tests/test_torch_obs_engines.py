"""The observed engines: the port's ``Server``, training loop and
launchers with tracing, the metrics registry, the monitor and the drift
gauge on, held to repro and to themselves with observation off.  On the
CPU, at reduced sizes (qwen2-1.5b and llama3.2-3b cut by ``reduced()``).

- compile: ``verify/calibration.faithful_assignments``,
  ``verify/train_cell.train_faithful_assignments`` and the plan record's
  ``breakdown`` (``launch/compile._executed_breakdown``) equal repro's on
  the same graph and axes at repro's constants, for a train and a decode
  cell at (4, 2); ``solve_observed_regime``'s ``total_bytes`` equals
  repro's (the port's solve given repro's HBM through a ``CapacityTerm``,
  as tests/test_torch_solver.py gives it).
- ``Server``: repro's spans and instants, per request, and its four
  registry metrics, on the linear tier and on the paged tier with
  preemption and spec_k 4 (f32 weights, greedy: the streams are equal
  too); everything on against everything off: equal streams, dispatch
  counts and plain-path calls (``ops.plain_calls``, the CPU's stand-in
  for kernel launches); the trace and metrics files pass both packages'
  validators.
- monitor: a stall injected into four decode steps fires the ITL
  burn-rate rule, whose flight record validates.
- trainer: ``straggler_cb`` fires on the injected step; the losses with
  the monitor on, and at ``log_every`` 1 and 3, are bit-equal.
- arrivals: ``--arrivals poisson`` gives repro's arrival times.
- one spawn of 8 gloo ranks: hand-built collectives priced by repro's
  ring formulas; the launchers' drift records of one reduced dense train
  step (llama3.2-3b with 2 KV heads, 8 x 16, the solved (4, 2) plan at
  beam 32) and one decode step (qwen2-1.5b, 8 slots x 48, the solved
  (4, 2) decode plan); the train run is also given ``--stages 2``: its
  pipeline record equals repro's ``solve_pipeline`` on the same graph
  and axes, and it trains on the flat plan, as repro's does (its loss
  is the planned engine step's, bit for bit); the dry run's meta trace
  of that train step on a fake process group of 8 records rank 0's
  collectives op for op.

Measured drift (ratio = measured / predicted wire bytes, band [0.25,
4]): the train step 1.63 (predicted 5,424,128 bytes, measured 8,844,856:
26 all-gathers, 12 all-reduces, 8 reduce-scatters; 8,858,680 with 15
all-reduces before the grad sync reduced a grad pending over both mesh
dims in one all-reduce, 9,608,840 with 17 before the planned loss took
its labels to the logits' placements and the embedding its token ids
whole), in the band; the
decode step 1.0 by the floor rule (predicted 0, measured 43,008 bytes of
18 all-gathers, both under 256 kB).  On gloo DTensor runs a
shard-to-shard all-to-all as an all-gather and a chunk, and the
recorded bytes are that all-gather's.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from repro_torch.analysis import comm
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.launch import mesh as tmesh

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")
R_BW = 100e9            # repro's solver bandwidth (ICI_BW x 2 links)
TRAIN_SHAPE = ("trainr8x16", 16, 8, "train")
SERVE_ARGS = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
              "--mesh", "4x2", "--plan", "auto", "--slots", "8",
              "--max-len", "48", "--gen", "4"]


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny CPU ops run far faster on one intra-op thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tracers():
    """Both packages' tracers, cleared, ring-less and disabled around the
    test."""
    from repro.obs import tracing as r_tracing
    from repro_torch.obs import tracing as t_tracing
    ts = (r_tracing.get_tracer(), t_tracing.get_tracer())
    for t in ts:
        t.disable()
        t.detach_ring()
        t.clear()
    yield ts
    for t in ts:
        t.disable()
        t.detach_ring()
        t.clear()


def _canon(per_axis):
    return [{t: repr(c) for t, c in a.items()} for a in per_axis]


# -- compile ---------------------------------------------------------------------

@pytest.mark.parametrize("kind,batch,seq", [("train", 8, 16),
                                            ("decode", 4, 32)])
def test_executed_breakdown_is_repros(kind, batch, seq):
    """Reduced llama3.2-3b at (4, 2), solved at beam 32 with repro's
    constants: the same assignments, the same as-executed projection and
    the same breakdown (total, by kind, by phase)."""
    from repro.configs.base import ShapeConfig as RShape
    from repro.configs.base import get_arch as r_arch
    from repro.core.builders import build_graph as r_build
    from repro.core.cost import HBM_PER_DEV as R_HBM
    from repro.core.solver import MeshAxis as RAxis
    from repro.core.solver import solve_mesh as r_solve
    from repro.launch.compile import _executed_breakdown as r_breakdown
    from repro.verify.calibration import faithful_assignments as r_faith
    from repro.verify.train_cell import \
        train_faithful_assignments as r_train_faith
    from repro_torch.core.builders import build_graph
    from repro_torch.core.costterms import CapacityTerm
    from repro_torch.core.solver import MeshAxis, solve_mesh
    from repro_torch.launch.compile import _executed_breakdown
    from repro_torch.verify import calibration, train_cell
    rg = r_build(r_arch("llama3.2-3b").reduced(),
                 RShape("c", seq, batch, kind))
    raxes = [RAxis("data", 4, R_BW), RAxis("model", 2, R_BW)]
    rsol = r_solve(rg, raxes, beam=32)
    g = build_graph(get_arch("llama3.2-3b").reduced(),
                    ShapeConfig("c", seq, batch, kind))
    axes = [MeshAxis("data", 4, R_BW), MeshAxis("model", 2, R_BW)]
    sol = solve_mesh(g, axes, beam=32, mem_scale=0.0,
                     terms=(CapacityTerm(scale=1.0, hbm=R_HBM),))
    assert _canon(sol.per_axis) == _canon(rsol.per_axis)
    assert _canon(calibration.faithful_assignments(g, sol.per_axis)) == \
        _canon(r_faith(rg, rsol.per_axis))
    assert _canon(train_cell.train_faithful_assignments(g, sol.per_axis)) \
        == _canon(r_train_faith(rg, rsol.per_axis))
    got = _executed_breakdown(g, axes, sol.per_axis, kind)
    assert got == r_breakdown(rg, raxes, rsol.per_axis, kind)
    assert got["total"] > 0
    dp = calibration._dp_solution(g, axes)
    assert len(dp.per_axis) == 2
    assert [a.size for a in calibration.verify_axes()] == [4, 2]


@pytest.mark.parametrize("regime,seq", [("decode-heavy", 64),
                                        ("prefill-heavy", 8)])
def test_observed_regime_is_repros(monkeypatch, regime, seq):
    """The advisor's bridge: reduced qwen2-1.5b on (4, 2) axes at repro's
    bandwidth, 4 slots; the record's total_bytes, breakdown and role cuts
    are repro's (the port's solve at repro's HBM); an unknown regime
    raises."""
    import functools

    from repro.configs.base import get_arch as r_arch
    from repro.core.cost import HBM_PER_DEV as R_HBM
    from repro.core.solver import MeshAxis as RAxis
    from repro.launch.compile import solve_observed_regime as r_observed
    from repro_torch.core.costterms import CapacityTerm
    from repro_torch.core.solver import MeshAxis, solve_mesh
    from repro_torch.launch import compile as tcompile
    monkeypatch.setattr(tcompile, "solve_mesh", functools.partial(
        solve_mesh, mem_scale=0.0,
        terms=(CapacityTerm(scale=1.0, hbm=R_HBM),)))
    ref = r_observed(r_arch("qwen2-1.5b").reduced(),
                     [RAxis("data", 4, R_BW), RAxis("model", 2, R_BW)],
                     "obs", regime, 4, seq, use_cache=False)
    got = tcompile.solve_observed_regime(
        get_arch("qwen2-1.5b").reduced(),
        [MeshAxis("data", 4, R_BW), MeshAxis("model", 2, R_BW)], "obs",
        regime, 4, seq, use_cache=False)
    assert got["total_bytes"] == pytest.approx(ref["total_bytes"],
                                               rel=1e-9)
    assert got["breakdown"] == ref["breakdown"]
    assert got["role_cuts"] == ref["role_cuts"]
    with pytest.raises(ValueError, match="unknown regime"):
        tcompile.solve_observed_regime(get_arch("qwen2-1.5b").reduced(),
                                       [MeshAxis("data", 4)], "obs",
                                       "bursty", 4, 8)


# -- the Server ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def f32_pair():
    """repro's reduced qwen2-1.5b in f32 and the port's on its weights."""
    import jax

    from repro.configs import get_arch as r_arch
    from repro.models.model import LM as JaxLM
    from repro_torch.convert import params_from_jax
    from repro_torch.models.model import LM
    jcfg = dataclasses.replace(r_arch("qwen2-1.5b").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_arch("qwen2-1.5b").reduced(),
                               dtype="float32")
    jm = JaxLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    return jm, jp, LM(tcfg), tp


TIERS = {
    "linear": dict(slots=4, max_len=32, prefill_chunk=8),
    "paged": dict(slots=6, max_len=32, prefill_chunk=8, paged=True,
                  block_len=8, n_blocks=13, spec_k=4),
}
METRICS = ("serve.tokens", "serve.preemptions", "serve.prompt_cache_hits",
           "serve.block_pool_utilization")


def _prompts(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(3, 12))).tolist()
            for _ in range(n)]


def _span_counts(events):
    """{(name, rid): count} over the serve.* spans and instants (rid None
    for the pool-wide ones: decode, draft, verify, trie_match)."""
    return collections.Counter(
        (e["name"], (e.get("args") or {}).get("rid"))
        for e in events if e["name"].startswith("serve."))


def _run(srv, prompts, budget):
    rids = [srv.submit(p, budget) for p in prompts]
    res = srv.run()
    return [res[r] for r in rids]


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_server_spans_and_metrics_are_repros(tier, f32_pair, tracers,
                                             tmp_path):
    """The same requests through repro's Server and the port's, each with
    its package's tracer and a registry: equal streams, equal span and
    instant counts per request, equal registry records of the four
    scheduler metrics; the port's trace and metrics files pass repro's
    validators and ``python -m repro_torch.obs validate``."""
    from repro.obs import __main__ as r_cli
    from repro.obs import metrics as r_metrics
    from repro.runtime.serve import ServeConfig as JaxServeConfig
    from repro.runtime.serve import Server as JaxServer
    from repro_torch.obs import __main__ as t_cli
    from repro_torch.obs import metrics as t_metrics
    from repro_torch.runtime.serve import ServeConfig, Server
    jm, jp, tm, tp = f32_pair
    kw = TIERS[tier]
    prompts = _prompts(jm.cfg.vocab, 6, 0)
    r_reg, t_reg = r_metrics.Registry(), t_metrics.Registry()
    js = JaxServer(jm, jp, JaxServeConfig(**kw), registry=r_reg)
    ts = Server(tm, tp, ServeConfig(**kw), registry=t_reg)
    outs = []
    for tracer, srv in zip(tracers, (js, ts)):
        tracer.enable()
        outs.append(_run(srv, prompts, 10))
        tracer.disable()
    assert outs[0] == outs[1]
    if tier == "paged":
        assert ts.preemptions > 0 and ts.verify_dispatches > 0
    want = _span_counts(tracers[0].events)
    assert _span_counts(tracers[1].events) == want
    for name in ("serve.admit", "serve.prefill", "serve.admitted",
                 "serve.retire"):
        assert any(k[0] == name for k in want), name
    pick = {m["name"]: m for m in r_reg.collect() if m["name"] in METRICS}
    got = {m["name"]: m for m in t_reg.collect() if m["name"] in METRICS}
    # (the linear tier never sets the pool gauge: NaN on both sides)
    assert json.dumps(got, sort_keys=True) == json.dumps(pick, sort_keys=True)
    assert got["serve.tokens"]["value"] == sum(len(o) for o in outs[1])
    trace, mfile = tmp_path / "t.json", tmp_path / "m.jsonl"
    trace.write_text(json.dumps(tracers[1].to_dict()))
    t_reg.dump_jsonl(str(mfile))
    assert r_cli.validate_trace(r_cli.load_trace(str(trace))) == []
    assert r_cli.validate_metrics(r_cli.load_metrics(str(mfile))) == []
    assert t_cli.main(["validate", str(trace), str(mfile)]) == 0


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_observation_changes_nothing(tier, tmp_path, tracers):
    """The port's Server (bf16, random init) with the tracer, a registry,
    a monitor with SLOs and a flight recorder, against the same server
    with none of them: equal streams, scheduler counters and plain-path
    calls."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import LM
    from repro_torch.obs import FlightRecorder, Monitor, Registry, SLO
    from repro_torch.runtime.serve import ServeConfig, Server
    cfg = get_arch("qwen2-1.5b").reduced()
    model = LM(cfg)
    params = model.init(0, device="cpu")
    prompts = _prompts(cfg.vocab, 6, 1)
    runs = []
    for observed in (False, True):
        kw = {}
        if observed:
            reg = Registry()
            tracers[1].enable()
            kw = dict(registry=reg, monitor=Monitor(
                slos=[SLO("itl", 1e-6), SLO("ttft", 1e-6)], registry=reg,
                recorder=FlightRecorder(str(tmp_path), registry=reg)))
        srv = Server(model, params, ServeConfig(**TIERS[tier]), **kw)
        ops.reset_plain_calls()
        streams = _run(srv, prompts, 10)
        runs.append((streams, srv.prefill_dispatches, srv.decode_dispatches,
                     srv.verify_dispatches, srv.preemptions,
                     srv.prompt_cache_hits, dict(ops.plain_calls)))
        if observed:
            kw["monitor"].recorder.close()
            assert kw["monitor"].n_events > 0     # the SLOs breached
    assert runs[0] == runs[1]


def test_itl_stall_fires_the_burn_rate_rule(tmp_path, tracers):
    """run_workload with a 0.5 s stall after decode steps 2-5: the ITL
    SLO (p95 under 0.3 s) breaches (the MAD-z rule may flag the first
    stall as an anomaly before), the breach writes a flight record that
    both packages' validators accept, and the monitor's counts match the
    scheduler's."""
    from repro.obs import flight as r_flight
    from repro_torch.launch.serve import run_workload
    from repro_torch.models.model import LM
    from repro_torch.obs import FlightRecorder, Monitor, Registry, SLO
    from repro_torch.obs import flight as t_flight
    from repro_torch.runtime.serve import ServeConfig, Server
    cfg = get_arch("qwen2-1.5b").reduced()
    model = LM(cfg)
    reg = Registry()
    rec = FlightRecorder(str(tmp_path), registry=reg)
    mon = Monitor(slos=[SLO("itl", target=0.3)], registry=reg, recorder=rec)
    srv = Server(model, model.init(0, device="cpu"),
                 ServeConfig(slots=4, max_len=32, prefill_chunk=8),
                 registry=reg, monitor=mon)

    def stall(n):
        if 2 <= n < 6:
            time.sleep(0.5)

    out = run_workload(srv, [(0.0, p) for p in _prompts(cfg.vocab, 4, 2)],
                       12, step_hook=stall)
    breaches = [e for e in mon.events if e["type"] == "slo_breach"]
    assert breaches and breaches[0]["signal"] == "itl"
    assert breaches[0]["flight"] in rec.dumps
    with open(breaches[0]["flight"]) as f:
        doc = json.load(f)
    assert t_flight.validate_flight(doc) == [] == \
        r_flight.validate_flight(doc)
    assert any(e["name"] == "serve.decode" for e in doc["traceEvents"])
    snap = mon.snapshot()["signals"]
    assert snap["ttft"]["count"] == out["requests"] == 4
    assert snap["itl"]["count"] == out["generated_tokens"] - 4
    assert reg.counter("serve.tokens").value == out["generated_tokens"]
    rec.close()


# -- the trainer ------------------------------------------------------------------

def test_trainer_straggler_and_losses():
    """Reduced qwen2-1.5b, 5 steps of 2 x 16: the losses at log_every 1
    and 3 and with a monitor and a straggler timeout on are bit-equal
    (repro's test_train_loss_log_interval_invariant); a 0.6 s stall after
    step 3's dispatch makes ``straggler_cb`` fire for step 3; with the
    monitor every step is observed."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import LM
    from repro_torch.obs import Monitor
    from repro_torch.runtime.train_loop import TrainConfig, train
    cfg = get_arch("qwen2-1.5b").reduced()
    dcfg = DataConfig(seed=0, vocab=cfg.vocab, seq_len=16, global_batch=2)
    losses = {}
    for tag, log_every, observed in (("le1", 1, False), ("le3", 3, False),
                                     ("mon", 10, True)):
        fired, kw = [], {}
        tcfg = TrainConfig(steps=5, log_every=log_every, warmup=1)
        if observed:
            tcfg.straggler_timeout_s = 0.5
            mon = Monitor()
            kw = dict(monitor=mon,
                      straggler_cb=lambda s, dt: fired.append((s, dt)),
                      step_hook=lambda s: time.sleep(0.6 if s == 3 else 0))
        out = train(LM(cfg), dcfg, tcfg, device="cpu", **kw)
        losses[tag] = [h["loss"] for h in out["history"]]
        if observed:
            assert 3 in [s for s, _ in fired]
            assert dict(fired)[3] >= 0.6
            counts = {k: v["count"] for k, v in
                      mon.snapshot()["signals"].items()}
            assert counts == {"step": 5, "data_wait": 5, "sync": 5}
            assert [h["sec"] for h in out["history"]][3] >= 0.6
    assert len(losses["le1"]) == 5
    assert losses["le1"] == losses["le3"] == losses["mon"]


# -- arrivals ------------------------------------------------------------------

class _Captured(Exception):
    pass


def test_poisson_arrivals_are_repros(monkeypatch):
    """``--arrivals poisson --rate 3`` at seed 5 for 7 requests: the
    (arrival time, prompt) pairs the port's launcher hands run_workload
    are those repro's hands its own (each launcher's run_workload is
    replaced by a catch; repro's Server by a stub, so nothing compiles)."""
    import repro.launch.serve as r_launch
    import repro.runtime.serve as r_serve
    import repro_torch.launch.serve as t_launch

    def catch(srv, arrivals, gen, step_hook=None):
        raise _Captured([(float(t), list(p)) for t, p in arrivals])

    class StubServer:
        def __init__(self, *a, **kw):
            self.outputs = {}

        def admit(self, *a, **kw):
            pass

        def run(self):
            pass

        def adopt_jits(self, other):
            pass

    argv = ["--arch", "qwen2-1.5b", "--reduced", "--requests", "7",
            "--arrivals", "poisson", "--rate", "3", "--seed", "5"]
    monkeypatch.setattr(r_launch, "run_workload", catch)
    monkeypatch.setattr(r_serve, "Server", StubServer)
    monkeypatch.setattr(t_launch, "run_workload", catch)
    got = {}
    for name, main, extra in (("repro", r_launch.main, []),
                              ("port", t_launch.main, ["--device", "cpu"])):
        with pytest.raises(_Captured) as e:
            main(argv + extra)
        got[name] = e.value.args[0]
    assert got["port"] == got["repro"]
    times = [t for t, _ in got["port"]]
    assert times == sorted(times) and times[0] > 0 and len(times) == 7


# -- 8 gloo ranks: collectives, drift, the --stages report ----------------------------

def _train_args():
    from repro_torch.launch.train import build_argparser
    return build_argparser().parse_args(
        ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu", "--mesh",
         "4x2", "--plan", "auto", "--stages", "2", "--steps", "1",
         "--batch", "8", "--seq", "16", "--warmup", "0"])


def _train_cfg():
    return dataclasses.replace(get_arch("llama3.2-3b").reduced(),
                               n_kv_heads=2)


def _rank_main(rank, world, path, train_plan, stages_rec, serve_json):
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    out = {}
    # hand-built: an all-reduce of 4000 bytes over the 8 ranks, an
    # all-gather of 1000-byte shards over "data" (4)
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    rec = comm._recorder_class()()
    with rec:
        dist.all_reduce(torch.ones(1000))
        funcol.all_gather_tensor(torch.ones(250), 0,
                                 mesh.get_group("data")).wait()
    out["hand"] = (list(rec.ops), comm.collect(rec.ops))
    # one planned train step with --stages 2: its drift and pipeline
    # records and its loss
    cfg = _train_cfg()
    trec = launch_train.run(_train_args(), cfg=cfg, plan_rec=train_plan,
                            pipeline_rec=stages_rec)
    out["train"] = {k: trec[k] for k in ("drift", "pipeline", "losses",
                                          "plan")}
    # the recorder's ops of the same step, for the formula check
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.launch.compile import plan_from_record
    from repro_torch.models.model import LM
    from repro_torch.models.sharding import place
    from repro_torch.runtime.train_loop import TrainConfig, make_engine
    tmesh_ = tmesh.make_mesh((4, 2), ("data", "model"), "cpu")
    eng = make_engine(LM(cfg), TrainConfig(), device="cpu", mesh=tmesh_,
                      plan=plan_from_record(train_plan))
    state = eng.init_state(0)
    pl = eng.batch_placements()
    batch = {k: place(torch.from_numpy(v), tmesh_, pl[k]) for k, v in
             host_batch(DataConfig(vocab=cfg.vocab, seq_len=16,
                                   global_batch=8), 0).items()}
    rec = comm._recorder_class()()
    with rec:
        _, m = eng.step(state, batch)
    out["train_ops"] = list(rec.ops)
    out["engine_loss"] = float(m["loss"])
    out["seq_cut"] = _seq_cut_forwards(tmesh_)
    # one planned decode step through the serving launcher
    launch_serve.main(SERVE_ARGS + ["--json-out", serve_json])
    if rank == 0:
        torch.save(out, path)


SEQ_CUT = {"data": "batch", "model": "seq"}


def _seq_cut_forwards(mesh):
    """The reduced llama3.2-3b (f32, 2 KV heads) forward on 8 x 16 tokens
    under a plan that cuts ``x`` and ``logits`` on batch over data and
    seq over model (llama3.2-3b prefill_32k's pod1 activations cut),
    with and without autograd, and with no plan: the logits, whole, and
    the attention fallbacks each planned forward counted."""
    from repro_torch.core.plan import ShardingPlan
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.kernels import ops
    from repro_torch.models.model import LM
    from repro_torch.models.sharding import (batch_placements, place,
                                             place_tree)
    cfg = dataclasses.replace(_train_cfg(), dtype="float32")
    tokens = torch.from_numpy(host_batch(DataConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=8), 3)["tokens"])
    params = LM(cfg).init(0, device="cpu")
    out = {}
    with torch.no_grad():
        out["plain"] = LM(cfg).forward(params, tokens)[0]
    plan = ShardingPlan(("data", "model"), {"x": SEQ_CUT, "logits": SEQ_CUT})
    model = LM(cfg, plan=plan, mesh=mesh)
    placed = place_tree(params, mesh, plan)
    tok = place(tokens, mesh, batch_placements(plan, mesh.mesh_dim_names,
                                               "prefill"))
    for grad in (False, True):
        before = ops.plan_fallbacks["attention"]
        with torch.set_grad_enabled(grad):
            logits = model.forward(placed, tok)[0]
        out[grad] = (logits.full_tensor().detach(),
                     ops.plan_fallbacks["attention"] - before)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The parent solves the plans at beam 32 (the decode plan into the
    plan cache the serving launcher reads), then spawns 8 gloo ranks."""
    from repro_torch.launch.compile import solve_cell_plan
    from repro_torch.launch.train import solve_stages
    d = tmp_path_factory.mktemp("obs_ranks")
    axes = tmesh.solver_axes((4, 2))
    cfg = _train_cfg()
    train_plan = solve_cell_plan(
        cfg, ShapeConfig(*TRAIN_SHAPE), axes, "obs_mesh4x2_mp",
        use_cache=False, beam=32,
        graph_kwargs={"master_fp32": True, "error_feedback": False})
    solve_cell_plan(get_arch("qwen2-1.5b").reduced(),
                    ShapeConfig("server8x48", 48, 8, "decode"), axes,
                    "mesh4x2", use_cache=False, beam=32)
    stages_rec = solve_stages(_train_args(), cfg, beam=32)
    path, serve_json = d / "out.pt", d / "serve.json"
    tmesh.spawn(_rank_main, 8, "cpu",
                (str(path), train_plan, stages_rec, str(serve_json)))
    out = torch.load(path, weights_only=False)
    out["serve"] = json.loads(serve_json.read_text())
    out["train_plan"] = train_plan
    return out


def test_hand_built_collectives_price_by_the_ring_formulas(ranks):
    """4000 bytes all-reduced over 8 ranks: 2 x 4000 x 7 / 8 = 7000 wire
    bytes a rank; 1000-byte shards gathered over 4: a 4000-byte result,
    4000 x 3 / 4 = 3000."""
    ops, stats = ranks["hand"]
    assert ops == [("all-reduce", 4000.0, 8), ("all-gather", 4000.0, 4)]
    assert stats.wire_by_kind == {"all-reduce": 7000.0,
                                  "all-gather": 3000.0}
    assert stats.wire_bytes_per_device == 10000.0
    assert stats.counts == {"all-reduce": 1, "all-gather": 1}


def test_drift_of_a_train_and_a_decode_step(ranks):
    """The measured totals are the ring formulas summed over the recorded
    collectives, times 8.  The train step's ratio lies in repro's band
    [0.25, 4]; the decode step's predicted and measured bytes are both
    under repro's ABS_FLOOR, so its ratio is 1.0 (see the module
    docstring for their values)."""
    from repro.verify.calibration import ABS_FLOOR, RATIO_HI, RATIO_LO
    d = ranks["train"]["drift"]
    ops = ranks["train_ops"]
    assert ops and not any(k.startswith("unpriced") for k, _, _ in ops)
    per_dev = sum(comm.ring_wire_bytes(k, s, g) for k, s, g in ops)
    assert d["measured_wire_bytes"] == pytest.approx(per_dev * 8, rel=1e-12)
    assert d["predicted_wire_bytes"] == \
        ranks["train_plan"]["breakdown"]["total"]
    assert d["n_devices"] == 8
    assert RATIO_LO <= d["ratio"] <= RATIO_HI and d["in_band"], d
    assert sum(d["collective_counts"].values()) == len(ops)
    s = ranks["serve"]["drift"]
    assert s["n_devices"] == 8
    assert 0 < s["measured_wire_bytes"] < ABS_FLOOR, s
    assert s["predicted_wire_bytes"] < ABS_FLOOR, s
    assert s["ratio"] == 1.0 and s["in_band"]
    assert ranks["serve"]["requests"] == 8


def test_fake_group_trace_records_the_gloo_collectives(ranks):
    """The dry run's trace of the same train step (``analysis/
    cost_trace``: rank 0 of torch's fake process group of 8 in this
    process, state and batch on meta shards) records the collectives that
    rank 0 of the gloo run recorded: the same kinds, counts, per-device
    result bytes and group sizes, op for op."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.analysis.cost_trace import trace_step
    from repro_torch.launch.compile import plan_from_record
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = init_device_mesh("cpu", (4, 2),
                                mesh_dim_names=("data", "model"))
        cost = trace_step(_train_cfg(), ShapeConfig(*TRAIN_SHAPE),
                          plan_from_record(ranks["train_plan"]), mesh)
    finally:
        dist.destroy_process_group()
    gloo = comm.collect(ranks["train_ops"])
    assert cost.ops == ranks["train_ops"]
    assert cost.collectives.counts == gloo.counts
    assert cost.collectives.result_bytes == gloo.result_bytes
    assert cost.collectives.wire_bytes_per_device == \
        gloo.wire_bytes_per_device
    assert cost.flops > 0 and cost.hbm_bytes > 0


@pytest.mark.parametrize("grad", [False, True])
def test_seq_cut_forward_is_the_unplanned_one(ranks, grad):
    """The forward under a batch-over-data, seq-over-model cut of the
    activations on the 8 gloo ranks: each of the 4 layers' attention
    calls is a counted fallback (no local rule for a seq cut), which
    keeps the batch cut and, without autograd, the queries' seq cut at
    their offset (k and v gathered over model), with autograd gathers q
    too; the logits are within u R max|logits| of the unplanned
    forward's, u = 2^-24 and R = 4 x 496 + 128 = 2112 the reduction
    lengths from the embedding to a logit (tests/test_torch_serve_plan.py's
    derivation: d 64, hd 16, 16 positions, 4 heads, d_ff 128)."""
    d = ranks["seq_cut"]
    logits, fallbacks = d[grad]
    plain = d["plain"]
    assert fallbacks == 4
    tol = 2.0 ** -24 * 2112 * float(plain.abs().max())
    err = float((logits - plain).abs().max())
    assert err <= tol, (err, tol)


def test_stages_launcher_reports_repros_pipeline_plan(ranks):
    """``launch.train --mesh 4x2 --plan auto --stages 2`` carries the
    record of ``solve_stages``, which equals repro's ``solve_pipeline``
    on repro's graph of the same config and shape, given the port's axes
    and peak rate (stage count, cuts, bubble factor, modeled and flat
    step, every candidate); the run then trained on the flat plan: its
    loss is the planned engine step's on the same batch, bit for bit."""
    from repro.configs.base import ShapeConfig as RShape
    from repro.configs.base import get_arch as r_arch
    from repro.core.builders import build_graph as r_build
    from repro.core.solver import MeshAxis as RAxis
    from repro.core.solver import solve_pipeline as r_solve
    from repro_torch.core.solver import DEFAULT_PEAK_FLOPS
    rec = ranks["train"]
    p = rec["pipeline"]
    rg = r_build(dataclasses.replace(r_arch("llama3.2-3b").reduced(),
                                     n_kv_heads=2),
                 RShape("stages8x16", 16, 8, "train"), master_fp32=True)
    raxes = [RAxis(a.name, a.size, a.bandwidth)
             for a in tmesh.solver_axes((4, 2))]
    want = r_solve(rg, raxes, n_micro=1, stage_counts=(1, 2), beam=32,
                   mem_scale=0.0, peak_flops=DEFAULT_PEAK_FLOPS)
    assert (p["n_stages"], p["cuts"], p["n_micro"]) == \
        (want.n_stages, want.cuts, 1)
    assert p["bubble_factor"] == want.bubble_factor
    assert p["modeled_step_s"] == want.total_seconds
    assert p["flat_step_s"] == want.candidates[1]
    assert p["candidates_ms"] == {str(k): v * 1e3
                                  for k, v in want.candidates.items()}
    assert p["n_stages"] == 2
    assert rec["plan"] is not None and rec["drift"] is not None
    assert rec["losses"] == [ranks["engine_loss"]]
