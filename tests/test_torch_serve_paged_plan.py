"""Serving's remaining tiers under a solved plan on 8 gloo ranks: the
paged pool with its block table, speculative drafts and the re-score on
both tiers, and danube's scan prefill, against repro's ``Server`` under
the same plans on 8 host devices and against the single-process port
with no plan.

One spawn of 8 ranks for the file, a (4, 2) ("data", "model") mesh,
torch on one thread a rank; beside it one subprocess with 8 forced host
devices runs repro's Server under repro's own plans.  The weights are
the port's ``LM(cfg).init(0)`` in f32, handed to repro as numpy.  The
dense configs are reduced qwen2-1.5b (one KV head) and llama3.2-3b with
two KV heads (so a kv_heads cut by 2 divides), at
``repro.verify.serve_paged_cell``'s sizes: 4 slots, max_len 32, blocks
of 8, spec_k 4, its 6 requests of 3-11 tokens with 8 new tokens each,
after two requests that share a 16-token prefix.  The pool has 10
blocks, so the scheduler preempts and resumes.  Plans, by config:

  qwen2 ``solved``: the reduced config's own decode plan; its cache cut
      (batch on data, seq_kv on model) names no dim of the pool, so pool
      and table are whole on every rank (the linear tier's seq_kv cut
      takes the counted gathered route);
  llama ``paged``: solved from ``decode_graph(paged=True)``: the table
      cut on batch over data, the pool (replicated per data shard) on
      kv_heads over model;
  llama ``megatron``: ``manual_megatron_plan`` with the pool cut on
      kv_heads (its own names ``heads``, which no pool dim has);
  qwen2 ``blocks``: ``manual_megatron_plan`` with the pool cut on
      ``blocks``, which has no local-shard rule: every paged call gathers
      and is counted in ``ops.plan_fallbacks``.

Each serves ``paged`` (spec_k 4 on the 10-block pool: the drafts, the
re-score, a preemption and its resume scan, the second shared-prefix
request re-linking the first's block 0 from another data shard and
copying its block 1, copy-on-write) and ``forced`` (the paged pool
teacher-forced: 4 prefills on 4 slots, 4 decode steps with fixed
tokens); the first two plans also ``linear`` (spec_k 4 on the linear
cache: its re-score gathered under the seq_kv cut, on the owner ranks
under the batch cut; the other two plans cut the linear cache as the
second does).  Streams,
dispatch counters and retirements are equal.  The teacher-forced
logits are within FORCED_ATOL = 1e-5 of the unplanned port's and of
repro's under the same plan (measured: at most 3.6e-6, f32 sums in
another order on the shards).  Every other logits row a run sampled from
(the prefills, each decode step's or last draft step's rows that
advanced) is within SERVED_ATOL = 1e-3, test_torch_serve_paged.py's f32
band: over a free run an f32 difference of one ulp in a K or V entry
can round to another bf16 value in the cache and then moves the logits
by ~1e-4 (measured: at most 1.8e-4 for the dense configs, the port and
repro unplanned differ by as much; 7.2e-4 for danube against repro
under its solved plan, whose own gap to repro unplanned is as large).
h2o-danube-3-4b reduced (window 16) serves 4 requests through its scan
prefill, two prompts longer than its ring of 16, to position 32, under
its solved plan (a seq_kv cut: the counted gathered route) and under
megatron (batch on data: the owner rule), against repro's Server under
the same plans.  Every rank imports only torch and the port."""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.core.plan import ShardingPlan, manual_megatron_plan
from repro_torch.kernels import ops
from repro_torch.launch.mesh import spawn
from repro_torch.models.model import LM
from repro_torch.runtime.serve import ServeConfig, Server

FORCED_ATOL = 1e-5
SERVED_ATOL = 1e-3
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
MESH = (4, 2)
NAMES = ("data", "model")
# repro.verify.serve_paged_cell's sizes
SLOTS, MAX_LEN, BLOCK_LEN, BUDGET, N_REQ, SPEC_K = 4, 32, 8, 8, 6, 4
N_BLOCKS = 10           # preempts; even, so a blocks cut by 2 divides
PAGED = ServeConfig(slots=SLOTS, max_len=MAX_LEN, paged=True,
                    block_len=BLOCK_LEN, n_blocks=N_BLOCKS, spec_k=SPEC_K)
LINEAR = ServeConfig(slots=SLOTS, max_len=MAX_LEN, spec_k=SPEC_K)
SHARED = list(range(40, 60))


def _cell_prompts():
    rng = np.random.default_rng(0)          # serve_paged_cell's draw
    return [rng.integers(0, 256, size=int(rng.integers(3, 12))).tolist()
            for _ in range(N_REQ)]


PROMPTS = [SHARED, SHARED[:16]] + _cell_prompts()
FORCED = np.random.default_rng(1).integers(0, 256, size=(4, SLOTS))
DANUBE = "h2o-danube-3-4b"
DANUBE_SCFG = ServeConfig(slots=SLOTS, max_len=48, prefill_chunk=8)
DANUBE_PROMPTS = [p.tolist() for p in np.split(
    np.random.default_rng(2).integers(0, 256, size=46), [20, 25, 43])]
DANUBE_GEN = 12
KV_HEADS = {"qwen2-1.5b": None, "llama3.2-3b": 2, DANUBE: None}
CASES = [("qwen2-1.5b", "solved"), ("llama3.2-3b", "paged"),
         ("llama3.2-3b", "megatron"), ("qwen2-1.5b", "blocks"),
         (DANUBE, "solved"), (DANUBE, "megatron")]
DENSE = CASES[:4]
LINEAR_TOO = CASES[:2]          # the plans that also serve the linear tier
COUNTERS = ("prefill_dispatches", "decode_dispatches", "verify_dispatches",
            "preemptions", "prompt_cache_hits")


def _cfg(arch):
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    if KV_HEADS[arch]:
        cfg = dataclasses.replace(cfg, n_kv_heads=KV_HEADS[arch])
    return cfg


def _shape(arch):
    if arch == DANUBE:
        return ShapeConfig("serve4x48", DANUBE_SCFG.max_len, SLOTS, "decode")
    return ShapeConfig("serve4x32", MAX_LEN, SLOTS, "decode")


def _megatron(make, kv_cut):
    return make(NAMES, ["data"], "model").with_override(
        "kv_cache", {"data": "batch", "model": kv_cut})


def _recording(base):
    """``base`` (the port's or repro's Server) recording every logits row
    sampling read: each admission's, and the rows that advanced in each
    decode step or speculative round (the last draft step's logits); an
    inactive row's logits read the null block, whose bytes differ
    between the two packages (repro drops those writes)."""
    class Recording(base):
        logs: list
        copies = 0

        def _admit(self, req, slot, method="chunked"):
            ev = super()._admit(req, slot, method)
            self.logs.append(np.asarray(self.prefill_logits[slot]).copy())
            return ev

        def _step(self, fn):
            pos, n = self.pos.copy(), self.decode_dispatches
            ev = fn()
            if self.decode_dispatches > n:
                moved = self.pos > pos
                self.logs.append(np.asarray(self.last_logits)[moved].copy())
            return ev

        def decode_once(self, forced_tokens=None):
            return self._step(lambda: super(Recording, self).decode_once(
                forced_tokens))

        def spec_once(self):
            return self._step(lambda: super(Recording, self).spec_once())

        def _copy_block(self, dst, src):        # the port's CoW
            self.copies += 1
            return super()._copy_block(dst, src)
    return Recording


def _run(make, scfg, prompts, budget, note):
    srv = make(scfg)
    for p in prompts:
        srv.submit(p, max_new_tokens=budget)
    rec = dict(streams=srv.run(),
               counters={c: getattr(srv, c) for c in COUNTERS},
               finished=dict(srv.finished), logits=srv.logs,
               copies=srv.copies)
    return note(srv, rec)


def _forced(make, note):
    """serve_paged_cell's sharded leg: 4 prefills, then 4 decode steps
    fed fixed tokens, on the paged pool."""
    srv = make(PAGED)
    for s, p in enumerate(PROMPTS[2:2 + SLOTS]):
        srv.admit(p, s)
    for f in FORCED:
        srv.decode_once(f)
    return note(srv, dict(logits=srv.logs))


def serve_all(make, cfg, linear, note=lambda srv, rec: rec):
    """The runs of config ``cfg`` on one side (``linear``: the linear
    tier's too): ``make(scfg)`` builds a recording Server,
    ``note(server, record)`` adds to each run's record."""
    if cfg.swa_window:
        return {"danube": _run(make, DANUBE_SCFG, DANUBE_PROMPTS,
                               DANUBE_GEN, note)}
    out = {"paged": _run(make, PAGED, PROMPTS, BUDGET, note),
           "forced": _forced(make, note)}
    if linear:
        out["linear"] = _run(make, LINEAR, PROMPTS, BUDGET, note)
    return out


def _serve_port(model, params, linear=True):
    """The port's runs; each record also carries the plain calls (the
    kernels' stand-ins on the CPU) and the plan fallbacks it counted,
    and, under a plan, each cache leaf's placements and local shape."""
    cls = _recording(Server)

    def make(scfg):
        ops.reset_plain_calls()
        srv = cls(model, params, scfg)
        srv.logs = []
        return srv

    def note(srv, rec):
        rec.update(plain=dict(ops.plain_calls),
                   fallbacks=dict(ops.plan_fallbacks))
        if model.plan is not None:
            leaves = dict(pos=srv.cache["pos"],
                          k=(srv.cache.get("pages") or srv.cache["kv"])["k"])
            if "block_table" in srv.cache:
                leaves["block_table"] = srv.cache["block_table"]
            rec["layout"] = {k: (tuple(map(str, v.placements)),
                                 tuple(v.to_local().shape))
                             for k, v in leaves.items()}
        return rec
    return serve_all(make, model.cfg, linear, note)


def _rank_main(rank, world, plans, path):
    """One rank: every run under every plan; rank 0 saves the results,
    with each rank's plain calls and the cache layouts."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    mesh = make_mesh(MESH, NAMES, "cpu")
    out = {}
    for (arch, name), plan in plans.items():
        cfg = _cfg(arch)
        out[(arch, name)] = _serve_port(LM(cfg, plan=plan, mesh=mesh),
                                        LM(cfg).init(0, device="cpu"),
                                        (arch, name) in LINEAR_TOO)
    plain = [None] * world
    dist.all_gather_object(plain, {
        key: {tier: r["plain"] for tier, r in res.items()}
        for key, res in out.items()})
    if rank == 0:
        torch.save({"out": out, "plain": plain}, path)


@pytest.fixture(scope="module")
def plans():
    from repro_torch.core.builders import decode_graph
    from repro_torch.core.solver import solve_mesh
    from repro_torch.launch.mesh import solver_axes

    def solved(arch, paged):
        g = decode_graph(_cfg(arch), _shape(arch), paged=paged,
                         block_len=BLOCK_LEN)
        return ShardingPlan.from_graph_solution(
            solve_mesh(g, solver_axes(MESH, NAMES)), g)

    make = {"solved": lambda a: solved(a, False),
            "paged": lambda a: solved(a, True),
            "blocks": lambda a: _megatron(manual_megatron_plan, "blocks"),
            "megatron": lambda a: _megatron(
                manual_megatron_plan, "heads" if a == DANUBE else "kv_heads")}
    return {(a, n): make[n](a) for a, n in CASES}


def _repro_main(params_path, out_path):
    """repro's side, in a process with 8 host devices: its Server with no
    plan and under each of repro's own plans, on the same weights."""
    import jax

    from repro.compat import make_compat_mesh
    from repro.configs import get_arch as r_arch
    from repro.configs.base import ShapeConfig as RShape
    from repro.core.builders import decode_graph
    from repro.core.plan import ShardingPlan as RPlan
    from repro.core.plan import manual_megatron_plan as r_megatron
    from repro.core.solver import solve_mesh
    from repro.launch.mesh import mesh_to_solver_axes
    from repro.models.model import LM as RLM
    from repro.runtime.serve import ServeConfig as RServeConfig
    from repro.runtime.serve import Server as RServer

    mesh = make_compat_mesh(MESH, NAMES)
    with open(params_path, "rb") as f:
        weights = pickle.load(f)
    cls = _recording(RServer)

    def rcfg(arch):
        cfg = dataclasses.replace(r_arch(arch).reduced(), dtype="float32")
        if KV_HEADS[arch]:
            cfg = dataclasses.replace(cfg, n_kv_heads=KV_HEADS[arch])
        return cfg

    def plan_of(arch, name):
        if name in ("blocks", "megatron"):
            return _megatron(r_megatron, "blocks" if name == "blocks" else
                             "heads" if arch == DANUBE else "kv_heads")
        s = _shape(arch)
        g = decode_graph(rcfg(arch), RShape(s.name, s.seq_len,
                                            s.global_batch, s.kind),
                         paged=name == "paged", block_len=BLOCK_LEN)
        return RPlan.from_graph_solution(
            solve_mesh(g, mesh_to_solver_axes(mesh)), g)

    out = {}
    for arch, name in [(a, None) for a in KV_HEADS] + CASES:
        cfg = rcfg(arch)
        params = jax.tree_util.tree_map(jax.numpy.asarray, weights[arch])
        plan = None if name is None else plan_of(arch, name)
        m = None if plan is None else mesh

        def make(scfg):
            srv = cls(RLM(cfg, plan=plan, mesh=m), params,
                      RServeConfig(**dataclasses.asdict(scfg)), mesh=m)
            srv.logs = []
            return srv
        out[(arch, name)] = serve_all(
            make, cfg, name is None or (arch, name) in LINEAR_TOO)
        out[(arch, name)]["role_cuts"] = (None if plan is None
                                          else plan.role_cuts)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(plans, tmp_path_factory):
    """(the unplanned port by arch, the 8 ranks' results, repro's), the
    ranks and repro's subprocess running side by side."""
    tmp = tmp_path_factory.mktemp("ranks")
    params = {a: LM(_cfg(a)).init(0, device="cpu") for a in KV_HEADS}
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump({a: _numpy_tree(p) for a, p in params.items()}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(tmp / "params.pkl"),
         str(tmp / "repro.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            ref = {a: _serve_port(LM(_cfg(a)), params[a])
                   for a in KV_HEADS}
        finally:
            torch.set_num_threads(n)
        spawn(_rank_main, MESH[0] * MESH[1], "cpu",
              (plans, str(tmp / "out.pt")))
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    with open(tmp / "repro.pkl", "rb") as f:
        rep = pickle.load(f)
    return ref, torch.load(tmp / "out.pt", weights_only=False), rep


def _numpy_tree(t):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in t.items()}


def _check_like(want, got, atol=SERVED_ATOL, budget=BUDGET):
    """The same streams (every request to its full length), dispatch
    counters and retirements, and every recorded logits row within
    ``atol``."""
    if "streams" in want:
        assert got["streams"] == want["streams"]
        assert all(len(t) == budget for t in got["streams"].values())
        assert got["counters"] == want["counters"]
        assert got["finished"] == want["finished"]
    assert len(got["logits"]) == len(want["logits"])
    err = max(float(np.abs(a - b).max()) if a.size else 0.0
              for a, b in zip(got["logits"], want["logits"]))
    assert err <= atol, err


def test_plans_are_repros_cut_for_cut(plans, runs):
    """The port's plans, from its solver (the plain decode graph and the
    paged one) and its helpers, are repro's, each role cut on each axis;
    the paged graph gives the table a role, cut on batch over data."""
    _, _, rep = runs
    for key, plan in plans.items():
        assert plan.role_cuts == rep[key]["role_cuts"], key
    assert "block_table" not in plans[("qwen2-1.5b", "solved")].role_cuts
    assert plans[("llama3.2-3b", "paged")].role_cuts["block_table"] == {
        "data": "batch", "model": None}


@pytest.mark.parametrize("arch,name", DENSE)
def test_serves_like_repro_and_the_unplanned_port(runs, arch, name):
    """Each plan's paged (drafts, re-scores, preemption, resume, CoW),
    linear speculative and teacher-forced runs against repro's Server
    under the same plan and the port with no plan: the same streams,
    counters and retirements; teacher-forced logits within FORCED_ATOL,
    the free runs' within SERVED_ATOL."""
    ref, out, rep = runs
    got = out["out"][(arch, name)]
    assert ("linear" in got) == ((arch, name) in LINEAR_TOO)
    for tier in ("paged", "linear", "forced"):
        if tier not in got:
            continue
        atol = FORCED_ATOL if tier == "forced" else SERVED_ATOL
        _check_like(rep[(arch, name)][tier], got[tier], atol)
        _check_like(ref[arch][tier], got[tier], atol)
        _check_like(rep[(arch, None)][tier], ref[arch][tier], atol)
    c = got["paged"]["counters"]
    assert c["preemptions"] >= 1 and c["verify_dispatches"] >= 1
    assert ref[arch]["linear"]["counters"]["verify_dispatches"] >= 1
    # the second request re-linked block 0 and copied block 1 (7 tokens)
    assert c["prompt_cache_hits"] >= 15 and got["paged"]["copies"] >= 1


def test_a_prefix_block_written_on_another_data_shard(runs):
    """The llama paged plan cuts the table on batch over the 4 data
    shards, one slot each.  Request 1 is admitted into slot 1 right after
    request 0's prefill in slot 0 and re-links its first block: data
    shard 1 reads a block that slot 0's prefill wrote.  Every rank writes
    every row into its pool replica, so request 1's stream and logits
    are the unplanned port's (a rank that wrote only its own rows would
    leave shard 1's replica stale)."""
    ref, out, _ = runs
    got = out["out"][("llama3.2-3b", "paged")]["paged"]
    assert got["layout"]["block_table"] == (("S(0)", "R"), (1, 4))
    assert got["streams"][1] == ref["llama3.2-3b"]["paged"]["streams"][1]
    assert got["counters"]["prompt_cache_hits"] >= 15


def test_pool_and_table_allocated_shard_by_shard(runs):
    """Each rank allocates its shard only: the [4, 10, 8, KV, 16] pool
    whole on blocks (replicated over data), cut on kv_heads where the plan
    says so; the [4, 4] table cut on batch over data or whole."""
    _, out, _ = runs
    lay = {k: v["paged"]["layout"] for k, v in out["out"].items()
           if "paged" in v}
    assert lay[("qwen2-1.5b", "solved")] == {
        "pos": (("R", "R"), (4,)), "block_table": (("R", "R"), (4, 4)),
        "k": (("R", "R"), (4, 10, 8, 1, 16))}
    for name in ("paged", "megatron"):
        assert lay[("llama3.2-3b", name)] == {
            "pos": (("R", "R"), (4,)),
            "block_table": (("S(0)", "R"), (1, 4)),
            "k": (("R", "S(3)"), (4, 10, 8, 1, 16))}
    assert lay[("qwen2-1.5b", "blocks")]["k"] == (("R", "S(1)"),
                                                  (4, 5, 8, 1, 16))


# the (config, plan) pairs whose cut has no local-shard rule on a tier
GATHERED = {("qwen2-1.5b", "solved"): "linear",    # the cache on seq_kv
            ("qwen2-1.5b", "blocks"): "paged"}     # the pool on blocks


def test_kernels_launch_as_on_the_unplanned_tier(runs):
    """On every rank the paged decode kernel (draft steps, resume-scan
    steps, a re-score a layer a round) and the decode kernel (the linear
    tier's steps and re-scores) ran exactly as often as in the unplanned
    port, on local shards or, where the cut has no local rule, on the
    gathered tensors; only there a call is counted as a fallback.  Each
    prefill chunk's forward ran on the ranks that own its slot: world x
    (local rows / slots) of them, every rank on the gathered route."""
    ref, out, _ = runs
    for arch, name in DENSE:
        res = out["out"][(arch, name)]
        for tier in ("paged", "linear")[:1 + ((arch, name) in LINEAR_TOO)]:
            gathered = GATHERED.get((arch, name)) == tier
            key = (arch, name, tier)
            assert bool(sum(res[tier]["fallbacks"].values())) == gathered, \
                key
            want = ref[arch][tier]["plain"]
            per_rank = [p[(arch, name)][tier] for p in out["plain"]]
            for k in ("flash_attention_paged_decode_ref",
                      "flash_attention_decode_ref"):
                assert {p[k] for p in per_rank} == {want[k]}, (key, k)
            lay = res[tier]["layout"]
            rows = (lay["block_table"][1][0] if tier == "paged"
                    else lay["k"][1][1])
            owners = 8 if gathered else 8 * rows // SLOTS
            assert sum(p["flash_attention_fwd_ref"] for p in per_rank) == \
                owners * want["flash_attention_fwd_ref"], key
    assert sum(out["out"][("llama3.2-3b", "paged")]["forced"][
        "fallbacks"].values()) == 0


def test_pool_cut_on_blocks_falls_back_and_counts(runs):
    """The pool cut on ``blocks`` has no local-shard rule: every paged
    decode step (drafts and resume scans), prefill chunk and re-score
    gathers and runs the same kernel wrapper, each counted; each
    copy-on-write gathers its K and V pools' blocks cut, counted; the
    streams are the unplanned port's and repro's."""
    ref, out, _ = runs
    got = out["out"][("qwen2-1.5b", "blocks")]["paged"]
    want = ref["qwen2-1.5b"]["paged"]
    L = _cfg("qwen2-1.5b").n_layers
    rescores = L * want["counters"]["verify_dispatches"]
    assert got["fallbacks"] == {
        "attend_cache": 0, "attention": 0,
        "prefill_attention": want["plain"]["flash_attention_fwd_ref"],
        "attend_paged": (want["plain"]["flash_attention_paged_decode_ref"]
                         - rescores),
        "rescore": rescores, "copy_block": 2 * want["copies"]}
    assert got["fallbacks"]["attend_paged"] > 0 and want["copies"] >= 1
    assert got["plain"] == want["plain"]


@pytest.mark.parametrize("name", ["solved", "megatron"])
def test_danube_scan_prefill_under_a_plan_past_its_window(runs, name):
    """Reduced danube (window 16, a ring of 16) under a plan: prompts of
    20 and 18 tokens wrap the ring in the scan prefill and the streams
    run to position 32; the streams, counters and logits are repro's
    under the same plan and the unplanned port's.  Its solved plan cuts
    the ring on seq_kv: every scan and decode step gathers, counted;
    megatron cuts batch only: the owner of the slot's row writes and
    attends, nothing falls back."""
    ref, out, rep = runs
    got = out["out"][(DANUBE, name)]["danube"]
    _check_like(rep[(DANUBE, name)]["danube"], got, budget=DANUBE_GEN)
    _check_like(ref[DANUBE]["danube"], got, budget=DANUBE_GEN)
    _check_like(rep[(DANUBE, None)]["danube"], ref[DANUBE]["danube"],
                budget=DANUBE_GEN)
    assert max(map(len, DANUBE_PROMPTS)) > _cfg(DANUBE).swa_window
    L = _cfg(DANUBE).n_layers
    steps = (got["counters"]["decode_dispatches"]
             + sum(map(len, DANUBE_PROMPTS)))
    want = L * steps if name == "solved" else 0
    assert got["fallbacks"]["attend_cache"] == want
    assert sum(got["fallbacks"].values()) == want


def test_for_pool_drops_the_table_batch_cut_as_the_caches():
    """``ShardingPlan.for_pool`` drops a batch cut of ``block_table``
    exactly where it drops ``kv_cache``'s: on the mesh axes whose running
    product stops dividing the slot count."""
    cuts = {"data": "batch", "model": "batch"}
    plan = ShardingPlan(NAMES, {"kv_cache": dict(cuts),
                                "block_table": dict(cuts)})
    for slots, want in ((8, cuts), (4, {"data": "batch", "model": None}),
                        (6, {"data": None, "model": "batch"}),
                        (3, {"data": None, "model": None})):
        pool = plan.for_pool(slots, {"data": 4, "model": 2})
        assert pool.role_cuts["block_table"] == want, slots
        assert pool.role_cuts["kv_cache"] == want, slots


if __name__ == "__main__":
    _repro_main(sys.argv[1], sys.argv[2])
