"""Linear-tier serving under a solved plan on 8 gloo ranks, against
repro's ``Server`` under the same plan on 8 host devices and against the
single-process port ``Server`` with no plan.

The weights are the port's ``LM(cfg).init(0)`` (reduced qwen2-1.5b, f32),
handed to repro as numpy.  One spawn of 8 ranks for the file, a
(4, 2) ("data", "model") mesh, torch on one thread a rank; at the same
time one subprocess with 8 forced host devices runs repro's Server under
repro's own plans.  Each serves greedy, 8 slots, five requests of mixed
prompt lengths (two of them longer than a prefill chunk), under four
plans in turn:

  (a) the reduced config's own solved decode plan: it cuts ``batch``
      only;
  (b) the full-width config's (4, 2) decode plan, solved with repro's
      constants (its 16 GB HBM), applied to the reduced model: the cuts
      are by dim name, and 64 / 128 / 256 divide by 8, so ``embed``,
      ``logits``, ``w_gate`` and ``w_down`` really shard;
  (c) ``manual_megatron_plan``, with its ``kv_cache`` cut put on
      ``kv_heads`` (the plan names ``heads``, which no dim of the cache
      carries): the single KV head does not divide by 2, so every
      attention call takes the counted fallback (repro cannot place this
      cache at all: JAX refuses a cut that does not divide);
  (d) ``manual_megatron_plan`` with its ``kv_cache`` cut on ``seq_kv``,
      which would split the softmax: the port's counted fallback again,
      here against repro's own path under the same plan.

The plans equal repro's cut for cut.  Each run gives repro's streams and
dispatch counters under the same plan (for (c), repro's unplanned ones)
and the unplanned port's, its logits within 1e-5 of both; (a) and (b)
count no fallback, (c) and (d) count every attention call.  In process: a
plan serves the paged tier and speculative decoding on one rank, and
refuses the hybrid family.
Every rank imports only torch and the port (repro is imported in the
``plans`` fixture and in the subprocess alone)."""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.core.plan import manual_megatron_plan
from repro_torch.kernels import ops
from repro_torch.launch.mesh import spawn
from repro_torch.models.model import LM
from repro_torch.runtime.serve import ServeConfig, Server

LOGITS_ATOL = 1e-5
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
MESH = (4, 2)
NAMES = ("data", "model")
SCFG = ServeConfig(slots=8, max_len=64, prefill_chunk=8)
PROMPTS = [[3, 17, 99, 5, 8, 2, 41], [7] * 3, list(range(20, 45)),
           [11, 12], [200] + list(range(1, 11))]
GEN = 6


def _cfg():
    return dataclasses.replace(get_arch("qwen2-1.5b").reduced(),
                               dtype="float32")


def serve(model, params):
    """Run PROMPTS through a Server and return its streams, counters and
    every logits row sampling read (prefill, then each decode step)."""
    logs = []

    class Recording(Server):
        def _admit(self, req, slot, method="chunked"):
            ev = super()._admit(req, slot, method)
            logs.append(self.prefill_logits[slot].copy())
            return ev

        def decode_once(self, forced_tokens=None):
            ev = super().decode_once(forced_tokens)
            if ev:
                logs.append(self.last_logits.cpu().numpy().copy())
            return ev

    ops.reset_plain_calls()
    srv = Recording(model, params, SCFG)
    for p in PROMPTS:
        srv.submit(p, max_new_tokens=GEN)
    streams = srv.run()
    return dict(streams=streams, prefill=srv.prefill_dispatches,
                decode=srv.decode_dispatches, finished=dict(srv.finished),
                fallbacks=dict(ops.plan_fallbacks), logits=logs,
                params=srv.params, cache=srv.cache)


def _rank_main(rank, world, plans, path):
    """One rank: serve under each plan; rank 0 saves the results and the
    placements and local shapes of its params and cache."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    mesh = make_mesh(MESH, NAMES, "cpu")
    cfg = _cfg()
    out = {}
    for name, plan in plans.items():
        params = LM(cfg).init(0, device="cpu")
        res = serve(LM(cfg, plan=plan, mesh=mesh), params)
        placed = {}
        for key in ("embed", "layers/mlp/wg", "layers/mlp/wd",
                    "layers/mlp/wu", "layers/attn/wq"):
            node = res["params"]
            for k in key.split("/"):
                node = node[k]
            assert isinstance(node, DTensor)
            placed[key] = (tuple(map(str, node.placements)),
                           tuple(node.to_local().shape), tuple(node.shape))
        res["params"] = placed
        k = res.pop("cache")["kv"]["k"]
        res["cache_k"] = (tuple(map(str, k.placements)),
                          tuple(k.to_local().shape))
        out[name] = res
    if rank == 0:
        torch.save(out, path)


@pytest.fixture(scope="module")
def plans():
    from repro.core.cost import HBM_PER_DEV as R_HBM
    from repro_torch.core.builders import build_graph
    from repro_torch.core.costterms import CapacityTerm
    from repro_torch.core.plan import ShardingPlan
    from repro_torch.core.solver import solve_mesh
    from repro_torch.launch.mesh import solver_axes

    def solved(cfg, shape, **kw):
        g = build_graph(cfg, shape)
        return ShardingPlan.from_graph_solution(
            solve_mesh(g, solver_axes(MESH, NAMES), **kw), g)

    full = get_arch("qwen2-1.5b")
    return {
        "a": solved(full.reduced(), ShapeConfig(
            "serve8x64", SCFG.max_len, SCFG.slots, "decode")),
        "b": solved(full, ShapeConfig("serve16x2048", 2048, 16, "decode"),
                    mem_scale=0.0, terms=(CapacityTerm(hbm=R_HBM),)),
        "c": _megatron(manual_megatron_plan, "kv_heads"),
        "d": _megatron(manual_megatron_plan, "seq_kv"),
    }


def _megatron(make, kv_cut):
    return make(NAMES, ["data"], "model").with_override(
        "kv_cache", {"data": "batch", "model": kv_cut})


def _repro_main(params_path, out_path):
    """repro's side, in a process with 8 host devices: its Server on the
    same weights with no plan and under each of repro's own plans (its
    solver and constants), streams, counters and logits rows pickled."""
    import jax

    from repro.compat import make_compat_mesh
    from repro.configs import get_arch as r_arch
    from repro.configs.base import ShapeConfig as RShape
    from repro.core.builders import build_graph
    from repro.core.plan import ShardingPlan, manual_megatron_plan
    from repro.core.solver import solve_mesh
    from repro.launch.mesh import mesh_to_solver_axes
    from repro.models.model import LM as RLM
    from repro.runtime.serve import ServeConfig as RServeConfig
    from repro.runtime.serve import Server as RServer

    mesh = make_compat_mesh(MESH, NAMES)

    def solved(cfg, shape):
        g = build_graph(cfg, shape)
        return ShardingPlan.from_graph_solution(
            solve_mesh(g, mesh_to_solver_axes(mesh)), g)

    full = r_arch("qwen2-1.5b")
    plans = {
        None: None,
        "a": solved(full.reduced(), RShape("serve8x64", SCFG.max_len,
                                           SCFG.slots, "decode")),
        "b": solved(full, RShape("serve16x2048", 2048, 16, "decode")),
        "c": _megatron(manual_megatron_plan, "kv_heads"),
        "d": _megatron(manual_megatron_plan, "seq_kv"),
    }
    cfg = dataclasses.replace(full.reduced(), dtype="float32")
    with open(params_path, "rb") as f:
        params = jax.tree_util.tree_map(jax.numpy.asarray, pickle.load(f))
    out = {}
    for name, plan in plans.items():
        logs = []

        class Recording(RServer):
            def _admit(self, req, slot, method="chunked"):
                ev = super()._admit(req, slot, method)
                logs.append(self.prefill_logits[slot].copy())
                return ev

            def decode_once(self, forced_tokens=None):
                ev = super().decode_once(forced_tokens)
                if ev:
                    logs.append(np.asarray(self.last_logits).copy())
                return ev

        m = None if plan is None else mesh
        rec = {"role_cuts": None if plan is None else plan.role_cuts}
        try:
            srv = Recording(RLM(cfg, plan=plan, mesh=m), params,
                            RServeConfig(slots=SCFG.slots,
                                         max_len=SCFG.max_len,
                                         prefill_chunk=SCFG.prefill_chunk),
                            mesh=m)
        except ValueError as e:          # a cut JAX cannot place
            rec["refused"] = str(e)
            out[name] = rec
            continue
        for p in PROMPTS:
            srv.submit(p, max_new_tokens=GEN)
        rec.update(streams=srv.run(), prefill=srv.prefill_dispatches,
                   decode=srv.decode_dispatches,
                   finished=dict(srv.finished), logits=logs)
        out[name] = rec
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(plans, tmp_path_factory):
    """(the unplanned port, the port's 8 ranks by plan, repro by plan),
    the ranks and repro's subprocess running side by side on the port's
    ``init(0)`` weights (repro's tree as it stands: both packages keep
    ``[in, out]`` weights under the same keys)."""
    tmp = tmp_path_factory.mktemp("ranks")
    cfg = _cfg()
    params = LM(cfg).init(0, device="cpu")
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(_numpy_tree(params), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(tmp / "params.pkl"),
         str(tmp / "repro.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ref = serve(LM(cfg), params)
        spawn(_rank_main, MESH[0] * MESH[1], "cpu",
              (plans, str(tmp / "out.pt")))
        _, err = proc.communicate(timeout=300)
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


def _check_like(want, got):
    """The same streams (every request to its full length), dispatch
    counts and retirements, every logits row within LOGITS_ATOL."""
    assert got["streams"] == want["streams"]
    assert all(len(t) == GEN for t in got["streams"].values())
    assert (got["prefill"], got["decode"], got["finished"]) == \
        (want["prefill"], want["decode"], want["finished"])
    assert len(got["logits"]) == len(want["logits"])
    err = max(float(np.abs(a - b).max())
              for a, b in zip(got["logits"], want["logits"]))
    assert err <= LOGITS_ATOL, err


def test_plans_are_repros_cut_for_cut(plans, runs):
    """The port's four plans, as its solver and helpers make them, are
    the ones repro's make: each role cut on each axis."""
    _, _, rep = runs
    for name, plan in plans.items():
        assert plan.mesh_axis_names == NAMES
        assert plan.role_cuts == rep[name]["role_cuts"], name


@pytest.mark.parametrize("name", ["a", "b", "c", "d"])
def test_serves_like_repro_under_the_same_plan(runs, name):
    """The 8 ranks under a plan against repro's Server under that plan on
    8 host devices: the same streams and dispatch counters, logits within
    1e-5.  repro cannot place plan (c)'s cache (one KV head cut
    by 2), so there the port is held to repro with no plan."""
    _, out, rep = runs
    want = rep[name]
    if name == "c":
        assert "divisible by 2" in want["refused"]
        want = rep[None]
    assert "refused" not in want
    _check_like(want, out[name])


def test_cache_is_allocated_shard_by_shard(runs):
    """Each rank allocates only its shard of the [L, 8, 64, 1, 16] linear
    cache: under (a) one batch row (both axes stack on ``batch``)."""
    _, out, _ = runs
    assert out["a"]["cache_k"] == (("S(1)", "S(1)"), (4, 1, 64, 1, 16))
    # megatron: batch over data, and the one KV head over model (rank 0
    # holds it; its partner's shard is empty)
    assert out["c"]["cache_k"] == (("S(1)", "S(3)"), (4, 2, 64, 1, 16))
    assert out["d"]["cache_k"] == (("S(1)", "S(2)"), (4, 2, 32, 1, 16))


def test_seq_kv_cut_falls_back(runs):
    ref, out, _ = runs
    got = out["d"]
    _check_like(ref, got)
    L = _cfg().n_layers
    assert got["fallbacks"] == {"prefill_attention": L * ref["prefill"],
                                "attend_cache": L * ref["decode"],
                                "attention": 0, "attend_paged": 0,
                                "rescore": 0, "copy_block": 0}


def test_own_plan_cuts_batch_only(plans, runs):
    ref, out, _ = runs
    cuts = {d for c in plans["a"].role_cuts.values() for d in c.values()}
    assert cuts == {None, "batch"}
    got = out["a"]
    _check_like(ref, got)
    assert sum(got["fallbacks"].values()) == 0
    assert got["params"]["embed"][0] == ("R", "R")


def test_full_width_plan_shards_the_weights(plans, runs):
    ref, out, _ = runs
    plan = plans["b"]
    assert plan.role_cuts["embed"] == {"data": "d_model", "model": "d_model"}
    assert plan.role_cuts["logits"] == {"data": "vocab", "model": "vocab"}
    assert plan.role_cuts["w_gate"] == {"data": None, "model": "d_ff"}
    assert plan.role_cuts["w_down"] == {"data": None, "model": "d_ff"}
    got = out["b"]
    _check_like(ref, got)
    assert sum(got["fallbacks"].values()) == 0
    p = got["params"]
    # embed [256, 64]: d_model over both axes, 8 columns a rank
    assert p["embed"] == (("S(1)", "S(1)"), (256, 8),
                          (256, 64))
    # stacked [L, 64, 128] gate and [L, 128, 64] down: d_ff over model
    assert p["layers/mlp/wg"][:2] == (("R", "S(2)"),
                                      (4, 64, 64))
    assert p["layers/mlp/wd"][:2] == (("R", "S(1)"),
                                      (4, 64, 64))


def test_kv_heads_cut_that_does_not_divide_falls_back(runs):
    ref, out, _ = runs
    got = out["c"]
    _check_like(ref, got)
    L = _cfg().n_layers
    # every attention call fell back: one per layer per prefill chunk and
    # per decode step
    assert got["fallbacks"] == {"prefill_attention": L * ref["prefill"],
                                "attend_cache": L * ref["decode"],
                                "attention": 0, "attend_paged": 0,
                                "rescore": 0, "copy_block": 0}
    # megatron's model axis cuts the heads of wq
    assert got["params"]["layers/attn/wq"][0] == ("R",
                                                  "S(2)")


def test_plan_on_one_rank_and_what_it_refuses():
    """On a world-1 gloo group: the (1, 1) mesh's solver axes; params
    placed already are taken as they are; paged=True and spec_k=4 serve
    under a plan, giving the streams of the same server with no plan;
    the hybrid family raises under a plan, naming ROADMAP A.1; a plan
    without a mesh is refused."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import (free_port, init_distributed,
                                         make_mesh, mesh_to_solver_axes)
    from repro_torch.models.sharding import place_tree
    cfg = _cfg()
    plan = manual_megatron_plan(NAMES, ["data"], "model")
    params = LM(cfg).init(0, device="cpu")
    assert not dist.is_initialized()
    init_distributed("cpu", 0, 1, free_port())
    try:
        mesh = make_mesh((1, 1), NAMES, "cpu")
        assert [(a.name, a.size) for a in mesh_to_solver_axes(mesh)] == \
            [("data", 1), ("model", 1)]
        model = LM(cfg, plan=plan, mesh=mesh)
        placed = place_tree(params, mesh, plan.for_pool(SCFG.slots,
                                                        {"data": 1,
                                                         "model": 1}))
        assert isinstance(placed["layers"]["attn"]["wq"], DTensor)
        srv = Server(model, placed, SCFG)
        assert srv.params["embed"] is placed["embed"]
        for kw in (dict(paged=True), dict(spec_k=4),
                   dict(paged=True, spec_k=4)):
            scfg = dataclasses.replace(SCFG, **kw)
            streams = []
            for m in (model, LM(cfg)):
                srv = Server(m, params, scfg)
                for p in PROMPTS:
                    srv.submit(p, max_new_tokens=GEN)
                streams.append(srv.run())
                tier = srv.cache["pages" if scfg.paged else "kv"]
                assert isinstance(tier["k"], DTensor) == (m is model)
            assert streams[0] == streams[1], kw
            assert all(len(t) == GEN for t in streams[0].values())
        hyb = get_arch("zamba2-2.7b").reduced()
        with pytest.raises(NotImplementedError, match="ROADMAP A.1"):
            Server(LM(hyb, plan=plan, mesh=mesh),
                   LM(hyb).init(0, device="cpu"), SCFG)
        with pytest.raises(ValueError, match="mesh"):
            Server(LM(cfg, plan=plan), params, SCFG)
    finally:
        dist.destroy_process_group()


def test_launch_serve_spawns_gloo_ranks(tmp_path):
    """``python -m repro_torch.launch.serve --mesh 2x2 --plan auto
    --device cpu`` without a launcher spawns its 4 gloo ranks, solves the
    decode plan and serves every request; rank 0 writes the record."""
    from repro_torch.launch import serve as launch_serve
    out = tmp_path / "rec.json"
    assert launch_serve.main([
        "--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
        "--mesh", "2x2", "--plan", "auto", "--slots", "4", "--gen", "4",
        "--json-out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["meta"]["mesh"] == "2x2" and rec["meta"]["device"] == "cpu"
    assert rec["requests"] == 4 and rec["generated_tokens"] == 16
    assert rec["plan"]["mesh_axes"] == ["data", "model"]
    assert rec["plan"]["role_cuts"]["kv_cache"] == {"data": "batch",
                                                    "model": "batch"}


def test_launch_serve_paged_spec_spawns_gloo_ranks(tmp_path):
    """``--paged --spec-k 4 --mesh 2x2 --plan auto --device cpu``: the 4
    gloo ranks serve the paged tier with speculative decoding under the
    solved decode plan; rank 0 writes the record, with the paged
    counters."""
    from repro_torch.launch import serve as launch_serve
    out = tmp_path / "rec.json"
    assert launch_serve.main([
        "--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
        "--mesh", "2x2", "--plan", "auto", "--slots", "4", "--gen", "6",
        "--paged", "--n-blocks", "9", "--spec-k", "4",
        "--json-out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["meta"]["mesh"] == "2x2" and rec["meta"]["paged"]
    assert rec["meta"]["spec_k"] == 4 and rec["meta"]["n_blocks"] == 9
    assert rec["requests"] == 4 and rec["generated_tokens"] == 24
    assert rec["paged"]["verify_dispatches"] >= 1
    assert rec["plan"]["mesh_axes"] == ["data", "model"]


if __name__ == "__main__":
    _repro_main(sys.argv[1], sys.argv[2])
