"""The port's dry run (src/repro_torch/launch/dryrun.py, hillclimb.py,
compile.solve_plan / input_specs, mesh.production_axes) on the CPU,
against repro's where repro has the same piece.

- ``solve_plan`` on the production axes, given repro's constants (its
  100 GB/s rings and 16 GB HBM), is repro's plan for xlstm-125m
  ``train_4k`` pod1, cut for cut.
- ``run_cell`` at full width (llama3.2-3b ``train_4k`` on the (16, 16)
  fake mesh, no rank started) writes a record with the keys of repro's,
  ``trace_s`` in place of ``lower_s`` / ``compile_s``; ``long_500k`` of a
  full-attention arch is skipped with repro's record.
- The sLSTM recurrence is traced step by step: the products of an sLSTM
  layer's forward over S steps are S times one step's, which is why the
  port has no ``_slstm_correction``.
- The planned loss keeps its backward on local shards (no rank holds a
  tensor of the global logits' shape).
- ``--override`` parsing and ``top_collectives``' ranking by repro's ring
  formulas."""
from __future__ import annotations

import dataclasses
import functools
import json

import pytest
import torch

from repro_torch.configs.base import SHAPES, ShapeConfig, get_arch
from repro_torch.launch import compile as tcompile
from repro_torch.launch import dryrun
from repro_torch.launch import hillclimb
from repro_torch.launch.mesh import production_axes

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


@pytest.fixture
def plan_cache(tmp_path, monkeypatch):
    """Plans solved here go to a temporary cache, not the repo's."""
    monkeypatch.setattr(tcompile, "CACHE_DIR", str(tmp_path / "plans"))
    return tmp_path


def test_production_axes_and_inputs():
    """repro's shapes and names, every axis across hosts at InfiniBand's
    rate; the inputs as meta stand-ins of repro's shapes and dtypes."""
    from repro_torch.launch.mesh import IB_BW
    for multi, want in ((False, [("data", 16), ("model", 16)]),
                        (True, [("pod", 2), ("data", 16), ("model", 16)])):
        axes = production_axes(multi)
        assert [(a.name, a.size) for a in axes] == want
        assert all(a.bandwidth == IB_BW for a in axes)
    ins = tcompile.input_specs(get_arch("llama3.2-3b"), SHAPES["train_4k"])
    assert {k: (tuple(v.shape), v.dtype, v.device.type)
            for k, v in ins.items()} == {
        "tokens": ((256, 4096), torch.int32, "meta"),
        "labels": ((256, 4096), torch.int32, "meta")}
    ins = tcompile.input_specs(get_arch("musicgen-large"),
                               SHAPES["decode_32k"])
    assert tuple(ins["tokens"].shape) == (128, 2048)
    assert ins["tokens"].dtype == torch.bfloat16


def test_solve_plan_is_repros(plan_cache, monkeypatch):
    """xlstm-125m train_4k pod1 on the production axes at repro's
    constants: repro's role cuts."""
    from repro.core.cost import HBM_PER_DEV as R_HBM
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import get_arch as jax_arch
    from repro.launch import compile as jcompile
    from repro_torch.core.costterms import CapacityTerm
    from repro_torch.core.solver import MeshAxis, solve_mesh
    monkeypatch.setattr(jcompile, "CACHE_DIR", str(plan_cache / "jplans"))
    monkeypatch.setattr(tcompile, "production_axes", lambda multi=False: [
        MeshAxis(a.name, a.size, 100e9) for a in production_axes(multi)])
    monkeypatch.setattr(tcompile, "solve_mesh", functools.partial(
        solve_mesh, mem_scale=0.0, terms=(CapacityTerm(hbm=R_HBM),)))
    got = tcompile.solve_plan(get_arch("xlstm-125m"), SHAPES["train_4k"],
                              False, use_cache=False)
    want = jcompile.solve_plan(jax_arch("xlstm-125m"), J_SHAPES["train_4k"],
                               False, use_cache=False)
    assert got["mesh_axes"] == want["mesh_axes"] == ["data", "model"]
    assert got["role_cuts"] == want["role_cuts"]


def test_run_cell_full_width_record(plan_cache, tmp_path):
    """llama3.2-3b train_4k on the fake (16, 16) mesh: repro's record
    keys, complete, finite and positive terms, the batch cut on every
    card (local FLOPs well under the global step's), and no default
    process group left behind."""
    import math

    import torch.distributed as dist
    out = tmp_path / "out"
    rec = dryrun.run_cell("llama3.2-3b", "train_4k", False, str(out))
    want_keys = set(_repro_record_keys()) - {"lower_s", "compile_s"} | \
        {"trace_s"}
    assert set(rec) == want_keys
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    for k in ("flops_per_dev", "hbm_bytes_per_dev", "wire_bytes_per_dev",
              "bytes_per_dev_peak", "t_step", "trace_s"):
        assert math.isfinite(rec[k]) and rec[k] > 0, k
    assert rec["flops_per_dev"] < rec["model_flops_total"] / 64
    assert json.loads((out / "llama3.2-3b_train_4k_pod1.json").read_text()
                      ) == rec
    assert not dist.is_initialized()
    skip = dryrun.run_cell("llama3.2-3b", "long_500k", False)
    assert skip["status"] == "skipped" and "sub-quadratic" in skip["reason"]


def _repro_record_keys():
    """repro's run_cell record keys: its Roofline's and the ones it adds
    (src/repro/launch/dryrun.py)."""
    from repro.analysis import roofline as jrf
    roof = jrf.Roofline("a", "s", "m", 1, 1.0, 1.0, 0.0, 0.0, {}, 1.0, None)
    return list(roof.to_dict()) + [
        "status", "lower_s", "compile_s", "memory_analysis", "solver_bytes",
        "solver_per_axis", "probe_depths", "probe_flops"]


def test_planned_loss_backward_stays_local(plan_cache):
    """The reduced llama3.2-3b train step under a plan that cuts the
    batch over all 256 cards: no tensor of the step holds the global
    logits (DTensor's label gather once made, in its backward, a zero
    tensor of the global logits' shape on every rank), so the step's own
    peak stays far under their bytes."""
    from repro_torch.core.builders import build_graph
    from repro_torch.core.plan import ShardingPlan
    from repro_torch.core.solver import solve_mesh
    cfg = dataclasses.replace(get_arch("llama3.2-3b").reduced(),
                              n_kv_heads=2)
    shape = ShapeConfig("r", 32, 256, "train")
    g = build_graph(cfg, shape)
    plan = ShardingPlan.from_graph_solution(
        solve_mesh(g, production_axes(False), beam=32), g)
    assert plan.role_cuts["x"] == {"data": "batch", "model": "batch"}
    cost, n = dryrun.trace_cell(cfg, shape, plan, False)
    global_logits = 256 * 32 * cfg.vocab * 4
    assert cost.peak_bytes - cost.state_bytes < global_logits / 2


def test_slstm_steps_are_all_traced():
    """An sLSTM layer's forward (reduced xlstm-125m, one device) over 8
    and 16 steps: its products grow by exactly the 8 extra steps' input
    and recurrent products (repro's per-step count), so the trace
    misses no step and needs no correction."""
    from repro_torch.analysis.cost_trace import CostMode
    from repro_torch.models import xlstm
    from repro_torch.models.model import LM
    cfg = get_arch("xlstm-125m").reduced()
    shapes = LM(cfg).param_shapes()["slstm"]
    p = {k: torch.empty(v[0][1:], dtype=v[1], device="meta")
         for k, v in shapes.items()}
    flops = {}
    for s in (8, 16):
        x = torch.empty((2, s, cfg.d_model), dtype=torch.bfloat16,
                        device="meta")
        mode = CostMode()
        with mode:
            xlstm.slstm_forward(p, x, cfg)
        flops[s] = mode.matmul_flops
    hd = cfg.d_model // cfg.n_heads
    step = 2.0 * 2 * cfg.n_heads * hd * 4 * hd          # repro's per step
    per_token_in = (flops[16] - flops[8]) / (2 * 8) - step / 2
    assert per_token_in > 0
    assert flops[16] - flops[8] == pytest.approx(
        8 * (step + 2 * per_token_in), rel=1e-12)


def test_override_parsing_and_top_collectives():
    role, cuts = hillclimb.parse_override("wq=model:heads,data:-")
    assert (role, cuts) == ("wq", {"model": "heads", "data": None})
    from repro_torch.core.plan import ShardingPlan
    plan = hillclimb.apply_overrides(
        ShardingPlan(("data", "model"), {"wq": {"data": "d_model",
                                                "model": None}}),
        ["wq=model:heads", "w_up=data:d_ff"])
    assert plan.role_cuts["wq"] == {"data": None, "model": "heads"}
    assert plan.role_cuts["w_up"] == {"data": "d_ff", "model": None}
    ops = [("all-gather", 1600.0, 16), ("all-reduce", 1000.0, 16),
           ("reduce-scatter", 100.0, 16), ("unpriced:c10d.x", 0.0, 1),
           ("all-to-all", 3200.0, 2)]
    top = hillclimb.top_collectives(ops, n=3)
    # ring wire bytes: 2*1000*15/16 = 1875, 1600*15/16 = 1500,
    # 100*15 = 1500, 3200/2 = 1600
    assert [(k, w) for k, _, _, w in top] == [
        ("all-reduce", 1875.0), ("all-to-all", 1600.0),
        ("all-gather", 1500.0)]


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-1.5b",
                                  "h2o-danube-3-4b", "musicgen-large"])
def test_planned_prefill_attention_keeps_the_batch_cut(arch):
    """A reduced prefill (32 x 256) under llama3.2-3b prefill_32k's pod1
    cut of the activations (``x`` and ``logits``: batch over data, seq
    over model; the weights whole) on the fake (16, 16) mesh; qkv bias,
    a window and embeds in turn.  Attention has no local rule for a seq
    cut, so each layer's call is a counted fallback that gathers k and v
    over model; it keeps the batch cut over data and, without autograd,
    the queries' seq cut: each card's scores are its 2 rows' 16 queries
    against the 256 keys (they once were the whole batch's 32 rows of
    256 queries: 256x the share on every card).  The numbers are held to
    the unplanned forward in tests/test_torch_obs_engines.py.  On torch
    2.11 this trace stops earlier, in ``x @ wq``'s view (ROADMAP C)."""
    import torch.distributed as dist

    from repro_torch.analysis.cost_trace import CostMode, build_step
    from repro_torch.core.plan import ShardingPlan
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_production_mesh
    cfg = get_arch(arch).reduced()
    cut = {"data": "batch", "model": "seq"}
    plan = ShardingPlan(("data", "model"), {"x": cut, "logits": cut})
    rows = 2
    scores = []

    class Scores(CostMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if func._overloadpacket is torch.ops.aten._softmax and \
                    out is not NotImplemented:
                scores.append(tuple(args[0].shape))
            return out

    mesh = make_production_mesh(multi_pod=False)
    before = ops.plan_fallbacks["attention"]
    try:
        step, state, inputs = build_step(cfg, ShapeConfig("r", 256, 32,
                                                          "prefill"),
                                         plan, mesh)
        with Scores():
            logits = step(state, inputs)[0]
    finally:
        dist.destroy_process_group()
    assert ops.plan_fallbacks["attention"] - before == cfg.n_layers
    assert tuple(logits.to_local().shape) == (rows, 16, cfg.vocab)
    assert len(scores) == cfg.n_layers
    for s in scores:
        assert s[0] == rows and s[-2:] == (16, 256), s
