"""The port's roofline (src/repro_torch/analysis/roofline.py) and its
per-device cost trace (analysis/cost_trace.py) against repro's roofline
and the analytic counts, on the CPU.

- The arithmetic is repro's: the same numbers into both packages'
  ``Roofline`` (the port given repro's TPU constants: 197e12 FLOP/s,
  819e9 B/s, 2 x 50e9 B/s a ring), ``model_train_flops`` and
  ``ideal_step_bytes`` give equal values, and ``to_dict`` has repro's
  keys.
- FLOPs are the local shards': a bf16 product [1048576, 4096] @ [4096,
  14336] cut (Shard(0), Replicate()) x (Replicate(), Shard(1)) on a fake
  (16, 16) mesh of meta shards counts 2 m n k of the shard, [65536,
  4096] @ [4096, 896], on the device (0.48 TFLOP, not the global 123.1);
  a replicated product counts in full.
- The reduced qwen2-1.5b prefill cell of tests/test_roofline.py (4 x 16
  tokens, one device): the trace's product FLOPs equal the analytic
  count exactly (the QKV, output, MLP and head products and the whole
  4 x 16 x 16 score matrix of each head, QK and PV: 20,971,520).  Held
  against repro's ``analyze`` of the cell compiled with its layers
  unrolled, as repro's depth probes compile it (XLA counts a scanned
  layer body once): the port's total FLOPs within [0.8, 1.25] of repro's
  (XLA counts elementwise and transcendental work by its own rules;
  measured 0.928, the products alone 0.909 of repro's total) and its
  HBM bytes within [0.5, 2] (both ignore fusion; measured 1.079)."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.analysis import cost_trace
from repro_torch.analysis import roofline as rf
from repro_torch.configs.base import ShapeConfig, get_arch

R_PEAK, R_HBM, R_LINK = 197e12, 819e9, 2 * 50e9   # repro's TPU constants


def _numbers():
    return dict(arch="a", shape="s", mesh="pod1", n_devices=256,
                flops_per_dev=3.1e14, hbm_bytes_per_dev=2.2e12,
                wire_bytes_per_dev=6.5e10, naive_collective_bytes=5.6e10,
                collective_counts={"all-gather": 30, "all-reduce": 16},
                model_flops_total=2.0e16, bytes_per_dev_peak=5.3e10)


@pytest.mark.parametrize("ideal", [None, 3.5e8, 5e12])
def test_roofline_is_repros_arithmetic(ideal):
    """Equal fields, equal properties, repro's keys, at repro's
    constants; the compute calibration too."""
    from repro.analysis import roofline as jrf
    want = jrf.Roofline(**_numbers(), ideal_bytes_per_dev=ideal)
    got = rf.Roofline(**_numbers(), ideal_bytes_per_dev=ideal,
                      peak_flops=R_PEAK, hbm_bw=R_HBM, link_bw=R_LINK)
    assert got.to_dict() == want.to_dict()
    assert list(got.to_dict()) == list(want.to_dict())
    assert got.compute_calibration(7e17) == want.compute_calibration(7e17)


def test_model_flops_and_ideal_bytes_are_repros():
    from repro.analysis import roofline as jrf
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import get_arch as jax_arch
    from repro_torch.configs import ASSIGNED, SHAPES
    for arch in ASSIGNED:
        for name, shape in SHAPES.items():
            assert rf.model_train_flops(get_arch(arch), shape) == \
                jrf.model_train_flops(jax_arch(arch), J_SHAPES[name])
    for kind in ("train", "prefill", "decode"):
        assert rf.ideal_step_bytes(6.4e9, 2.56e10, kind, 256) == \
            jrf.ideal_step_bytes(6.4e9, 2.56e10, kind, 256)


def test_t_collective_prices_each_group_at_its_links_rate():
    """Wire bytes of a group spanning "data" at its rate, of one spanning
    both dims at the slower one's; without the split, at ``link_bw``."""
    r = rf.Roofline(**_numbers(), wire_by_axes={("model",): 9e11,
                                                ("data", "model"): 5e10},
                    axis_bw={"data": 50e9, "model": 900e9})
    assert r.t_collective == pytest.approx(9e11 / 900e9 + 5e10 / 50e9)
    assert rf.Roofline(**_numbers(), link_bw=50e9).t_collective == \
        pytest.approx(6.5e10 / 50e9)


def test_tree_bytes_of_meta_tensors_and_shapes():
    from repro_torch.models.model import LM
    cfg = get_arch("qwen2-1.5b").reduced()
    shapes = LM(cfg).param_shapes()

    def meta(t):
        return {k: meta(v) if isinstance(v, dict) else
                torch.empty(v[0], dtype=v[1], device="meta")
                for k, v in t.items()}
    n = rf.tree_bytes(shapes)
    assert n == rf.tree_bytes(meta(shapes)) > 0


def test_flops_are_the_local_shards():
    """The sharded product counts its shard's 2 m n k on the device; a
    replicated product counts in full."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.sharding import zeros_placed
    mesh = make_production_mesh(multi_pod=False)
    try:
        x = zeros_placed((1048576, 4096), torch.bfloat16, mesh,
                         [Shard(0), Replicate()], "meta")
        w = zeros_placed((4096, 14336), torch.bfloat16, mesh,
                         [Replicate(), Shard(1)], "meta")
        a = zeros_placed((1024, 512), torch.bfloat16, mesh,
                         [Replicate(), Replicate()], "meta")
        b = zeros_placed((512, 256), torch.bfloat16, mesh,
                         [Replicate(), Replicate()], "meta")
        mode = cost_trace.CostMode()
        with mode:
            y = x @ w
        assert tuple(y.to_local().shape) == (65536, 896)
        assert mode.matmul_flops == 2 * 65536 * 4096 * 896     # 0.48 TFLOP
        mode = cost_trace.CostMode()
        with mode:
            a @ b
        assert mode.matmul_flops == 2 * 1024 * 512 * 256
        assert mode.hbm_bytes == 2 * (1024 * 512 + 512 * 256 + 1024 * 256)
    finally:
        dist.destroy_process_group()


def _analytic_prefill_flops(cfg, b, s):
    """The products of a dense prefill: QKV, the whole score matrix (QK
    and PV), the output and MLP products per layer, and the head."""
    t, d, hd = b * s, cfg.d_model, cfg.hd
    per_layer = (2 * t * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                 + 2 * 2 * b * cfg.n_heads * s * s * hd
                 + 2 * t * cfg.n_heads * hd * d
                 + 3 * 2 * t * d * cfg.d_ff)
    return cfg.n_layers * per_layer + 2 * t * d * cfg.vocab


def test_reduced_prefill_cell_matches_analytic_and_repro():
    """One device, tests/test_roofline.py's cell (module docstring)."""
    import jax

    from repro.analysis import roofline as jrf
    from repro.compat import make_compat_mesh
    from repro.configs import get_arch as jax_arch
    from repro.configs.base import ShapeConfig as JShape
    from repro.core.plan import ShardingPlan as JPlan
    from repro.launch.compile import compile_step, input_specs
    from repro.models import attention as jax_attention
    from repro_torch.models.model import LM
    cfg = get_arch("qwen2-1.5b").reduced()
    shape = ShapeConfig("smoke", 16, 4, "prefill")
    cost = cost_trace.trace_step(cfg, shape, None, None)
    assert cost.matmul_flops == _analytic_prefill_flops(cfg, 4, 16) \
        == 20_971_520
    roof = rf.analyze(cost, 1, rf.model_train_flops(cfg, shape), cfg.name,
                      shape.name, "host1")
    assert roof.wire_bytes_per_dev == 0.0 and roof.t_collective == 0.0
    assert roof.bytes_per_dev_peak >= rf.tree_bytes(LM(cfg).param_shapes())

    jcfg = jax_arch("qwen2-1.5b").reduced()
    jshape = JShape("smoke", 16, 4, "prefill")
    mesh = make_compat_mesh((1,), ("data",), devices=jax.devices()[:1])
    jax_attention.DEFAULT_UNROLL = True
    try:
        compiled, _, _ = compile_step(
            jcfg, jshape, JPlan(("data",), {}), mesh,
            input_specs(jcfg, jshape), layer_loop="unrolled")
    finally:
        jax_attention.DEFAULT_UNROLL = False
    want = jrf.analyze(compiled, compiled.as_text(), 1,
                       jrf.model_train_flops(jcfg, jshape), jcfg.name,
                       jshape.name, "host1")
    ratio = roof.flops_per_dev / want.flops_per_dev
    assert 0.8 <= ratio <= 1.25, ratio
    ratio = roof.hbm_bytes_per_dev / want.hbm_bytes_per_dev
    assert 0.5 <= ratio <= 2.0, ratio


def test_train_and_decode_cells_trace_on_one_device():
    """The train step (loss, backward, AdamW) and the decode step on one
    device: positive FLOPs and bytes, no collective, a peak above the
    state; the train step counts at least 3x the forward's products."""
    cfg = dataclasses.replace(get_arch("llama3.2-3b").reduced(),
                              n_kv_heads=2)
    fwd = cost_trace.trace_step(cfg, ShapeConfig("p", 16, 8, "prefill"),
                                None, None)
    train = cost_trace.trace_step(cfg, ShapeConfig("t", 16, 8, "train"),
                                  None, None)
    dec = cost_trace.trace_step(cfg, ShapeConfig("d", 16, 8, "decode"),
                                None, None)
    assert train.matmul_flops >= 3 * fwd.matmul_flops
    for c in (fwd, train, dec):
        assert c.flops > 0 and c.hbm_bytes > 0 and not c.ops
        assert c.peak_bytes > c.state_bytes > 0
