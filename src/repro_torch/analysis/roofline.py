"""Three-term roofline of a dry-run cell at H100 constants (the port's
counterpart of ``repro.analysis.roofline``).

    compute    = FLOPs_per_device / peak FLOP/s
    memory     = HBM_bytes_per_device / HBM rate
    collective = sum over the step's collectives of their ring wire bytes
                 per device / the rate of the slowest link their group's
                 ring crosses

The per-device terms come from ``analysis/cost_trace`` (a step traced on
meta tensors) in place of XLA's ``cost_analysis``; the cross-check
against MODEL_FLOPS = 6 N D (6 N_active D for MoE) / n_devices and the
useful-compute ratio are repro's.  The rates are arguments with H100
defaults, so repro's TPU constants can be given to check the arithmetic
against repro's."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from ..launch.mesh import IB_BW

# NVIDIA H100 SXM5 (https://www.nvidia.com/en-us/data-center/h100/):
# dense bf16 tensor-core peak (the datasheet's 1,979 TFLOP/s is with
# sparsity) and HBM3 bandwidth.  Published figures, the ones the port's
# solver (core/cost.DEFAULT_PEAK_FLOPS) and PERF.md's kernel bounds use.
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_dev: float
    hbm_bytes_per_dev: float
    wire_bytes_per_dev: float
    naive_collective_bytes: float
    collective_counts: Dict[str, int]
    model_flops_total: float
    bytes_per_dev_peak: Optional[float]   # the trace's live-bytes peak
    ideal_bytes_per_dev: Optional[float] = None   # compulsory HBM traffic
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = IB_BW
    # ring wire bytes per device by the mesh dims their group spans, and
    # each dim's link rate; without them every byte goes at ``link_bw``
    wire_by_axes: Optional[Dict[Tuple[str, ...], float]] = None
    axis_bw: Optional[Dict[str, float]] = None

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_dev / self.hbm_bw

    @property
    def t_collective(self) -> float:
        if not self.wire_by_axes or not self.axis_bw:
            return self.wire_bytes_per_dev / self.link_bw
        return sum(w / min((self.axis_bw[a] for a in axes),
                           default=self.link_bw)
                   for axes, w in self.wire_by_axes.items())

    @property
    def t_step(self) -> float:
        """Modeled step time: compute and HBM traffic overlap on-chip
        (take the max), collectives serialize against both."""
        return max(self.t_compute, self.t_memory) + self.t_collective

    def compute_calibration(self, analytic_flops_total: float) -> float:
        """Measured-over-analytic flops ratio, the ``calibration`` knob of
        ``core.costterms.ComputeConfig``."""
        if analytic_flops_total <= 0:
            return 1.0
        return (self.flops_per_dev * max(1, self.n_devices)
                / analytic_flops_total)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        per_dev_model = self.model_flops_total / max(1, self.n_devices)
        return per_dev_model / max(1.0, self.flops_per_dev)

    @property
    def mem_efficiency(self) -> Optional[float]:
        """compulsory HBM traffic / counted traffic (1.0 = every byte
        moved was unavoidable); the counted bytes ignore fusion, so this
        is a lower bound."""
        if self.ideal_bytes_per_dev is None or not self.hbm_bytes_per_dev:
            return None
        return min(1.0, self.ideal_bytes_per_dev / self.hbm_bytes_per_dev)

    @property
    def roofline_fraction(self) -> float:
        """useful FLOPs / (t_bound x peak), t_bound the dominant term."""
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        per_dev_model = self.model_flops_total / max(1, self.n_devices)
        return (per_dev_model / (t_bound * self.peak_flops)
                if t_bound else 0.0)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_devices": self.n_devices,
            "flops_per_dev": self.flops_per_dev,
            "hbm_bytes_per_dev": self.hbm_bytes_per_dev,
            "wire_bytes_per_dev": self.wire_bytes_per_dev,
            "naive_collective_bytes": self.naive_collective_bytes,
            "collective_counts": self.collective_counts,
            "model_flops_total": self.model_flops_total,
            "bytes_per_dev_peak": self.bytes_per_dev_peak,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "t_step": self.t_step,
            "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "ideal_bytes_per_dev": self.ideal_bytes_per_dev,
            "mem_efficiency": self.mem_efficiency,
        }


def model_train_flops(cfg, shape) -> float:
    """6·N·D (dense) or 6·N_active·D (MoE); D = tokens (2·N·D outside
    training)."""
    n = cfg.active_param_count()
    mult = 6.0 if shape.kind == "train" else 2.0
    tokens = (shape.global_batch if shape.kind == "decode"
              else shape.tokens)
    return mult * n * tokens


def tree_bytes(tree) -> float:
    """Bytes of a nested dict whose leaves are tensors (meta ones too) or
    (shape, dtype) pairs."""
    import math

    import torch
    total = 0.0
    for v in tree.values():
        if isinstance(v, dict):
            total += tree_bytes(v)
        elif isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        else:
            shape, dtype = v
            total += math.prod(shape) * dtype.itemsize
    return float(total)


def ideal_step_bytes(params_bytes: float, state_bytes: float,
                     kind: str, n_devices: int) -> float:
    """Compulsory per-device HBM traffic per step.  decode: read all
    params + all KV/SSM state.  train: params read fwd+bwd (2x) + grads
    written+read (2x) + Adam m/v read+write (in state_bytes) + weight
    write.  prefill: params once."""
    if kind == "decode":
        return (params_bytes + state_bytes) / n_devices
    if kind == "train":
        return (3 * params_bytes + 2 * params_bytes
                + 2 * state_bytes + params_bytes) / n_devices
    return params_bytes / n_devices


def analyze(cost, n_devices: int, model_flops: float, arch: str,
            shape: str, mesh_name: str,
            axis_bw: Optional[Dict[str, float]] = None) -> Roofline:
    """The roofline of a ``cost_trace.StepCost`` (repro's ``analyze`` of
    a compiled artifact)."""
    coll = cost.collectives
    return Roofline(arch, shape, mesh_name, n_devices, cost.flops,
                    cost.hbm_bytes, coll.wire_bytes_per_device,
                    coll.naive_operand_bytes, coll.counts, model_flops,
                    cost.peak_bytes, wire_by_axes=dict(cost.wire_by_axes),
                    axis_bw=axis_bw)
