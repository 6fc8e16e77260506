"""Pluggable cost terms for the tiling DP (carved out of core/solver.py).

The one-cut DP's native objective is conversion wire bytes (the op cost
tables of cost.py).  Everything else the search trades off against those
bytes is a *cost term*: a per-tensor, per-tiling additive penalty charged
once when the DP assigns that tensor.  Before this module the solver had
exactly one such term hard-wired (the soft-capacity Lagrangian of
``memory_penalties``); the joint pipeline-stage search adds a second, so
the interface is now explicit:

  CapacityTerm          the soft-capacity Lagrangian λ_kind × per-device
                        bytes (wraps cost.memory_penalties; this is what
                        ``mem_scale`` constructs inside solve_one_cut)
  BoundaryTransferTerm  stage-boundary transfer priced on the stage link
                        (network vs NVLink): the per-axis-exact decomposition of
                        the boundary wire bytes — see below
  TensorPenaltyTerm     an explicit {tensor: {tiling: cost}} table, for
                        tests and ad-hoc pins

The DP's dominance pruning assumes penalties are >= 0; every term must
honor that.

Boundary-transfer decomposition
-------------------------------
A tensor crossing a pipeline-stage cut is sent point-to-point between
peer devices of adjacent stage groups.  Each of the ``inner_degree``
devices in a stage group ships its local shard, so the system-wide wire
bytes over the cut are

    T = mult × nbytes × Π_{axis k where t is NOT partitioned} a_k

(fully partitioned: T = nbytes; fully replicated: every device ships the
whole tensor).  Along the k-cut recursion — where axis k sees the tensor
already divided to ``s_k`` bytes by the previous axes' Part choices and
carries the ``groups_k = Π_{j<k} a_j`` weighting — this telescopes
*exactly* into per-axis charges

    T = mult × nbytes  +  Σ_k [choice_k is not Part] ×
                           mult × s_k × groups_k × (a_k − 1)

with the first term assignment-independent.  ``BoundaryTransferTerm``
charges one axis' slice of that sum, pre-scaled into the axis' native
byte currency (one axis-k byte is worth 1/(bw_k × a_k) seconds in the
solve_mesh accounting, one boundary byte 1/(stage_bw × inner_degree)
seconds over the parallel stage links), so the one-cut DP trades
intra-stage conversion bytes against stage-link transfer seconds at the
correct exchange rate.

The 1F1B bubble is not a per-tensor penalty — it is a schedule-level
multiplier on the critical stage time — but it lives here (BubbleTerm)
so every knob of the pipeline cost model is declared in one place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence

from .cost import HBM_PER_DEV, memory_penalties, tensor_tiling_choices
from .graph import Graph
from .tiling import Part, Tiling

PenaltyTable = Dict[str, Dict[Tiling, float]]

# NVIDIA H100 SXM defaults: datasheet values
# (https://www.nvidia.com/en-us/data-center/h100/), not measured.
DEFAULT_PEAK_FLOPS = 989e12     # dense bf16 tensor-core peak
# The alignment granules come from wgmma's m64nNk16 tile: a product's
# output block is issued as 64-row (M) tiles, one warpgroup each, with N
# any multiple of 8.  So a cut of the output's last dim (N) pads to 8
# columns, and a cut of its second-to-last dim (M) pads to 64 rows.
HOPPER_LANE = 8         # last-dim granule (wgmma N step)
HOPPER_SUBLANE = 64     # second-to-last-dim granule (wgmma M)


def alignment_factor(n: float, unit: int) -> float:
    """Padded-over-actual block size when an ``n``-element dim is tiled
    at ``unit`` granularity — ceil(n/unit)·unit / n >= 1.  This is the
    kernel-visible cost of a tiling whose per-shard blocks miss the
    tensor-core tile sizes (the kernel pads the tile; wgmma runs the
    padded shape)."""
    if n <= 0:
        return 1.0
    return math.ceil(n / unit) * unit / n


class CostTerm:
    """One additive cost term of the tiling DP.

    ``penalties(g, arity)`` returns {tensor: {tiling: cost >= 0}} charged
    once when the DP assigns that tensor, in the same currency as the
    op-conversion cost tables of the cut being solved."""

    name = "term"

    def penalties(self, g: Graph, arity: int) -> PenaltyTable:
        raise NotImplementedError


@dataclasses.dataclass
class CapacityTerm(CostTerm):
    """Soft-capacity Lagrangian (the pre-existing ``mem_scale`` term)."""

    scale: float = 1.0
    hbm: float = HBM_PER_DEV
    name = "capacity"

    def penalties(self, g: Graph, arity: int) -> PenaltyTable:
        if not self.scale:
            return {}
        return memory_penalties(g, arity, self.scale, self.hbm)


@dataclasses.dataclass
class TensorPenaltyTerm(CostTerm):
    """Explicit per-tensor penalty table (tests / ad-hoc pins)."""

    table: PenaltyTable
    name = "table"

    def penalties(self, g: Graph, arity: int) -> PenaltyTable:
        return {t: per for t, per in self.table.items() if t in g.tensors}


@dataclasses.dataclass
class BoundaryTransferTerm(CostTerm):
    """One inner axis' slice of the stage-boundary transfer cost.

    ``weights``: {tensor: w} with w = mult × groups_k × bw_k × a_k /
    (stage_bw × inner_degree) — everything about the axis and the stage
    link folded into one scalar by the stage solver, so the charge here
    is simply w × current_bytes × (arity − 1) for every non-Part choice
    (Part ships a strictly smaller shard and is charged downstream on
    the later axes' s_k, per the exact telescoping above)."""

    weights: Mapping[str, float]
    name = "stage-boundary"

    def penalties(self, g: Graph, arity: int) -> PenaltyTable:
        out: PenaltyTable = {}
        for t, w in self.weights.items():
            ts = g.tensors.get(t)
            if ts is None or not w:
                continue
            excess = w * ts.nbytes * (arity - 1)
            out[t] = {c: (0.0 if isinstance(c, Part) else excess)
                      for c in tensor_tiling_choices(g, t, arity)}
        return out


@dataclasses.dataclass(frozen=True)
class BubbleTerm:
    """1F1B / GPipe bubble: with S stages and n_micro microbatches the
    schedule runs n_micro + S − 1 stage-times to drain, so the step pays

        factor(S) = (n_micro + S − 1) / n_micro = 1 + (S − 1)/n_micro

    times the critical (slowest) stage time.  1F1B shares GPipe's bubble
    count — what it improves is activation memory, which the per-stage
    capacity term sees through the stage subgraphs."""

    n_micro: int

    def factor(self, n_stages: int) -> float:
        if n_stages <= 1:
            return 1.0
        return (self.n_micro + n_stages - 1) / float(self.n_micro)


@dataclasses.dataclass
class ComputeTerm(CostTerm):
    """Kernel-aware compute time as a per-tensor penalty (ROADMAP item 1:
    the paper's objective is communication-only; FlexFlow/PaSE fold
    per-op compute into the strategy search).

    Each einsum op's analytic FLOPs (2 × Π dim sizes × repeat, exactly
    :func:`repro.core.cost.graph_flops` per op) are attributed to its
    *output* tensor's tiling choice:

      Part(d)    -> flops / arity × alignment_factor(per-shard d size)
      REPLICATE  -> flops            (each cut group member computes all)

    and converted from seconds into the cut's byte currency by the
    ``exchange`` rate (one axis-k byte is worth 1/(bw_k × a_k) seconds in
    solve_mesh's accounting, so t seconds = t × bw_k × a_k bytes — the
    same pre-scaling BoundaryTransferTerm uses).  ``calibration`` is the
    measured-HLO-flops / analytic-flops ratio from real compiled
    artifacts (analysis/roofline.py; verify's compute cell fits it).

    Modeling notes, deliberate and documented in DESIGN.md §14:
    - The alignment unit is HOPPER_LANE for a cut of the output's *last*
      dim, HOPPER_SUBLANE otherwise; a shard smaller than its unit pays the
      padded block (the factor may exceed the arity — partitioning a
      tiny dim really is slower than replicating on the tensor cores).
    - A replicated output is charged full flops even when a contraction
      dim is partitioned (the per-tensor interface cannot see the
      inputs' joint assignment); this biases the solver toward
      output-partitioned forms, which are also the tensor-core-friendly
      ones.
    - All penalties are >= 0, preserving the DP's dominance pruning, and
      the term rides the standard penalties() interface, so
      solve == reprice == oracle holds by construction.
    """

    peak_flops: float = DEFAULT_PEAK_FLOPS
    exchange: float = 1.0       # bytes per second: axis bw × arity
    calibration: float = 1.0
    lane: int = HOPPER_LANE
    sublane: int = HOPPER_SUBLANE
    name = "compute"

    def penalties(self, g: Graph, arity: int) -> PenaltyTable:
        out: PenaltyTable = {}
        scale = self.calibration * self.exchange / self.peak_flops
        for op in g.ops:
            if op.kind != "einsum":
                continue
            lhs, rhs = (g.tensors[i] for i in op.inputs)
            ots = g.tensors[op.output]
            sizes = dict(zip(lhs.dims, lhs.shape))
            sizes.update(zip(rhs.dims, rhs.shape))
            sizes.update(zip(ots.dims, ots.shape))
            flops = 2.0 * op.repeat
            for s in sizes.values():
                flops *= s
            per = out.setdefault(op.output, {})
            for c in tensor_tiling_choices(g, op.output, arity):
                if isinstance(c, Part):
                    n = dict(zip(ots.dims, ots.shape))[c.dim] / arity
                    unit = self.lane if c.dim == ots.dims[-1] \
                        else self.sublane
                    t = flops / arity * alignment_factor(n, unit)
                else:
                    t = flops
                per[c] = per.get(c, 0.0) + t * scale
        return out


@dataclasses.dataclass(frozen=True)
class ComputeConfig:
    """Solver-facing configuration of the compute term: one per solve,
    expanded into a per-axis :class:`ComputeTerm` (the exchange rate
    depends on each axis' bandwidth × arity) by solve_mesh /
    composed_cost / solution_breakdown."""

    peak_flops: float = DEFAULT_PEAK_FLOPS
    calibration: float = 1.0
    lane: int = HOPPER_LANE
    sublane: int = HOPPER_SUBLANE

    def term_for_axis(self, bandwidth: float, arity: int) -> ComputeTerm:
        return ComputeTerm(peak_flops=self.peak_flops,
                           exchange=bandwidth * max(1, arity),
                           calibration=self.calibration,
                           lane=self.lane, sublane=self.sublane)

    def token(self) -> str:
        """Stable key component for the plan cache (launch/compile.py):
        two plans solved under different compute configs must not share
        a cache entry."""
        return (f"ct{self.peak_flops:.4g}-{self.calibration:.4g}"
                f"-{self.lane}-{self.sublane}")


def graph_compute_seconds(g: Graph, cfg: ComputeConfig) -> float:
    """Exact in-model per-device compute seconds of a graph whose shapes
    are already divided to per-device blocks (Graph.divided along every
    mesh axis): Σ einsum flops × block alignment factor / peak, times the
    measured calibration.  This is the end-to-end compute half of the
    predicted step time (the per-axis ComputeTerm charges are the DP's
    *search* signal; this is the exact final accounting — see
    solver.solution_compute_seconds)."""
    total = 0.0
    for op in g.ops:
        if op.kind != "einsum":
            continue
        lhs, rhs = (g.tensors[i] for i in op.inputs)
        ots = g.tensors[op.output]
        sizes = dict(zip(lhs.dims, lhs.shape))
        sizes.update(zip(rhs.dims, rhs.shape))
        sizes.update(zip(ots.dims, ots.shape))
        flops = 2.0 * op.repeat
        for s in sizes.values():
            flops *= s
        f = 1.0
        if len(ots.shape) >= 1:
            f *= alignment_factor(ots.shape[-1], cfg.lane)
        if len(ots.shape) >= 2:
            f *= alignment_factor(ots.shape[-2], cfg.sublane)
        total += flops * f
    return cfg.calibration * total / cfg.peak_flops


def combined_penalties(g: Graph, arity: int,
                       terms: Sequence[CostTerm]) -> PenaltyTable:
    """Sum the terms' penalty tables (per tensor, per tiling)."""
    merged: PenaltyTable = {}
    for term in terms:
        for t, per in term.penalties(g, arity).items():
            dst = merged.setdefault(t, {})
            for c, v in per.items():
                dst[c] = dst.get(c, 0.0) + v
    return merged
