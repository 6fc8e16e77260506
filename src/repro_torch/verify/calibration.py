"""Cost-model calibration: the bands, the verification mesh's solver axes
and the as-executed projection of a solved tiling (the port's copy of
these parts of ``repro.verify.calibration``).

The calibration gate compares solver-predicted wire bytes with what a
step actually moves: measured/predicted in [RATIO_LO, RATIO_HI], or both
sides under ABS_FLOOR ("no meaningful communication").  The predicted
side prices the *as-executed* projection of the solved tiling
(``faithful_assignments``; for training, ``train_cell.
train_faithful_assignments``), which ``launch/compile._executed_breakdown``
stores in every plan record and ``obs/drift`` reads at run time.
Stdlib-only at import (the port's ``core`` is).
"""
from __future__ import annotations

from typing import List, Sequence

from ..core.solver import (MeshAxis, TilingSolution,
                           data_parallel_assignment)
from ..core.tiling import REPLICATE

# declared calibration tolerance bands (repro's)
RATIO_LO = 0.25      # measured may undershoot: moves fused or elided
RATIO_HI = 4.0       # or overshoot: resharding the model does not see
ABS_FLOOR = 256e3    # bytes; below this a cell is "no communication"

# the verification mesh: 8 ranks as data=4 x model=2 (repro's)
MESH_SHAPE = (4, 2)
MESH_AXES = ("data", "model")


def verify_axes() -> List[MeshAxis]:
    """Solver axes of the verification mesh at the port's link rates
    (``launch/mesh.solver_axes``: every axis of one host on NVLink)."""
    from ..launch.mesh import solver_axes
    return solver_axes(MESH_SHAPE, MESH_AXES)


def faithful_assignments(g, per_axis: Sequence[dict]) -> List[dict]:
    """Project per-axis assignments onto what the executed step can
    actually run: gradient and optimizer tensors follow their weight's
    tiling (the grads are internal to the step; only params, optimizer
    state and the batch carry placements).  In the ring model this
    projection is nearly cost-neutral (red→P + P→r ≡ red→r =
    2·s·(A-1)); what it removes is the ZeRO-style sharded-gradient
    accounting the executed step does not perform.  Calibration prices
    THIS assignment."""
    out = []
    for assign in per_axis:
        a = dict(assign)
        for name, ts in g.tensors.items():
            if ts.kind != "weight":
                continue
            w = a.get(name, REPLICATE)
            for der, dts in g.tensors.items():
                if dts.kind == "opt" and der == f"opt:{name}":
                    a[der] = w
                elif dts.kind == "grad" and (
                        der == f"d_{name}" or
                        der.startswith(f"d_{name}#") or
                        der.startswith(f"d_{name}.sum")):
                    a[der] = w
        out.append(a)
    return out


def _dp_solution(g, axes: Sequence[MeshAxis]) -> TilingSolution:
    """Pure data parallelism: batch-partition on the first (data) axis,
    replicate on the rest."""
    dp = data_parallel_assignment(g)
    per_axis = [dp if i == 0 else {t: REPLICATE for t in g.tensors}
                for i in range(len(axes))]
    return TilingSolution(list(axes), per_axis,
                          [0.0] * len(axes), 0.0, 0.0)
