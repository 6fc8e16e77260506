"""Live cost-model drift: predicted wire bytes vs the collectives a step
issued (the port's counterpart of ``repro.obs.drift``).

repro hands ``record_drift`` the compiled program's HLO text and parses
its collectives.  The port has no compiled program: it records the
collectives that one step issues under its plan
(``analysis/comm.record``, a ``CommDebugMode``) and hands their
:class:`~repro_torch.analysis.comm.CollectiveStats` here.  Everything
else is repro's: the plan record's as-executed predicted system-wide
wire bytes (``breakdown.total``) against the measured ring-model bytes
(per device x devices), set as gauges on the run's metrics registry
under repro's names:

    drift.predicted_wire_bytes      solver prediction (system-wide)
    drift.measured_wire_bytes       ring-model bytes of the recorded step
    drift.predicted_vs_measured_bytes   measured / predicted ratio

The ratio is judged against the calibration band (``RATIO_LO`` /
``RATIO_HI``, ``verify/calibration.py``); both sides under ``ABS_FLOOR``
count as "no meaningful communication" and report ratio 1.0 (every
collective of a one-card (1, 1) mesh has a group of 1 and moves
nothing).  Stdlib-only at import, like the rest of ``repro_torch.obs``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

from .metrics import Registry

# kept equal to verify/calibration.py, should it fail to import
_RATIO_LO, _RATIO_HI, _ABS_FLOOR = 0.25, 4.0, 256e3


def _band():
    try:
        from ..verify import calibration as cal
        return cal.RATIO_LO, cal.RATIO_HI, cal.ABS_FLOOR
    except Exception:
        return _RATIO_LO, _RATIO_HI, _ABS_FLOOR


def drift_ratio(predicted: float, measured: float,
                floor: Optional[float] = None) -> float:
    """measured/predicted with the calibration floor applied: both
    sides under the floor → 1.0 (no meaningful communication either
    way); predicted ~0 but measured real → +inf (a genuine miss that a
    finiteness gate should catch)."""
    if floor is None:
        floor = _band()[2]
    if predicted < floor and measured < floor:
        return 1.0
    if predicted <= 0.0:
        return math.inf
    return measured / predicted


def record_drift(registry: Registry, predicted: float, stats,
                 n_devices: int,
                 predicted_by_kind: Optional[Dict[str, float]] = None,
                 ) -> Dict[str, Any]:
    """Set the drift gauges on ``registry`` from ``stats`` (the
    ``analysis/comm.CollectiveStats`` of one recorded step on one rank)
    and return the comparison record the launch CLIs embed in their
    result JSON (repro's fields)."""
    measured = stats.wire_bytes_per_device * n_devices
    lo, hi, floor = _band()
    ratio = drift_ratio(predicted, measured, floor)
    in_band = (lo <= ratio <= hi) if math.isfinite(ratio) else False

    registry.gauge(
        "drift.predicted_wire_bytes",
        help="solver-predicted system-wide wire bytes").set(predicted)
    registry.gauge(
        "drift.measured_wire_bytes",
        help="ring-model wire bytes of the collectives one step "
             "issued").set(measured)
    registry.gauge(
        "drift.predicted_vs_measured_bytes",
        help="measured/predicted wire-byte ratio (calibration band "
             f"[{lo}, {hi}])").set(ratio)

    rec: Dict[str, Any] = {
        "predicted_wire_bytes": predicted,
        "measured_wire_bytes": measured,
        "ratio": ratio,
        "in_band": in_band,
        "band": [lo, hi],
        "floor_bytes": floor,
        "n_devices": n_devices,
        "measured_by_kind": {k: v * n_devices
                             for k, v in stats.wire_by_kind.items()},
        "collective_counts": dict(stats.counts),
    }
    if predicted_by_kind:
        rec["predicted_by_kind"] = dict(predicted_by_kind)
    return rec


def describe(rec: Dict[str, Any]) -> str:
    """One line for a launcher's log: the two sides, the ratio and the
    band."""
    return (f"drift: predicted {rec['predicted_wire_bytes'] / 1e6:.3f}MB, "
            f"measured {rec['measured_wire_bytes'] / 1e6:.3f}MB, ratio "
            f"{rec['ratio']:.2f} (band {rec['band']}, "
            f"{'in' if rec['in_band'] else 'OUT OF'} band)")
