"""Small-sample statistics shared by the launch CLIs (the port's copy of
``repro.obs.stats``, unchanged but for this docstring).

``percentile`` matches
``numpy.percentile``'s default linear interpolation exactly, returns
``None`` on an empty sample (instead of raising or returning a bogus 0),
and returns the sample itself for a single observation.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence


def percentile(xs: Sequence[float], q: float) -> Optional[float]:
    """q-th percentile (q in [0, 100]) with linear interpolation between
    closest ranks — the same definition as ``numpy.percentile``'s
    default.  Returns None for an empty sample."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    n = len(xs)
    if n == 0:
        return None
    if n == 1:
        return float(xs[0])
    s = sorted(float(x) for x in xs)
    rank = (q / 100.0) * (n - 1)
    lo = math.floor(rank)
    hi = math.ceil(rank)
    if lo == hi:
        return s[lo]
    frac = rank - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


def mean(xs: Sequence[float]) -> Optional[float]:
    if not xs:
        return None
    return sum(float(x) for x in xs) / len(xs)


def summarize(xs: Sequence[float],
              qs: Sequence[float] = (50.0, 90.0, 99.0)) -> Dict[str, Optional[float]]:
    """Count/mean/min/max plus the requested percentiles (keys
    ``p50``/``p90``/... — trailing ``.0`` dropped).  All value fields are
    None on an empty sample so callers can json-dump the result as-is."""
    out: Dict[str, Optional[float]] = {
        "count": len(xs),
        "mean": mean(xs),
        "min": min(xs) if xs else None,
        "max": max(xs) if xs else None,
    }
    for q in qs:
        label = f"{q:g}".replace(".", "_")
        out[f"p{label}"] = percentile(xs, q)
    return out
