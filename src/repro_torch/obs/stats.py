"""Small-sample statistics for the launch harness (own copy of
``repro.obs.stats.percentile``)."""
from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(xs: Sequence[float], q: float) -> Optional[float]:
    """q-th percentile (q in [0, 100]) with linear interpolation between
    closest ranks, as ``numpy.percentile``'s default.  None for an empty
    sample."""
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
