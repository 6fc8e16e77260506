"""SLO objectives and multi-window burn-rate rules (the port's copy of
``repro.obs.slo``, unchanged but for its docstring).

An :class:`SLO` declares, for one monitored signal, the latency target a
given fraction of observations must meet — "p95 of inter-token latency
under 40 ms" is ``SLO("itl", target=0.040, objective=0.95)``.  The error
budget is ``1 - objective`` (5% of tokens may be slower than target).

Breach detection uses the multi-window, multi-burn-rate rule from the
SRE workbook: the *burn rate* over a window is the observed
error fraction divided by the budget (burn 1.0 = spending the budget
exactly as fast as allowed), and an alert fires only when BOTH a short
window (fast reaction, noisy) and a long window (evidence the burn is
sustained) exceed their thresholds.  The defaults — short burn >= 14.4
and long burn >= 6 — are the workbook's page-worthy tier; a single
straggler token cannot trip them, a sustained regression trips them
within ``short_window`` observations.

Windows here are counted in *observations*, not wall seconds: the
serving/training loops observe at a roughly steady cadence and a
sample-count ring is O(1) memory with no clock dependence, which keeps
replay deterministic (the anomaly/flight tests replay recorded streams
and must reproduce breach decisions bit-for-bit).

Everything is stdlib-only, like the rest of ``repro_torch.obs``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, Optional

# SRE-workbook page tier: 14.4x burn over the short window consumes 2%
# of a 30-day budget in an hour; 6x sustained over the long window is
# the corroboration that it is not a blip.
FAST_BURN = 14.4
SLOW_BURN = 6.0


@dataclasses.dataclass(frozen=True)
class SLO:
    """One signal's objective: ``objective`` fraction of observations
    must be <= ``target`` (seconds, or whatever unit the signal uses)."""
    signal: str                 # "itl" | "ttft" | "step" | ...
    target: float               # threshold per observation
    objective: float = 0.95     # fraction that must meet the target
    short_window: int = 16      # observations (fast, noisy window)
    long_window: int = 64       # observations (sustained-evidence window)
    fast_burn: float = FAST_BURN
    slow_burn: float = SLOW_BURN
    # breaches need at least this many samples in the long window, so a
    # cold start cannot alert off two bad observations
    min_count: int = 8

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"SLO {self.signal}: objective must be in (0, 1), got "
                f"{self.objective}")
        if self.target <= 0:
            raise ValueError(
                f"SLO {self.signal}: target must be positive")
        if self.short_window > self.long_window:
            raise ValueError(
                f"SLO {self.signal}: short_window {self.short_window} > "
                f"long_window {self.long_window}")

    @property
    def budget(self) -> float:
        return 1.0 - self.objective


class BurnRateRule:
    """Streaming evaluator of one :class:`SLO` — O(long_window) memory,
    O(1) per observation (running error counts, no rescan)."""

    def __init__(self, slo: SLO):
        self.slo = slo
        self._short = collections.deque(maxlen=slo.short_window)
        self._long = collections.deque(maxlen=slo.long_window)
        self._short_errs = 0
        self._long_errs = 0
        self.total = 0
        self.total_errs = 0
        self.breaches = 0

    def _push(self, dq: collections.deque, errs: int, bad: bool) -> int:
        if len(dq) == dq.maxlen and dq[0]:
            errs -= 1
        dq.append(bad)
        return errs + (1 if bad else 0)

    def burn_rates(self) -> Dict[str, float]:
        """Current (short, long) burn rates — error fraction over the
        window divided by the error budget."""
        b = self.slo.budget
        s = (self._short_errs / len(self._short) / b
             if self._short else 0.0)
        l = (self._long_errs / len(self._long) / b
             if self._long else 0.0)
        return {"short": s, "long": l}

    def observe(self, value: float) -> Optional[Dict[str, Any]]:
        """Feed one observation; returns a breach record when both
        windows burn past their thresholds, else None.  Keeps firing
        while the condition holds — debouncing is the consumer's job
        (the flight recorder debounces dumps per trigger)."""
        slo = self.slo
        bad = value > slo.target
        self.total += 1
        self.total_errs += 1 if bad else 0
        self._short_errs = self._push(self._short, self._short_errs, bad)
        self._long_errs = self._push(self._long, self._long_errs, bad)
        if len(self._long) < slo.min_count:
            return None
        rates = self.burn_rates()
        if rates["short"] >= slo.fast_burn and \
                rates["long"] >= slo.slow_burn:
            self.breaches += 1
            return {
                "type": "slo_breach",
                "signal": slo.signal,
                "target": slo.target,
                "objective": slo.objective,
                "value": value,
                "burn_short": rates["short"],
                "burn_long": rates["long"],
                "windows": [slo.short_window, slo.long_window],
                "thresholds": [slo.fast_burn, slo.slow_burn],
            }
        return None

    def snapshot(self) -> Dict[str, Any]:
        rates = self.burn_rates()
        return {
            "signal": self.slo.signal,
            "target": self.slo.target,
            "objective": self.slo.objective,
            "observations": self.total,
            "violations": self.total_errs,
            "burn_short": rates["short"],
            "burn_long": rates["long"],
            "breaches": self.breaches,
        }
