"""Continuous SLO/anomaly monitor: O(1)-memory streaming estimators,
robust anomaly scoring, and the drift-triggered replan advisor (the
port's copy of ``repro.obs.monitor``: the same estimators, code for code,
P²'s known inaccuracy on heavy tails included).

Estimators
----------
- :class:`WindowPercentile` — exact percentiles over a bounded sliding
  window (ring buffer + ``obs.stats.percentile`` on demand).  The
  default for serving/training cadences, where a few hundred samples of
  history is the regime that matters and exactness keeps the replayed
  anomaly tests bit-deterministic.
- :class:`P2Quantile` — the P² algorithm (Jain & Chlamtac '85): five
  markers tracking one quantile of the *whole* stream in O(1) memory
  with no buffer at all.  The fallback when a window would be
  unboundedly large (whole-run percentiles on million-token streams).
- :class:`MadZ` — robust z-score against the sliding window's median
  absolute deviation.  Median/MAD ignore the spike being scored, so a
  step-time straggler scores high even when it lands in its own window.

:class:`Monitor` composes them per signal, evaluates
:class:`repro_torch.obs.slo.BurnRateRule` rules, counts preemption storms,
watches the drift gauge (``obs.drift``), and on any trigger (a) records the event,
(b) asks the :class:`repro_torch.obs.flight.FlightRecorder` to dump the
moments around it, and (c) asks the :class:`ReplanAdvisor` to re-solve
the tiling under the observed regime.  Unobserved components pay one
``is None`` attribute check per event — same contract as tracing.

The advisor deliberately does NOT swap plans (live re-planning is out
of scope); it closes the detect -> re-solve -> report
loop and leaves the swap to an operator or a future control loop.
Everything here is stdlib-only; the solver bridge is injected as a
callable so importing ``repro_torch.obs`` never pulls in torch.
"""
from __future__ import annotations

import collections
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from . import stats
from .slo import SLO, BurnRateRule
from .tracing import instant as _instant

# consistent MAD -> sigma for normal data: 1 / Phi^-1(3/4)
MAD_SIGMA = 1.4826


# ---------------------------------------------------------------------------
# streaming estimators
# ---------------------------------------------------------------------------

class WindowPercentile:
    """Exact percentiles over the last ``window`` observations.
    O(window) memory, O(window log window) per query (queries are
    rare — flush boundaries, breach records — while observes are a
    deque append)."""

    def __init__(self, window: int = 256):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.buf: collections.deque = collections.deque(maxlen=window)
        self.count = 0

    def observe(self, v: float) -> None:
        self.buf.append(float(v))
        self.count += 1

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 100] — the repo-wide convention
        (``obs.stats.percentile``)."""
        return stats.percentile(list(self.buf), q)

    def median(self) -> Optional[float]:
        return self.percentile(50.0)


class P2Quantile:
    """P² single-quantile estimator: five markers, O(1) memory, no
    sample retention.  ``q`` in [0, 100].  Within a few percent of the
    exact stream quantile on unimodal data (the parity test bands it
    against ``numpy.percentile`` on random streams)."""

    def __init__(self, q: float):
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"quantile q must be in [0, 100], got {q}")
        self.q = q / 100.0
        self.count = 0
        self._init: List[float] = []       # first five observations
        self.heights: List[float] = []     # marker heights q_i
        self.npos: List[float] = []        # actual marker positions n_i
        self.dpos: List[float] = []        # desired positions n'_i

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        if self.count <= 5:
            self._init.append(x)
            if self.count == 5:
                p = self.q
                self.heights = sorted(self._init)
                self.npos = [1.0, 2.0, 3.0, 4.0, 5.0]
                self.dpos = [1.0, 1 + 2 * p, 1 + 4 * p, 3 + 2 * p, 5.0]
            return
        h, n = self.heights, self.npos
        # cell containing x; clamp extremes into the marker span
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            n[i] += 1
        p = self.q
        for i, inc in enumerate((0.0, p / 2, p, (1 + p) / 2, 1.0)):
            self.dpos[i] += inc
        # adjust interior markers toward their desired positions
        for i in (1, 2, 3):
            d = self.dpos[i] - n[i]
            if (d >= 1 and n[i + 1] - n[i] > 1) or \
               (d <= -1 and n[i - 1] - n[i] < -1):
                d = 1.0 if d > 0 else -1.0
                hp = h[i] + d / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + d) * (h[i + 1] - h[i])
                    / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1])
                    / (n[i] - n[i - 1]))
                if h[i - 1] < hp < h[i + 1]:       # parabolic
                    h[i] = hp
                else:                               # linear fallback
                    j = i + (1 if d > 0 else -1)
                    h[i] = h[i] + d * (h[j] - h[i]) / (n[j] - n[i])
                n[i] += d

    def value(self) -> Optional[float]:
        if self.count == 0:
            return None
        if self.count <= 5:
            return stats.percentile(self._init, self.q * 100.0)
        return self.heights[2]


class MadZ:
    """Robust anomaly score: (x - median) / (1.4826 * MAD) over the
    current window, computed BEFORE x joins the window so a spike is
    judged against clean history.  Deterministic under replay.  A
    window with MAD 0 (constant history) scores any deviation as +inf —
    the caller's threshold then fires on the first real spike."""

    def __init__(self, window: int = 64, min_samples: int = 8):
        self.buf: collections.deque = collections.deque(maxlen=window)
        self.min_samples = max(3, min_samples)

    def score(self, v: float) -> float:
        """Score v against current history (does not insert it)."""
        xs = list(self.buf)
        if len(xs) < self.min_samples:
            return 0.0
        med = stats.percentile(xs, 50.0)
        mad = stats.percentile([abs(x - med) for x in xs], 50.0)
        dev = float(v) - med
        if mad <= 0.0:
            return 0.0 if dev == 0.0 else math.copysign(math.inf, dev)
        return dev / (MAD_SIGMA * mad)

    def observe(self, v: float) -> float:
        """Score v, then add it to the window; returns the score."""
        s = self.score(v)
        self.buf.append(float(v))
        return s


# ---------------------------------------------------------------------------
# the monitor
# ---------------------------------------------------------------------------

class _Signal:
    __slots__ = ("pctl", "madz", "rules")

    def __init__(self, window: int, anomaly_window: int,
                 rules: List[BurnRateRule]):
        self.pctl = WindowPercentile(window)
        self.madz = MadZ(anomaly_window)
        self.rules = rules


class Monitor:
    """Continuous monitor over named scalar signals ("itl", "ttft",
    "step", ...).  ``observe`` is the hot path: deque appends, running
    burn-rate counters, one median pair for the anomaly score — no
    allocation proportional to history.

    Triggers (SLO breach / anomaly / preemption storm / drift blowout)
    are returned as event dicts, mirrored onto the registry and the
    trace stream, and forwarded to the flight recorder and the replan
    advisor when attached."""

    def __init__(self, slos: Sequence[SLO] = (),
                 registry=None, recorder=None, advisor=None,
                 regime_fn: Optional[Callable[[], str]] = None,
                 window: int = 256, anomaly_window: int = 64,
                 anomaly_z: float = 8.0,
                 storm_threshold: int = 8, storm_window_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.registry = registry
        self.recorder = recorder
        self.advisor = advisor
        self.regime_fn = regime_fn
        self.window = window
        self.anomaly_window = anomaly_window
        self.anomaly_z = anomaly_z
        self.storm_threshold = storm_threshold
        self.storm_window_s = storm_window_s
        self.clock = clock
        self._slos: Dict[str, List[SLO]] = {}
        for s in slos:
            self._slos.setdefault(s.signal, []).append(s)
        self.signals: Dict[str, _Signal] = {}
        self._storms: Dict[str, collections.deque] = {}
        self.events: collections.deque = collections.deque(maxlen=256)
        self.n_events = 0

    # -- plumbing ---------------------------------------------------------
    def _signal(self, name: str) -> _Signal:
        sig = self.signals.get(name)
        if sig is None:
            rules = [BurnRateRule(s) for s in self._slos.get(name, [])]
            sig = _Signal(self.window, self.anomaly_window, rules)
            self.signals[name] = sig
        return sig

    def _emit(self, event: Dict[str, Any]) -> Dict[str, Any]:
        self.events.append(event)
        self.n_events += 1
        kind = event["type"]
        if self.registry is not None:
            self.registry.counter(
                f"monitor.{kind}_total",
                help=f"monitor {kind} events").inc()
        _instant(f"monitor.{kind}",
                 **{k: v for k, v in event.items()
                    if isinstance(v, (int, float, str, bool))})
        if self.recorder is not None:
            path = self.recorder.dump(
                trigger=f"{kind}-{event.get('signal', 'run')}",
                events=list(self.events), extra=event)
            if path is not None:
                event["flight"] = path
        if self.advisor is not None:
            regime = self.regime_fn() if self.regime_fn else "observed"
            advice = self.advisor.advise(trigger=kind, regime=regime)
            if advice is not None:
                event["advice"] = advice
                self.events.append(advice)
                self.n_events += 1
        return event

    # -- observations -----------------------------------------------------
    def observe(self, signal: str, value: float,
                ) -> List[Dict[str, Any]]:
        """Feed one observation of ``signal``; returns any events it
        triggered (usually none)."""
        sig = self._signal(signal)
        out: List[Dict[str, Any]] = []
        z = sig.madz.observe(value)
        sig.pctl.observe(value)
        if z >= self.anomaly_z:
            out.append(self._emit({
                "type": "anomaly", "signal": signal,
                "value": value,
                "madz": z if math.isfinite(z) else 1e9,
                "threshold": self.anomaly_z,
                "window_median": sig.madz.buf and stats.percentile(
                    list(sig.madz.buf), 50.0) or None,
            }))
        for rule in sig.rules:
            breach = rule.observe(value)
            if breach is not None:
                out.append(self._emit(breach))
        return out

    def bump(self, kind: str = "preempt") -> List[Dict[str, Any]]:
        """Count a discrete occurrence (preemption, rejection); fires a
        ``<kind>_storm`` event when ``storm_threshold`` of them land
        within ``storm_window_s`` seconds."""
        now = self.clock()
        dq = self._storms.setdefault(
            kind, collections.deque(maxlen=self.storm_threshold))
        dq.append(now)
        if (len(dq) == self.storm_threshold
                and now - dq[0] <= self.storm_window_s):
            ev = self._emit({
                "type": f"{kind}_storm", "signal": kind,
                "count": self.storm_threshold,
                "window_s": now - dq[0],
            })
            dq.clear()
            return [ev]
        return []

    def check_drift(self, ratio: float,
                    band=(0.25, 4.0)) -> List[Dict[str, Any]]:
        """Judge the live drift gauge (measured/predicted wire bytes)
        against its calibration band; a blowout is a trigger like any
        other — the plan is priced wrong for what actually compiled."""
        if math.isfinite(ratio) and band[0] <= ratio <= band[1]:
            return []
        return [self._emit({
            "type": "drift_blowout", "signal": "drift",
            "ratio": ratio if math.isfinite(ratio) else None,
            "band": list(band),
        })]

    # -- reporting --------------------------------------------------------
    def export_gauges(self) -> None:
        """Write current window percentiles per signal onto the
        registry (``monitor.<signal>_p50/_p95``)."""
        if self.registry is None:
            return
        for name, sig in self.signals.items():
            for q in (50.0, 95.0):
                v = sig.pctl.percentile(q)
                if v is not None:
                    self.registry.gauge(
                        f"monitor.{name}_p{q:g}",
                        help=f"sliding-window p{q:g} of {name}").set(v)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable state summary (embedded in launch result
        records and flight dumps)."""
        sigs = {}
        for name, sig in self.signals.items():
            sigs[name] = {
                "count": sig.pctl.count,
                "p50": sig.pctl.percentile(50.0),
                "p95": sig.pctl.percentile(95.0),
                "slo": [r.snapshot() for r in sig.rules],
            }
        return {
            "signals": sigs,
            "n_events": self.n_events,
            "events": list(self.events),
        }


# ---------------------------------------------------------------------------
# replan advisor
# ---------------------------------------------------------------------------

class ReplanAdvisor:
    """Detect -> re-solve -> report.  ``solve_fn(regime)`` is the solver
    bridge (a launch-CLI closure over ``launch.compile``'s cached
    ``solve_observed_regime``); ``current`` is the running plan's record
    (``total_seconds`` / ``breakdown.total`` are the modeled baseline).
    ``advise`` returns an advisory event with the re-solved plan's
    modeled win, or None inside the cooldown.  It never swaps the plan.
    """

    def __init__(self, solve_fn: Callable[[str], Dict[str, Any]],
                 current: Dict[str, Any], registry=None,
                 cooldown_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.solve_fn = solve_fn
        self.current = current
        self.registry = registry
        self.cooldown_s = cooldown_s
        self.clock = clock
        self._last: Optional[float] = None
        self.advice: List[Dict[str, Any]] = []

    def advise(self, trigger: str, regime: str) -> Optional[Dict[str, Any]]:
        now = self.clock()
        if self._last is not None and now - self._last < self.cooldown_s:
            return None
        self._last = now
        try:
            rec = self.solve_fn(regime)
        except Exception as e:       # a failed re-solve must not kill serving
            rec = None
            err = f"{type(e).__name__}: {e}"
        if rec is None:
            event = {"type": "replan_advice", "trigger": trigger,
                     "regime": regime, "error": err}
            self.advice.append(event)
            return event
        cur_s = self.current.get("total_seconds")
        new_s = rec.get("total_seconds")
        win = None
        if cur_s and new_s is not None:
            win = 1.0 - new_s / cur_s
        cur_b = (self.current.get("breakdown") or {}).get(
            "total", self.current.get("total_bytes"))
        new_b = (rec.get("breakdown") or {}).get(
            "total", rec.get("total_bytes"))
        changed = rec.get("role_cuts") != self.current.get("role_cuts")
        event = {
            "type": "replan_advice",
            "trigger": trigger,
            "regime": regime,
            "current_step_s": cur_s,
            "advised_step_s": new_s,
            "modeled_win": win,
            "current_wire_bytes": cur_b,
            "advised_wire_bytes": new_b,
            "plan_changed": changed,
            "solve_s": rec.get("solve_time"),
        }
        if changed:
            event["advised_role_cuts"] = rec.get("role_cuts")
        if self.registry is not None:
            self.registry.counter(
                "monitor.replan_advice_total",
                help="replan advisories issued").inc()
            if win is not None:
                self.registry.gauge(
                    "monitor.replan_modeled_win",
                    help="modeled step-time win of the latest advised "
                         "plan (1 - new/current)").set(win)
        _instant("monitor.replan_advice", trigger=trigger, regime=regime,
                 modeled_win=-1.0 if win is None else win,
                 plan_changed=changed)
        self.advice.append(event)
        return event
