"""Anomaly flight recorder (the port's copy of ``repro.obs.flight``,
unchanged but for its docstrings).

A :class:`FlightRecorder` keeps the tracer's bounded ring sink attached
for the whole run — always on, unlike ``--trace-out`` — so the last few
thousand spans/instants exist in memory at the moment something goes
wrong.  When the monitor fires a trigger (SLO breach, anomaly score,
preemption storm, drift blowout) ``dump`` writes
``flight-<trigger>.json``: a Perfetto-compatible Chrome trace whose
``traceEvents`` are the ring contents, with a top-level ``"flight"``
block carrying the triggering event, the monitor's recent event log, and
a full metrics-registry snapshot.  Trace viewers ignore unknown
top-level keys, so the same file loads at ui.perfetto.dev AND validates
as a flight record under ``python -m repro_torch.obs validate``.

Dumps are debounced per trigger kind (a sustained breach keeps firing
the rule every observation; the evidence from the first dump is the
evidence) and capped per run, so a pathological run cannot fill a disk.
Stdlib-only, like the rest of ``repro_torch.obs``.
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Dict, List, Optional

from . import tracing

FLIGHT_SCHEMA_VERSION = 1

_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")


def _slug(s: str) -> str:
    return _SAFE.sub("-", s).strip("-") or "trigger"


class FlightRecorder:
    """Always-on ring capture + triggered dump (see module docstring).

    ``out_dir`` is created lazily at first dump.  ``registry`` (a
    :class:`repro_torch.obs.metrics.Registry`) is snapshotted into each dump
    when given.  ``debounce_s`` suppresses repeat dumps of the same
    trigger kind; ``max_dumps`` bounds the run's total."""

    def __init__(self, out_dir: str, registry=None,
                 ring_size: int = 2048, debounce_s: float = 10.0,
                 max_dumps: int = 8,
                 clock=time.monotonic, tracer=None):
        self.out_dir = out_dir
        self.registry = registry
        self.debounce_s = debounce_s
        self.max_dumps = max_dumps
        self.clock = clock
        self.tracer = tracer if tracer is not None else tracing.get_tracer()
        self.ring = self.tracer.attach_ring(ring_size)
        self._last: Dict[str, float] = {}
        self.dumps: List[str] = []
        self._seq = 0

    def dump(self, trigger: str,
             events: Optional[List[Dict[str, Any]]] = None,
             extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write a flight record for ``trigger``; returns the path, or
        None when debounced / over the dump cap."""
        if len(self.dumps) >= self.max_dumps:
            return None
        now = self.clock()
        kind = trigger.split("-", 1)[0]
        last = self._last.get(kind)
        if last is not None and now - last < self.debounce_s:
            return None
        self._last[kind] = now
        self._seq += 1
        with self.tracer._lock:
            ring = list(self.ring)
        payload = {
            "displayTimeUnit": "ms",
            "traceEvents": ring,
            "flight": {
                "schema_version": FLIGHT_SCHEMA_VERSION,
                "trigger": trigger,
                "seq": self._seq,
                "unix_time": time.time(),
                "event": extra,
                "monitor_events": events or [],
                "metrics": (self.registry.collect()
                            if self.registry is not None else []),
            },
        }
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"flight-{_slug(trigger)}.json")
        if os.path.exists(path):
            path = os.path.join(
                self.out_dir, f"flight-{_slug(trigger)}-{self._seq}.json")
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        self.dumps.append(path)
        return path

    def close(self) -> None:
        """Detach the ring (restores the tracer's zero-sink state)."""
        self.tracer.detach_ring()


def validate_flight(doc: Dict[str, Any]) -> List[str]:
    """Schema-check one flight record (already-parsed JSON); returns a
    list of problems, empty when valid.  The trace portion is checked
    by the caller with the normal trace validator."""
    errs: List[str] = []
    fl = doc.get("flight")
    if not isinstance(fl, dict):
        return ["missing top-level 'flight' object"]
    if fl.get("schema_version") != FLIGHT_SCHEMA_VERSION:
        errs.append(
            f"flight.schema_version {fl.get('schema_version')!r} != "
            f"{FLIGHT_SCHEMA_VERSION}")
    if not isinstance(fl.get("trigger"), str) or not fl.get("trigger"):
        errs.append("flight.trigger missing or not a string")
    if not isinstance(fl.get("monitor_events"), list):
        errs.append("flight.monitor_events missing or not a list")
    else:
        for i, ev in enumerate(fl["monitor_events"]):
            if not isinstance(ev, dict) or "type" not in ev:
                errs.append(f"flight.monitor_events[{i}] lacks 'type'")
    if not isinstance(fl.get("metrics"), list):
        errs.append("flight.metrics missing or not a list")
    ev = fl.get("event")
    if ev is not None and (not isinstance(ev, dict) or "type" not in ev):
        errs.append("flight.event present but lacks 'type'")
    return errs
