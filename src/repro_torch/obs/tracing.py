"""Structured tracing: span context managers -> Chrome trace-event JSON.

One process-global :class:`Tracer` records *complete* events ("ph": "X",
wall-clock microseconds + duration) for ``span(...)`` blocks and
*instant* events ("ph": "i") for point occurrences.  The export is the
Chrome trace-event format — load it at ``chrome://tracing`` or
https://ui.perfetto.dev (File > Open).

Disabled (the default) the hot path is one attribute check returning a
shared null context manager: no event objects, no timestamps, no
allocations that survive the call.  Enable explicitly
(``tracing.enable("run.trace.json")``, what the launch CLIs'
``--trace-out`` does) or via the ``REPRO_TRACE=<path>`` env var (picked
up at import; the file is written atexit), which is how subprocess runs
— conformance cells, benches — inherit tracing.

``annotate=True`` additionally enters a
``torch.profiler.record_function`` for every span, so spans line up with
the kernels inside a ``torch.profiler`` capture.  torch is imported
lazily and only then — this module itself stays stdlib-only.  (The
port's copy of ``repro.obs.tracing``; the annotation is its only
change.)

Besides the unbounded export list there is an optional bounded *ring*
sink (``attach_ring``), which the flight recorder keeps attached for the
whole run: the last N events are always available for a post-incident
dump even when ``--trace-out`` was never passed.  The recording hot path
checks a single ``_active`` attribute that folds together "export list
enabled" and "ring attached", so the unobserved path stays exactly one
attribute check regardless of how many sinks exist.

Thread-safe: events carry the recording thread's id (Perfetto lays
threads out as separate tracks) and the event list is appended under a
lock.
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional


class _NullSpan:
    """Shared do-nothing context manager returned while disabled."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "attrs", "_t0", "_ann")

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._ann = None

    def set(self, **attrs):
        """Attach/override attributes mid-span (recorded at exit)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        t = self._tracer
        if t.annotate:
            try:
                from torch.profiler import record_function
                self._ann = record_function(self.name)
                self._ann.__enter__()
            except Exception:       # torch absent / profiler unavailable
                self._ann = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._tracer._record(self.name, self._t0, t1, self.attrs)
        return False


class Tracer:
    """In-memory trace-event collector (see module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []
        self.enabled = False
        self.annotate = False
        self.out: Optional[str] = None
        # bounded always-on sink for the flight recorder; None unless
        # attached.  _active = enabled OR ring attached — the single
        # attribute the hot path checks.
        self.ring: Optional[collections.deque] = None
        self._active = False
        # perf_counter epoch so ts starts near 0 (Perfetto dislikes
        # huge absolute timestamps)
        self._epoch = time.perf_counter()
        self._pid = os.getpid()

    # -- recording --------------------------------------------------------
    def span(self, name: str, attrs: Optional[Dict[str, Any]] = None):
        if not self._active:
            return NULL_SPAN
        return _Span(self, name, attrs)

    def instant(self, name: str, **attrs) -> None:
        if not self._active:
            return
        ts = (time.perf_counter() - self._epoch) * 1e6
        ev = {"name": name, "cat": name.split(".")[0], "ph": "i",
              "s": "t", "ts": ts, "pid": self._pid,
              "tid": threading.get_ident()}
        if attrs:
            ev["args"] = attrs
        with self._lock:
            if self.enabled:
                self.events.append(ev)
            if self.ring is not None:
                self.ring.append(ev)

    def _record(self, name: str, t0: float, t1: float,
                attrs: Optional[Dict[str, Any]]) -> None:
        ev = {"name": name, "cat": name.split(".")[0], "ph": "X",
              "ts": (t0 - self._epoch) * 1e6,
              "dur": (t1 - t0) * 1e6,
              "pid": self._pid, "tid": threading.get_ident()}
        if attrs:
            ev["args"] = attrs
        with self._lock:
            if self.enabled:
                self.events.append(ev)
            if self.ring is not None:
                self.ring.append(ev)

    # -- lifecycle --------------------------------------------------------
    def _refresh_active(self) -> None:
        self._active = self.enabled or self.ring is not None

    def enable(self, out: Optional[str] = None,
               annotate: bool = False) -> None:
        self.enabled = True
        self.annotate = annotate
        if out is not None:
            self.out = out
        self._refresh_active()

    def disable(self) -> None:
        self.enabled = False
        self.annotate = False
        self._refresh_active()

    def attach_ring(self, maxlen: int = 2048) -> collections.deque:
        """Attach (or resize) the bounded always-on sink; returns the
        deque the flight recorder snapshots at dump time."""
        with self._lock:
            old = list(self.ring) if self.ring is not None else []
            self.ring = collections.deque(old, maxlen=maxlen)
        self._refresh_active()
        return self.ring

    def detach_ring(self) -> None:
        with self._lock:
            self.ring = None
        self._refresh_active()

    def clear(self) -> None:
        with self._lock:
            self.events = []

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            evs = list(self.events)
        return {"displayTimeUnit": "ms", "traceEvents": evs}

    def export(self, path: Optional[str] = None) -> Optional[str]:
        """Write the Chrome trace JSON; returns the path written (None
        when there is nowhere to write)."""
        path = path or self.out
        if path is None:
            return None
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def span(name: str, **attrs):
    """The hot-path entry point: a context manager timing ``name``.
    While no sink is active this is one attribute check and returns
    the shared :data:`NULL_SPAN` (nothing is recorded or kept)."""
    t = _TRACER
    if not t._active:
        return NULL_SPAN
    return _Span(t, name, attrs or None)


def instant(name: str, **attrs) -> None:
    """Record a point event (preemption, retirement, ...)."""
    t = _TRACER
    if t._active:
        t.instant(name, **attrs)


def record(name: str, t0: float, t1: float, **attrs) -> None:
    """Record an already-measured interval; ``t0``/``t1`` must be
    ``time.perf_counter()`` readings (the tracer's clock)."""
    t = _TRACER
    if t._active:
        t._record(name, t0, t1, attrs or None)


def enabled() -> bool:
    return _TRACER.enabled


def enable(out: Optional[str] = None, annotate: bool = False) -> None:
    _TRACER.enable(out, annotate)


def disable() -> None:
    _TRACER.disable()


def export(path: Optional[str] = None) -> Optional[str]:
    return _TRACER.export(path)


@atexit.register
def _export_atexit() -> None:
    t = _TRACER
    if t.enabled and t.out and t.events:
        try:
            t.export()
        except OSError:
            pass


_env = os.environ.get("REPRO_TRACE")
if _env:
    enable(_env, annotate=bool(os.environ.get("REPRO_TRACE_ANNOTATE")))
