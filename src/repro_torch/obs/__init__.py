"""Telemetry subsystem (the port's copy of ``repro.obs``): tracing,
metrics, drift, and the continuous monitor.

Stdlib-only, like repro's, so every layer and the launch CLIs can import
it unconditionally; ``import repro_torch.obs`` does not import torch.

- ``obs.tracing``  — span API (``with obs.span("serve.decode"): ...``)
  exporting Chrome/Perfetto trace-event JSON; ~free when disabled (one
  attribute check and a shared null context manager).
- ``obs.metrics``  — counters / gauges / fixed-bucket histograms with
  JSONL and Prometheus-text sinks.
- ``obs.drift``    — solver-predicted wire bytes vs the collectives one
  step issued (``analysis/comm.py``), as gauges.
- ``obs.slo``      — SLO objectives + multi-window burn-rate rules.
- ``obs.monitor``  — streaming percentile estimators, MAD-z anomaly
  scoring, the :class:`Monitor` facade and the :class:`ReplanAdvisor`.
- ``obs.flight``   — always-on bounded ring of recent trace events,
  dumped as ``flight-<trigger>.json`` when something goes wrong.
- ``obs.regress``  — the bench-regression sentinel.

``python -m repro_torch.obs`` validates / summarizes trace, metrics and
flight files, renders a per-slot serving timeline, and runs the
regression sentinel.
"""
from . import drift, flight, metrics, monitor, regress, slo, stats, tracing
from .flight import FlightRecorder
from .metrics import Registry, default_registry
from .monitor import Monitor, ReplanAdvisor
from .slo import SLO
from .tracing import disable, enable, export, instant, span

__all__ = [
    "tracing", "metrics", "stats", "drift",
    "slo", "monitor", "flight", "regress",
    "span", "instant", "enable", "disable", "export",
    "Registry", "default_registry",
    "SLO", "Monitor", "ReplanAdvisor", "FlightRecorder",
]
