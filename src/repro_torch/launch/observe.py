"""The observation plumbing that both launchers (``launch/serve.py``,
``launch/train.py``) share: the continuous monitor with its flight
recorder and replan advisor, the drift check of one recorded step, the
monitor's part of the run record, and rank 0's metrics and trace files.
"""
from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, List, Optional

from .. import obs


def make_monitor(args: argparse.Namespace, slos: List[obs.SLO], registry,
                 plan_rec: Optional[Dict[str, Any]],
                 solve_regime: Callable, **monitor_kw):
    """(monitor, flight recorder, replan advisor) for ``slos``, or (None,
    None, None) when no SLO and no fault injection is asked for.  The
    recorder writes into ``--flight-dir``; the advisor exists where the
    run has a plan record, and prices a regime as
    ``solve_regime(axes, regime)`` on the ``--mesh`` solver axes."""
    if not (slos or args.inject_spike_ms):
        return None, None, None
    recorder = obs.FlightRecorder(args.flight_dir, registry=registry)
    advisor = None
    if plan_rec is not None:
        from .mesh import solver_axes
        shape = tuple(int(s) for s in args.mesh.lower().split("x"))
        axes = solver_axes(shape, ("data", "model")[:len(shape)])
        advisor = obs.ReplanAdvisor(lambda regime: solve_regime(axes, regime),
                                    plan_rec, registry=registry)
    monitor = obs.Monitor(slos=slos, registry=registry, recorder=recorder,
                          advisor=advisor, **monitor_kw)
    return monitor, recorder, advisor


def check_drift(plan_rec: Dict[str, Any], stats, n_devices: int, registry,
                monitor) -> Optional[Dict[str, Any]]:
    """The drift record of one recorded step (``analysis/comm`` stats)
    against the plan record's as-executed prediction, set on ``registry``
    and handed to ``monitor``; None for a plan record that predates the
    breakdown (a stale cache), as repro reports it."""
    breakdown = plan_rec.get("breakdown")
    if breakdown is None:
        print("drift: plan record predates breakdown support (stale "
              "cache) - skipping")
        return None
    from ..obs import drift as obs_drift
    d = obs_drift.record_drift(registry, breakdown["total"], stats,
                               n_devices,
                               predicted_by_kind=breakdown.get("by_kind"))
    print(obs_drift.describe(d))
    if monitor is not None:
        monitor.check_drift(d["ratio"], band=tuple(d["band"]))
    return d


def finish_monitor(rec: Dict[str, Any], monitor, recorder, advisor) -> None:
    """Put the monitor's snapshot, its flight dumps and any advisory into
    ``rec["monitor"]``, print them, and detach the recorder's ring."""
    monitor.export_gauges()
    mon = rec["monitor"] = monitor.snapshot()
    mon["flight_dumps"] = recorder.dumps
    mon["advice"] = advisor.advice if advisor else []
    recorder.close()
    n_breach = sum(1 for e in mon["events"] if e["type"] == "slo_breach")
    print(f"monitor: {mon['n_events']} event(s) ({n_breach} SLO breach "
          f"obs), {len(recorder.dumps)} flight record(s)"
          + "".join(f"\n  flight -> {p}" for p in recorder.dumps))
    for a in mon["advice"]:
        if "error" in a:
            print(f"  replan advice [{a['trigger']}/{a['regime']}]: solve "
                  f"failed: {a['error']}")
            continue
        win = a.get("modeled_win")
        print(f"  replan advice [{a['trigger']}/{a['regime']}]: modeled "
              f"step {a['current_step_s']:.3g}s -> "
              f"{a['advised_step_s']:.3g}s (win "
              + ("n/a" if win is None else f"{win:+.1%}")
              + f", plan {'changed' if a['plan_changed'] else 'unchanged'})")


def write_sinks(args: argparse.Namespace, registry) -> None:
    """Rank 0's metrics file and trace, where asked for; the trace ends
    with the run (a caller may run again in the same process)."""
    if args.metrics_out:
        registry.dump_jsonl(args.metrics_out)
        print(f"metrics registry -> {args.metrics_out}")
    if args.trace_out:
        obs.export(args.trace_out)
        obs.disable()
        obs.tracing.get_tracer().clear()
        print(f"trace -> {args.trace_out}")
