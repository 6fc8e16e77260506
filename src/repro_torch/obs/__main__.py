"""Trace/metrics/flight artifact tooling: validate, summarize,
timeline, regress (the port's copy of ``repro.obs.__main__``; it reads
the trace, metrics and flight files the port's launchers write, whose
schema is repro's).

Subcommand interface (file type is sniffed — ``.jsonl`` = metrics,
JSON with a top-level ``"flight"`` block = flight record, otherwise
Chrome trace):

    python -m repro_torch.obs validate run.trace.json run.metrics.jsonl
    python -m repro_torch.obs validate flight-*.json            # flight records
    python -m repro_torch.obs summarize run.trace.json
    python -m repro_torch.obs timeline serve.trace.json
    python -m repro_torch.obs regress --baseline BENCH_solver.json \\
        --candidate /tmp/BENCH_solver_smoke.json [--report-only]

The original flag interface is kept for compatibility:

    python -m repro_torch.obs --trace run.trace.json                 # summary
    python -m repro_torch.obs --trace run.trace.json --validate      # schema gate
    python -m repro_torch.obs --metrics run.metrics.jsonl --validate
    python -m repro_torch.obs --metrics ... --require-drift          # CI gate:
        drift.predicted_vs_measured_bytes present and finite
    python -m repro_torch.obs --trace serve.trace.json --timeline    # per-slot
        text timeline of a serving run (admit/prefill/decode/preempt)

Validation exits non-zero on the first structural problem, so CI can
gate on it directly.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Any, Dict, List

from . import stats
from .flight import validate_flight

VALID_PH = {"X", "i", "I", "B", "E", "M", "C"}


# ---------------------------------------------------------------- trace --
def load_trace(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):        # bare-array form is also legal Chrome
        doc = {"traceEvents": doc}
    return doc


def validate_trace(doc: Dict[str, Any]) -> List[str]:
    """Structural checks against the Chrome trace-event format; returns
    a list of problems (empty = valid)."""
    errs: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    if not evs:
        errs.append("traceEvents is empty")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            errs.append(f"event[{i}] is not an object")
            continue
        for k in ("name", "ph", "ts", "pid", "tid"):
            if k not in ev:
                errs.append(f"event[{i}] missing {k!r}")
        ph = ev.get("ph")
        if ph is not None and ph not in VALID_PH:
            errs.append(f"event[{i}] bad ph {ph!r}")
        ts = ev.get("ts")
        if ts is not None and not isinstance(ts, (int, float)):
            errs.append(f"event[{i}] ts not numeric")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"event[{i}] X event bad dur {dur!r}")
        if "args" in ev and not isinstance(ev["args"], dict):
            errs.append(f"event[{i}] args not an object")
        if len(errs) > 20:
            errs.append("... (truncated)")
            break
    return errs


def summarize_trace(doc: Dict[str, Any]) -> Dict[str, Any]:
    evs = doc.get("traceEvents", [])
    spans = [e for e in evs if e.get("ph") == "X"]
    instants = [e for e in evs if e.get("ph") in ("i", "I")]
    by_name: Dict[str, List[float]] = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e["dur"] / 1e6)
    t_lo = min((e["ts"] for e in evs), default=0.0)
    t_hi = max((e["ts"] + e.get("dur", 0.0) for e in evs), default=0.0)
    names = {}
    for name in sorted(by_name):
        ds = by_name[name]
        names[name] = {"count": len(ds), "total_s": sum(ds),
                       "mean_s": stats.mean(ds),
                       "p50_s": stats.percentile(ds, 50.0),
                       "max_s": max(ds)}
    return {"events": len(evs), "spans": len(spans),
            "instants": len(instants),
            "wall_s": (t_hi - t_lo) / 1e6,
            "threads": len({(e.get("pid"), e.get("tid")) for e in evs}),
            "by_name": names}


def print_trace_summary(s: Dict[str, Any]) -> None:
    print(f"events: {s['events']} ({s['spans']} spans, "
          f"{s['instants']} instants) over {s['wall_s']:.3f}s "
          f"on {s['threads']} thread(s)")
    if not s["by_name"]:
        return
    w = max(len(n) for n in s["by_name"])
    print(f"{'span':<{w}}  {'count':>6}  {'total_s':>9}  "
          f"{'mean_s':>9}  {'max_s':>9}")
    for name, r in sorted(s["by_name"].items(),
                          key=lambda kv: -kv[1]["total_s"]):
        print(f"{name:<{w}}  {r['count']:>6}  {r['total_s']:>9.4f}  "
              f"{r['mean_s']:>9.5f}  {r['max_s']:>9.5f}")


# ------------------------------------------------------------- metrics --
def load_metrics(path: str) -> List[Dict[str, Any]]:
    recs = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: bad JSON ({e})")
    return recs


def validate_metrics(recs: List[Dict[str, Any]]) -> List[str]:
    errs: List[str] = []
    if not recs:
        errs.append("metrics file is empty")
    seen = set()
    for i, r in enumerate(recs):
        name, typ = r.get("name"), r.get("type")
        if not name or typ not in ("counter", "gauge", "histogram"):
            errs.append(f"rec[{i}] bad name/type: {name!r}/{typ!r}")
            continue
        if name in seen:
            errs.append(f"rec[{i}] duplicate metric {name!r}")
        seen.add(name)
        if typ == "histogram":
            bks = r.get("buckets")
            if not isinstance(bks, list) or not bks:
                errs.append(f"{name}: missing buckets")
                continue
            if bks[-1].get("le") != "inf":
                errs.append(f"{name}: last bucket must be le=inf")
            les = [b["le"] for b in bks[:-1]]
            if les != sorted(les):
                errs.append(f"{name}: bucket bounds not increasing")
            if sum(b["count"] for b in bks) != r.get("count"):
                errs.append(f"{name}: bucket counts do not sum to count")
        elif "value" not in r:
            errs.append(f"{name}: missing value")
    return errs


def check_drift(recs: List[Dict[str, Any]]) -> List[str]:
    g = next((r for r in recs
              if r.get("name") == "drift.predicted_vs_measured_bytes"), None)
    if g is None:
        return ["drift gauge drift.predicted_vs_measured_bytes missing"]
    v = g.get("value")
    if not isinstance(v, (int, float)) or not math.isfinite(v):
        return [f"drift gauge not finite: {v!r}"]
    return []


# ------------------------------------------------------------ timeline --
def render_timeline(doc: Dict[str, Any], width: int = 100) -> str:
    """Per-slot text timeline of a serving trace.  Decode spans carry a
    ``slots`` attr (active slot ids that tick); prefill spans a ``slot``
    attr; admit/preempt/resume/retire are instants with a ``slot``.
    Legend: A admit, P prefill, D decode, ~ preempted wait, x preempt,
    r resume, . idle."""
    evs = doc.get("traceEvents", [])
    serve = [e for e in evs if str(e.get("name", "")).startswith("serve.")]
    if not serve:
        return "(no serve.* events in trace)"
    t0 = min(e["ts"] for e in serve)
    t1 = max(e["ts"] + e.get("dur", 0.0) for e in serve)
    span_us = max(t1 - t0, 1.0)

    def col(ts: float) -> int:
        return min(width - 1, int((ts - t0) / span_us * width))

    slots = set()
    for e in serve:
        a = e.get("args") or {}
        if "slot" in a:
            slots.add(int(a["slot"]))
        for s in a.get("slots", []):
            slots.add(int(s))
    if not slots:
        return "(no slot-attributed serve events in trace)"

    lanes = {s: ["."] * width for s in sorted(slots)}

    def paint(slot: int, c0: int, c1: int, ch: str) -> None:
        lane = lanes[slot]
        for c in range(c0, max(c0, c1) + 1):
            if lane[c] == ".":
                lane[c] = ch

    for e in serve:
        a = e.get("args") or {}
        name = e["name"]
        if e.get("ph") == "X":
            c0, c1 = col(e["ts"]), col(e["ts"] + e.get("dur", 0.0))
            if name.startswith("serve.prefill") and "slot" in a:
                paint(int(a["slot"]), c0, c1, "P")
            elif name.startswith("serve.decode"):
                for s in a.get("slots", []):
                    paint(int(s), c0, c1, "D")
            elif name.startswith(("serve.draft", "serve.verify")):
                for s in a.get("slots", []):
                    paint(int(s), c0, c1, "D")
        else:   # instants override painted cells
            if "slot" not in a:
                continue
            s, c = int(a["slot"]), col(e["ts"])
            if "admit" in name:
                lanes[s][c] = "A"
            elif "preempt" in name:
                lanes[s][c] = "x"
            elif "resume" in name:
                lanes[s][c] = "r"
            elif "retire" in name:
                lanes[s][c] = "|"

    lines = [f"serve timeline — {span_us / 1e6:.3f}s across {width} cols "
             f"(A admit, P prefill, D decode, x preempt, r resume, "
             f"| retire, . idle)"]
    for s, lane in lanes.items():
        lines.append(f"slot {s:>3} {''.join(lane)}")
    return "\n".join(lines)


# ------------------------------------------------------- subcommands --
def _validate_file(path: str, require_drift: bool = False) -> List[str]:
    """Sniff the artifact type and schema-check it; returns problems
    prefixed with the path."""
    if path.endswith(".jsonl"):
        recs = load_metrics(path)
        probs = [f"metrics: {e}" for e in validate_metrics(recs)]
        if require_drift:
            probs += [f"metrics: {e}" for e in check_drift(recs)]
    else:
        doc = load_trace(path)
        if "flight" in doc:
            probs = [f"flight: {e}" for e in validate_trace(doc)]
            probs += [f"flight: {e}" for e in validate_flight(doc)]
        else:
            probs = [f"trace: {e}" for e in validate_trace(doc)]
    return [f"{path}: {p}" for p in probs]


def _cmd_validate(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs validate",
        description="Schema-validate trace / metrics / flight-record "
                    "artifacts (type sniffed per file).")
    ap.add_argument("files", nargs="+")
    ap.add_argument("--require-drift", action="store_true",
                    help="fail unless metrics files contain a finite "
                         "drift.predicted_vs_measured_bytes gauge")
    args = ap.parse_args(argv)
    problems: List[str] = []
    for path in args.files:
        problems += _validate_file(path, args.require_drift)
    for p in problems:
        print(f"INVALID: {p}", file=sys.stderr)
    if problems:
        return 1
    print(f"OK: {len(args.files)} artifact(s) valid")
    return 0


def _cmd_summarize(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs summarize")
    ap.add_argument("files", nargs="+")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    for path in args.files:
        doc = load_trace(path)
        s = summarize_trace(doc)
        if args.json:
            print(json.dumps({path: s}, indent=2))
            continue
        print(f"== {path}")
        fl = doc.get("flight")
        if fl:
            print(f"flight record: trigger={fl.get('trigger')!r} "
                  f"seq={fl.get('seq')} "
                  f"monitor_events={len(fl.get('monitor_events', []))} "
                  f"metrics={len(fl.get('metrics', []))}")
        print_trace_summary(s)
    return 0


def _cmd_timeline(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs timeline")
    ap.add_argument("file")
    ap.add_argument("--width", type=int, default=100)
    args = ap.parse_args(argv)
    print(render_timeline(load_trace(args.file), args.width))
    return 0


# ----------------------------------------------------------------- cli --
def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and not argv[0].startswith("-"):
        cmd, rest = argv[0], list(argv[1:])
        if cmd == "validate":
            return _cmd_validate(rest)
        if cmd == "summarize":
            return _cmd_summarize(rest)
        if cmd == "timeline":
            return _cmd_timeline(rest)
        if cmd == "regress":
            from . import regress as _regress
            return _regress.main(rest)
        print(f"unknown subcommand {cmd!r} (expected validate | "
              f"summarize | timeline | regress)", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--trace", help="Chrome trace-event JSON file")
    ap.add_argument("--metrics", help="metrics JSONL file")
    ap.add_argument("--validate", action="store_true",
                    help="schema-validate the artifacts; exit non-zero "
                         "on problems")
    ap.add_argument("--require-drift", action="store_true",
                    help="fail unless the metrics contain a finite "
                         "drift.predicted_vs_measured_bytes gauge")
    ap.add_argument("--timeline", action="store_true",
                    help="render a per-slot serving timeline from the "
                         "trace")
    ap.add_argument("--width", type=int, default=100,
                    help="timeline width in columns")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON")
    args = ap.parse_args(argv)

    if not args.trace and not args.metrics:
        ap.error("nothing to do: pass --trace and/or --metrics")

    problems: List[str] = []
    out: Dict[str, Any] = {}

    if args.trace:
        doc = load_trace(args.trace)
        if args.validate:
            problems += [f"trace: {e}" for e in validate_trace(doc)]
        out["trace"] = summarize_trace(doc)
        if args.timeline:
            print(render_timeline(doc, args.width))
        elif not args.json:
            print_trace_summary(out["trace"])

    if args.metrics:
        recs = load_metrics(args.metrics)
        if args.validate:
            problems += [f"metrics: {e}" for e in validate_metrics(recs)]
        if args.require_drift:
            problems += [f"metrics: {e}" for e in check_drift(recs)]
        out["metrics"] = {"count": len(recs),
                          "names": sorted(r.get("name", "?") for r in recs)}
        if not args.json and not args.timeline:
            print(f"metrics: {len(recs)} instruments in {args.metrics}")

    if args.json:
        print(json.dumps(out, indent=2))

    for p in problems:
        print(f"INVALID: {p}", file=sys.stderr)
    if problems:
        return 1
    if args.validate:
        print("OK: artifacts valid" + (
            " (drift gauge finite)" if args.require_drift else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
