"""Bench regression sentinel: ``python -m repro_torch.obs regress`` (the
port's copy of ``repro.obs.regress``).

Diffs a committed ``BENCH_*.json`` baseline against a freshly produced
candidate and fails on out-of-band deltas, so CI gets a perf-regression
gate alongside its correctness gates.

Matching is by *identity keys* — the whitelisted fields that name a
bench cell (arch/mesh/shape/slots/...) — never by position, so a smoke
run that produces a subset of the committed cells still compares the
cells it has; unmatched cells on either side are reported but do not
fail.  Metrics are classified by name into higher-is-better (throughput,
speedup) and lower-is-better (latencies, compile/solve seconds, modeled
cost/bytes); counts and other direction-less fields are ignored.  A
matched metric regresses when the candidate is worse than baseline by
more than ``--tol`` relative (default 0.5 — generous, because CI runners
are noisy and the smoke cells are tiny); improvements never fail.

``--report-only`` prints the full report and exits 0 regardless, which
is how CI runs it until enough runner-variance data exists to tighten
the band.  Stdlib-only.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

# fields that NAME a cell (stringified into the match key); everything
# else numeric is a candidate metric
IDENTITY_KEYS = ("arch", "mode", "shape", "mesh", "slots", "batch",
                 "seq", "name", "kind", "stages", "n_micro", "task",
                 "cell")

# name-pattern direction classification; higher-better checked first so
# "tokens_per_s" does not fall into the lower-better "_s" bucket
_HIGHER = ("per_s", "speedup", "tput", "throughput", "hit_rate")
_LOWER = ("_s", "_ms", "seconds", "itl", "ttft", "latency", "compile",
          "solve", "cost", "bytes", "bubble")


def direction(key: str) -> Optional[str]:
    k = key.lower()
    if any(p in k for p in _HIGHER):
        return "higher"
    if any(p in k for p in _LOWER):
        return "lower"
    return None


def flatten(obj: Any, prefix: str = "") -> Dict[str, float]:
    """Numeric leaves of a nested dict, dotted-key flattened; bools and
    identity keys are skipped."""
    out: Dict[str, float] = {}
    if not isinstance(obj, dict):
        return out
    for k, v in obj.items():
        if not prefix and k in IDENTITY_KEYS:
            continue
        key = f"{prefix}{k}"
        if isinstance(v, bool):
            continue
        if isinstance(v, (int, float)):
            out[key] = float(v)
        elif isinstance(v, dict):
            out.update(flatten(v, prefix=f"{key}."))
    return out


def identity(cell: Dict[str, Any]) -> str:
    parts = []
    for k in IDENTITY_KEYS:
        if k in cell:
            v = cell[k]
            parts.append(f"{k}={json.dumps(v, sort_keys=True)}"
                         if isinstance(v, (dict, list)) else f"{k}={v}")
    return " ".join(parts) or "(anonymous)"


def extract_cells(doc: Dict[str, Any]) -> List[Tuple[str, Dict[str, Any]]]:
    """(identity, cell) pairs from one BENCH document: every element of
    the ``cells`` list, plus each non-meta top-level dict section
    (``summary``, ``prefill``, ``pipeline``, ...) as a singleton cell
    named after the section."""
    out: List[Tuple[str, Dict[str, Any]]] = []
    for cell in doc.get("cells", []) or []:
        if isinstance(cell, dict):
            out.append((identity(cell), cell))
    for k, v in doc.items():
        if k in ("cells", "meta") or not isinstance(v, dict):
            continue
        out.append((f"section={k}", v))
    return out


def diff(baseline: Dict[str, Any], candidate: Dict[str, Any],
         tol: float = 0.5) -> Dict[str, Any]:
    """Compare two parsed BENCH documents; see module docstring for the
    matching and banding rules."""
    base = dict(extract_cells(baseline))
    cand = dict(extract_cells(candidate))
    regressions: List[Dict[str, Any]] = []
    improvements: List[Dict[str, Any]] = []
    compared = 0
    for key in base:
        if key not in cand:
            continue
        b, c = flatten(base[key]), flatten(cand[key])
        for metric in sorted(set(b) & set(c)):
            d = direction(metric)
            if d is None:
                continue
            bv, cv = b[metric], c[metric]
            compared += 1
            if bv == cv:
                continue
            if bv == 0:
                continue                    # no relative scale to band on
            rel = (cv - bv) / abs(bv)       # + = candidate larger
            worse = rel if d == "lower" else -rel
            rec = {"cell": key, "metric": metric, "direction": d,
                   "baseline": bv, "candidate": cv,
                   "rel_change": rel}
            if worse > tol:
                regressions.append(rec)
            elif worse < -tol:
                improvements.append(rec)
    return {
        "tol": tol,
        "cells_matched": len(set(base) & set(cand)),
        "cells_baseline_only": sorted(set(base) - set(cand)),
        "cells_candidate_only": sorted(set(cand) - set(base)),
        "metrics_compared": compared,
        "regressions": regressions,
        "improvements": improvements,
        "pass": not regressions,
    }


def print_report(rep: Dict[str, Any], baseline: str, candidate: str) -> None:
    print(f"regress: {candidate} vs baseline {baseline}")
    print(f"  matched {rep['cells_matched']} cell(s), compared "
          f"{rep['metrics_compared']} metric(s), tol ±{rep['tol']:.0%}")
    for k in ("cells_baseline_only", "cells_candidate_only"):
        if rep[k]:
            print(f"  {k.replace('_', ' ')}: {len(rep[k])} "
                  f"(not compared)")
    for r in rep["regressions"]:
        print(f"  REGRESSION {r['cell']} :: {r['metric']} "
              f"({r['direction']} better): {r['baseline']:.6g} -> "
              f"{r['candidate']:.6g} ({r['rel_change']:+.1%})")
    for r in rep["improvements"]:
        print(f"  improved   {r['cell']} :: {r['metric']}: "
              f"{r['baseline']:.6g} -> {r['candidate']:.6g} "
              f"({r['rel_change']:+.1%})")
    print("  PASS" if rep["pass"] else "  FAIL")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs regress", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--baseline", required=True,
                    help="committed BENCH_*.json to diff against")
    ap.add_argument("--candidate", required=True,
                    help="freshly produced BENCH json")
    ap.add_argument("--tol", type=float, default=0.5,
                    help="relative worsening that fails (default 0.5)")
    ap.add_argument("--report-only", action="store_true",
                    help="print the report but always exit 0")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON")
    args = ap.parse_args(argv)
    with open(args.baseline) as f:
        base = json.load(f)
    with open(args.candidate) as f:
        cand = json.load(f)
    rep = diff(base, cand, tol=args.tol)
    if args.json:
        print(json.dumps(rep, indent=2))
    else:
        print_report(rep, args.baseline, args.candidate)
    if args.report_only:
        return 0
    return 0 if rep["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
