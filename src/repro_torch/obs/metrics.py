"""Metrics registry: counters, gauges, fixed-bucket histograms.

A :class:`Registry` is a named collection of metric instruments with two
sinks: JSONL (one JSON object per metric per line, the format of repro's
``--metrics-out`` files) and Prometheus text exposition format.  (The
port's copy of ``repro.obs.metrics``, unchanged but for this line.)

Instruments are get-or-create by name, so independent layers can update
the same counter without threading handles around; hot-path updates are
a single locked add (host-side scheduler rates, not per-token device
work).  Components that should record *nothing* unless a harness opted
in take an ``Optional[Registry]`` and fall back to :data:`NULL`, a
registry whose instruments are shared no-ops.
"""
from __future__ import annotations

import json
import math
import os
import re
import threading
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

# default latency buckets (seconds): ~100 µs .. 10 s, quarter-decade
# steps — wide enough for host-CPU serving ITLs and train step times
DEFAULT_TIME_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Counter:
    __slots__ = ("name", "help", "labels", "_value", "_lock")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative inc {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def to_dict(self) -> Dict[str, Any]:
        d = {"type": "counter", "name": self.name, "value": self._value}
        if self.labels:
            d["labels"] = dict(self.labels)
        return d


class Gauge:
    __slots__ = ("name", "help", "labels", "_value", "_lock")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = labels
        self._value = float("nan")
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def to_dict(self) -> Dict[str, Any]:
        d = {"type": "gauge", "name": self.name, "value": self._value}
        if self.labels:
            d["labels"] = dict(self.labels)
        return d


class Histogram:
    """Fixed-bucket histogram.  ``buckets`` are inclusive upper bounds
    (``v <= le`` lands in the bucket, Prometheus semantics); an implicit
    +inf bucket catches the rest.  Tracks sum/count/min/max alongside,
    and can estimate percentiles from the bucket counts (linear within
    the winning bucket) — a bounded-memory stand-in for the exact
    sample percentiles in ``obs.stats``."""

    __slots__ = ("name", "help", "labels", "les", "counts", "_sum",
                 "_count", "_min", "_max", "_lock")

    def __init__(self, name: str, buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                 help: str = "", labels: Optional[Dict[str, str]] = None):
        les = [float(b) for b in buckets]
        if not les or sorted(les) != les or len(set(les)) != len(les):
            raise ValueError(
                f"histogram {name}: buckets must be strictly "
                f"increasing, got {buckets}")
        self.name = name
        self.help = help
        self.labels = labels
        self.les = les
        self.counts = [0] * (len(les) + 1)      # + overflow (inf)
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def _bucket_index(self, v: float) -> int:
        # first bucket whose upper bound admits v (bisect on small
        # fixed lists; linear scan is fine and allocation-free)
        for i, le in enumerate(self.les):
            if v <= le:
                return i
        return len(self.les)

    def observe(self, v: float) -> None:
        v = float(v)
        i = self._bucket_index(v)
        with self._lock:
            self.counts[i] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def observe_many(self, vs: Sequence[float]) -> None:
        for v in vs:
            self.observe(v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> Optional[float]:
        """Bucket-estimated q-th percentile, q in [0, 100] — the same
        convention as ``obs.stats.percentile`` (unified repo-wide; this
        method took q in [0, 1] before PR 10).  A q in the open
        interval (0, 1) is almost certainly a caller on the old
        fraction convention: it is interpreted as a fraction with a
        DeprecationWarning.  None when empty.  Clamped to [min, max] so
        single-sample and narrow-distribution estimates stay sane."""
        if 0.0 < q < 1.0:
            warnings.warn(
                f"Histogram.percentile({q}): q in [0, 1] fractions are "
                f"deprecated; pass q in [0, 100] like "
                f"obs.stats.percentile (interpreting as {q * 100:g})",
                DeprecationWarning, stacklevel=2)
            q = q * 100.0
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        if self._count == 0:
            return None
        rank = q / 100.0 * self._count
        seen = 0
        lo = 0.0 if not self.les or self.les[0] > 0 else None
        prev = self._min
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            hi = self.les[i] if i < len(self.les) else self._max
            lo_b = prev if seen else self._min
            if seen + c >= rank:
                frac = 0.5 if c == 0 else max(0.0, min(
                    1.0, (rank - seen) / c))
                est = lo_b + (hi - lo_b) * frac
                return max(self._min, min(self._max, est))
            seen += c
            prev = hi
        _ = lo
        return self._max

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "type": "histogram", "name": self.name,
            "count": self._count, "sum": self._sum,
            "min": None if self._count == 0 else self._min,
            "max": None if self._count == 0 else self._max,
            "buckets": [{"le": le, "count": c}
                        for le, c in zip(self.les, self.counts)]
                       + [{"le": "inf", "count": self.counts[-1]}],
        }
        if self.labels:
            d["labels"] = dict(self.labels)
        return d


# ------------------------------------------------- prometheus helpers --
_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)$")


def prom_name(name: str) -> str:
    """Registry name -> valid Prometheus series name (dots and other
    out-of-charset characters become underscores)."""
    n = _PROM_BAD.sub("_", name)
    return ("_" + n) if n and n[0].isdigit() else n


def escape_label_value(v: str) -> str:
    """Escape per the exposition-format spec: backslash, double quote,
    line feed."""
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(str(v))}"'
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _parse_label_body(s: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    i, n = 0, len(s)
    while i < n:
        eq = s.index("=", i)
        key = s[i:eq].strip()
        if eq + 1 >= n or s[eq + 1] != '"':
            raise ValueError(f"label {key!r}: value not quoted in {s!r}")
        i = eq + 2
        buf: List[str] = []
        while i < n and s[i] != '"':
            c = s[i]
            if c == "\\" and i + 1 < n:
                buf.append({"n": "\n", "\\": "\\", '"': '"'}.get(
                    s[i + 1], s[i + 1]))
                i += 2
            else:
                buf.append(c)
                i += 1
        if i >= n:
            raise ValueError(f"unterminated label value in {s!r}")
        labels[key] = "".join(buf)
        i += 1                                  # closing quote
        if i < n and s[i] == ",":
            i += 1
    return labels


def parse_prometheus_text(text: str) -> Dict[str, Any]:
    """Parse the exposition format back into ``{"types": {series:
    type}, "samples": [(series, labels, value)]}`` — the round-trip
    check for :meth:`Registry.prometheus_text` (handles escaped label
    values)."""
    types: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) == 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {ln}: unparsable sample {line!r}")
        name, _, body, value = m.groups()
        labels = _parse_label_body(body) if body else {}
        samples.append((name, labels, float(value)))
    return {"types": types, "samples": samples}


class Registry:
    """Named collection of instruments with JSONL / Prometheus sinks."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls, *args, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(name, Counter, help, labels=labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(name, Gauge, help, labels=labels)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                  help: str = "",
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._get(name, Histogram, buckets, help, labels=labels)

    def get(self, name: str):
        return self._metrics.get(name)

    def collect(self) -> List[Dict[str, Any]]:
        with self._lock:
            ms = list(self._metrics.values())
        return [m.to_dict() for m in ms]

    # -- sinks ------------------------------------------------------------
    def dump_jsonl(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            for rec in self.collect():
                f.write(json.dumps(rec) + "\n")
        return path

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (histogram buckets are
        cumulative there, per the spec; the JSONL sink keeps per-bucket
        counts).  Metric names are sanitized to the Prometheus charset
        (dotted registry names become underscored series), label values
        are escaped, and the ``_sum``/``_count`` histogram series get
        their own ``# TYPE`` lines so naive scrapers do not treat them
        as untyped."""
        lines: List[str] = []
        for rec in self.collect():
            name, typ = prom_name(rec["name"]), rec["type"]
            labels = rec.get("labels") or {}
            lines.append(f"# TYPE {name} {typ}")
            if typ in ("counter", "gauge"):
                lines.append(f"{name}{fmt_labels(labels)} {rec['value']}")
                continue
            cum = 0
            for b in rec["buckets"]:
                cum += b["count"]
                le = b["le"] if b["le"] != "inf" else "+Inf"
                bl = dict(labels, le=str(le))
                lines.append(f"{name}_bucket{fmt_labels(bl)} {cum}")
            lines.append(f"# TYPE {name}_sum counter")
            lines.append(f"{name}_sum{fmt_labels(labels)} {rec['sum']}")
            lines.append(f"# TYPE {name}_count counter")
            lines.append(f"{name}_count{fmt_labels(labels)} {rec['count']}")
        return "\n".join(lines) + "\n"


class _NullMetric:
    """Shared no-op instrument (inc/set/observe all discard)."""
    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def observe_many(self, vs) -> None:
        pass


class _NullRegistry(Registry):
    """A registry whose instruments are shared no-ops — hand this to a
    component whose metrics nobody will read."""

    def __init__(self):
        super().__init__()
        self._null = _NullMetric()

    def counter(self, name, help="",
                labels=None):                   # type: ignore[override]
        return self._null

    def gauge(self, name, help="",
              labels=None):                     # type: ignore[override]
        return self._null

    def histogram(self, name, buckets=DEFAULT_TIME_BUCKETS,
                  help="", labels=None):        # type: ignore[override]
        return self._null


NULL = _NullRegistry()

_REGISTRY = Registry()


def default_registry() -> Registry:
    """The process-global registry (solver memo-cache hit counters and
    other library-level instruments land here)."""
    return _REGISTRY
