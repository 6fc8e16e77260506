"""Collective-byte accounting from the collectives a step issues (the
port's counterpart of ``repro.analysis.hlo``).

repro parses the collectives out of a compiled SPMD program's HLO text.
The port has no compiled program; :func:`record` runs one step under a
``torch.distributed.tensor.debug.CommDebugMode`` subclass that notes,
for every collective this rank dispatches, its kind, its per-device
result bytes ``s`` and its group size ``g``.  It prices the
collectives that the port's train and decode steps issue on gloo ranks:
the functional all-gather, reduce-scatter and all-reduce
of DTensor's redistributes, and c10d's all-reduce (``dist.all_reduce``
in AdamW's grad norm and the int8 compression), plus MoE's expert
all-to-all (``all_to_all_single_autograd``, and the functional
all-to-all of its backward).  Any other collective is kept as
``unpriced:<op>`` with 0 bytes, so a new one shows in ``counts`` and is
never priced silently.  On a CPU mesh DTensor runs its shard-to-shard
all-to-all as an all-gather and a local chunk (gloo has no all-to-all),
and the mode records that all-gather.  Point-to-point ``send`` /
``recv`` (the pipeline's stage hops) are left out: they are counted in
``runtime/pipeline_parallel.hop_bytes``.

repro's ring wire formulas, per device, are kept (``s`` the per-device
result bytes):

    all-reduce          2·s·(g-1)/g
    all-gather          s·(g-1)/g     (s = gathered result)
    reduce-scatter      s·(g-1)      (s = scattered result)
    all-to-all          s·(g-1)/g
    collective-permute  s

Each recorded collective also keeps where it came from
(:func:`call_site`): the innermost line of the port outside this module,
and, for a DTensor redistribute, its source and target placements.
``CollectiveStats.by_site`` sums the collectives by that site, so a
cell's report says which line issues which bytes.

Summing per-device wire bytes over the n devices of an SPMD step gives
the system-wide total that the solver's ``solution_breakdown`` predicts
(``obs/drift.record_drift`` multiplies this rank's by n).  torch is
imported only inside :func:`record`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    result_bytes: Dict[str, float]      # per-device result bytes by kind
    wire_by_kind: Dict[str, float]      # per-device ring wire bytes by kind
    wire_bytes_per_device: float        # total ring-model wire bytes
    naive_operand_bytes: float          # "sum result sizes" (spec formula)
    # per call site (``call_site``), largest first: {"site", "kind",
    # "count", "wire_bytes"} (per device); empty unless sites were kept
    by_site: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def total(self) -> float:
        return self.wire_bytes_per_device


def ring_wire_bytes(kind: str, s: float, g: int) -> float:
    """Per-device ring wire bytes for one collective (see module
    docstring).  ``s``: per-device result bytes; ``g``: group size."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * s * (g - 1) / g
    if kind == "all-gather":
        return s * (g - 1) / g       # s is the gathered result here
    if kind == "reduce-scatter":
        return s * (g - 1)
    if kind == "all-to-all":
        return s * (g - 1) / g
    if kind == "collective-permute":
        return s
    raise ValueError(kind)


def collect(ops: List[Tuple[str, float, int]],
            sites: Sequence[str] = ()) -> CollectiveStats:
    """Stats of recorded (kind, per-device result bytes, group size)
    triples, the fields of repro's ``hlo.collect``; ``sites`` (one a
    triple, from :func:`call_site`) adds ``by_site``."""
    counts: Dict[str, int] = {}
    res_bytes: Dict[str, float] = {}
    wire_by_kind: Dict[str, float] = {}
    naive = 0.0
    for kind, s, g in ops:
        counts[kind] = counts.get(kind, 0) + 1
        res_bytes[kind] = res_bytes.get(kind, 0.0) + s
        naive += s
        wire_by_kind[kind] = wire_by_kind.get(kind, 0.0) + \
            ring_wire_bytes(kind, s, g)
    table: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for (kind, s, g), site in zip(ops, sites):
        row = table.setdefault((site, kind), {"site": site, "kind": kind,
                                              "count": 0, "wire_bytes": 0.0})
        row["count"] += 1
        row["wire_bytes"] += ring_wire_bytes(kind, s, g) \
            if not kind.startswith("unpriced") else 0.0
    by_site = sorted(table.values(), key=lambda r: -r["wire_bytes"])
    return CollectiveStats(counts, res_bytes, wire_by_kind,
                           sum(wire_by_kind.values()), naive, by_site)


def call_site() -> str:
    """Where the collective being dispatched comes from: ``file:line
    function`` of the innermost frame of the port outside this module and
    of its caller in the port (paths from the package root), and, when a DTensor redistribute
    issues it, ``src -> dst`` placements (read from torch's
    ``redistribute_local_tensor`` frame)."""
    import sys
    f = sys._getframe(1)
    where, move = None, None
    while f is not None:
        code = f.f_code
        fn = code.co_filename.replace("\\", "/")
        if move is None and code.co_name == "redistribute_local_tensor":
            cur, dst = f.f_locals.get("current_spec"), \
                f.f_locals.get("target_spec")
            if cur is not None and dst is not None:
                move = "".join(map(str, cur.placements)) + " -> " + \
                    "".join(map(str, dst.placements))
        if "/repro_torch/" in fn and not fn.endswith("analysis/comm.py"):
            here = (f"{fn.split('/repro_torch/')[-1]}:{f.f_lineno} "
                    f"{code.co_name}")
            if where is not None:
                where = f"{where} < {here}"
                break
            where = here
        f = f.f_back
    where = where or "(outside the port)"
    return where if move is None else f"{where} [{move}]"


def _nbytes(t) -> float:
    return float(t.numel() * t.element_size())


def collective_note():
    """``note(ops, func, args, sites=None)``: appends the (kind, s, g) of
    a dispatched op to ``ops`` when it is a collective, priced by its rule
    (the table below, for the ops this torch has), or kept as
    ("unpriced:<op>", 0 bytes, 1), and its :func:`call_site` to
    ``sites`` when given; point-to-point ops are left out.  Shared by
    :func:`record`'s mode and ``analysis/cost_trace``'s."""
    import torch
    from torch.distributed import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group

    fn = torch.ops._c10d_functional
    fa = torch.ops._c10d_functional_autograd
    c10d = torch.ops.c10d

    def gsize(group) -> int:
        if isinstance(group, str):
            return _resolve_process_group(group).size()
        if isinstance(group, ProcessGroup):
            return group.size()
        return ProcessGroup.unbox(group).size()

    def tensors(x) -> List:
        if isinstance(x, (list, tuple)):
            return [t for y in x for t in tensors(y)]
        return [x] if isinstance(x, torch.Tensor) else []

    def a2a(a):
        s = _nbytes(a[0])
        if a[1]:                     # output split sizes: rows received
            s = s / a[0].shape[0] * sum(int(x) for x in a[1])
        return s, gsize(a[3])

    # (op namespace, op, kind, args -> (per-device result bytes, group
    # size)); an op this torch does not have is skipped
    table = [
        (fn, "all_reduce", "all-reduce", lambda a: (
            _nbytes(a[0]), gsize(a[2]))),
        (fn, "all_gather_into_tensor", "all-gather", lambda a: (
            _nbytes(a[0]) * a[1], a[1])),
        (fn, "reduce_scatter_tensor", "reduce-scatter", lambda a: (
            _nbytes(a[0]) / a[2], a[2])),
        (fn, "all_to_all_single", "all-to-all", a2a),
        (fa, "all_to_all_single", "all-to-all", a2a),
        (c10d, "allreduce_", "all-reduce", lambda a: (
            sum(_nbytes(t) for t in tensors(a[0])), gsize(a[1]))),
    ]
    rules: Dict[Any, Tuple[str, Callable]] = {}
    for ns, op, kind, size in table:
        if hasattr(ns, op):
            rules[getattr(ns, op)] = (kind, size)
    point_to_point = {"c10d.send", "c10d.recv_", "c10d.recv_any_source_",
                      "c10d.barrier"}
    # the functional collectives CommDebugMode counts, native and Python
    from torch.distributed.tensor.debug import CommDebugMode
    registry = set(getattr(CommDebugMode(), "comm_registry", ()))

    def note(ops: List, func, args, sites: Optional[List] = None) -> None:
        packet = func._overloadpacket
        rule = rules.get(packet)
        name = str(packet)
        if rule is not None:
            kind, size = rule
            s, g = size(args)
            ops.append((kind, float(s), int(g)))
        elif ((packet in registry or name.startswith("c10d."))
              and name not in point_to_point):
            ops.append((f"unpriced:{packet}", 0.0, 1))
        else:
            return
        if sites is not None:
            sites.append(call_site())

    return note


def _recorder_class():
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    note = collective_note()

    class Recorder(CommDebugMode):
        """CommDebugMode that also keeps (kind, s, g) per collective.
        A collective it has no formula for is kept as ("unpriced:<op>",
        0 bytes): it shows in ``counts``, never silently."""

        def __init__(self, sites: bool = False):
            super().__init__()
            self.ops: List[Tuple[str, float, int]] = []
            self.sites: Optional[List[str]] = [] if sites else None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not isinstance(func, torch._ops.HigherOrderOperator):
                note(self.ops, func, args, self.sites)
            return super().__torch_dispatch__(func, types, args, kwargs)

    return Recorder


def record(fn: Callable, *args, sites: bool = False,
           **kwargs) -> Tuple[Any, CollectiveStats]:
    """Run ``fn(*args, **kwargs)`` and return (its result, the stats of
    the collectives this rank dispatched while it ran, backward passes
    included); ``sites``: also their ``by_site`` table (a stack walk a
    collective)."""
    rec = _recorder_class()(sites)
    with rec:
        out = fn(*args, **kwargs)
    return out, collect(rec.ops, rec.sites or ())
