"""Operator communication cost via aligned tilings (paper §4.2.1, Eq. 2).

For each op kind we enumerate the *aligned forms* — (input-tilings,
output-tiling) combinations that execute with zero communication and no
redundant compute — and price an arbitrary assignment as the cheapest
conversion into one of them:

  einsum  X ⋅ Y -> Z   (dim classes: batch / row / col / contract)
    F_row(d):   X:P(d)  Y:r     Z:P(d)       (paper's R×r=R)
    F_col(d):   X:r     Y:P(d)  Z:P(d)       (paper's r×C=C)
    F_con(d):   X:P(d)  Y:P(d)  Z:red        (paper's C×R=red)
    F_bat(d):   X:P(d)  Y:P(d)  Z:P(d)       (batched dims; zero comm)

  ewise  (broadcast-aware; optional ``align_dims`` whitelist)
    F(d): every tensor containing d is P(d); tensors lacking d are r.
    all-r allowed with penalty = output bytes, except ``update`` ops where
    it is free (the standard replicated-parameter update; see DESIGN.md).

  reduce over axis k:  X -> Z (dims(Z) = dims(X) - {k})
    F(d), d != k:  X:P(d)  Z:P(d)
    F(k):          X:P(k)  Z:red

  custom: explicit aligned-form set supplied by the builder (paper §4.5:
    the only operator-specific knowledge is its aligned tilings).  Used
    for MoE route/combine and attention-with-KV-cache.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from ..obs.metrics import default_registry as _default_registry
from .graph import Graph, OpSpec
from .tiling import (REDUCED, REPLICATE, Part, Tiling, conversion_cost,
                     conversion_kind, paper_naive_conversion_cost)

Assignment = Dict[str, Tiling]


def tensor_tiling_choices(g: Graph, name: str, arity: int = 2) -> List[Tiling]:
    """Candidate tilings for one tensor under one cut of ``arity``: P(d)
    for every dim evenly divisible by the arity, plus replication."""
    ts = g.tensors[name]
    out: List[Tiling] = [REPLICATE]
    seen = set()
    for d in ts.dims:
        if d not in seen and ts.can_cut(d, arity):
            out.append(Part(d))
            seen.add(d)
    return out


def _aligned_forms(g: Graph, op: OpSpec, arity: int):
    """Yield ({tensor: aligned tiling}, penalty_bytes) forms that are
    feasible at the given arity (even tiling requires divisibility)."""

    def ok(tname: str, d: str) -> bool:
        return g.tensors[tname].can_cut(d, arity)

    if op.kind == "einsum":
        lhs, rhs = op.inputs
        out = op.output
        batch, row, col, contract = g.einsum_dim_classes(op)
        for d in row:
            if ok(lhs, d) and ok(out, d):
                yield {lhs: Part(d), rhs: REPLICATE, out: Part(d)}, 0.0
        for d in col:
            if ok(rhs, d) and ok(out, d):
                yield {lhs: REPLICATE, rhs: Part(d), out: Part(d)}, 0.0
        for d in contract:
            if ok(lhs, d) and ok(rhs, d):
                yield {lhs: Part(d), rhs: Part(d), out: REDUCED}, 0.0
        for d in batch:
            if ok(lhs, d) and ok(rhs, d) and ok(out, d):
                yield {lhs: Part(d), rhs: Part(d), out: Part(d)}, 0.0
        # fully-replicated fallback — keeps degenerate ops (e.g. batch-1
        # decode at arity 16 with no divisible dim) solvable.  Penalty =
        # output bytes × arity: every device redoes the full compute, so
        # this must never beat a real aligned form on non-tiny ops.
        yield ({lhs: REPLICATE, rhs: REPLICATE, out: REPLICATE},
               g.tensors[out].nbytes * arity)
    elif op.kind == "ewise":
        out = op.output
        whitelist = op.attrs.get("align_dims")
        tensors = g.op_tensors(op)
        for d in g.tensors[out].dims:
            if whitelist is not None and d not in whitelist:
                continue
            if not ok(out, d):
                continue
            form = {}
            feasible = True
            for t in tensors:
                if d in g.tensors[t].dims:
                    if not ok(t, d):
                        feasible = False
                        break
                    form[t] = Part(d)
                else:
                    form[t] = REPLICATE
            if feasible:
                yield form, 0.0
        penalty = 0.0 if op.attrs.get("update") else g.tensors[out].nbytes
        yield {t: REPLICATE for t in tensors}, penalty
    elif op.kind == "reduce":
        (inp,), out = op.inputs, op.output
        k = op.attrs["axis"]
        ts = g.tensors[inp]
        for d in ts.dims:
            if not ok(inp, d):
                continue
            if d == k:
                yield {inp: Part(d), out: REDUCED}, 0.0
            elif d in g.tensors[out].dims:
                yield {inp: Part(d), out: Part(d)}, 0.0
        yield {inp: REPLICATE, out: REPLICATE}, g.tensors[out].nbytes
    elif op.kind == "custom":
        for form, penalty in op.attrs["forms"]:
            feasible = True
            for t, tl in form.items():
                if isinstance(tl, Part) and not ok(t, tl.dim):
                    feasible = False
                    break
            if feasible:
                yield form, penalty
        yield ({t: REPLICATE for t in g.op_tensors(op)},
               g.tensors[op.output].nbytes * arity)
    else:  # pragma: no cover
        raise ValueError(op.kind)


def op_cost_base(g: Graph, op: OpSpec, assign: Assignment, arity: int,
                 naive: bool = False) -> float:
    """Eq. (2): min over aligned forms of total conversion cost, *without*
    the op's repeat factor (so memoized tables can be shared between ops
    that differ only in repeat)."""
    conv = paper_naive_conversion_cost if naive else conversion_cost
    tensors = g.op_tensors(op)
    best = float("inf")
    for form, penalty in _aligned_forms(g, op, arity):
        c = penalty
        for t in tensors:
            want = form.get(t, REPLICATE)
            have = assign[t]
            nbytes = g.tensors[t].nbytes
            if t == op.output:
                # output conversion: aligned-form result -> requested tiling
                c += conv(want, have, nbytes, arity)
            else:
                c += conv(have, want, nbytes, arity)
            if c >= best:
                break
        if c < best:
            best = c
    return best


def op_cost(g: Graph, op: OpSpec, assign: Assignment, arity: int,
            naive: bool = False) -> float:
    """Eq. (2): min over aligned forms of total conversion cost, times the
    op's repeat factor."""
    return op_cost_base(g, op, assign, arity, naive) * op.repeat


def op_cost_detail(g: Graph, op: OpSpec, assign: Assignment,
                   arity: int) -> tuple:
    """Like :func:`op_cost` but also returns *where* the bytes go: the
    chosen aligned form's conversions as records
    ``{"tensor", "role", "kind", "bytes"}`` (kind = the HLO collective the
    conversion lowers to, or "recompute" for an aligned-form penalty).
    Bytes include the op's repeat factor; their sum equals op_cost exactly
    — this is the attribution side of the conformance subsystem (see
    repro.verify.calibration)."""
    tensors = g.op_tensors(op)
    best = float("inf")
    best_recs: List[dict] = []
    for form, penalty in _aligned_forms(g, op, arity):
        c = penalty
        recs: List[dict] = []
        if penalty:
            recs.append({"tensor": op.output,
                         "role": _attribution_role(g, op.output),
                         "kind": "recompute", "bytes": penalty})
        for t in tensors:
            want = form.get(t, REPLICATE)
            have = assign[t]
            nbytes = g.tensors[t].nbytes
            if t == op.output:
                src, dst = want, have
            else:
                src, dst = have, want
            step = conversion_cost(src, dst, nbytes, arity)
            c += step
            if c >= best:
                break
            if step:
                recs.append({"tensor": t,
                             "role": _attribution_role(g, t),
                             "kind": conversion_kind(src, dst) or "other",
                             "bytes": step})
        else:
            if c < best:
                best = c
                best_recs = recs
    for r in best_recs:
        r["bytes"] *= op.repeat
    return best * op.repeat, best_recs


def _attribution_role(g: Graph, tensor: str) -> str:
    """Role key for per-role byte attribution: the tensor's declared role,
    else a kind-level bucket (<grad>, <activation>, ...)."""
    ts = g.tensors[tensor]
    return ts.role or f"<{ts.kind}>"


def op_cost_table(g: Graph, op: OpSpec, arity: int,
                  choices: Dict[str, List[Tiling]],
                  naive: bool = False) -> Dict[tuple, float]:
    """Precomputed cost for every combination of the op's tensors' tilings
    (keys ordered as g.op_tensors(op))."""
    import itertools

    tensors = g.op_tensors(op)
    table: Dict[tuple, float] = {}
    for combo in itertools.product(*(choices[t] for t in tensors)):
        assign = dict(zip(tensors, combo))
        table[combo] = op_cost(g, op, assign, arity, naive)
    return table


# ---------------------------------------------------------------------------
# memoized cost tables (solver perf): ops from repeated layers are costed
# once per *signature*, not once per op instance — see DESIGN.md.
# ---------------------------------------------------------------------------

def _canon_tiling(t: Tiling, canon: Dict[str, str]) -> Tiling:
    if isinstance(t, Part):
        return Part(canon.get(t.dim, t.dim))
    return t


def op_signature(g: Graph, op: OpSpec, arity: int,
                 choices: Dict[str, List[Tiling]]) -> tuple:
    """Hashable key identifying everything the op's cost table depends on:
    op kind + role structure, per-tensor (dims, shape, bytes, units,
    uneven flag) and candidate-tiling lists, and the cut arity.  Dimension
    names are canonicalized in order of first appearance so isomorphic ops
    from different layers (``wqA`` vs ``wqB``, forward vs a later layer's
    forward) share one table."""
    tensors = g.op_tensors(op)
    index = {t: i for i, t in enumerate(tensors)}
    canon: Dict[str, str] = {}
    for t in tensors:
        for d in g.tensors[t].dims:
            if d not in canon:
                canon[d] = f"d{len(canon)}"

    def cd(d):
        # dims referenced by attrs but absent from every op tensor are
        # inert for costing; collapse them to one sentinel.
        return canon.get(d, "~absent")

    tsig = []
    for t in tensors:
        ts = g.tensors[t]
        tsig.append((
            tuple(cd(d) for d in ts.dims),
            ts.shape,
            ts.bytes_per_elem,
            tuple(sorted((cd(d), u) for d, u in ts.units.items())),
            ts.allow_uneven,
            tuple(_canon_tiling(c, canon) for c in choices[t]),
        ))

    if op.kind == "custom":
        # form entries for tensors outside the op are never *priced* by
        # op_cost, but _aligned_forms does feasibility-check them (can the
        # referenced dim be cut at this arity?) — encode exactly that bit.
        def entry(t, tl):
            if t in index:
                return (index[t], _canon_tiling(tl, canon))
            feasible = (not isinstance(tl, Part)
                        or g.tensors[t].can_cut(tl.dim, arity))
            return (-1, "ext-feasible" if feasible else "ext-infeasible")

        forms = tuple(
            (tuple(sorted((entry(t, tl) for t, tl in form.items()),
                          key=lambda kv: (kv[0], str(kv[1])))), pen)
            for form, pen in op.attrs["forms"])
        attrs_sig: tuple = ("custom", forms)
    elif op.kind == "ewise":
        wl = op.attrs.get("align_dims")
        attrs_sig = ("ewise",
                     None if wl is None else tuple(sorted(cd(d) for d in wl)),
                     bool(op.attrs.get("update")))
    elif op.kind == "reduce":
        attrs_sig = ("reduce", cd(op.attrs["axis"]))
    else:
        attrs_sig = (op.kind,)

    return (arity, attrs_sig,
            tuple(index[t] for t in op.inputs), index[op.output],
            tuple(tsig))


# solver memo-cache effectiveness, on the process-global registry (the
# launch CLIs dump it alongside their run metrics)
_MEMO_HITS = _default_registry().counter(
    "solver.cost_table_memo_hits",
    help="cached_cost_table signature-cache hits")
_MEMO_MISSES = _default_registry().counter(
    "solver.cost_table_memo_misses",
    help="cached_cost_table signature-cache misses (tables built)")


def cached_cost_table(g: Graph, op: OpSpec, arity: int,
                      choices: Dict[str, List[Tiling]],
                      cache: Dict[tuple, Dict[tuple, float]],
                      naive: bool = False) -> Dict[tuple, float]:
    """Base-cost table (no repeat factor) for every combination of the
    op's tensors' candidate tilings, keyed by per-tensor *choice indices*
    in g.op_tensors(op) order.  Memoized in ``cache`` across ops, layers
    and k-cut levels via :func:`op_signature`."""
    import itertools

    key = (op_signature(g, op, arity, choices), naive)
    tbl = cache.get(key)
    if tbl is not None:
        _MEMO_HITS.inc()
        return tbl
    _MEMO_MISSES.inc()
    tensors = g.op_tensors(op)
    lists = [choices[t] for t in tensors]
    tbl = {}
    for combo in itertools.product(*(range(len(l)) for l in lists)):
        assign = {t: lists[i][ci]
                  for i, (t, ci) in enumerate(zip(tensors, combo))}
        tbl[combo] = op_cost_base(g, op, assign, arity, naive)
    cache[key] = tbl
    return tbl


def graph_flops(g: Graph) -> float:
    """Analytic FLOPs of all einsum ops (2 × prod of all dim sizes ×
    repeat) — used by the simulated-runtime benchmarks."""
    total = 0.0
    for op in g.ops:
        if op.kind != "einsum":
            continue
        lhs, rhs = (g.tensors[i] for i in op.inputs)
        out = g.tensors[op.output]
        sizes = dict(zip(lhs.dims, lhs.shape))
        sizes.update(zip(rhs.dims, rhs.shape))
        sizes.update(zip(out.dims, out.shape))
        n = 2.0
        for s in sizes.values():
            n *= s
        total += n * op.repeat
    return total


HBM_PER_DEV = 80e9          # H100 SXM: 80 GB HBM3 (datasheet)
_PERSISTENT_ROLES = ("kv_cache", "ssm_state")


def memory_penalties(g: Graph, arity: int, scale: float = 1.0,
                     hbm: float = HBM_PER_DEV):
    """Soft-capacity (Lagrangian) term — a beyond-paper extension: the
    paper optimizes communication only, which happily *replicates* a
    480 GB KV cache or a 76B optimizer state.  Every persistent tensor
    (weights, optimizer moments, KV/SSM caches) accrues a one-time
    penalty λ_kind × per-device-bytes(assignment), with λ_kind =
    scale × (aggregate bytes of that kind / HBM): negligible when the
    kind fits comfortably, dominant when replication cannot fit.  This
    is how ZeRO-style optimizer sharding and cache partitioning emerge
    from the solver (see DESIGN.md)."""
    agg: Dict[str, float] = {}

    def kind_of(ts) -> str:
        if ts.kind in ("weight", "opt"):
            return ts.kind
        if ts.role in _PERSISTENT_ROLES:
            return "cache"
        return "transient"

    for ts in g.tensors.values():
        k = kind_of(ts)
        if k != "transient":
            agg[k] = agg.get(k, 0.0) + ts.nbytes
    lam = {k: scale * v / hbm for k, v in agg.items()}

    out: Dict[str, Dict[Tiling, float]] = {}
    for name, ts in g.tensors.items():
        k = kind_of(ts)
        if k == "transient":
            continue
        lam_k = lam[k]
        per: Dict[Tiling, float] = {}
        for t in tensor_tiling_choices(g, name, arity):
            per_dev = ts.nbytes / (arity if isinstance(t, Part) else 1)
            per[t] = lam_k * per_dev
        out[name] = per
    return out


def graph_cost(g: Graph, assign: Assignment, arity: int,
               naive: bool = False, mem_scale: float = 0.0,
               terms: Sequence = ()) -> float:
    """Total one-cut cost of a full assignment (Eq. 3) + cost terms.

    ``terms`` are costterms.CostTerm instances (duck-typed here to avoid
    a cycle); ``mem_scale`` remains sugar for the capacity term so every
    existing caller prices exactly what it did before."""
    total = sum(op_cost(g, op, assign, arity, naive) for op in g.ops)
    if mem_scale:
        pen = memory_penalties(g, arity, mem_scale)
        for t, per in pen.items():
            total += per.get(assign.get(t, REPLICATE), 0.0)
    for term in terms:
        for t, per in term.penalties(g, arity).items():
            total += per.get(assign.get(t, REPLICATE), 0.0)
    return total
