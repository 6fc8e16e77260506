"""Optimal tiling search (paper §4.2.2 one-cut DP, §4.3 k-cut recursion).

One-cut: BFS-level the undirected op graph (ops adjacent iff they share a
tensor — this automatically interleaves forward op l with its backward and
gradient ops: the paper's "operators that share inputs or outputs are
considered together").  We then run exact dynamic programming along the
BFS op order with *variable elimination*: the DP state assigns tilings to
the currently *live* tensors (those still used by a later op) — this is
Eq. (5) with the boundary τ_l generalized per-op, and returns the same
optimum as level-DP while scaling to ops with many tensors.

Mesh k-cut: the paper recursively halves the device set; a PartitionSpec
can give each mesh axis at most one tensor dim, so we solve one cut *per
mesh axis* (arity = axis size), slowest interconnect first (§5.1), dividing
tensor shapes between cuts (Algorithm 1).  Total bytes use the physically
accurate weighting δ_i × groups_above(i): for a run of identical binary
cuts this reproduces the arity-2^m ring-collective cost exactly (see
DESIGN.md on Theorem 1 accounting).

`solve_one_cut_bruteforce` enumerates every assignment — the optimality
oracle for tests.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..obs.tracing import span as _span
from .cost import (Assignment, cached_cost_table, graph_cost,
                   memory_penalties, op_cost, op_cost_table,
                   tensor_tiling_choices)
from .graph import Graph, OpSpec
from .tiling import REPLICATE, Tiling

# ``beam="auto"``: start here and widen ×4 until the DP completes without
# hitting the cap (exact) or the cost stops improving meaningfully
# (> _AUTO_MIN_IMPROVE relative).  Each round's best cost becomes the
# dominance bound for the next round, so the wider confirmation runs
# prune most of their states.  The second rung (8192) matches the
# pre-overhaul production beam, so plan quality is not sacrificed on
# graphs where the first rung truncates.
AUTO_BEAM_START = 2_048
AUTO_BEAM_MAX = 32_768
_AUTO_MIN_IMPROVE = 1e-3
_INCUMBENT_BEAM = 64
BeamSpec = Union[int, str, None]


@dataclasses.dataclass
class OneCutSolution:
    cost: float
    assignment: Assignment
    exact: bool = True        # no beam truncation occurred anywhere


def solve_one_cut(g: Graph, arity: int,
                  fixed: Optional[Assignment] = None,
                  beam: BeamSpec = "auto",
                  mem_scale: float = 1.0,
                  optimize: bool = True,
                  cost_cache: Optional[dict] = None,
                  terms: Sequence = ()) -> OneCutSolution:
    """Optimal (or beam-pruned) one-cut tiling of graph ``g`` across
    ``arity`` device groups.  Exact variable-elimination DP over the
    layer-group op order; tilings are interned to small ints for speed.
    ``fixed`` pins tilings of given tensors.

    ``beam``: int = fixed cap on DP states per step, None = unlimited,
    "auto" = adaptive widening (exactness detected when no step ever hits
    the cap).  ``optimize=False`` runs the unmemoized, unpruned seed
    implementation — kept callable as the baseline for
    benchmarks/solver_bench.py.  ``cost_cache`` shares memoized per-op
    cost tables across calls (e.g. across the k-cut recursion).

    ``terms``: extra costterms.CostTerm penalties charged next to the op
    tables (``mem_scale`` stays sugar for the capacity term).  Penalties
    must be >= 0 — dominance pruning relies on it.  They live outside the
    memoized cost tables, so a shared ``cost_cache`` stays valid across
    calls with different terms."""
    if arity <= 1:
        return OneCutSolution(0.0, {t: REPLICATE for t in g.tensors})
    if not optimize:
        b = 50_000 if isinstance(beam, str) else beam
        return _solve_one_cut_seed(g, arity, fixed, b, mem_scale, terms)
    return _solve_one_cut_fast(g, arity, fixed, beam, mem_scale, cost_cache,
                               terms)


def _term_penalties(g: Graph, arity: int, mem_scale: float,
                    terms: Sequence) -> Dict[str, Dict[Tiling, float]]:
    """The DP's merged per-tensor penalty table: capacity (mem_scale
    sugar) plus any explicit cost terms."""
    pen = memory_penalties(g, arity, mem_scale) if mem_scale else {}
    if terms:
        from .costterms import combined_penalties
        extra = combined_penalties(g, arity, terms)
        if extra:
            pen = {t: dict(per) for t, per in pen.items()}
            for t, per in extra.items():
                dst = pen.setdefault(t, {})
                for c, v in per.items():
                    dst[c] = dst.get(c, 0.0) + v
    return pen


# ---------------------------------------------------------------------------
# optimized path: memoized tables + dominance pruning + adaptive beam
# ---------------------------------------------------------------------------

def _solve_one_cut_fast(g: Graph, arity: int, fixed: Optional[Assignment],
                        beam: BeamSpec, mem_scale: float,
                        cost_cache: Optional[dict],
                        terms: Sequence = ()) -> OneCutSolution:
    fixed = fixed or {}
    order = g.elimination_order()
    names = list(g.tensors)
    tid = {t: i for i, t in enumerate(names)}
    choice_map: Dict[str, List[Tiling]] = {
        t: ([fixed[t]] if t in fixed else tensor_tiling_choices(g, t, arity))
        for t in names
    }
    choices = [choice_map[t] for t in names]
    n_choice = [len(c) for c in choices]

    last_use = [-1] * len(names)
    for i, op in enumerate(order):
        for t in g.op_tensors(op):
            last_use[tid[t]] = i

    pen = _term_penalties(g, arity, mem_scale, terms)
    pen_by_id: Dict[int, List[float]] = {}
    for t, per in pen.items():
        j = tid[t]
        pen_by_id[j] = [per.get(c, 0.0) for c in choices[j]]

    # penalized tensors no op touches (possible in traced graphs: unused
    # weights) never enter the DP; charge their cheapest choice up front
    # so the returned cost matches graph_cost on the returned assignment
    # (and the brute-force oracle, which enumerates every tensor).
    touched = {t for op in order for t in g.op_tensors(op)}
    base_cost = 0.0
    base_assign: Assignment = {}
    for j, pj in pen_by_id.items():
        if names[j] not in touched and pj:
            ci = min(range(len(pj)), key=pj.__getitem__)
            base_cost += pj[ci]
            base_assign[names[j]] = choices[j][ci]

    # tie-break: among equal-cost assignments prefer partitioned tensors
    # (bytes left replicated), so ties feed *smaller* subproblems to the
    # later cuts of the k-cut recursion — an equal-cost cut that leaves a
    # huge gradient replicated makes every subsequent cut pay for it.
    from .tiling import Part
    tb_by_id = [
        [0.0 if isinstance(c, Part) else g.tensors[names[j]].nbytes
         for c in choices[j]]
        for j in range(len(names))
    ]

    cache = cost_cache if cost_cache is not None else {}
    # per-op precomputation, shared by the incumbent pass and every
    # adaptive-beam widening: (op_ids, base table, repeat, live_after)
    steps = []
    live: List[int] = []
    with _span("solver.cost_tables", ops=len(order), arity=arity):
        for i, op in enumerate(order):
            op_ts = g.op_tensors(op)
            op_ids = tuple(tid[t] for t in op_ts)
            tbl = cached_cost_table(g, op, arity, choice_map, cache)
            live_after = tuple(sorted(set(
                j for j in set(live) | set(op_ids) if last_use[j] > i)))
            steps.append((op, op_ids, tbl, op.repeat, live_after))
            live = list(live_after)

    # incumbent pass: a narrow-beam run gives a feasible upper bound U;
    # the main run then applies *dominance pruning* — any DP state whose
    # accumulated cost exceeds U cannot complete below U (all future op
    # costs and penalties are >= 0), so it is dropped.  Sound, so when no
    # beam cap is hit the result is exact.
    with _span("solver.dp.incumbent", beam=_INCUMBENT_BEAM):
        inc_cost, inc_node, _ = _run_dp(steps, n_choice, pen_by_id,
                                        tb_by_id, _INCUMBENT_BEAM,
                                        float("inf"), g)

    def _ub(c: float) -> float:
        return c * (1.0 + 1e-12) + 1e-6

    def _run(b, ub):
        # ub pruning + beam truncation can, in the worst case, empty the
        # state set (cheap trap prefixes crowd out the incumbent path and
        # then all their extensions exceed ub); the incumbent itself is
        # always a valid answer then — never raise where the seed solver
        # returned a plan.
        try:
            return _run_dp(steps, n_choice, pen_by_id, tb_by_id, b, ub, g)
        except RuntimeError:
            return inc_cost, inc_node, True

    ub = _ub(inc_cost)
    with _span("solver.dp", ops=len(order), tensors=len(names)) as sp:
        if beam == "auto":
            b = AUTO_BEAM_START
            best: Optional[Tuple[float, object]] = None
            exact = False
            while True:
                cost, node, hit = _run(b, ub)
                improved = best is None or \
                    cost < best[0] - _AUTO_MIN_IMPROVE * abs(best[0])
                if best is None or cost < best[0]:
                    best = (cost, node)
                    ub = min(ub, _ub(cost))
                # an un-truncated run is exact (ub pruning is sound), so
                # its cost is the optimum; it proves the kept solution
                # optimal whenever the kept cost is not worse.
                if not hit and best[0] <= cost + 1e-9 * abs(cost):
                    exact = True
                if not improved or not hit or b >= AUTO_BEAM_MAX:
                    break
                b *= 4
            cost, node = best
            sp.set(beam=b, exact=exact)
        else:
            cost, node, hit = _run(beam, ub)
            exact = not hit
            sp.set(beam=beam, exact=exact)

    full = dict(fixed)
    full.update(base_assign)
    while node is not None:
        node, pairs = node
        for j, ci in pairs:
            full[names[j]] = choices[j][ci]
    for t in g.tensors:  # untouched tensors -> replicate
        full.setdefault(t, REPLICATE)
    return OneCutSolution(cost + base_cost, full, exact=exact)


def _run_dp(steps, n_choice, pen_by_id, tb_by_id, beam: Optional[int],
            ub: float, g: Graph):
    """One variable-elimination DP sweep.  States map
    key = ((tensor_id, choice_idx), ... ascending) -> (cost, tb, node):
    tb is the tie-break (bytes left replicated; lower preferred at equal
    cost), node a backpointer chain (parent_node, assigned_pairs).
    Returns (best_cost, best_node, hit_beam)."""
    inf = float("inf")
    state: Dict[tuple, Tuple[float, float, object]] = {(): (0.0, 0.0, None)}
    hit_beam = False
    for op, op_ids, tbl, rep, live_after in steps:
        la_set = set(live_after)
        # bucket states by their bound choices on this op's tensors: every
        # state in a bucket shares the same free set and per-combo cost
        # delta, which is computed once per (bucket, combo).
        buckets: Dict[tuple, list] = {}
        for key, (cost0, tb0, node) in state.items():
            kd = dict(key)
            bproj = tuple(kd.get(j, -1) for j in op_ids)
            pers = tuple(p for p in key if p[0] in la_set)
            buckets.setdefault(bproj, []).append(
                (cost0, tb0, node, pers))

        new_state: Dict[tuple, Tuple[float, float, object]] = {}
        for bproj, members in buckets.items():
            members.sort(key=lambda m: (m[0], m[1]))
            free = tuple(j for j, b in zip(op_ids, bproj) if b < 0)
            min_cost0 = members[0][0]
            for combo in itertools.product(*(range(n_choice[j])
                                             for j in free)):
                it = iter(combo)
                full = tuple(b if b >= 0 else next(it) for b in bproj)
                d = tbl[full] * rep
                if d == inf:
                    continue
                pairs = tuple(zip(free, combo))
                dtb = 0.0
                for j, ci in pairs:
                    pj = pen_by_id.get(j)
                    if pj is not None:
                        d += pj[ci]
                    dtb += tb_by_id[j][ci]
                if min_cost0 + d > ub:
                    continue
                added = tuple(sorted(p for p in pairs if p[0] in la_set))
                for cost0, tb0, node, pers in members:
                    c = cost0 + d
                    if c > ub:
                        break  # members sorted ascending by cost
                    nkey = (tuple(sorted(pers + added))
                            if added else pers)
                    cur = new_state.get(nkey)
                    if cur is None or c < cur[0] or \
                            (c == cur[0] and tb0 + dtb < cur[1]):
                        new_state[nkey] = (c, tb0 + dtb, (node, pairs))
        if not new_state:
            raise RuntimeError(
                f"no feasible tiling at op {op.name} of {g.name}")
        if beam is not None and len(new_state) > beam:
            hit_beam = True
            new_state = dict(heapq.nsmallest(
                beam, new_state.items(), key=lambda kv: (kv[1][0],
                                                         kv[1][1])))
        state = new_state

    best_cost, best_tb, best_node = min(
        state.values(), key=lambda v: (v[0], v[1]))
    return best_cost, best_node, hit_beam


# ---------------------------------------------------------------------------
# seed path (pre-overhaul reference implementation, benchmarks only)
# ---------------------------------------------------------------------------

def _solve_one_cut_seed(g: Graph, arity: int,
                        fixed: Optional[Assignment] = None,
                        beam: Optional[int] = 50_000,
                        mem_scale: float = 1.0,
                        terms: Sequence = ()) -> OneCutSolution:
    fixed = fixed or {}
    order = g.elimination_order()

    names = list(g.tensors)
    tid = {t: i for i, t in enumerate(names)}
    choices: List[List[Tiling]] = [
        [fixed[t]] if t in fixed else tensor_tiling_choices(g, t, arity)
        for t in names
    ]
    n_choice = [len(c) for c in choices]

    last_use = [-1] * len(names)
    for i, op in enumerate(order):
        for t in g.op_tensors(op):
            last_use[tid[t]] = i

    # soft-capacity + cost-term penalties, charged once per assignment
    pen = _term_penalties(g, arity, mem_scale, terms)
    pen_by_id = {}
    for t, per in pen.items():
        j = tid[t]
        pen_by_id[j] = [per.get(c, 0.0) for c in choices[j]]

    # op-less penalized tensors (see _solve_one_cut_fast): charge their
    # cheapest choice up front
    touched = {t for op in order for t in g.op_tensors(op)}
    base_cost = 0.0
    base_assign: Dict[int, int] = {}
    for j, pj in pen_by_id.items():
        if names[j] not in touched and pj:
            ci = min(range(len(pj)), key=pj.__getitem__)
            base_cost += pj[ci]
            base_assign[j] = ci

    # DP state: tuple of (tensor_id, choice_idx) for live assigned tensors
    # (ascending tensor_id) -> (cost, backpointer dict tensor_id->choice)
    state: Dict[tuple, Tuple[float, Dict[int, int]]] = {(): (0.0, {})}
    live: List[int] = []
    for i, op in enumerate(order):
        op_ts = g.op_tensors(op)
        op_ids = [tid[t] for t in op_ts]
        # cost table indexed by per-tensor choice indices
        tbl: Dict[tuple, float] = {}
        for combo in itertools.product(*(range(n_choice[j]) for j in op_ids)):
            assign = {t: choices[j][ci]
                      for t, j, ci in zip(op_ts, op_ids, combo)}
            tbl[combo] = op_cost(g, op, assign, arity)
        live_after = sorted(set(
            j for j in set(live) | set(op_ids) if last_use[j] > i))
        new_state: Dict[tuple, Tuple[float, Dict[int, int]]] = {}
        for key, (cost0, back) in state.items():
            bound = dict(key)
            free = [j for j in op_ids if j not in bound]
            for combo in itertools.product(*(range(n_choice[j])
                                             for j in free)):
                local = dict(bound)
                local.update(zip(free, combo))
                c = cost0 + tbl[tuple(local[j] for j in op_ids)]
                if c == float("inf"):
                    continue
                for j, ci in zip(free, combo):
                    if j in pen_by_id:
                        c += pen_by_id[j][ci]
                nkey = tuple((j, local[j]) for j in live_after
                             if j in local)
                cur = new_state.get(nkey)
                if cur is None or c < cur[0]:
                    nb = dict(back)
                    nb.update(zip(free, combo))
                    new_state[nkey] = (c, nb)
        if not new_state:
            raise RuntimeError(
                f"no feasible tiling at op {op.name} of {g.name} "
                f"(arity {arity})")
        if beam is not None and len(new_state) > beam:
            new_state = dict(sorted(new_state.items(),
                                    key=lambda kv: kv[1][0])[:beam])
        state = new_state
        live = live_after

    best_cost, best_back = min(state.values(), key=lambda v: v[0])
    full = dict(fixed)
    for j, ci in base_assign.items():
        full[names[j]] = choices[j][ci]
    for j, ci in best_back.items():
        full[names[j]] = choices[j][ci]
    for t in g.tensors:  # untouched tensors -> replicate
        full.setdefault(t, REPLICATE)
    return OneCutSolution(best_cost + base_cost, full)


def _bruteforce_chunk(payload) -> Tuple[float, Optional[Assignment]]:
    """Worker for the parallel oracle: exhaust the sub-product where the
    pivot tensor is pinned to one choice (top-level for pickling)."""
    g, arity, names, choice_lists, mem_scale, terms = payload
    best: Tuple[float, Optional[Assignment]] = (float("inf"), None)
    for combo in itertools.product(*choice_lists):
        assign = dict(zip(names, combo))
        c = graph_cost(g, assign, arity, mem_scale=mem_scale, terms=terms)
        if c < best[0]:
            best = (c, assign)
    return best


def solve_one_cut_bruteforce(g: Graph, arity: int,
                             fixed: Optional[Assignment] = None,
                             mem_scale: float = 1.0,
                             workers: Optional[int] = None,
                             terms: Sequence = ()) -> OneCutSolution:
    """Exhaustive reference solver (the optimality oracle for tests and
    benchmarks).  ``workers``: fan the assignment product out over
    processes with concurrent.futures (0/None on small products = serial);
    the pivot is the widest-choice tensor."""
    with _span("solver.oracle", arity=arity, tensors=len(g.tensors)):
        return _solve_one_cut_bruteforce(g, arity, fixed, mem_scale,
                                         workers, terms)


def _solve_one_cut_bruteforce(g: Graph, arity: int,
                              fixed: Optional[Assignment],
                              mem_scale: float,
                              workers: Optional[int],
                              terms: Sequence) -> OneCutSolution:
    fixed = fixed or {}
    names = list(g.tensors)
    choice_lists = [
        [fixed[t]] if t in fixed else tensor_tiling_choices(g, t, arity)
        for t in names
    ]
    n_combos = 1
    for cl in choice_lists:
        n_combos *= len(cl)
    if workers is None and n_combos >= 50_000:
        workers = os.cpu_count() or 1
    if workers and workers > 1 and n_combos >= 1_000:
        pivot = max(range(len(names)), key=lambda i: len(choice_lists[i]))
        jobs = []
        for c in choice_lists[pivot]:
            sub = list(choice_lists)
            sub[pivot] = [c]
            jobs.append((g, arity, names, sub, mem_scale, terms))
        try:
            from concurrent.futures import ProcessPoolExecutor
            from concurrent.futures.process import BrokenProcessPool
            with ProcessPoolExecutor(
                    max_workers=min(workers, len(jobs))) as ex:
                results = list(ex.map(_bruteforce_chunk, jobs))
            best = min(results, key=lambda r: r[0])
            assert best[1] is not None
            return OneCutSolution(best[0], best[1])
        except (OSError, BrokenProcessPool):  # no process pool: serial
            pass
    best = _bruteforce_chunk((g, arity, names, choice_lists, mem_scale,
                              terms))
    assert best[1] is not None
    return OneCutSolution(best[0], best[1])


@dataclasses.dataclass
class MeshAxis:
    name: str
    size: int
    # bytes/s per device along this axis; default NVLink 4 on the H100,
    # 900 GB/s a GPU (NVIDIA's H100 datasheet, not measured)
    bandwidth: float = 900e9


@dataclasses.dataclass
class TilingSolution:
    """Per-mesh-axis one-cut assignments, outermost (slowest) first."""

    axes: List[MeshAxis]
    per_axis: List[Assignment]
    per_axis_bytes: List[float]     # δ_i × groups_above(i)
    total_bytes: float
    total_seconds: float

    def tiling_of(self, tensor: str) -> Tuple[Tiling, ...]:
        return tuple(a.get(tensor, REPLICATE) for a in self.per_axis)

    def describe(self, tensors: Optional[Sequence[str]] = None) -> str:
        lines = []
        names = tensors if tensors is not None else sorted(
            {t for a in self.per_axis for t in a})
        for t in names:
            cuts = ", ".join(
                f"{ax.name}:{a.get(t, REPLICATE)!r}"
                for ax, a in zip(self.axes, self.per_axis))
            lines.append(f"  {t:28s} {cuts}")
        return "\n".join(lines)


def _axis_terms(terms: Sequence, compute, ax: "MeshAxis") -> Sequence:
    """Per-axis term list: shared ``terms`` plus the compute term at this
    axis\' exchange rate (ComputeConfig -> ComputeTerm expansion)."""
    if compute is None:
        return terms
    return tuple(terms) + (
        compute.term_for_axis(ax.bandwidth, ax.size),)


def solve_mesh(g: Graph, axes: Sequence[MeshAxis],
               fixed_per_axis: Optional[Dict[str, Assignment]] = None,
               beam: BeamSpec = "auto",
               mem_scale: float = 1.0,
               optimize: bool = True,
               cost_cache: Optional[dict] = None,
               terms: Sequence = (),
               compute=None) -> TilingSolution:
    """Algorithm 1 generalized to a named mesh: recursively cut along each
    axis (slowest first), dividing shapes in between.  The memoized
    ``cost_cache`` is shared across the per-axis cuts (pass one in to
    share further, e.g. across capacity-escalation rounds).

    ``terms`` are extra costterms.CostTerm penalties applied at every
    axis; ``compute`` is a costterms.ComputeConfig pricing kernel-aware
    compute time per cut (each axis sees the *divided* graph, so the
    per-axis compute charges are the DP's search signal, mirroring how
    the capacity term re-prices per axis; the exact end-to-end compute
    seconds of the final composed tiling come from
    :func:`solution_compute_seconds`)."""
    fixed_per_axis = fixed_per_axis or {}
    if cost_cache is None and optimize:
        cost_cache = {}
    cur = g
    groups = 1
    per_axis: List[Assignment] = []
    per_bytes: List[float] = []
    total_b = 0.0
    total_s = 0.0
    for ax in axes:
        with _span("solver.axis", axis=ax.name, size=ax.size):
            sol = solve_one_cut(cur, ax.size,
                                fixed=fixed_per_axis.get(ax.name),
                                beam=beam,
                                mem_scale=mem_scale, optimize=optimize,
                                cost_cache=cost_cache,
                                terms=_axis_terms(terms, compute, ax))
        weighted = sol.cost * groups
        per_axis.append(sol.assignment)
        per_bytes.append(weighted)
        total_b += weighted
        # seconds: bytes cross this cut in parallel across groups & members
        total_s += sol.cost / (ax.bandwidth * max(1, ax.size))
        cur = cur.divided(sol.assignment, ax.size)
        groups *= ax.size
    return TilingSolution(list(axes), per_axis, per_bytes, total_b, total_s)


def solution_compute_seconds(g: Graph, axes: Sequence[MeshAxis],
                             per_axis: Sequence[Assignment],
                             compute) -> float:
    """Exact in-model per-device compute seconds of a composed tiling:
    divide the graph along every axis, then price the final per-device
    blocks (flops × alignment / peak × calibration) — the compute half
    of the predicted step time, comparable to HLO cost_analysis flops /
    PEAK_FLOPS on the compiled program."""
    from .costterms import graph_compute_seconds
    cur = g
    for ax, assign in zip(axes, per_axis):
        cur = cur.divided(assign, ax.size)
    return graph_compute_seconds(cur, compute)


def _solve_mesh_job(payload) -> TilingSolution:
    g, axes, kw = payload
    return solve_mesh(g, axes, **kw)


def solve_mesh_many(jobs: Sequence[Tuple[Graph, Sequence[MeshAxis]]],
                    workers: Optional[int] = None,
                    **kw) -> List[TilingSolution]:
    """Solve several independent (graph, axes) problems concurrently with
    concurrent.futures — the per-axis cuts *within* one mesh are a chain
    (each cut divides the graph for the next), so parallelism lives at
    the level of independent meshes/graphs (e.g. sweeping several archs
    or meshes at once; parity with sequential solve_mesh is pinned by
    tests/test_solver.py).  Falls back to serial where process pools are
    unavailable."""
    kw.pop("cost_cache", None)   # per-process caches
    payloads = [(g, axes, kw) for g, axes in jobs]
    workers = workers if workers is not None else (os.cpu_count() or 1)
    if workers > 1 and len(jobs) > 1:
        try:
            from concurrent.futures import ProcessPoolExecutor
            from concurrent.futures.process import BrokenProcessPool
            with ProcessPoolExecutor(
                    max_workers=min(workers, len(jobs))) as ex:
                return list(ex.map(_solve_mesh_job, payloads))
        except (OSError, BrokenProcessPool):
            pass
    return [_solve_mesh_job(p) for p in payloads]


def persistent_bytes_per_device(g: Graph, axes: Sequence[MeshAxis],
                                per_axis: Sequence[Assignment]) -> float:
    """Per-device bytes of persistent tensors (weights, optimizer moments,
    KV/SSM caches) under a composed tiling — the hard-capacity check."""
    from .cost import _PERSISTENT_ROLES
    from .tiling import Part
    total = 0.0
    for name, ts in g.tensors.items():
        if ts.kind not in ("weight", "opt") and \
                ts.role not in _PERSISTENT_ROLES:
            continue
        div = 1
        for ax, assign in zip(axes, per_axis):
            if isinstance(assign.get(name), Part):
                div *= ax.size
        total += ts.nbytes / div
    return total


def solve_mesh_capacity(g: Graph, axes: Sequence[MeshAxis],
                        hbm: float = 80e9, budget_frac: float = 0.7,
                        beam: BeamSpec = "auto",
                        max_rounds: int = 5,
                        workers: Optional[int] = None,
                        compute=None) -> TilingSolution:
    """Dual ascent on the capacity Lagrangian: solve, check the hard
    per-device persistent-bytes budget, escalate the penalty scale until
    the plan fits (beyond-paper: the paper's objective is communication
    only and will happily replicate 64 GB of weights).

    Once feasible, a *polish* pass re-solves with the persistent tensors
    pinned to the feasible tilings and the penalty off — a very large λ
    drowns the communication signal and yields feasible-but-awful plans
    (observed on 32B prefill: λ escalation alone gave a zero-collective
    plan with 10× the memory traffic).

    ``workers`` > 1 evaluates the candidate λ scales concurrently with
    concurrent.futures and keeps the smallest feasible one — identical
    result to the sequential escalation, lower wall time when escalation
    is needed.

    The penalty is priced against the same ``hbm`` as the budget (a
    ``CapacityTerm(scale, hbm)``; ``mem_scale`` would read
    ``HBM_PER_DEV``), so a solve at another card's memory size is that
    card's solve throughout."""
    from .cost import _PERSISTENT_ROLES
    from .costterms import CapacityTerm

    def penalty(sc: float) -> dict:
        return {"mem_scale": 0.0,
                "terms": (CapacityTerm(scale=sc, hbm=hbm),)}

    scales = [8.0 ** k for k in range(max_rounds)]
    cost_cache: dict = {}   # λ only rescales penalties; tables are shared

    def feasible(s: TilingSolution) -> bool:
        return (persistent_bytes_per_device(g, axes, s.per_axis)
                <= budget_frac * hbm)

    sol = None
    raw_ok = False    # feasible at the first scale -> no polish needed
    parallel_ok = False
    if workers and workers > 1:
        # solve each scale as its own job (mem_scale differs per job);
        # consume results in scale order; once the smallest feasible
        # scale is known, drop pending jobs without waiting on running
        # ones (shutdown(wait=False, cancel_futures=True) — their
        # results are discarded)
        payloads = [(g, axes,
                     {"beam": beam, "compute": compute, **penalty(sc)})
                    for sc in scales]
        try:
            from concurrent.futures import ProcessPoolExecutor
            from concurrent.futures.process import BrokenProcessPool
            ex = ProcessPoolExecutor(
                max_workers=min(workers, len(scales)))
            try:
                futs = [ex.submit(_solve_mesh_job, p) for p in payloads]
                for i, fut in enumerate(futs):
                    sol = fut.result()
                    if feasible(sol):
                        raw_ok = i == 0
                        break
            finally:
                ex.shutdown(wait=False, cancel_futures=True)
            parallel_ok = True
        except (OSError, BrokenProcessPool):   # no process pool: serial
            sol = None
            raw_ok = False
    if not parallel_ok:
        for i, sc in enumerate(scales):
            sol = solve_mesh(g, axes, beam=beam, cost_cache=cost_cache,
                             compute=compute, **penalty(sc))
            if feasible(sol):
                raw_ok = i == 0
                break
    if sol is None or raw_ok:
        return sol
    # polish: pin persistent tilings, re-optimize the rest for comm only
    fixed_per_axis: Dict[str, Assignment] = {}
    for ax, assign in zip(axes, sol.per_axis):
        pins: Assignment = {}
        for name, ts in g.tensors.items():
            if ts.kind in ("weight", "opt") or ts.role in _PERSISTENT_ROLES:
                if name in assign:
                    pins[name] = assign[name]
        fixed_per_axis[ax.name] = pins
    return solve_mesh(g, axes, fixed_per_axis=fixed_per_axis, beam=beam,
                      mem_scale=0.0, cost_cache=cost_cache, compute=compute)


def composed_cost(g: Graph, axes: Sequence[MeshAxis],
                  per_axis: Sequence[Assignment],
                  naive: bool = False, mem_scale: float = 0.0,
                  terms: Sequence = (), compute=None) -> float:
    """Total weighted bytes of an arbitrary composed tiling (for comparing
    canonical DP/MP strategies against the solver's choice).  With the
    same ``mem_scale``/``terms``/``compute`` knobs as solve_mesh this
    reprices its exact objective (solve == reprice)."""
    cur = g
    groups = 1
    total = 0.0
    for ax, assign in zip(axes, per_axis):
        total += graph_cost(cur, assign, ax.size, naive=naive,
                            mem_scale=mem_scale,
                            terms=_axis_terms(terms, compute, ax)) * groups
        cur = cur.divided(assign, ax.size)
        groups *= ax.size
    return total


def solution_breakdown(g: Graph, axes: Sequence[MeshAxis],
                       per_axis: Sequence[Assignment],
                       mem_scale: float = 0.0,
                       terms: Sequence = (),
                       compute=None) -> Dict[str, object]:
    """Attribute a composed tiling's predicted bytes to collective kinds
    and tensor roles, walking the same k-cut recursion as
    :func:`composed_cost` (totals match it exactly).  Returns
    ``{"total", "by_kind", "by_role", "by_axis", "by_phase"}`` with bytes
    weighted by groups_above(i) — i.e. system-wide wire bytes, directly
    comparable to ``hlo.collect(...).wire_bytes_per_device × n_devices``
    on the compiled program (repro.verify.calibration).

    ``by_term`` attributes the solver objective per cost term:
    "conversion" is the wire-byte total above; each extra term
    (capacity via ``mem_scale``, explicit ``terms``, the kernel-aware
    ``compute`` config) adds its own weighted penalty bucket, so
    ``sum(by_term.values())`` == composed_cost under the same knobs.

    ``by_phase`` splits the same total by op provenance (builder naming
    convention): ``update`` = parameter-update ops (``upd:*``) — these
    carry the ZeRO-style optimizer-state collectives (dW reduce-scatter
    into the moment layout, bf16 weight all-gather after the sharded
    update); ``backward`` = mirrored backward/grad-accumulation ops;
    ``forward`` = everything else."""
    from .cost import op_cost_detail
    from .costterms import CapacityTerm
    cur = g
    groups = 1
    total = 0.0
    by_kind: Dict[str, float] = {}
    by_role: Dict[str, float] = {}
    by_axis: Dict[str, float] = {}
    by_phase: Dict[str, float] = {}
    by_term: Dict[str, float] = {"conversion": 0.0}
    base_terms = ((CapacityTerm(scale=mem_scale),) if mem_scale else ()) \
        + tuple(terms)

    def phase_of(op) -> str:
        if op.name.startswith("upd:"):
            return "update"
        if op.name.startswith(("bwd:", "acc:", "seed:")):
            return "backward"
        return "forward"

    for ax, assign in zip(axes, per_axis):
        axis_total = 0.0
        for op in cur.ops:
            full = {t: assign.get(t, REPLICATE)
                    for t in cur.op_tensors(op)}
            c, recs = op_cost_detail(cur, op, full, ax.size)
            axis_total += c * groups
            ph = phase_of(op)
            by_phase[ph] = by_phase.get(ph, 0.0) + c * groups
            for r in recs:
                b = r["bytes"] * groups
                by_kind[r["kind"]] = by_kind.get(r["kind"], 0.0) + b
                by_role[r["role"]] = by_role.get(r["role"], 0.0) + b
        by_axis[ax.name] = axis_total
        total += axis_total
        by_term["conversion"] += axis_total
        for term in _axis_terms(base_terms, compute, ax):
            pen = term.penalties(cur, ax.size)
            v = sum(per.get(assign.get(t, REPLICATE), 0.0)
                    for t, per in pen.items()) * groups
            by_term[term.name] = by_term.get(term.name, 0.0) + v
            total += v
        cur = cur.divided(assign, ax.size)
        groups *= ax.size
    return {"total": total, "by_kind": by_kind, "by_role": by_role,
            "by_axis": by_axis, "by_phase": by_phase, "by_term": by_term}


def assignment_cost_naive(g: Graph, axes: Sequence[MeshAxis],
                          per_axis: Sequence[Assignment]) -> float:
    """Paper §2.2 parameter-server accounting of a composed tiling.
    Consecutive axes with identical assignments are merged into one cut of
    the product arity (Theorem 2 flattening) before pricing — this is how
    the paper arrives at 57.6/76.8/33.6 MB for the 16-GPU MLP example."""
    merged: List[Tuple[Assignment, int]] = []
    for ax, assign in zip(axes, per_axis):
        if merged and merged[-1][0] == assign:
            merged[-1] = (assign, merged[-1][1] * ax.size)
        else:
            merged.append((assign, ax.size))
    cur = g
    groups = 1
    total = 0.0
    for assign, arity in merged:
        total += graph_cost(cur, assign, arity, naive=True) * groups
        cur = cur.divided(assign, arity)
        groups *= arity
    return total


# Canonical whole-strategy assignments (paper §4.1) -------------------------

def data_parallel_assignment(g: Graph, batch_dims: Sequence[str] = ("batch", "tok")
                             ) -> Assignment:
    """Replicate weights; partition everything else on its batch-like dim."""
    from .tiling import Part
    out: Assignment = {}
    for name, ts in g.tensors.items():
        if ts.kind == "weight" or not ts.dims:
            out[name] = REPLICATE
        else:
            bdim = next((d for d in ts.dims if d in batch_dims), None)
            out[name] = Part(bdim) if bdim else REPLICATE
    return out


def model_parallel_fixed(g: Graph, weight_dim_index: int = 0) -> Assignment:
    """Pin every weight partitioned along one dim (the paper's §4.1 model
    parallelism); activation tilings are then found by the solver."""
    from .tiling import Part
    fixed: Assignment = {}
    for name, ts in g.tensors.items():
        if ts.kind == "weight" and len(ts.dims) > weight_dim_index:
            d = ts.dims[weight_dim_index]
            fixed[name] = Part(d)
    return fixed


def canonical_mp_assignment(g: Graph) -> Assignment:
    """The paper's §4.1 T_model, written out: weights row-partitioned
    (P(dims[0])); activations column-partitioned (P(last dim)); weight
    gradients follow their weight (local update); everything else
    replicated."""
    from .tiling import Part
    weights = {n: ts for n, ts in g.tensors.items() if ts.kind == "weight"}
    out: Assignment = {}
    for name, ts in g.tensors.items():
        if ts.kind == "weight":
            out[name] = Part(ts.dims[0])
        elif ts.kind in ("grad", "opt"):
            base = name[2:] if name.startswith("d_") else name
            base = base[4:] if base.startswith("opt:") else base
            base = base.split("#")[0].split(".sum")[0]
            w = weights.get(base)
            out[name] = Part(w.dims[0]) if w is not None else REPLICATE
        elif ts.dims:
            out[name] = Part(ts.dims[-1])
        else:
            out[name] = REPLICATE
    return out


# ---------------------------------------------------------------------------
# joint pipeline-stage + tiling search (bubble-aware; ROADMAP item 1)
# ---------------------------------------------------------------------------
# Pipelining is *outside* the tiling space (DESIGN.md §5): no PartitionSpec
# expresses "layers 0..k on these devices".  So the search is lifted one
# level: choose contiguous layer-block ranges as stages, carve a ``stage``
# axis off the slowest mesh axis, and tile each stage's subgraph over the
# remaining (inner) axes with the existing one-cut DP — extended with a
# BoundaryTransferTerm so intra-stage conversion bytes and stage-link
# transfer seconds trade off inside one objective.  The schedule-level
# bubble multiplies the critical stage (costterms.BubbleTerm), giving
#
#   T(cuts, tilings) = (n_micro + S - 1)/n_micro × max_s τ_s
#   τ_s = comm_s(tilings_s) + flops_s/(peak × inner_degree)
#         + boundary_bytes_s(tilings_s)/(stage_bw × inner_degree)
#
# τ_s depends only on stage s' own range and tilings (boundary bytes are
# charged to the *consumer* stage), so min over cuts of the max is an
# exact interval DP: dp[j][s] = min_i max(dp[i][s-1], τ(i, j)).

# a weight/opt tensor straddling a cut needs its gradient synced across
# the stage link every step, both directions — priced at 2× the one-way
# activation transfer (ring all-reduce ≈ 2 × bytes on the wire).
PIPE_WEIGHT_XFER_MULT = 2.0
# default modeled compute rate: the H100's dense bf16 peak, 989 TFLOP/s
# (datasheet; costterms.DEFAULT_PEAK_FLOPS)
DEFAULT_PEAK_FLOPS = 989e12


def layer_blocks(g: Graph) -> List[List[OpSpec]]:
    """Ops grouped into layer blocks by the builders' ``group`` tags
    (backward/update ops carry their forward op's tag, so one block holds
    a layer's forward, backward AND update work).  Untagged ops land in
    group 0; a graph with no tags is one block (S=1 only)."""
    by_group: Dict[int, List[OpSpec]] = {}
    for op in g.ops:
        by_group.setdefault(int(op.attrs.get("group", 0)), []).append(op)
    return [by_group[k] for k in sorted(by_group)]


def _block_spans(g: Graph, blocks: Sequence[Sequence[OpSpec]]
                 ) -> Dict[str, Tuple[int, int]]:
    """tensor -> (first, last) block index touching it; custom-op aligned
    forms count as touches (their penalties reference those tensors)."""
    spans: Dict[str, Tuple[int, int]] = {}
    for bi, ops in enumerate(blocks):
        for op in ops:
            names = list(g.op_tensors(op))
            if op.kind == "custom":
                for form, _pen in op.attrs["forms"]:
                    names.extend(form)
            for t in names:
                if t not in g.tensors:
                    continue
                lo, hi = spans.get(t, (bi, bi))
                spans[t] = (min(lo, bi), max(hi, bi))
    return spans


def crossing_tensors(spans: Dict[str, Tuple[int, int]],
                     cut: int) -> List[str]:
    """Tensors live across cut ``cut`` (between blocks cut-1 and cut)."""
    return sorted(t for t, (lo, hi) in spans.items() if lo < cut <= hi)


def stage_subgraph(g: Graph, blocks: Sequence[Sequence[OpSpec]],
                   lo: int, hi: int) -> Graph:
    """Subgraph of blocks [lo, hi): shares OpSpec/TensorSpec objects with
    ``g`` (same trick as Graph.divided), holding exactly the tensors its
    ops (and their custom forms) touch."""
    sub = Graph(f"{g.name}[{lo}:{hi}]", g.allow_uneven)
    for ops in blocks[lo:hi]:
        sub.ops.extend(ops)
    needed: List[str] = []
    for op in sub.ops:
        needed.extend(g.op_tensors(op))
        if op.kind == "custom":
            for form, _pen in op.attrs["forms"]:
                needed.extend(form)
    for t in dict.fromkeys(needed):
        if t in g.tensors:
            sub.tensors[t] = g.tensors[t]
    return sub


def _boundary_mult(ts) -> float:
    return PIPE_WEIGHT_XFER_MULT if ts.kind in ("weight", "opt") else 1.0


@dataclasses.dataclass
class StageSolution:
    """One pipeline stage: its block range, subgraph, inner-axis tilings
    and the three components of its full-batch stage time."""

    lo: int
    hi: int
    graph: Graph
    per_axis: List[Assignment]
    incoming: List[str]             # tensors crossing the inbound cut
    comm_seconds: float             # intra-stage conversions (+ capacity λ)
    compute_seconds: float
    boundary_seconds: float
    boundary_bytes: Dict[str, float]   # per inbound tensor, wire bytes
    exact: bool = True

    @property
    def seconds(self) -> float:
        return self.comm_seconds + self.compute_seconds + \
            self.boundary_seconds

    @property
    def boundary_bytes_total(self) -> float:
        return sum(self.boundary_bytes.values())


@dataclasses.dataclass
class PipelineSolution:
    """Joint stage-cut + per-stage tiling choice for one mesh."""

    axes: List[MeshAxis]            # original solver axes (slowest first)
    n_micro: int
    n_stages: int
    stage_axis: Optional[MeshAxis]  # None when n_stages == 1
    inner_axes: List[MeshAxis]      # per-stage tiling axes
    stages: List[StageSolution]
    bubble_factor: float
    total_seconds: float            # bubble × max stage seconds
    candidates: Dict[int, float]    # stage count -> total seconds
    mem_scale: float
    peak_flops: float
    exact: bool

    @property
    def cuts(self) -> List[int]:
        return [s.lo for s in self.stages] + [self.stages[-1].hi]

    @property
    def flat(self) -> bool:
        return self.n_stages == 1

    @property
    def critical_seconds(self) -> float:
        return max(s.seconds for s in self.stages)

    def describe(self) -> str:
        lines = [f"stages={self.n_stages} bubble={self.bubble_factor:.3f} "
                 f"n_micro={self.n_micro} "
                 f"modeled={self.total_seconds * 1e3:.3f} ms"]
        for i, st in enumerate(self.stages):
            lines.append(
                f"  stage {i}: blocks [{st.lo},{st.hi}) "
                f"comm={st.comm_seconds * 1e3:.3f}ms "
                f"compute={st.compute_seconds * 1e3:.3f}ms "
                f"boundary={st.boundary_seconds * 1e3:.3f}ms "
                f"({st.boundary_bytes_total:.2e} B in)")
        return "\n".join(lines)


def pipeline_stage_options(axes: Sequence[MeshAxis]
                           ) -> List[Tuple[int, Optional[MeshAxis],
                                           List[MeshAxis]]]:
    """Candidate (n_stages, stage_axis, inner_axes) splits.  The stage
    axis is carved from the outermost (slowest) axis — that is where
    point-to-point boundary hops beat collective sync — keeping its
    bandwidth for the stage link: every divisor of the outer size, then
    (outer fully consumed) products into divisors of the second axis."""
    opts: List[Tuple[int, Optional[MeshAxis], List[MeshAxis]]] = [
        (1, None, list(axes))]
    if not axes:
        return opts
    a0 = axes[0]
    for d in range(2, a0.size + 1):
        if a0.size % d:
            continue
        left = a0.size // d
        inner = ([MeshAxis(a0.name, left, a0.bandwidth)] if left > 1
                 else []) + list(axes[1:])
        opts.append((d, MeshAxis("stage", d, a0.bandwidth), inner))
    if len(axes) > 1:
        a1 = axes[1]
        for d in range(2, a1.size + 1):
            if a1.size % d:
                continue
            s = a0.size * d
            left = a1.size // d
            inner = ([MeshAxis(a1.name, left, a1.bandwidth)] if left > 1
                     else []) + list(axes[2:])
            opts.append((s, MeshAxis("stage", s, a0.bandwidth), inner))
    return opts


def _price_stage(sub: Graph, inner_axes: Sequence[MeshAxis],
                 per_axis: Sequence[Assignment],
                 crossing: Sequence[str], full_tensors: Dict[str, object],
                 stage_bw: float, inner_degree: int, mem_scale: float,
                 peak_flops: float
                 ) -> Tuple[float, float, float, Dict[str, float]]:
    """The single pricing source for a stage (DP, reporting, reprice and
    the brute-force oracle all call this): walk the k-cut recursion over
    the inner axes summing conversion seconds, and accumulate each
    inbound tensor's boundary wire bytes by the exact per-axis
    decomposition (costterms.BoundaryTransferTerm docstring) — base
    ``mult × nbytes`` plus ``mult × s_k × groups_k × (a_k − 1)`` per
    inner axis where it is not partitioned.  Tensors crossing the cut
    but untouched by this stage (pass-throughs) stay at the optimistic
    fully-sharded base."""
    from .cost import graph_flops
    from .tiling import Part

    wire = {t: _boundary_mult(full_tensors[t]) * full_tensors[t].nbytes
            for t in crossing}
    comm_s = 0.0
    cur = sub
    groups = 1
    for ax, assign in zip(inner_axes, per_axis):
        comm_s += graph_cost(cur, assign, ax.size, mem_scale=mem_scale) \
            / (ax.bandwidth * max(1, ax.size))
        for t in crossing:
            ts = cur.tensors.get(t)
            if ts is None:
                continue
            if not isinstance(assign.get(t, REPLICATE), Part):
                wire[t] += _boundary_mult(ts) * ts.nbytes * groups \
                    * (ax.size - 1)
        cur = cur.divided(assign, ax.size)
        groups *= ax.size
    boundary_s = sum(wire.values()) / (stage_bw * max(1, inner_degree))
    compute_s = graph_flops(sub) / (peak_flops * max(1, inner_degree))
    return comm_s, compute_s, boundary_s, wire


def _solve_stage(g: Graph, blocks, spans, lo: int, hi: int,
                 inner_axes: Sequence[MeshAxis], stage_bw: float,
                 inner_degree: int, mem_scale: float, peak_flops: float,
                 beam: BeamSpec, cost_cache: Optional[dict]
                 ) -> StageSolution:
    """Solve one candidate stage: per-inner-axis one-cut DPs with the
    boundary-transfer term injected at the exact exchange rate, then
    price the result through _price_stage."""
    from .costterms import BoundaryTransferTerm

    sub = stage_subgraph(g, blocks, lo, hi)
    crossing = crossing_tensors(spans, lo) if lo > 0 else []
    cur = sub
    groups = 1
    per_axis: List[Assignment] = []
    exact = True
    for ax in inner_axes:
        denom = stage_bw * max(1, inner_degree)
        weights = {
            t: _boundary_mult(g.tensors[t]) * groups * ax.bandwidth
            * ax.size / denom
            for t in crossing if t in cur.tensors
        }
        terms = (BoundaryTransferTerm(weights),) if weights else ()
        sol = solve_one_cut(cur, ax.size, beam=beam, mem_scale=mem_scale,
                            cost_cache=cost_cache, terms=terms)
        exact = exact and sol.exact
        per_axis.append(sol.assignment)
        cur = cur.divided(sol.assignment, ax.size)
        groups *= ax.size
    comm_s, compute_s, boundary_s, wire = _price_stage(
        sub, inner_axes, per_axis, crossing, g.tensors, stage_bw,
        inner_degree, mem_scale, peak_flops)
    return StageSolution(lo, hi, sub, per_axis, list(crossing), comm_s,
                         compute_s, boundary_s, wire, exact)


def solve_pipeline(g: Graph, axes: Sequence[MeshAxis], *,
                   n_micro: int = 8,
                   stage_counts: Optional[Sequence[int]] = None,
                   beam: BeamSpec = "auto",
                   mem_scale: float = 1.0,
                   peak_flops: float = DEFAULT_PEAK_FLOPS,
                   cost_cache: Optional[dict] = None) -> PipelineSolution:
    with _span("solver.pipeline_dp", n_micro=n_micro) as sp:
        sol = _solve_pipeline(g, axes, n_micro=n_micro,
                              stage_counts=stage_counts, beam=beam,
                              mem_scale=mem_scale,
                              peak_flops=peak_flops,
                              cost_cache=cost_cache)
        sp.set(n_stages=sol.n_stages)
        return sol


def _solve_pipeline(g: Graph, axes: Sequence[MeshAxis], *,
                    n_micro: int = 8,
                    stage_counts: Optional[Sequence[int]] = None,
                    beam: BeamSpec = "auto",
                    mem_scale: float = 1.0,
                    peak_flops: float = DEFAULT_PEAK_FLOPS,
                    cost_cache: Optional[dict] = None) -> PipelineSolution:
    """Jointly choose pipeline stage cuts AND per-stage tilings.

    For every candidate stage count S (1 plus divisor-carvings of the
    slowest axes, optionally filtered by ``stage_counts``) an exact
    interval min-max DP places S-1 cuts between layer blocks; each
    interval's time comes from the boundary-term-aware one-cut solve of
    its subgraph.  S=1 is the flat solve — the pipelined search can only
    return something it prices better than the best flat tiling."""
    from .costterms import BubbleTerm

    blocks = layer_blocks(g)
    spans = _block_spans(g, blocks)
    n_blocks = len(blocks)
    if cost_cache is None:
        cost_cache = {}

    best: Optional[PipelineSolution] = None
    candidates: Dict[int, float] = {}
    for n_stages, stage_ax, inner_axes in pipeline_stage_options(axes):
        if stage_counts is not None and n_stages not in stage_counts:
            continue
        if n_stages > n_blocks:
            continue
        inner_degree = 1
        for ax in inner_axes:
            inner_degree *= ax.size
        stage_bw = stage_ax.bandwidth if stage_ax else (
            axes[0].bandwidth if axes else 0.0)
        bubble = BubbleTerm(n_micro).factor(n_stages)
        # per-candidate cache: stage time depends only on (lo, hi)
        memo: Dict[Tuple[int, int], StageSolution] = {}

        def stage(lo: int, hi: int) -> StageSolution:
            st = memo.get((lo, hi))
            if st is None:
                st = _solve_stage(g, blocks, spans, lo, hi, inner_axes,
                                  stage_bw, inner_degree, mem_scale,
                                  peak_flops, beam, cost_cache)
                memo[(lo, hi)] = st
            return st

        if n_stages == 1:
            stages = [stage(0, n_blocks)]
            total = stages[0].seconds
        else:
            inf = float("inf")
            # dp[s][j]: best max-stage-time covering blocks [0, j) with s
            # stages; parent[s][j] the minimizing previous boundary
            dp = [[inf] * (n_blocks + 1) for _ in range(n_stages + 1)]
            parent = [[-1] * (n_blocks + 1) for _ in range(n_stages + 1)]
            dp[0][0] = 0.0
            for s in range(1, n_stages + 1):
                for j in range(s, n_blocks - (n_stages - s) + 1):
                    for i in range(s - 1, j):
                        if dp[s - 1][i] == inf:
                            continue
                        v = max(dp[s - 1][i], stage(i, j).seconds)
                        if v < dp[s][j]:
                            dp[s][j] = v
                            parent[s][j] = i
            if dp[n_stages][n_blocks] == inf:
                continue
            cuts = [n_blocks]
            for s in range(n_stages, 0, -1):
                cuts.append(parent[s][cuts[-1]])
            cuts.reverse()
            stages = [stage(lo, hi)
                      for lo, hi in zip(cuts[:-1], cuts[1:])]
            total = bubble * max(st.seconds for st in stages)
        candidates[n_stages] = total
        if best is None or total < best.total_seconds:
            best = PipelineSolution(
                list(axes), n_micro, n_stages, stage_ax,
                list(inner_axes), stages, bubble, total, candidates,
                mem_scale, peak_flops,
                all(st.exact for st in stages))
    assert best is not None, "no pipeline candidate (empty mesh?)"
    best.candidates = candidates
    return best


def reprice_pipeline(g: Graph, psol: PipelineSolution) -> float:
    """Recompute a PipelineSolution's total from its stored cuts and
    assignments via _price_stage — the repricing invariant pinned by
    verify/fuzz.py (solve == reprice == oracle)."""
    blocks = layer_blocks(g)
    spans = _block_spans(g, blocks)
    inner_degree = 1
    for ax in psol.inner_axes:
        inner_degree *= ax.size
    stage_bw = psol.stage_axis.bandwidth if psol.stage_axis else (
        psol.axes[0].bandwidth if psol.axes else 0.0)
    worst = 0.0
    for st in psol.stages:
        sub = stage_subgraph(g, blocks, st.lo, st.hi)
        crossing = crossing_tensors(spans, st.lo) if st.lo > 0 else []
        comm_s, compute_s, boundary_s, _ = _price_stage(
            sub, psol.inner_axes, st.per_axis, crossing, g.tensors,
            stage_bw, inner_degree, psol.mem_scale, psol.peak_flops)
        worst = max(worst, comm_s + compute_s + boundary_s)
    return psol.bubble_factor * worst


def pipeline_brute_combo_count(g: Graph, axes: Sequence[MeshAxis],
                               stage_counts: Optional[Sequence[int]] = None
                               ) -> int:
    """Cost estimate for the oracle: Σ over candidates and stage ranges
    of the stage subgraph's full assignment product."""
    from .cost import tensor_tiling_choices
    blocks = layer_blocks(g)
    n_blocks = len(blocks)
    total = 0
    for n_stages, _stage_ax, inner_axes in pipeline_stage_options(axes):
        if stage_counts is not None and n_stages not in stage_counts:
            continue
        if n_stages > n_blocks:
            continue
        for lo in range(n_blocks):
            for hi in range(lo + 1, n_blocks + 1):
                sub = stage_subgraph(g, blocks, lo, hi)
                for ax in inner_axes:
                    combos = 1
                    for t in sub.tensors:
                        combos *= len(tensor_tiling_choices(sub, t,
                                                            ax.size))
                    total += combos
    return total


def solve_pipeline_bruteforce(g: Graph, axes: Sequence[MeshAxis], *,
                              n_micro: int = 8,
                              stage_counts: Optional[Sequence[int]] = None,
                              mem_scale: float = 1.0,
                              peak_flops: float = DEFAULT_PEAK_FLOPS
                              ) -> PipelineSolution:
    """Exhaustive oracle over (cut set × per-stage tiling): for every
    candidate stage count and every cut placement, enumerate each stage's
    full tiling assignment and price it through the same _price_stage as
    the DP.  Stages are independent under the min-max objective (boundary
    bytes are charged to the consumer), so the per-stage minimum is taken
    before the max over stages — identical optimum to enumerating full
    cross products, without the cross-product blowup.  Exact only for a
    single-axis mesh (multi-axis inner solves are the same greedy chain
    as solve_mesh, which the oracle cannot enumerate); rejects wider
    meshes."""
    with _span("solver.pipeline_oracle", n_micro=n_micro):
        return _solve_pipeline_bruteforce(
            g, axes, n_micro=n_micro, stage_counts=stage_counts,
            mem_scale=mem_scale, peak_flops=peak_flops)


def _solve_pipeline_bruteforce(g: Graph, axes: Sequence[MeshAxis], *,
                               n_micro: int = 8,
                               stage_counts: Optional[Sequence[int]] = None,
                               mem_scale: float = 1.0,
                               peak_flops: float = DEFAULT_PEAK_FLOPS
                               ) -> PipelineSolution:
    from .costterms import BubbleTerm

    for _n, _sa, inner_axes in pipeline_stage_options(axes):
        if len(inner_axes) > 1:
            raise ValueError("pipeline oracle supports single-axis meshes")
    blocks = layer_blocks(g)
    spans = _block_spans(g, blocks)
    n_blocks = len(blocks)

    best: Optional[PipelineSolution] = None
    candidates: Dict[int, float] = {}
    for n_stages, stage_ax, inner_axes in pipeline_stage_options(axes):
        if stage_counts is not None and n_stages not in stage_counts:
            continue
        if n_stages > n_blocks:
            continue
        inner_degree = 1
        for ax in inner_axes:
            inner_degree *= ax.size
        stage_bw = stage_ax.bandwidth if stage_ax else (
            axes[0].bandwidth if axes else 0.0)
        bubble = BubbleTerm(n_micro).factor(n_stages)

        memo: Dict[Tuple[int, int], StageSolution] = {}

        def stage_best(lo: int, hi: int) -> StageSolution:
            st = memo.get((lo, hi))
            if st is not None:
                return st
            sub = stage_subgraph(g, blocks, lo, hi)
            crossing = crossing_tensors(spans, lo) if lo > 0 else []
            names = list(sub.tensors)
            choice_lists = [tensor_tiling_choices(sub, t, ax.size)
                            for ax in inner_axes for t in names]
            best_st: Optional[StageSolution] = None
            if not inner_axes:
                combos = [()]
            else:
                combos = itertools.product(
                    *(tensor_tiling_choices(sub, t, inner_axes[0].size)
                      for t in names))
            del choice_lists
            for combo in combos:
                per_axis = [dict(zip(names, combo))] if inner_axes else []
                comm_s, compute_s, boundary_s, wire = _price_stage(
                    sub, inner_axes, per_axis, crossing, g.tensors,
                    stage_bw, inner_degree, mem_scale, peak_flops)
                cand = StageSolution(lo, hi, sub, per_axis,
                                     list(crossing), comm_s, compute_s,
                                     boundary_s, wire)
                if best_st is None or cand.seconds < best_st.seconds:
                    best_st = cand
            assert best_st is not None
            memo[(lo, hi)] = best_st
            return best_st

        for cut_mid in itertools.combinations(range(1, n_blocks),
                                              n_stages - 1):
            cuts = (0,) + cut_mid + (n_blocks,)
            stages = [stage_best(lo, hi)
                      for lo, hi in zip(cuts[:-1], cuts[1:])]
            total = bubble * max(st.seconds for st in stages)
            if n_stages not in candidates or total < candidates[n_stages]:
                candidates[n_stages] = total
            if best is None or total < best.total_seconds:
                best = PipelineSolution(
                    list(axes), n_micro, n_stages, stage_ax,
                    list(inner_axes), stages, bubble, total, candidates,
                    mem_scale, peak_flops, True)
    assert best is not None
    best.candidates = candidates
    return best


def pipeline_breakdown(g: Graph, psol: PipelineSolution
                       ) -> Dict[str, object]:
    """solution_breakdown grown per-stage: each stage's intra-stage byte
    attribution (by_kind / by_role / by_axis / by_phase over its subgraph
    and inner axes) plus per-boundary-edge wire-byte attribution — the
    numbers the verify pipeline cell gates measured stage-boundary bytes
    against."""
    stages = []
    boundaries = []
    for i, st in enumerate(psol.stages):
        bd = solution_breakdown(st.graph, psol.inner_axes, st.per_axis)
        bd.update({
            "stage": i, "blocks": [st.lo, st.hi],
            "comm_seconds": st.comm_seconds,
            "compute_seconds": st.compute_seconds,
            "boundary_seconds": st.boundary_seconds,
        })
        stages.append(bd)
        if i > 0:
            boundaries.append({
                "edge": [i - 1, i],
                "tensors": dict(st.boundary_bytes),
                "wire_bytes_total": st.boundary_bytes_total,
                "seconds": st.boundary_seconds,
            })
    return {
        "n_stages": psol.n_stages,
        "n_micro": psol.n_micro,
        "bubble_factor": psol.bubble_factor,
        "total_seconds": psol.total_seconds,
        "candidates": {str(k): v for k, v in psol.candidates.items()},
        "stages": stages,
        "boundaries": boundaries,
        "intra_stage_wire_bytes_total": sum(b["total"] for b in stages),
        "boundary_wire_bytes_total": sum(b["wire_bytes_total"]
                                         for b in boundaries),
    }
