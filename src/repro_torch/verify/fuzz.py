"""Randomized semantic-graph fuzzing of the tiling solver (the port's
``repro.verify.fuzz``).

Generates small random graphs (random einsum-like ops over named dims,
random dim sizes, occasional weights/reductions) and asserts the solver
invariants that must hold on *every* graph:

  oracle       solve_one_cut cost == solve_one_cut_bruteforce cost
               (exhaustive enumeration is the optimality oracle)
  permutation  renaming dims/tensors, shuffling tensor insertion order
               and swapping einsum operands never changes the optimum
  replication  the all-REPLICATE assignment is always feasible (finite
               cost) and never beats the solver
  execution    a solved plan, forced onto the ranks of a real device
               mesh as DTensor placements, computes the same numbers as
               the serial program (executor.py)
  trace        the graph's torch program (the executor's semantics) is
               captured back through the trace frontend (repro_torch.trace)
               and re-solved: its one-cut optimum is at most the
               original's (capture only relaxes the problem)
  autoshard    ``autoshard`` of that program on the execution mesh
               computes the serial interpreter's numbers
  pipeline     the joint stage-cut x per-stage-tiling solve (every op
               tagged as its own layer block) reprices to its own cost
               and equals the brute-force (cut set x tiling) oracle

The Python ``random`` stream is consumed exactly as repro's, so a seed
draws repro's graphs.  Plain ``random.Random`` generation: no hypothesis
needed.  torch comes in only with the execution and trace legs.
"""
from __future__ import annotations

import dataclasses
import random
import string
from typing import Dict, List, Optional

from ..core.cost import graph_cost
from ..core.graph import Graph
from ..core.solver import (MeshAxis, pipeline_brute_combo_count,
                           reprice_pipeline, solve_mesh, solve_one_cut,
                           solve_one_cut_bruteforce, solve_pipeline,
                           solve_pipeline_bruteforce)
from ..core.tiling import REPLICATE

_DIM_SIZES = (2, 4, 8)
_MAX_BRUTE_COMBOS = 200_000
# f32 end-to-end execution band, shared by the fuzz exec invariants
EXEC_ATOL = 2e-4


def random_graph(rng: random.Random, min_ops: int = 2,
                 max_ops: int = 5) -> Graph:
    """Small random semantic graph: a chain of einsum / ewise / reduce
    ops over 2-3-dim tensors with named dims sized in {2,4,8}."""
    g = Graph(f"fuzz{rng.randrange(1 << 30)}")
    names = iter(string.ascii_lowercase)
    sizes: Dict[str, int] = {}

    def new_dim() -> str:
        d = f"d{next(names)}"
        sizes[d] = rng.choice(_DIM_SIZES)
        return d

    def add(name, dims, kind="activation", role=None):
        g.tensor(name, dims, tuple(sizes[d] for d in dims),
                 bytes_per_elem=4.0, kind=kind, role=role)
        return name

    n_dims = rng.randint(2, 3)
    x_dims = tuple(new_dim() for _ in range(n_dims))
    x = add("x0", x_dims, kind="input")
    acts: List[str] = [x]
    n_ops = rng.randint(min_ops, max_ops)
    for i in range(n_ops):
        src = rng.choice(acts)
        sdims = g.tensors[src].dims
        op_kind = rng.choice(["einsum", "einsum", "einsum", "ewise",
                              "reduce"])
        if op_kind == "reduce" and len(sdims) < 2:
            op_kind = "ewise"
        if op_kind == "einsum":
            c = rng.choice(sdims)              # contraction dim
            n = new_dim()                      # fresh output dim
            wdims = (c, n)
            if len(sdims) > 1 and rng.random() < 0.3:
                b = rng.choice([d for d in sdims if d != c])
                wdims = (b, c, n)              # batched einsum
            w = add(f"w{i}", wdims, kind="weight", role=f"w{i}")
            out = add(f"t{i}", tuple(n if d == c else d for d in sdims))
            if rng.random() < 0.5:
                g.einsum(f"mm{i}", src, w, out)
            else:
                g.einsum(f"mm{i}", w, src, out)
        elif op_kind == "ewise":
            ins = [src]
            if rng.random() < 0.5:
                # broadcast partner over a dim subset of src
                keep = [d for d in sdims if rng.random() < 0.7] or \
                    [sdims[0]]
                ins.append(add(f"b{i}", tuple(keep), kind="input"))
            out = add(f"t{i}", sdims)
            align = None
            if rng.random() < 0.3:
                align = tuple(d for d in sdims if rng.random() < 0.7) \
                    or (sdims[0],)
            g.ewise(f"ew{i}", tuple(ins), out, align_dims=align)
        else:  # reduce
            axis = rng.choice(sdims)
            out = add(f"t{i}", tuple(d for d in sdims if d != axis))
            g.reduce(f"rd{i}", src, out, axis=axis)
        acts.append(out)
    return g


def brute_combo_count(g: Graph, arity: int) -> int:
    from ..core.cost import tensor_tiling_choices
    n = 1
    for t in g.tensors:
        n *= len(tensor_tiling_choices(g, t, arity))
    return n


def permuted_clone(g: Graph, rng: random.Random) -> Graph:
    """Isomorphic copy: dims and tensors renamed, tensor insertion order
    shuffled (op order kept — it is already topological).  The solver
    optimum must be identical on it."""
    dim_map = {}
    for ts in g.tensors.values():
        for d in ts.dims:
            if d not in dim_map:
                dim_map[d] = f"p{len(dim_map)}_{d}"
    name_map = {t: f"perm_{t}" for t in g.tensors}

    g2 = Graph(g.name + ":perm", g.allow_uneven)
    order = list(g.tensors)
    rng.shuffle(order)
    for t in order:
        ts = g.tensors[t]
        g2.tensor(name_map[t], tuple(dim_map[d] for d in ts.dims),
                  ts.shape, ts.bytes_per_elem, ts.kind, ts.role,
                  {dim_map[d]: u for d, u in ts.units.items()})
    for op in g.ops:
        ins = tuple(name_map[t] for t in op.inputs)
        out = name_map[op.output]
        if op.kind == "einsum":
            g2.einsum(op.name, ins[0], ins[1], out, op.repeat)
        elif op.kind == "ewise":
            wl = op.attrs.get("align_dims")
            g2.ewise(op.name, ins, out, op.repeat,
                     align_dims=None if wl is None else
                     tuple(dim_map[d] for d in wl),
                     update=bool(op.attrs.get("update")))
        elif op.kind == "reduce":
            g2.reduce(op.name, ins[0], out,
                      axis=dim_map[op.attrs["axis"]], repeat=op.repeat)
        else:
            raise NotImplementedError(op.kind)
    return g2


@dataclasses.dataclass
class FuzzResult:
    n: int
    arities: List[int]
    oracle_checked: int = 0
    pipeline_checked: int = 0
    pipeline_oracle_checked: int = 0
    permutation_checked: int = 0
    exec_checked: int = 0
    # einsums of the execution leg that DTensor refused to flatten (torch
    # 2.11), run sharded by executor.local_einsum
    exec_local_einsums: int = 0
    trace_checked: int = 0
    trace_exec_checked: int = 0
    compute_checked: int = 0
    skipped_too_big: int = 0
    failures: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures

    def to_dict(self) -> dict:
        return dataclasses.asdict(self) | {"ok": self.ok}


def _check_exec(g: Graph, seed: int, result: FuzzResult, exec_mesh,
                atol: float) -> None:
    """Sharded-vs-serial execution of the solved plan on ``exec_mesh``,
    leaf values from ``seed``."""
    import numpy as np

    from . import executor

    msol = solve_mesh(g, [MeshAxis(exec_mesh.mesh_dim_names[0],
                                   exec_mesh.size())])
    plan = executor.tensor_plan(g, msol)
    vals = executor.random_values(g, seed=seed)
    serial = executor.execute(g, vals)
    stats = {}
    sharded = executor.execute_sharded(g, vals, plan, exec_mesh,
                                       stats=stats)
    result.exec_checked += 1
    result.exec_local_einsums += stats["local_einsums"]
    for t, v in sharded.items():
        ref = serial[t].numpy()
        if not isinstance(v, np.ndarray):
            result.failures.append(
                f"{g.name}@mesh: sharded {t} came back as {type(v)}")
            continue
        got = v.astype(np.float32)
        err = float(np.max(np.abs(ref - got))) if ref.size else 0.0
        scale = float(np.max(np.abs(ref))) if ref.size else 0.0
        if err > atol * max(1.0, scale):
            result.failures.append(
                f"{g.name}@mesh: sharded {t} differs by {err} "
                f"(scale {scale})")


def program(g: Graph):
    """The graph's torch program (repro's ``gen_fn``): leaf values {name:
    tensor} -> the sink tensors' values, by the executor's semantics; an
    einsum of DTensors that DTensor refuses to flatten runs as each
    rank's local einsum (``executor.sharded_einsum``)."""
    from . import executor
    sinks = executor.sink_tensors(g)

    def gen_fn(vals):
        full = executor.execute(g, dict(vals),
                                einsum=executor.sharded_einsum)
        return {t: full[t] for t in sinks}
    return gen_fn


def _check_trace(g: Graph, arity: int, result: FuzzResult):
    """Trace round-trip: capture the graph's program back and re-solve.
    Capture can only *relax* the problem (no align whitelists, REDUCED
    forms available), so the captured optimum must never exceed the
    original one — equality in the typical case.  Penalties are off on
    both sides: they depend on tensor kinds (weight/opt) that a traced
    program does not carry.  Returns the capture."""
    import torch

    from . import executor
    from ..trace import capture

    meta = {t: torch.empty(tuple(g.tensors[t].shape), device="meta")
            for t in executor.leaf_tensors(g)}
    traced = capture(program(g), meta, name=g.name)
    c0 = solve_one_cut(g, arity, beam="auto", mem_scale=0.0).cost
    c1 = solve_one_cut(traced.graph, arity, beam="auto",
                       mem_scale=0.0).cost
    result.trace_checked += 1
    if c1 > c0 * (1.0 + 1e-9) + 1.0:
        result.failures.append(
            f"{g.name}@{arity}: trace round-trip solved to {c1} > "
            f"original {c0}")
    return traced


def _check_autoshard(g: Graph, seed: int, result: FuzzResult, exec_mesh,
                     atol: float) -> None:
    """``autoshard`` of the graph's program on ``exec_mesh`` (solved on
    the mesh, leaves placed as DTensors, run) against the serial
    interpreter on the execution leg's values."""
    import numpy as np
    import torch

    from . import executor
    from ..trace import autoshard
    from .numerics import mesh_device

    vals = executor.random_values(g, seed=seed)
    serial = executor.execute(g, vals)
    dev = mesh_device(exec_mesh)
    placed = {t: torch.as_tensor(v).to(dev) for t, v in vals.items()}
    ash = autoshard(program(g), exec_mesh, placed, name=g.name,
                    mem_scale=0.0)
    auto = ash(placed)
    result.trace_exec_checked += 1
    for t in executor.sink_tensors(g):
        ref = serial[t].numpy()
        got = auto[t].full_tensor().cpu().numpy().astype(np.float32)
        err = float(np.max(np.abs(ref - got))) if ref.size else 0.0
        scale = float(np.max(np.abs(ref))) if ref.size else 0.0
        if err > atol * max(1.0, scale):
            result.failures.append(
                f"{g.name}@mesh: autoshard {t} differs by {err} "
                f"(scale {scale})")


# the invariants of one graph, in the order check_graph runs them (the
# oracle leg holds the replication, pricing, oracle and permutation
# checks; the exec leg the sharded execution and autoshard);
# run_fuzz(share=True) shares them out over ranks
LEGS = ("oracle", "compute", "trace", "exec", "pipeline")


def check_graph(g: Graph, arity: int, rng: random.Random,
                result: FuzzResult, exec_mesh=None,
                atol: float = EXEC_ATOL, legs=LEGS,
                exec_result: Optional[FuzzResult] = None) -> None:
    """Run the invariants ``legs`` on one graph; append failures to
    ``result`` (the execution leg's to ``exec_result`` when given).
    ``exec_mesh``: a 1-D DeviceMesh whose every rank calls this with the
    same graph (the execution leg's collectives).  Whatever ``legs``
    holds, ``rng`` gives what the whole check draws from it."""
    rel = 1e-9

    def close(a, b):
        return abs(a - b) <= rel * max(abs(a), abs(b), 1.0)

    # replication always feasible
    repl = graph_cost(g, {t: REPLICATE for t in g.tensors}, arity,
                      mem_scale=1.0)
    if repl == float("inf"):
        if "oracle" in legs:
            result.failures.append(
                f"{g.name}@{arity}: replication infeasible")
        return

    if "oracle" in legs or "compute" in legs:
        sol = solve_one_cut(g, arity, beam="auto")
    if "oracle" in legs:
        if not (0.0 <= sol.cost <= repl + 1e-9):
            result.failures.append(
                f"{g.name}@{arity}: solver cost {sol.cost} outside "
                f"[0, replication={repl}]")

        # the returned assignment must price to the returned cost
        priced = graph_cost(g, sol.assignment, arity, mem_scale=1.0)
        if not close(priced, sol.cost):
            result.failures.append(
                f"{g.name}@{arity}: assignment prices to {priced}, "
                f"solver said {sol.cost}")

        # brute-force oracle
        if brute_combo_count(g, arity) <= _MAX_BRUTE_COMBOS:
            oracle = solve_one_cut_bruteforce(g, arity, workers=0)
            result.oracle_checked += 1
            if not close(sol.cost, oracle.cost):
                result.failures.append(
                    f"{g.name}@{arity}: solver {sol.cost} != oracle "
                    f"{oracle.cost}")
        else:
            result.skipped_too_big += 1

    if "compute" in legs:
        # kernel-aware compute term: solve == reprice == oracle must also
        # hold with the ComputeTerm charged next to the conversion tables
        # (its penalties are >= 0, so dominance pruning stays sound)
        from ..core.costterms import ComputeConfig
        cterm = ComputeConfig(peak_flops=1e12).term_for_axis(50e9, arity)
        csol = solve_one_cut(g, arity, beam="auto", terms=[cterm])
        cpriced = graph_cost(g, csol.assignment, arity, mem_scale=1.0,
                             terms=[cterm])
        result.compute_checked += 1
        if not close(cpriced, csol.cost):
            result.failures.append(
                f"{g.name}@{arity}: compute-term assignment prices to "
                f"{cpriced}, solver said {csol.cost}")
        if csol.cost < sol.cost - 1e-9 * max(1.0, sol.cost):
            result.failures.append(
                f"{g.name}@{arity}: adding a >=0 compute term lowered the "
                f"optimum {sol.cost} -> {csol.cost}")
        if brute_combo_count(g, arity) <= _MAX_BRUTE_COMBOS:
            coracle = solve_one_cut_bruteforce(g, arity, workers=0,
                                               terms=[cterm])
            if not close(csol.cost, coracle.cost):
                result.failures.append(
                    f"{g.name}@{arity}: compute-term solver {csol.cost} != "
                    f"oracle {coracle.cost}")

    # permutation invariance (the clone is drawn whatever the legs)
    g2 = permuted_clone(g, rng)
    if "oracle" in legs:
        sol2 = solve_one_cut(g2, arity, beam="auto")
        result.permutation_checked += 1
        if not close(sol.cost, sol2.cost):
            result.failures.append(
                f"{g.name}@{arity}: permuted clone cost {sol2.cost} != "
                f"{sol.cost}")

    if "trace" in legs:
        _check_trace(g, arity, result)

    # sharded-vs-serial execution of the solved plan, then of autoshard
    # (its seed is drawn whatever the legs)
    if exec_mesh is not None:
        seed = rng.randrange(1 << 30)
        if "exec" in legs and exec_mesh.get_coordinate() is not None:
            _check_exec(g, seed, exec_result or result, exec_mesh, atol)
            _check_autoshard(g, seed, exec_result or result, exec_mesh,
                             atol)

    if "pipeline" not in legs:
        return
    # pipelined solve: solve == reprice == oracle.  Tag every op as its
    # own layer block (mutates g — keep this invariant LAST) and run the
    # joint stage-cut + tiling search on a single size-4 axis, where the
    # brute-force (cut set x per-stage tiling) enumeration is exact.
    def close_rel(a, b):
        return abs(a - b) <= 1e-9 * max(abs(a), abs(b)) + 1e-18

    for i, op in enumerate(g.ops):
        op.attrs["group"] = i
    paxes = [MeshAxis("s0", 4, 1e9)]
    pkw = dict(n_micro=3, mem_scale=1.0, peak_flops=1e12)
    psol = solve_pipeline(g, paxes, **pkw)
    result.pipeline_checked += 1
    rp = reprice_pipeline(g, psol)
    if not close_rel(psol.total_seconds, rp):
        result.failures.append(
            f"{g.name}@pipe: reprice {rp} != solve {psol.total_seconds}")
    if pipeline_brute_combo_count(g, paxes) <= _MAX_BRUTE_COMBOS:
        poracle = solve_pipeline_bruteforce(g, paxes, **pkw)
        result.pipeline_oracle_checked += 1
        for s, v in poracle.candidates.items():
            got = psol.candidates.get(s, float("inf"))
            if not close_rel(got, v):
                result.failures.append(
                    f"{g.name}@pipe: S={s} solver {got} != oracle {v}")


def run_fuzz(n: int, seed: int = 0, arities=(2, 4),
             exec_mesh=None, exec_every: int = 10,
             share: bool = False) -> FuzzResult:
    """Fuzz ``n`` random graphs.  ``exec_mesh``: a 1-D DeviceMesh for the
    execution invariant (every rank of it runs this with the same
    arguments), exercised on every ``exec_every``-th graph.

    ``share``: every rank of the default process group runs this with the
    same arguments (the same ``exec_mesh``, which may leave ranks out)
    and the graphs' legs are shared out: leg k of graph i (oracle,
    compute, pipeline, trace) on rank (4 i + k) % world, an execution leg
    (with its autoshard) on every rank of ``exec_mesh``, counted on its
    first.  Every rank draws
    every graph, so the random stream is repro's, and every rank returns
    the whole run's result (graphs in order)."""
    rank, world = 0, 1
    if share:
        import torch.distributed as dist
        rank, world = dist.get_rank(), dist.get_world_size()
    shared = ("oracle", "compute", "pipeline", "trace")
    rng = random.Random(seed)
    parts = []
    for i in range(n):
        g = random_graph(rng)
        arity = arities[i % len(arities)]
        mesh = exec_mesh if (exec_mesh is not None
                             and i % exec_every == 0) else None
        legs = [leg for k, leg in enumerate(shared)
                if (len(shared) * i + k) % world == rank]
        counted = mesh is not None and rank == int(mesh.mesh.min())
        part = FuzzResult(n=0, arities=[])
        try:
            check_graph(g, arity, rng, part, exec_mesh=mesh,
                        legs=legs + ["exec"],
                        exec_result=None if counted or not share
                        else FuzzResult(n=0, arities=[]))
        except Exception as e:  # invariant machinery itself blew up
            part.failures.append(f"{g.name}@{arity}: exception {e!r}")
        parts.append((i, part))
    if share:
        import torch.distributed as dist
        gathered = [None] * world
        dist.all_gather_object(gathered, parts)
        parts = sorted((p for ps in gathered for p in ps),
                       key=lambda p: p[0])
    result = FuzzResult(n=n, arities=list(arities))
    for _, part in parts:
        for f in dataclasses.fields(FuzzResult):
            if f.type == "int" and f.name != "n":
                setattr(result, f.name,
                        getattr(result, f.name) + getattr(part, f.name))
        result.failures += part.failures
    return result
