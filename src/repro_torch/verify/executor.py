"""Reference interpreter for semantic graphs (core/graph.py), serial and
sharded (the port's ``repro.verify.executor``).

Gives every op kind a concrete (linear, deterministic) semantics so a
graph is a runnable einsum program:

  einsum   out = torch.einsum over the named dims (classes fall out of
           name identity, exactly as cost.py classifies them)
  ewise    out = Σ inputs, each input first sum-reduced over dims absent
           from the output, then broadcast-aligned to the output dims
  reduce   out = input summed over attrs["axis"]
  custom   not executable (builder-specific black box) — reject

The sharded path materialises a solved plan: leaf tensors are placed as
DTensors under the placements of the ``ShardingPlan``'s PartitionSpec
for their own name (fuzz plans use tensor names as roles), and every op
output is redistributed to its own planned placements (left as it is
where DTensor cannot, as repro's ``with_sharding_constraint`` hook does).
An einsum that DTensor refuses to propagate (torch 2.11 will not flatten
dims of which one but the first is cut, as einsum's batched product
does) runs as each rank's local einsum (:func:`local_einsum`), so it
stays sharded.  Serial vs sharded outputs agreeing is the execution leg
of the fuzz invariants.  torch is imported inside the functions.
"""
from __future__ import annotations

import string
from typing import Dict, List, Optional

import numpy as np

from ..core.graph import Graph
from ..core.plan import ShardingPlan


def leaf_tensors(g: Graph) -> List[str]:
    """Tensors never produced by an op (the program's inputs/weights)."""
    produced = {op.output for op in g.ops}
    return [t for t in g.tensors if t not in produced]


def sink_tensors(g: Graph) -> List[str]:
    """Tensors produced but never consumed (the program's outputs)."""
    produced = {op.output for op in g.ops}
    consumed = {t for op in g.ops for t in op.inputs}
    return sorted(produced - consumed)


def random_values(g: Graph, seed: int = 0) -> Dict[str, np.ndarray]:
    """f32 leaf values drawn with numpy, deterministic in ``seed``
    (executor math runs in f32 regardless of the cost model's
    bytes_per_elem)."""
    rng = np.random.default_rng(seed)
    return {name: rng.standard_normal(tuple(g.tensors[name].shape)
                                      ).astype(np.float32)
            for name in leaf_tensors(g)}


def _dim_letters(g: Graph) -> Dict[str, str]:
    """One einsum letter per distinct dim name in the graph."""
    letters: Dict[str, str] = {}
    pool = iter(string.ascii_letters)
    for ts in g.tensors.values():
        for d in ts.dims:
            if d not in letters:
                letters[d] = next(pool)
    return letters


def execute(g: Graph, values: Dict[str, object],
            constrain=None, einsum=None) -> Dict[str, object]:
    """Run ops in graph order; returns all tensor values (inputs
    included) as torch tensors.  ``values`` (numpy arrays or tensors)
    must cover :func:`leaf_tensors`.  ``constrain(name, value)``:
    optional hook applied to every op output (the sharded path forces
    each tensor's planned placements there).  ``einsum(sub, *xs)``:
    optional hook that computes every einsum, ``torch.einsum`` by
    default."""
    import torch

    let = _dim_letters(g)
    vals = {k: torch.as_tensor(v) for k, v in values.items()}
    einsum = einsum or torch.einsum

    def align_to(x, src_dims, dst_dims):
        # sum out dims missing from dst, then broadcast-align to dst
        keep = [d for d in src_dims if d in dst_dims]
        sub = f"{''.join(let[d] for d in src_dims)}->" \
              f"{''.join(let[d] for d in keep)}"
        x = einsum(sub, x)
        expand = f"{''.join(let[d] for d in keep)}->" \
                 f"{''.join(let[d] for d in dst_dims if d in keep)}"
        x = einsum(expand, x)
        # insert singleton axes for dst dims the input lacks
        shape = [1] * len(dst_dims)
        it = iter(x.shape)
        for i, d in enumerate(dst_dims):
            if d in keep:
                shape[i] = next(it)
        return x.reshape(shape)

    for op in g.ops:
        ins = [vals[t] for t in op.inputs]
        out_ts = g.tensors[op.output]
        if op.kind == "einsum":
            lhs, rhs = (g.tensors[t] for t in op.inputs)
            sub = (f"{''.join(let[d] for d in lhs.dims)},"
                   f"{''.join(let[d] for d in rhs.dims)}->"
                   f"{''.join(let[d] for d in out_ts.dims)}")
            vals[op.output] = einsum(sub, *ins)
        elif op.kind == "ewise":
            acc = None
            for t, x in zip(op.inputs, ins):
                a = align_to(x, g.tensors[t].dims, out_ts.dims)
                acc = a if acc is None else acc + a
            vals[op.output] = torch.broadcast_to(acc, tuple(out_ts.shape))
        elif op.kind == "reduce":
            src = g.tensors[op.inputs[0]]
            axis = src.dims.index(op.attrs["axis"])
            vals[op.output] = torch.sum(ins[0], dim=axis)
        else:
            raise NotImplementedError(
                f"executor cannot run op kind {op.kind!r}")
        if constrain is not None:
            vals[op.output] = constrain(op.output, vals[op.output])
    return vals


def tensor_plan(g: Graph, sol) -> ShardingPlan:
    """ShardingPlan over a solved graph using tensor names as roles —
    every tensor gets its own cut row."""
    return ShardingPlan.from_solution(sol, {t: t for t in g.tensors})


def _place_leaf(value, mesh, placements):
    """A leaf's full value (the same on every rank) as a DTensor under
    ``placements``, each rank keeping its own slice."""
    from ..models.sharding import place
    return place(value, mesh, placements)


def local_einsum(sub: str, *xs):
    """``torch.einsum(sub, *xs)`` of DTensors on one mesh as each rank's
    local einsum.  Per mesh dim, the first dim letter that an input cuts
    is cut on every input that has it (the others whole, pending sums
    summed first) and the output takes that cut, or is a pending sum
    where the letter is contracted: the local products DTensor's own
    einsum runs for such placements, without its flatten."""
    import torch
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..models.sharding import from_local

    lhs, out = sub.split("->")
    subs = lhs.split(",")
    mesh = xs[0].device_mesh
    size = {c: n for s, x in zip(subs, xs) for c, n in zip(s, x.shape)}
    xpl, opl = [[] for _ in xs], []
    for i in range(mesh.ndim):
        cut = [s[x.placements[i].dim] for s, x in zip(subs, xs)
               if type(x.placements[i]) is Shard]
        for pl, s in zip(xpl, subs):
            pl.append(Shard(s.index(cut[0])) if cut and cut[0] in s
                      else Replicate())
        opl.append(Replicate() if not cut else
                   Shard(out.index(cut[0])) if cut[0] in out else Partial())
    local = [x.redistribute(mesh, pl).to_local() for x, pl in zip(xs, xpl)]
    return from_local(torch.einsum(sub, *local), mesh, opl,
                      [size[c] for c in out])


def sharded_einsum(sub: str, *xs, stats: Optional[Dict[str, int]] = None):
    """``torch.einsum(sub, *xs)``; where DTensor refuses to flatten a cut
    dim (torch 2.11), each rank's local einsum (:func:`local_einsum`),
    counted in ``stats["local_einsums"]``.  Any other error is raised."""
    import torch
    try:
        return torch.einsum(sub, *xs)
    except RuntimeError as e:
        if "Attempted to flatten" not in str(e):
            raise
    if stats is not None:
        stats["local_einsums"] = stats.get("local_einsums", 0) + 1
    return local_einsum(sub, *xs)


def execute_sharded(g: Graph, values: Dict[str, object],
                    plan: ShardingPlan, mesh,
                    outputs: Optional[List[str]] = None,
                    stats: Optional[Dict[str, int]] = None):
    """Execute the graph on ``mesh`` (every rank of it calls this) with
    the plan's placements forced on every tensor; returns {name: value}
    for ``outputs`` (default: the sink tensors), whole, as numpy on the
    host.  ``stats["local_einsums"]`` (if given) counts the einsums that
    DTensor refused to flatten and :func:`local_einsum` ran."""
    import torch

    from ..models.sharding import spec_placements

    outs = outputs if outputs is not None else sink_tensors(g)
    names = mesh.mesh_dim_names
    stats = {} if stats is None else stats
    stats.setdefault("local_einsums", 0)

    def placements(t):
        return spec_placements(plan.pspec(t, g.tensors[t].dims), names)

    def constrain(name, x):
        try:
            return x.redistribute(mesh, placements(name))
        except (ValueError, RuntimeError, NotImplementedError):
            return x

    def einsum(sub, *xs):
        return sharded_einsum(sub, *xs, stats=stats)

    placed = {t: _place_leaf(torch.as_tensor(values[t]), mesh,
                             placements(t))
              for t in leaf_tensors(g)}
    full = execute(g, placed, constrain=constrain, einsum=einsum)
    return {t: full[t].full_tensor().cpu().numpy() for t in outs}
