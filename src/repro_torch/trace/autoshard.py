"""``repro_torch.trace.autoshard``: capture -> solve -> a DTensor-placed
callable (the port's ``repro.autoshard``).

Any PyTorch function is traced (capture.py), the captured semantic graph
is fed through the *unchanged* tiling solver, and the solved per-tensor
tilings are mapped back to DTensor placements per argument and output
leaf through a ShardingPlan keyed by traced tensor ids.  There is no
GSPMD to hand the plan to: calling the returned :class:`AutoShard`
places each tensor leaf of the arguments as a DTensor under its solved
placements, runs ``fn`` on them (DTensor's propagation issues the
collectives, and plain tensors that ``fn`` makes join as replicated), and
redistributes each output leaf to its solved placements.  The solver only
decides where tensors live, so execution is correct even where capture
lowered an op coarsely.  The attention op, given DTensors, runs each
rank's flash kernel on its local shards (``models/attention.attention``
routes it to ``attention_sharded``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..core.plan import ShardingPlan
from ..core.solver import (MeshAxis, TilingSolution, solution_breakdown,
                           solve_mesh)
from ..obs.tracing import span as _span
from .capture import Traced, capture


def leaf_placements(plan: ShardingPlan, tensor: Optional[str], dims,
                    shape, mesh) -> List:
    """DTensor placements of one traced leaf under ``plan`` on ``mesh``:
    the plan's cuts of the leaf's dims (``pspec``), without the cuts whose
    degree does not divide their dim or that are of a mesh dim of size 1
    (``models/sharding.even_placements``); replicated for a leaf with no
    graph tensor."""
    from torch.distributed.tensor import Replicate

    from ..models.sharding import even_placements, spec_placements
    if tensor is None:
        return [Replicate()] * mesh.ndim
    pl = spec_placements(plan.pspec(tensor, dims), mesh.mesh_dim_names)
    return even_placements(pl, tuple(shape), mesh)


@dataclasses.dataclass
class AutoShard:
    """Result of :func:`autoshard` — call it like the original fn.  Tensor
    arguments may be plain tensors (the same full value on every rank) or
    DTensors; the tensor outputs come back as DTensors under their solved
    placements."""

    fn: Callable                  # the traced function, run on DTensors
    traced: Traced
    solution: TilingSolution
    plan: ShardingPlan            # keyed by traced tensor ids
    mesh: Any                     # the DeviceMesh the leaves are placed on
    in_shardings: List[Any]       # per flattened input leaf: placements
    out_shardings: List[Any]      # per flattened output leaf: placements
    predicted: Dict[str, object]  # solution_breakdown of the solved plan

    def __call__(self, *args, **kwargs):
        import torch
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import \
            implicit_replication
        from torch.utils import _pytree as pytree

        from ..models.sharding import place
        flat, tree = pytree.tree_flatten((args, kwargs))
        if tree != self.traced.in_tree:
            raise TypeError(
                "autoshard'ed fn was traced with another argument "
                f"structure: {self.traced.in_tree} against {tree} (the "
                "specialization covers exactly the traced pytree)")
        placed = []
        for x, pl in zip(flat, self.in_shardings):
            if pl is None:
                pass
            elif isinstance(x, DTensor):
                x = x.redistribute(self.mesh, pl)
            elif isinstance(x, torch.Tensor):
                x = place(x, self.mesh, pl)
            placed.append(x)
        a, kw = pytree.tree_unflatten(placed, tree)
        with implicit_replication():
            out = self.fn(*a, **kw)
            leaves, out_tree = pytree.tree_flatten(out)
            res = []
            for y, pl in zip(leaves, self.out_shardings):
                if isinstance(y, torch.Tensor) and pl is not None:
                    if not isinstance(y, DTensor):
                        # a value fn computed from plain tensors only: the
                        # same on every rank
                        y = place(y, self.mesh, pl)
                    else:
                        y = y.redistribute(self.mesh, pl)
                res.append(y)
        return pytree.tree_unflatten(res, out_tree)

    @property
    def predicted_bytes(self) -> float:
        return float(self.predicted["total"])

    def describe(self) -> str:
        g = self.traced.graph
        lines = [f"autoshard[{g.name}]: {len(g.ops)} ops, "
                 f"{len(g.tensors)} tensors, "
                 f"predicted {self.predicted_bytes:.3e} wire bytes"]
        for t, ts in g.tensors.items():
            cuts = self.plan.role_cuts.get(t, {})
            s = ", ".join(f"{a}->{d}" for a, d in cuts.items() if d)
            if s:
                lines.append(f"  {t:24s} [{s}]")
        if self.traced.unknown_primitives:
            lines.append("  (coarse fallback for: "
                         + ", ".join(self.traced.unknown_primitives)
                         + ")")
        return "\n".join(lines)


def autoshard(fn: Callable, mesh, *example_args,
              axes: Optional[Sequence[MeshAxis]] = None,
              weight_argnums: Sequence[int] = (),
              beam="auto", mem_scale: float = 1.0,
              name: Optional[str] = None,
              traced: Optional[Traced] = None,
              **example_kwargs) -> AutoShard:
    """Automatically parallelize ``fn`` over ``mesh`` (a ``DeviceMesh``).

    ``fn`` is traced on the example arguments (on meta tensors), the
    captured graph is solved on mesh-matched axes (``launch/mesh.
    mesh_to_solver_axes``; override with ``axes`` for explicit bandwidth
    weights), and the returned :class:`AutoShard` runs ``fn`` on DTensors
    under the solved placements.  Shapes are fixed to the example shapes
    (one plan per shape).  ``weight_argnums`` marks argument positions
    whose tensor leaves are parameters (enables the capacity-aware
    terms).  ``traced``: reuse an existing :func:`capture` of the SAME fn
    and example shapes instead of tracing again."""
    from torch.utils import _pytree as pytree

    from ..launch.mesh import mesh_to_solver_axes

    if traced is None:
        traced = capture(fn, *example_args, name=name,
                         weight_argnums=weight_argnums, **example_kwargs)
    if axes is None:
        axes = mesh_to_solver_axes(mesh)
    with _span("autoshard.solve",
               fn=name or getattr(fn, "__name__", "traced"),
               tensors=len(traced.graph.tensors)):
        sol = solve_mesh(traced.graph, axes, beam=beam,
                         mem_scale=mem_scale)
    plan = ShardingPlan.from_solution(sol, traced.tensor_roles())
    predicted = solution_breakdown(traced.graph, sol.axes, sol.per_axis)

    flat = pytree.tree_leaves((example_args, example_kwargs))
    g = traced.graph
    in_pl = [leaf_placements(plan, t, d, g.tensors[t].shape, mesh)
             if t is not None else None
             for t, d, x in zip(traced.in_tensors, traced.in_dims, flat)]
    out_pl = []
    for t, d, m in zip(traced.out_tensors, traced.out_dims,
                       traced.out_shape):
        if m is None:
            out_pl.append(None)
        else:
            out_pl.append(leaf_placements(plan, t, d, m[0], mesh))
    return AutoShard(fn, traced, sol, plan, mesh, in_pl, out_pl, predicted)
