"""Semantic dataflow IR (paper §3, Fig. 8b) with named-dimension einsum ops.

The paper's graph nodes are matrix multiplications plus element-wise ops;
we generalize every operator to a *named-dims einsum*:

  - every tensor has a tuple of dimension *names* (e.g. ("tok", "d_model"));
    a name may stand for several fused physical axes (e.g. "tok" =
    batch×seq) — plan.py resolves names back to physical axes per role.
  - an einsum op classifies each dim as row (lhs+out), col (rhs+out),
    contraction (lhs+rhs), or batch (all three). 2-D matmul is the paper's
    case; batched attention matmuls, MoE expert einsums and im2col convs
    all fit.
  - element-wise ops (incl. broadcasts), reductions and updates are
    special cases handled in cost.py.

Graphs are built by builders.py for each model family: forward ops, the
mirrored backward ops, and the parameter-update ops, so that the solver
sees exactly the structure of Figure 8(b).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class TensorSpec:
    """A logical tensor in the semantic graph."""

    name: str
    dims: Tuple[str, ...]          # dimension names
    shape: Tuple[int, ...]         # sizes, same length as dims
    bytes_per_elem: float = 2.0    # bf16 default
    kind: str = "activation"       # weight | activation | grad | input | output
    role: Optional[str] = None     # sharding-plan role key (plan.py)
    # Per-dim indivisible granule (e.g. head_dim for a merged heads*hd dim):
    # an even cut of arity A along dim d is feasible iff
    # (size[d] / units[d]) % A == 0.
    units: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        assert len(self.dims) == len(self.shape), (self.name, self.dims, self.shape)

    def dim_count(self, d: str) -> int:
        """Number of indivisible granules along dim d."""
        size = dict(zip(self.dims, self.shape))[d]
        return size // self.units.get(d, 1)

    # set by Graph.__init__ via _owner backref; True for paper graphs whose
    # published configs are not divisible by the device count (e.g. 300
    # neurons / 16 GPUs) — cost modelling then allows approximate tiling.
    allow_uneven: bool = False

    def can_cut(self, d: str, arity: int) -> bool:
        if d not in self.dims:
            return False
        c = self.dim_count(d)
        if self.allow_uneven:
            return c >= arity
        return c >= arity and c % arity == 0

    @property
    def nbytes(self) -> float:
        n = self.bytes_per_elem
        for s in self.shape:
            n *= s
        return n

    def divided(self, dim: str, arity: int) -> "TensorSpec":
        """Shape after an even cut along ``dim`` (no-op if dim absent)."""
        if dim not in self.dims:
            return self
        shape = tuple(
            max(1, s // arity) if d == dim else s
            for d, s in zip(self.dims, self.shape)
        )
        return dataclasses.replace(self, shape=shape)


@dataclasses.dataclass
class OpSpec:
    """One operator.  kinds:

    - "einsum":  inputs (lhs, rhs) -> output, dim classes inferred by name.
    - "ewise":   n inputs -> output; all dims are batch-like; inputs may
                 broadcast (missing dims).
    - "reduce":  one input -> output missing ``attrs['axis']``.
    """

    name: str
    kind: str
    inputs: Tuple[str, ...]
    output: str
    # Per-op cost multiplier: e.g. an op inside a layer repeated L times by
    # weight sharing (zamba shared block) can carry repeat=L.
    repeat: float = 1.0
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)


class Graph:
    def __init__(self, name: str = "g", allow_uneven: bool = False):
        self.name = name
        self.allow_uneven = allow_uneven
        self.tensors: Dict[str, TensorSpec] = {}
        self.ops: List[OpSpec] = []
        # elimination_order depends only on op/tensor structure, not shapes,
        # so it is cached and propagated through divided() across the k-cut
        # recursion; any op-adding method invalidates it.
        self._elim_order: Optional[List[OpSpec]] = None

    # ---- construction ------------------------------------------------
    def tensor(self, name: str, dims: Sequence[str], shape: Sequence[int],
               bytes_per_elem: float = 2.0, kind: str = "activation",
               role: Optional[str] = None,
               units: Optional[Dict[str, int]] = None) -> str:
        if name in self.tensors:
            raise ValueError(f"duplicate tensor {name}")
        self.tensors[name] = TensorSpec(
            name, tuple(dims), tuple(shape), bytes_per_elem, kind, role,
            dict(units or {}), self.allow_uneven)
        return name

    def einsum(self, name: str, lhs: str, rhs: str, out: str,
               repeat: float = 1.0) -> None:
        self._elim_order = None
        self.ops.append(OpSpec(name, "einsum", (lhs, rhs), out, repeat))

    def ewise(self, name: str, inputs: Sequence[str], out: str,
              repeat: float = 1.0, align_dims: Optional[Sequence[str]] = None,
              update: bool = False) -> None:
        """align_dims: whitelist of dims the op may be partitioned along
        (e.g. attention is parallel over batch/heads but NOT seq).
        update=True marks a parameter update (replicated form is free, the
        standard data-parallel idiom — see DESIGN.md)."""
        attrs: Dict[str, object] = {}
        if align_dims is not None:
            attrs["align_dims"] = tuple(align_dims)
        if update:
            attrs["update"] = True
        self._elim_order = None
        self.ops.append(OpSpec(name, "ewise", tuple(inputs), out, repeat,
                               attrs))

    def reduce(self, name: str, inp: str, out: str, axis: str,
               repeat: float = 1.0) -> None:
        self._elim_order = None
        self.ops.append(OpSpec(name, "reduce", (inp,), out, repeat,
                               {"axis": axis}))

    def custom(self, name: str, inputs: Sequence[str], out: str,
               forms: Sequence[Tuple[Dict[str, object], float]],
               repeat: float = 1.0) -> None:
        """Operator with an explicit aligned-form set (paper §4.5: "the only
        information tied to operator type is its set of aligned tilings").
        ``forms``: list of ({tensor_name: Tiling}, penalty_bytes)."""
        self._elim_order = None
        self.ops.append(OpSpec(name, "custom", tuple(inputs), out, repeat,
                               {"forms": tuple(forms)}))

    # ---- queries -----------------------------------------------------
    def op_tensors(self, op: OpSpec) -> Tuple[str, ...]:
        # hot path in the solver: memoize on the OpSpec itself (the op
        # object is shared across divided() copies, where the answer is
        # identical).
        t = op.__dict__.get("_tensors")
        if t is None:
            t = tuple(dict.fromkeys(op.inputs + (op.output,)))
            op.__dict__["_tensors"] = t
        return t

    def einsum_dim_classes(self, op: OpSpec):
        """Return (batch, row, col, contract) dim-name tuples for an einsum."""
        lhs, rhs = (self.tensors[i] for i in op.inputs)
        out = self.tensors[op.output]
        ld, rd, od = set(lhs.dims), set(rhs.dims), set(out.dims)
        batch = tuple(d for d in out.dims if d in ld and d in rd)
        row = tuple(d for d in out.dims if d in ld and d not in rd)
        col = tuple(d for d in out.dims if d in rd and d not in ld)
        contract = tuple(d for d in lhs.dims if d in rd and d not in od)
        return batch, row, col, contract

    def divided(self, assignment: Dict[str, object], arity: int) -> "Graph":
        """Graph with every tensor's shape divided per a cut assignment
        (tiling objects from tiling.py; REPLICATE leaves shape)."""
        from .tiling import Part

        g = Graph(self.name, self.allow_uneven)
        g.ops = list(self.ops)
        g._elim_order = self._elim_order   # structure unchanged
        for name, ts in self.tensors.items():
            t = assignment.get(name)
            g.tensors[name] = (
                ts.divided(t.dim, arity) if isinstance(t, Part) else ts)
        return g

    # ---- BFS leveling (paper §4.2.2) ----------------------------------
    def bfs_levels(self, seeds: Optional[Sequence[str]] = None) -> List[List[OpSpec]]:
        """Organize ops into BFS levels of the undirected op-adjacency graph
        (ops adjacent iff they share a tensor).  Sources default to ops
        touching kind=="input" tensors."""
        tensor_to_ops: Dict[str, List[int]] = {}
        for i, op in enumerate(self.ops):
            for t in self.op_tensors(op):
                tensor_to_ops.setdefault(t, []).append(i)

        if seeds is None:
            seed_ops = [
                i for i, op in enumerate(self.ops)
                if any(self.tensors[t].kind == "input"
                       for t in self.op_tensors(op))
            ]
            if not seed_ops:
                seed_ops = [0]
        else:
            wanted = set(seeds)
            seed_ops = [i for i, op in enumerate(self.ops)
                        if wanted & set(self.op_tensors(op))]

        depth = {i: 0 for i in seed_ops}
        q = deque(seed_ops)
        while q:
            i = q.popleft()
            for t in self.op_tensors(self.ops[i]):
                for j in tensor_to_ops[t]:
                    if j not in depth:
                        depth[j] = depth[i] + 1
                        q.append(j)
        # disconnected ops (shouldn't happen) go in a final level
        maxd = max(depth.values()) if depth else 0
        for i in range(len(self.ops)):
            if i not in depth:
                maxd += 1
                depth[i] = maxd
        levels: Dict[int, List[OpSpec]] = {}
        for i, d in depth.items():
            levels.setdefault(d, []).append(self.ops[i])
        return [levels[d] for d in sorted(levels)]

    def elimination_order(self) -> List[OpSpec]:
        if self._elim_order is None:
            self._elim_order = self._elimination_order()
        return self._elim_order

    def _elimination_order(self) -> List[OpSpec]:
        """Op order for the DP: greedy min-liveness elimination.  The DP
        optimum is order-independent (the graph is treated undirected, as
        in the paper's §4.2.2 BFS leveling); only the *width* of the live
        tensor set matters for running time.  We greedily pick the next op
        that minimizes the resulting live-set size, preferring ops whose
        tensors are already (mostly) live — this closes live ranges early
        (e.g. a weight's update op right after its backward op) and keeps
        the state near the paper's constant-per-level width.  Group tags
        from the builders break ties so layers are processed in order."""
        remaining = list(range(len(self.ops)))
        uses: Dict[str, int] = {}
        for op in self.ops:
            for t in self.op_tensors(op):
                uses[t] = uses.get(t, 0) + 1
        live: set = set()
        order: List[OpSpec] = []
        while remaining:
            best = None
            best_key = None
            for i in remaining:
                op = self.ops[i]
                ts = self.op_tensors(op)
                new = [t for t in ts if t not in live]
                after = len(live) + len(new) - sum(
                    1 for t in ts if uses[t] == 1)
                key = (after, len(new), op.attrs.get("group", 0), i)
                if best_key is None or key < best_key:
                    best_key, best = key, i
            op = self.ops[best]
            remaining.remove(best)
            order.append(op)
            for t in self.op_tensors(op):
                uses[t] -= 1
                if uses[t] == 0:
                    live.discard(t)
                else:
                    live.add(t)
        return order

    def boundary_tensors(self, levels: List[List[OpSpec]]) -> List[List[str]]:
        """boundaries[l] = tensors shared between levels <= l and > l
        (the DP state variables τ_l of Eq. 5)."""
        first_seen: Dict[str, int] = {}
        last_seen: Dict[str, int] = {}
        for li, ops in enumerate(levels):
            for op in ops:
                for t in self.op_tensors(op):
                    first_seen.setdefault(t, li)
                    last_seen[t] = li
        out: List[List[str]] = []
        for li in range(len(levels) - 1):
            out.append(sorted(
                t for t in first_seen
                if first_seen[t] <= li < last_seen[t]))
        return out
