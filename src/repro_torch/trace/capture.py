"""FX capture: lower a PyTorch function to the named-dims IR (the port's
``repro.trace.capture``).

The paper's system "automatically transforms a serial dataflow graph
captured by an existing deep learning system frontend"; this module is
that frontend for PyTorch.  ``capture(fn, *example_args)`` traces ``fn``
with ``torch.fx.experimental.proxy_tensor.make_fx`` on *meta* tensors (the
example arguments' shapes and dtypes, no storage, no card) and walks the
aten graph, emitting one semantic op (core/graph.py) per node by repro's
lowering rules:

  mm / bmm / addmm       -> einsum ops (dim classes from unification); the
                            views ``matmul`` wraps around ``mm`` (leading
                            dims merged, then split back) are folded into
                            the einsum, as ``dot_general`` takes them whole
  pointwise family       -> ewise ops (broadcasts included); a unary op, or
                            one full operand with size-1 partners, is an
                            alias and no op; ``where`` is lowered as
                            ``jnp.where`` is (each operand broadcast to
                            the output, then one select op)
  sum / mean / amax ...  -> reduce ops (several dims are chained reduces);
                            ``_softmax`` is its max and sum reduces over the
                            softmax dim, the output an alias of the input
  layout moves           -> zero-cost aliases (t, permute, transpose,
                            _to_copy, clone, expand, unsqueeze, squeeze,
                            1:1 views) or tie ops (merged / split dims, with
                            granule ``units`` so a cut never splits the
                            folded constituent)
  indexing               -> repro's gather / scatter / top_k / sort /
                            cumulative / concatenate / slice / pad rules
  anything else          -> a conservative ewise fallback (recorded in
                            ``Traced.unknown_primitives``, by aten name)

Python loops unroll under ``make_fx``, where JAX's ``scan`` does not:
a run of k structurally equal segments of the aten graph (the layer loop
over the stacked ``[L, ...]`` leaves, the sLSTM's time loop) is folded
into one body lowered once with ``repeat=k``, as repro lowers a scan
body: the stacked leaves' per-iteration slices are zero-cost ties of the
stacked tensor, a value one iteration hands the next is a carry whose
loop-back op prices its re-sharding, and per-iteration results gathered by
``stack`` after the loop are a tie of the body's value.  So the op count
does not grow with the depth or the sequence length.

Every node of the trace is lowered, a dead one too: a jaxpr keeps an
equation whose result nothing reads, repro prices it, and eager torch
runs it (under ``autoshard`` its collectives are issued).

Dimension *names* are discovered by unification: every tensor axis gets a
fresh slot; ops merge slots that must carry the same logical dimension
(einsum contraction/batch pairs, element-wise alignment, carries).  A
union-find over slots yields the final named-dims graph.  Sharding
correctness never depends on capture fidelity: the plan only *chooses*
placements, and DTensor's propagation keeps execution correct
(``autoshard``).

The trace runs under ``torch.no_grad()`` and leaves the kernel counters
of ``kernels/ops.py`` as it found them: on meta tensors the kernel
wrappers take their plain route, which counts.  torch is imported inside
:func:`capture`.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.graph import Graph
from ..core.tiling import Part, REPLICATE


# ---------------------------------------------------------------------------
# dim-slot union-find
# ---------------------------------------------------------------------------

class DimTable:
    """Union-find over dimension slots; merging requires equal sizes."""

    def __init__(self):
        self._parent: List[int] = []
        self._size: List[int] = []

    def new(self, size: int) -> int:
        i = len(self._parent)
        self._parent.append(i)
        self._size.append(int(size))
        return i

    def find(self, i: int) -> int:
        while self._parent[i] != i:
            self._parent[i] = self._parent[self._parent[i]]
            i = self._parent[i]
        return i

    def size(self, i: int) -> int:
        return self._size[self.find(i)]

    def unify(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return True
        if self._size[ra] != self._size[rb]:
            return False
        self._parent[rb] = ra
        return True


# ---------------------------------------------------------------------------
# intermediate records (dim names are only assigned at finalize)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Val:
    """A node's value: the tensor holding it plus this node's view of the
    tensor's axes (aliases permute / subset / extend the dim ids)."""
    tensor: Optional[str]          # None => scalar constant, no tensor
    dims: Tuple[int, ...]          # dim slot ids in this view's axis order
    shape: Tuple[int, ...]
    itemsize: float

    @property
    def ndim(self) -> int:
        return len(self.shape)


@dataclasses.dataclass
class _TRec:
    name: str
    dims: Tuple[int, ...]
    shape: Tuple[int, ...]
    bytes_per_elem: float
    kind: str
    units: Dict[int, int] = dataclasses.field(default_factory=dict)


# custom-op form spec: {tensor_name: ("axis", axis_index) | "r"}
_FormSpec = Tuple[Dict[str, object], float]


@dataclasses.dataclass
class _OpRec:
    kind: str                      # einsum | ewise | reduce | custom
    inputs: Tuple[str, ...]
    output: str
    repeat: float
    align: Optional[Tuple[int, ...]] = None    # ewise dim-id whitelist
    update: bool = False
    axis: Optional[int] = None                 # reduce: input axis INDEX
    forms: Optional[Tuple[_FormSpec, ...]] = None


@dataclasses.dataclass
class _Lazy:
    """A part of ``src`` along ``dim`` (an ``unbind`` slice, dropping the
    dim, or a ``split`` part, keeping it), lowered only when read, at the
    reader's repeat: a layer loop's slice of a stacked leaf is then one
    tie in the folded body."""
    src: _Val
    dim: int
    start: int
    length: Optional[int]          # None: an unbind slice (dim dropped)
    val: Optional[_Val] = None


@dataclasses.dataclass
class _Merged:
    """A view that only merges runs of consecutive axes of ``src``
    (``groups``: per merged axis, the ``src`` axes it holds), kept
    deferred when its readers are matrix products: ``mm`` / ``bmm`` take
    the unmerged operands as ``dot_general`` would (the flattens of
    ``matmul`` and of ``einsum``'s batched product), their result is
    itself a deferred merge of the unmerged product, and a view of it
    reshapes the unmerged product.  Any other reader gets the merge
    lowered as a reshape."""
    src: _Val
    groups: Tuple[Tuple[int, ...], ...]
    shape: Tuple[int, ...]         # the merged shape
    val: Optional[_Val] = None


# the pointwise family (aten overload-packet names; an in-place op's
# trailing "_" is stripped first)
_POINTWISE = frozenset("""
add sub rsub mul div true_divide floor_divide neg exp exp2 log log1p log2
log10 expm1 tanh sigmoid silu gelu relu relu6 hardtanh leaky_relu elu selu
softplus mish rsqrt sqrt pow abs clamp clamp_min clamp_max clip maximum
minimum fmax fmin fmod remainder where eq ne lt le gt ge bitwise_and
bitwise_or bitwise_xor bitwise_not logical_and logical_or logical_xor
logical_not cos sin tan acos asin atan atan2 cosh sinh asinh acosh atanh
erf erfc erfinv reciprocal sign sgn floor ceil round trunc frac square
masked_fill nan_to_num isnan isinf isfinite lerp addcmul addcdiv xlogy
hypot copysign heaviside logit
""".split())

# pure layout / dtype moves: the output aliases the input tensor
_ALIAS = frozenset("_to_copy clone detach lift_fresh_copy alias".split())

_RESHAPE = frozenset("view _unsafe_view view_copy _reshape_alias".split())

# the matrix products whose operands may be deferred merges
_PRODUCTS = ("mm", "addmm", "bmm", "baddbmm")

_REDUCE = frozenset("""
sum mean amax amin prod any all argmax argmin max min logsumexp var std
nansum nanmean norm linalg_vector_norm
""".split())

_CUMULATIVE = frozenset("cumsum cumprod cummax cummin logcumsumexp".split())

_FILL = frozenset("""
full zeros ones empty empty_strided arange scalar_tensor full_like
zeros_like ones_like empty_like rand randn randint rand_like randn_like
new_zeros new_ones new_full new_empty eye linspace fill tensor
""".split())

_SCATTER = frozenset("""
scatter scatter_add scatter_reduce index_put index_add index_copy
index_fill masked_scatter copy slice_scatter select_scatter
""".split())


def aten_name(target) -> str:
    """The overload packet's name of an aten target (``aten.add.Tensor``
    -> "add", ``aten.bitwise_and_.Tensor`` -> "bitwise_and")."""
    packet = getattr(target, "overloadpacket", None)
    name = getattr(packet, "__name__", None) or str(target)
    name = name.split(".")[-1]
    if name.endswith("_") and not name.endswith("__") and \
            name[:-1] and not name.startswith("_"):
        name = name[:-1]
    return name


def _itemsize(dtype) -> float:
    return float(getattr(dtype, "itemsize", 4))


def _meta(node):
    """(shape, itemsize) of a node's output, or a list of them for a
    multi-output node (None where an output is not a tensor)."""
    import torch
    v = node.meta.get("val")

    def one(x):
        if isinstance(x, torch.Tensor):
            return tuple(int(s) for s in x.shape), _itemsize(x.dtype)
        return None
    if isinstance(v, (list, tuple)):
        return [one(x) for x in v]
    return one(v)


class _Capture:
    def __init__(self, name: str):
        self.name = name
        self.dt = DimTable()
        self.tensors: Dict[str, _TRec] = {}
        self.ops: List[_OpRec] = []
        self._n = 0
        self.unknown: List[str] = []
        self.env: Dict[Any, Any] = {}
        # select nodes of a folded body whose index is the iteration's
        # (lowered as ties of the sliced tensor, as repro's xs slices)
        self.loop_slices: set = set()
        # (start, period, count) of every fold, outermost first
        self.folds: List[Tuple[int, int, int]] = []
        self.signatures: Dict[Any, tuple] = {}

    # -- tensor helpers ------------------------------------------------
    def _fresh_name(self, prefix: str) -> str:
        self._n += 1
        prefix = "".join(c if (c.isalnum() or c == "_") else "_"
                         for c in prefix)
        return f"{prefix}.{self._n}"

    def new_dims(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return tuple(self.dt.new(s) for s in shape)

    def tensor(self, prefix: str, dims: Sequence[int],
               shape: Sequence[int], itemsize: float,
               kind: str = "activation",
               units: Optional[Dict[int, int]] = None) -> _Val:
        name = self._fresh_name(prefix)
        self.tensors[name] = _TRec(name, tuple(dims), tuple(shape),
                                   float(itemsize), kind, dict(units or {}))
        return _Val(name, tuple(dims), tuple(shape), float(itemsize))

    def leaf(self, prefix: str, shape, itemsize, kind: str = "input") -> _Val:
        return self.tensor(prefix, self.new_dims(shape), shape, itemsize,
                           kind)

    # -- op emit -------------------------------------------------------
    def ewise(self, inputs: Sequence[_Val], out: _Val, repeat: float,
              align: Optional[Sequence[int]] = None,
              update: bool = False) -> None:
        ins = tuple(dict.fromkeys(v.tensor for v in inputs
                                  if v.tensor is not None))
        if not ins:
            return                       # pure-constant compute: local
        self.ops.append(_OpRec("ewise", ins, out.tensor, repeat,
                               align=None if align is None
                               else tuple(align), update=update))

    def einsum(self, lhs: _Val, rhs: _Val, out: _Val,
               repeat: float) -> None:
        self.ops.append(_OpRec("einsum", (lhs.tensor, rhs.tensor),
                               out.tensor, repeat))

    def _tensor_axis(self, v: _Val, i: int) -> int:
        """Translate an axis of a view (which may permute or subset its
        tensor's axes by aliasing) to the tensor's own axis index — op
        records always store tensor axes."""
        return self.tensors[v.tensor].dims.index(v.dims[i])

    def reduce(self, inp: _Val, out: _Val, axis_index: int,
               repeat: float) -> None:
        self.ops.append(_OpRec("reduce", (inp.tensor,), out.tensor,
                               repeat,
                               axis=self._tensor_axis(inp, axis_index)))

    def custom(self, inputs: Sequence[_Val], out: _Val,
               forms: Sequence[_FormSpec], repeat: float) -> None:
        self.ops.append(_OpRec(
            "custom", tuple(v.tensor for v in inputs), out.tensor,
            repeat, forms=tuple(forms)))

    def tie(self, src: _Val, dst: _Val,
            pairs: Sequence[Tuple[int, int]], repeat: float) -> None:
        """Zero-cost data-identity op: partitioning ``src`` axis i is the
        same physical layout as partitioning ``dst`` axis j for every
        (i, j) in ``pairs``; replication maps to replication for free."""
        forms: List[_FormSpec] = []
        for i, j in pairs:
            if src.shape[i] <= 1:      # size-1 axes are never cuttable
                continue
            try:
                forms.append(
                    ({src.tensor: ("axis", self._tensor_axis(src, i)),
                      dst.tensor: ("axis", self._tensor_axis(dst, j))},
                     0.0))
            except ValueError:
                # alias-view axis absent from the backing tensor
                # (inserted or expanded dim): no corresponding cut exists
                continue
        forms.append(({src.tensor: "r", dst.tensor: "r"}, 0.0))
        self.custom((src,), dst, forms, repeat)

    # -- reading values --------------------------------------------------
    def read(self, a, repeat: float, keep_merged: bool = False):
        """The lowered value of an FX argument: a node's value (lazy parts
        lowered now, at ``repeat``), a list of them, or a constant."""
        from torch.fx import Node
        if isinstance(a, Node):
            return self._resolve(self.env[a], repeat, keep_merged)
        if isinstance(a, (list, tuple)):
            return [self.read(x, repeat, keep_merged) for x in a]
        return a

    def _resolve(self, v, repeat: float, keep_merged: bool = False):
        if isinstance(v, _Lazy):
            if v.val is None:
                v.val = self._lower_part(v, repeat)
            return v.val
        if isinstance(v, _Merged) and not keep_merged:
            if v.val is None:
                v.val = self._reshape_val(v.src, v.shape, repeat)
            return v.val
        return v

    def _lower_part(self, p: _Lazy, repeat: float) -> _Val:
        src = p.src
        if p.length is None:
            keep = [i for i in range(src.ndim) if i != p.dim]
            sl = self.tensor("xslice", [src.dims[i] for i in keep],
                             [src.shape[i] for i in keep], src.itemsize)
            self.tie(src, sl, [(i, k) for k, i in enumerate(keep)], repeat)
            return sl
        shape = list(src.shape)
        shape[p.dim] = p.length
        return self._slice_to(src, tuple(shape), repeat)

    # -- graph walking -----------------------------------------------------
    def lower_nodes(self, nodes: List, a: int, b: int,
                    repeat: float) -> None:
        """Lower ``nodes[a:b]``, folding the longest run of equal
        segments found there (recursively: the body's own loops fold
        inside it)."""
        fold = _find_fold(self, nodes, a, b)
        if fold is None:
            for n in nodes[a:b]:
                self.lower_node(n, repeat)
            return
        s, p, k, carries, slices = fold
        self.folds.append((s, p, k))
        self.lower_nodes(nodes, a, s, repeat)
        body_rep = repeat * k
        self.loop_slices.update(slices)
        self.lower_nodes(nodes, s, s + p, body_rep)
        for x0, r in carries:
            cin = self.read(x0, body_rep)
            cout = self._resolve(self.env[nodes[s + r]], body_rep)
            if not isinstance(cin, _Val) or not isinstance(cout, _Val) \
                    or cin.tensor is None or cout.tensor is None:
                continue
            if cin.tensor == cout.tensor:
                continue
            for x, y in zip(cin.dims, cout.dims):
                self.dt.unify(x, y)
            # price the loop-back re-shard (iteration i's carry-out feeds
            # iteration i+1's carry-in); update=True: a replicated carry
            # is the same buffer, not recompute
            self.ops.append(_OpRec("ewise", (cout.tensor,), cin.tensor,
                                   body_rep, update=True))
        for j in range(1, k):
            for q in range(p):
                self.env[nodes[s + j * p + q]] = self.env[nodes[s + q]]
        self.lower_nodes(nodes, s + k * p, b, repeat)

    def lower_node(self, node, repeat: float) -> None:
        if node.target is operator.getitem:
            base = self.env[node.args[0]]
            self.env[node] = base[node.args[1]]
            return
        name = aten_name(node.target)
        handler = getattr(self, f"_p_{name}", None)
        if handler is not None:
            out = handler(node, repeat)
        elif name in _POINTWISE:
            out = self._elementwise(node, repeat)
        elif name in _ALIAS:
            out = self._alias(node, repeat)
        elif name in _RESHAPE:
            out = self._p_view(node, repeat)
        elif name in _REDUCE:
            out = self._reduce(node, repeat)
        elif name in _CUMULATIVE:
            out = self._cumulative(node, repeat)
        elif name in _FILL:
            out = self._fill(node, repeat)
        elif name in _SCATTER:
            out = self._scatter_like(node, repeat)
        else:
            out = self._fallback(name, node, repeat)
        self.env[node] = out

    def _arrays(self, node, repeat) -> List[_Val]:
        """The tensor values among a node's arguments (lists flattened)."""
        out = []

        def go(x):
            if isinstance(x, _Val):
                if x.tensor is not None:
                    out.append(x)
            elif isinstance(x, list):
                for y in x:
                    go(y)
        for a in list(node.args) + list(node.kwargs.values()):
            go(self.read(a, repeat))
        return out

    def _out(self, node):
        m = _meta(node)
        if m is None:
            return (), 4.0
        return m

    # -- element-wise / broadcast ---------------------------------------
    def _elementwise(self, node, repeat) -> _Val:
        shape, isz = self._out(node)
        rank = len(shape)
        arrs = [v for v in self._arrays(node, repeat) if v.ndim > 0]
        if not arrs or rank == 0:     # pure-scalar compute
            return self._fallback(aten_name(node.target), node, repeat,
                                  record=False)
        # per-axis dim discovery + unification across operands aligned
        # from the right (torch broadcasting; an operand of lower rank has
        # size-1 axes in front, as jnp's rank promotion inserts)
        dims: List[int] = []
        for j, s in enumerate(shape):
            cands = [v.dims[j - (rank - v.ndim)] for v in arrs
                     if j - (rank - v.ndim) >= 0
                     and v.shape[j - (rank - v.ndim)] == s]
            if cands:
                d = cands[0]
                for c in cands[1:]:
                    self.dt.unify(d, c)
                dims.append(d)
            else:
                dims.append(self.dt.new(s))
        full = [v for v in arrs if v.shape == shape]
        if len(full) == 1:
            # a unary activation, or one full operand with size-1 /
            # lower-rank broadcast partners (keepdims normalizations,
            # biases): alias the full operand.  The partners stay unified
            # by dim name but get no op (builders model at block
            # granularity; an op per normalization multiply floods the DP)
            ref = full[0]
            return _Val(ref.tensor, ref.dims, ref.shape, isz)
        out = self.tensor(aten_name(node.target), dims, shape, isz)
        self.ewise(arrs, out, repeat)
        return out

    def _p_where(self, node, repeat) -> _Val:
        """repro's lowering of ``jnp.where``: each operand broadcast to the
        output shape first (a ``bcast`` op where it expands a size > 1
        axis, a ``fill`` leaf for a scalar), then one select op over the
        full operands, never an alias of one of them."""
        shape, isz = self._out(node)
        if not shape:
            return self._fallback("where", node, repeat, record=False)
        from torch.fx import Node
        full = []
        for a in node.args[:3]:
            v = self.read(a, repeat)
            if isinstance(v, _Val) and v.tensor is not None and v.ndim:
                full.append(self._broadcast(v, shape, repeat))
                continue
            m = _meta(a) if isinstance(a, Node) else None
            full.append(self.leaf("fill", shape, m[1] if m else isz,
                                  kind="activation"))
        dims = list(full[0].dims)
        for v in full[1:]:
            for d, e in zip(dims, v.dims):
                self.dt.unify(d, e)
        out = self.tensor("where", dims, shape, isz)
        self.ewise(full, out, repeat)
        return out

    def _broadcast(self, v: _Val, shape, repeat) -> _Val:
        """repro's ``_p_broadcast_in_dim`` of ``v`` to ``shape`` (axes
        aligned from the right, as torch broadcasts): an alias when only
        size-1 axes are added, else a ``bcast`` tensor and its op."""
        lead = len(shape) - v.ndim
        dims, expands = [], False
        for j, s in enumerate(shape):
            i = j - lead
            if i >= 0 and v.shape[i] == s:
                dims.append(v.dims[i])
                continue
            expands = expands or s > 1
            dims.append(self.dt.new(s))
        if not expands:
            return _Val(v.tensor, tuple(dims), tuple(shape), v.itemsize)
        out = self.tensor("bcast", dims, shape, v.itemsize)
        self.ewise([v], out, repeat, update=True)
        return out

    def _alias(self, node, repeat) -> _Val:
        v = self.read(node.args[0], repeat)
        shape, isz = self._out(node)
        if not isinstance(v, _Val) or v.tensor is None:
            return self._fill(node, repeat)
        return _Val(v.tensor, v.dims, v.shape, isz)

    def _p_t(self, node, repeat) -> _Val:
        v = self.read(node.args[0], repeat)
        if v.ndim < 2:
            return v
        return _Val(v.tensor, v.dims[::-1], v.shape[::-1], v.itemsize)

    def _p_permute(self, node, repeat) -> _Val:
        v = self.read(node.args[0], repeat)
        perm = [p % v.ndim for p in node.args[1]]
        return _Val(v.tensor, tuple(v.dims[i] for i in perm),
                    tuple(v.shape[i] for i in perm), v.itemsize)

    def _p_transpose(self, node, repeat) -> _Val:
        v = self.read(node.args[0], repeat)
        if v.ndim < 2:
            return v
        a, b = (x % v.ndim for x in node.args[1:3])
        perm = list(range(v.ndim))
        perm[a], perm[b] = perm[b], perm[a]
        return _Val(v.tensor, tuple(v.dims[i] for i in perm),
                    tuple(v.shape[i] for i in perm), v.itemsize)

    def _p_unsqueeze(self, node, repeat) -> _Val:
        v = self.read(node.args[0], repeat)
        d = node.args[1] % (v.ndim + 1)
        return _Val(v.tensor, v.dims[:d] + (self.dt.new(1),) + v.dims[d:],
                    v.shape[:d] + (1,) + v.shape[d:], v.itemsize)

    def _p_squeeze(self, node, repeat) -> _Val:
        v = self.read(node.args[0], repeat)
        shape, _ = self._out(node)
        if len(node.args) > 1:
            ds = node.args[1]
            ds = [ds] if isinstance(ds, int) else list(ds)
            drop = {d % v.ndim for d in ds if v.shape[d % v.ndim] == 1}
        else:
            drop = {i for i, s in enumerate(v.shape) if s == 1}
        keep = [i for i in range(v.ndim) if i not in drop]
        return _Val(v.tensor, tuple(v.dims[i] for i in keep),
                    tuple(v.shape[i] for i in keep), v.itemsize)

    def _p_expand(self, node, repeat) -> _Val:
        v = self.read(node.args[0], repeat)
        shape, isz = self._out(node)
        lead = len(shape) - v.ndim
        dims = []
        for j, s in enumerate(shape):
            i = j - lead
            if i >= 0 and v.shape[i] == s:
                dims.append(v.dims[i])
            else:
                dims.append(self.dt.new(s))
        return _Val(v.tensor, tuple(dims), tuple(shape), v.itemsize)

    def _p_view(self, node, repeat):
        v = self.read(node.args[0], repeat, keep_merged=True)
        shape, isz = self._out(node)
        if isinstance(v, _Merged):
            # a view of a deferred merge: the same reshape of the
            # unmerged value (both are row-major)
            return self._reshape_val(v.src, tuple(shape), repeat)
        if not isinstance(v, _Val) or v.tensor is None:
            return self._fallback("view", node, repeat)
        users = list(node.users)
        if users and all(u.op == "call_function"
                         and u.target is not operator.getitem
                         and aten_name(u.target) in _PRODUCTS
                         for u in users):
            groups = _merge_groups(v.shape, tuple(shape))
            if groups is not None and any(len(gr) > 1 for gr in groups):
                return _Merged(v, groups, tuple(shape))
        return self._reshape_val(v, tuple(shape), repeat)

    def _reshape_val(self, v: _Val, shape: Tuple[int, ...],
                     repeat: float) -> _Val:
        """A reshape of ``v``: size-1 axes are fresh (never cuttable), the
        others grouped by ``_reshape_groups``; 1:1 groups keep their dim
        (a pure alias when all are), merges and splits become a tie with
        granule ``units`` on the merged dim."""
        src_axes = [i for i, s in enumerate(v.shape) if s != 1]
        dst_axes = [j for j, s in enumerate(shape) if s != 1]
        groups = _reshape_groups(tuple(v.shape[i] for i in src_axes),
                                 tuple(shape[j] for j in dst_axes))
        if groups is None:
            out = self.tensor("rs", self.new_dims(shape), shape, v.itemsize)
            self.ewise([v], out, repeat)
            if "reshape" not in self.unknown:
                self.unknown.append("reshape")
            return out
        out_dims: List[int] = [self.dt.new(1) if s == 1 else -1
                               for s in shape]
        pairs: List[Tuple[int, int]] = []
        units: Dict[int, int] = {}
        pure = True
        for gs, gd in groups:
            sa = [src_axes[i] for i in gs]
            da = [dst_axes[j] for j in gd]
            if len(sa) == 1 and len(da) == 1:
                out_dims[da[0]] = v.dims[sa[0]]
                pairs.append((sa[0], da[0]))
                continue
            pure = False
            for a in da:
                out_dims[a] = self.dt.new(shape[a])
            if len(da) == 1:
                # merge: a cut of the folded dim must keep whole trailing
                # granules (the product after the lead axis)
                gran = 1
                for a in sa[1:]:
                    gran *= v.shape[a]
                units[out_dims[da[0]]] = gran
            pairs.append((sa[0], da[0]))
        if pure:
            return _Val(v.tensor, tuple(out_dims), tuple(shape), v.itemsize)
        out = self.tensor("rs", out_dims, shape, v.itemsize, units=units)
        self.tie(v, out, pairs, repeat)
        return out

    # -- reductions ------------------------------------------------------
    def _reduce_axes(self, node, ndim: int) -> Tuple[List[int], bool]:
        name = aten_name(node.target)
        args = list(node.args[1:])
        kw = dict(node.kwargs)
        dim = kw.get("dim", args[0] if args else None)
        keep = kw.get("keepdim")
        if keep is None:
            keep = next((a for a in args[1:] if isinstance(a, bool)), False)
        if dim is None or dim == [] or isinstance(dim, bool):
            axes = list(range(ndim))
        elif isinstance(dim, int):
            axes = [dim % ndim]
        else:
            axes = [d % ndim for d in dim]
        return sorted(set(axes), reverse=True), bool(keep)

    def _reduce(self, node, repeat):
        name = aten_name(node.target)
        v = self.read(node.args[0], repeat)
        meta = _meta(node)
        multi = isinstance(meta, list)
        if not isinstance(v, _Val) or v.tensor is None or v.ndim == 0:
            return self._fallback(name, node, repeat, record=False)
        axes, keep = self._reduce_axes(node, v.ndim)
        isz = (meta[0] if multi else meta)[1] if meta else v.itemsize
        for n, ax in enumerate(axes):
            ndims = v.dims[:ax] + v.dims[ax + 1:]
            nshape = v.shape[:ax] + v.shape[ax + 1:]
            if v.shape[ax] <= 1:      # reducing a singleton: pure alias
                v = _Val(v.tensor, ndims, nshape, v.itemsize)
                continue
            out = self.tensor(name, ndims, nshape,
                              isz if n == len(axes) - 1 else v.itemsize)
            self.reduce(v, out, ax, repeat)
            v = out
        if keep:
            d, s = list(v.dims), list(v.shape)
            for ax in sorted(axes):
                d.insert(ax, self.dt.new(1))
                s.insert(ax, 1)
            v = _Val(v.tensor, tuple(d), tuple(s), v.itemsize)
        if multi:
            return [v, v]
        return v

    def _softmax_like(self, node, repeat) -> _Val:
        """repro's jax.nn.softmax: the max and the sum reduces over the
        softmax dim, the output an alias of the input (the normalizing
        subtract, exp and divide alias it)."""
        v = self.read(node.args[0], repeat)
        shape, isz = self._out(node)
        ax = node.args[1] % v.ndim
        if v.shape[ax] > 1:
            dims = v.dims[:ax] + v.dims[ax + 1:]
            sh = v.shape[:ax] + v.shape[ax + 1:]
            for prefix in ("amax", "sum"):
                out = self.tensor(prefix, dims, sh, 4.0)
                self.reduce(v, out, ax, repeat)
        return _Val(v.tensor, v.dims, v.shape, isz)

    _p__softmax = _softmax_like
    _p__log_softmax = _softmax_like

    def _cumulative(self, node, repeat) -> _Val:
        v = self.read(node.args[0], repeat)
        shape, isz = self._out(node)
        ax = node.args[1] % v.ndim if v.ndim else 0
        out = self.tensor(aten_name(node.target), v.dims, shape, isz)
        self.ewise([v], out, repeat,
                   align=[d for i, d in enumerate(v.dims) if i != ax])
        if isinstance(_meta(node), list):
            return [out, out]
        return out

    # -- einsum-class ops ------------------------------------------------
    def _dot(self, lhs: _Val, rhs: _Val, lc, rc, lb, rb, isz: float,
             repeat: float) -> _Val:
        """repro's ``_p_dot_general``: contraction and batch pairs
        unified, rhs free axes that collide with an lhs dim forked.  Also
        forked: an rhs paired axis whose dim is another lhs axis's (P @ V,
        where V's sequence is the queries' and P's key axis is the forked
        one): unifying it would fold P's query and key axes into one name,
        which the classifier then reads as a batch dim of q @ k^T and
        prices a sequence cut of attention as free."""
        pairs = list(zip(lc, rc)) + list(zip(lb, rb))
        rdims = list(rhs.dims)
        forked = False
        for i, j in pairs:
            others = {self.dt.find(d) for k, d in enumerate(lhs.dims)
                      if k != i}
            rj = self.dt.find(rhs.dims[j])
            if rj != self.dt.find(lhs.dims[i]) and rj in others:
                rdims[j] = self.dt.new(rhs.shape[j])
                forked = True
        for i, j in pairs:
            self.dt.unify(lhs.dims[i], rdims[j])
        lhs_roots = {self.dt.find(d) for d in lhs.dims}
        # fork rhs free axes whose dim collides with an lhs dim: without a
        # fork the classifier would see a spurious batch dim (q @ k^T with
        # both seq axes unified is the canonical case)
        for k, d in enumerate(rhs.dims):
            if k in rc or k in rb:
                continue
            if self.dt.find(d) in lhs_roots:
                rdims[k] = self.dt.new(rhs.shape[k])
                forked = True
        if forked:
            fork = self.tensor("fork", rdims, rhs.shape, rhs.itemsize)
            self.tie(rhs, fork, [(i, i) for i in range(len(rdims))],
                     repeat)
            rhs = fork
        lfree = [i for i in range(lhs.ndim) if i not in lc + lb]
        rfree = [i for i in range(rhs.ndim) if i not in rc + rb]
        axes = ([(lhs, i) for i in lb] + [(lhs, i) for i in lfree]
                + [(rhs, i) for i in rfree])
        out_dims = [v.dims[i] for v, i in axes]
        shape = tuple(v.shape[i] for v, i in axes)
        # de-duplicate within the output (duplicate names break the
        # einsum classifier; only degenerate graphs hit this)
        seen = set()
        for i, d in enumerate(out_dims):
            r = self.dt.find(d)
            if r in seen:
                out_dims[i] = self.dt.new(shape[i])
            else:
                seen.add(r)
        out = self.tensor("mm", out_dims, shape, isz)
        self.einsum(lhs, rhs, out, repeat)
        return out

    def _product(self, node, li: int, batched: bool, repeat):
        """``mm`` / ``bmm`` (operands ``node.args[li]``, ``[li + 1]``) as
        one einsum of the unmerged operands where they are deferred
        merges whose contracted (and batch) groups pair axis for axis;
        the result is a deferred merge of the einsum's output when a
        group holds several axes."""
        lhs = self.read(node.args[li], repeat, keep_merged=True)
        rhs = self.read(node.args[li + 1], repeat, keep_merged=True)
        shape, isz = self._out(node)

        def grouped(x):
            # size-1 axes belong to no group: they pair with nothing and
            # stay free axes of the product
            src, groups = (x.src, x.groups) if isinstance(x, _Merged) \
                else (x, [(i,) for i in range(x.ndim)])
            return src, [tuple(i for i in gr if src.shape[i] != 1)
                         for gr in groups]
        ls, lg = grouped(lhs)
        rs, rg = grouped(rhs)
        if batched:
            (lb, lm, lk), (rb, rk, rn) = lg, rg
        else:
            (lm, lk), (rk, rn) = lg, rg
            lb = rb = ()

        def pairs(a, b):
            return len(a) == len(b) and all(
                ls.shape[i] == rs.shape[j] for i, j in zip(a, b))
        if not (pairs(lk, rk) and pairs(lb, rb)):
            ls, rs = self._resolve(lhs, repeat), self._resolve(rhs, repeat)
            if batched:
                lb, lk, rb, rk = (0,), (2,), (0,), (1,)
            else:
                lb, lk, rb, rk = (), (1,), (), (0,)
        out = self._dot(ls, rs, tuple(lk), tuple(rk), tuple(lb), tuple(rb),
                        isz, repeat)
        nb = len(lb)
        nm = ls.ndim - len(lk) - nb
        groups = ([tuple(range(nb))] if batched else []) + [
            tuple(range(nb, nb + nm)), tuple(range(nb + nm, out.ndim))]
        if out.shape == tuple(shape):
            return out
        return _Merged(out, tuple(groups), tuple(shape))

    def _p_mm(self, node, repeat):
        return self._product(node, 0, False, repeat)

    def _p_addmm(self, node, repeat):
        out = self._product(node, 1, False, repeat)
        bias = self.read(node.args[0], repeat)
        o = out.src if isinstance(out, _Merged) else out
        if isinstance(bias, _Val) and bias.ndim and \
                bias.shape[-1] == o.shape[-1]:
            self.dt.unify(o.dims[-1], bias.dims[-1])
        return out

    def _p_bmm(self, node, repeat):
        return self._product(node, 0, True, repeat)

    def _p_baddbmm(self, node, repeat):
        return self._product(node, 1, True, repeat)

    # -- indexing --------------------------------------------------------
    def _slice_to(self, v: _Val, shape: Tuple[int, ...], repeat) -> _Val:
        """repro's ``_slice_like``: the axes that keep their size keep
        their dim (the op's alignment), the cut ones get fresh dims."""
        dims = [v.dims[i] if v.shape[i] == shape[i] else self.dt.new(s)
                for i, s in enumerate(shape)]
        out = self.tensor("slc", dims, shape, v.itemsize)
        self.ewise([v], out, repeat, update=True,
                   align=[d for i, d in enumerate(dims)
                          if v.shape[i] == shape[i]])
        return out

    def _p_slice(self, node, repeat):
        v = self.read(node.args[0], repeat)
        shape, isz = self._out(node)
        if not isinstance(v, _Val) or v.tensor is None:
            return self._fill(node, repeat)
        if tuple(shape) == v.shape:
            return v
        return self._slice_to(v, tuple(shape), repeat)

    def _p_select(self, node, repeat):
        v = self.read(node.args[0], repeat)
        if not isinstance(v, _Val) or v.tensor is None:
            return self._fill(node, repeat)
        d = node.args[1] % v.ndim
        keep = [i for i in range(v.ndim) if i != d]
        dims = [v.dims[i] for i in keep]
        shape = [v.shape[i] for i in keep]
        if node in self.loop_slices:
            # the iteration's slice of a stacked tensor (repro's xs slice)
            sl = self.tensor("xslice", dims, shape, v.itemsize)
            self.tie(v, sl, [(i, k) for k, i in enumerate(keep)], repeat)
            return sl
        if v.shape[d] == 1:
            return _Val(v.tensor, tuple(dims), tuple(shape), v.itemsize)
        out = self.tensor("sel", dims, shape, v.itemsize)
        self.ewise([v], out, repeat, update=True, align=dims)
        return out

    def _p_unbind(self, node, repeat):
        v = self.read(node.args[0], repeat)
        d = (node.args[1] if len(node.args) > 1 else 0) % v.ndim
        return [_Lazy(v, d, i, None) for i in range(v.shape[d])]

    def _split(self, node, sizes, d, repeat):
        v = self.read(node.args[0], repeat)
        d %= v.ndim
        out, start = [], 0
        for s in sizes:
            out.append(_Lazy(v, d, start, s) if s != v.shape[d] else v)
            start += s
        return out

    def _p_split(self, node, repeat):
        v = self.read(node.args[0], repeat)
        size = node.args[1]
        d = node.args[2] if len(node.args) > 2 else node.kwargs.get("dim", 0)
        n = v.shape[d % v.ndim]
        if isinstance(size, int):
            sizes = [min(size, n - i) for i in range(0, n, size)]
        else:
            sizes = list(size)
        return self._split(node, sizes, d, repeat)

    def _p_split_with_sizes(self, node, repeat):
        d = node.args[2] if len(node.args) > 2 else node.kwargs.get("dim", 0)
        return self._split(node, list(node.args[1]), d, repeat)

    def _p_cat(self, node, repeat):
        shape, isz = self._out(node)
        k = (node.args[1] if len(node.args) > 1
             else node.kwargs.get("dim", 0)) % max(len(shape), 1)
        arrs = [v for v in self.read(node.args[0], repeat)
                if isinstance(v, _Val) and v.tensor is not None
                and v.ndim == len(shape)]
        if not arrs:
            return self._fill(node, repeat)
        ref = arrs[0]
        dims = []
        for j, s in enumerate(shape):
            if j == k:
                dims.append(self.dt.new(s))
                continue
            for other in arrs[1:]:
                self.dt.unify(ref.dims[j], other.dims[j])
            dims.append(ref.dims[j])
        out = self.tensor("cat", dims, shape, isz)
        self.ewise(arrs, out, repeat)
        return out

    def _p_stack(self, node, repeat):
        shape, isz = self._out(node)
        k = (node.args[1] if len(node.args) > 1
             else node.kwargs.get("dim", 0)) % max(len(shape), 1)
        vals = self.read(node.args[0], repeat)
        arrs = [v for v in vals if isinstance(v, _Val)
                and v.tensor is not None]
        if not arrs:
            return self._fill(node, repeat)
        ref = arrs[0]
        dims = list(ref.dims)
        dims.insert(k, self.dt.new(shape[k]))
        if all(v.tensor == ref.tensor and v.dims == ref.dims for v in arrs):
            # a folded loop's per-iteration results: the stack ties the
            # body's value (repro's ys stacking)
            st = self.tensor("ystack", dims, shape, isz)
            self.tie(ref, st, [(i, i if i < k else i + 1)
                               for i in range(ref.ndim)], repeat)
            return st
        for other in arrs[1:]:
            for a, b in zip(ref.dims, other.dims):
                self.dt.unify(a, b)
        out = self.tensor("stack", dims, shape, isz)
        self.ewise(arrs, out, repeat)
        return out

    def _p_constant_pad_nd(self, node, repeat):
        v = self.read(node.args[0], repeat)
        shape, isz = self._out(node)
        pad = list(node.args[1])
        changed = set()
        for i in range(len(pad) // 2):
            if pad[2 * i] or pad[2 * i + 1]:
                changed.add(v.ndim - 1 - i)
        dims = [v.dims[i] if i not in changed else self.dt.new(shape[i])
                for i in range(v.ndim)]
        out = self.tensor("pad", dims, shape, isz)
        self.ewise([v], out, repeat,
                   align=[d for i, d in enumerate(dims) if i not in changed])
        return out

    def _p_flip(self, node, repeat):
        v = self.read(node.args[0], repeat)
        rd = {d % v.ndim for d in node.args[1]}
        out = self.tensor("rev", v.dims, v.shape, v.itemsize)
        self.ewise([v], out, repeat,
                   align=[d for i, d in enumerate(v.dims) if i not in rd])
        return out

    def _gather_rows(self, operand: _Val, idx: _Val, axis: int, shape,
                     isz, repeat) -> _Val:
        """repro's ``_p_gather`` for a row gather along ``axis``: the
        output's index axes carry the index's dims, the other axes (whole
        slices) the operand's."""
        dims = []
        n_idx = len(shape) - operand.ndim + 1
        for j, s in enumerate(shape):
            if j < axis:
                d = operand.dims[j] if operand.shape[j] == s else None
            elif j < axis + n_idx:
                i = j - axis
                d = idx.dims[i] if i < idx.ndim and idx.shape[i] == s \
                    else None
            else:
                a = j - n_idx + 1
                d = operand.dims[a] if operand.shape[a] == s else None
            dims.append(d if d is not None else self.dt.new(s))
        out = self.tensor("gth", dims, shape, isz)
        self.ewise([v for v in (operand, idx)
                    if isinstance(v, _Val) and v.tensor is not None],
                   out, repeat)
        return out

    def _p_embedding(self, node, repeat):
        w = self.read(node.args[0], repeat)
        idx = self.read(node.args[1], repeat)
        shape, isz = self._out(node)
        return self._gather_rows(w, idx, 0, shape, isz, repeat)

    def _p_index(self, node, repeat):
        v = self.read(node.args[0], repeat)
        idxs = self.read(node.args[1], repeat)
        shape, isz = self._out(node)
        live = [i for i, x in enumerate(idxs) if x is not None]
        if len(live) != 1 or not all(x is None for x in idxs[:live[0]]):
            return self._fallback("index", node, repeat)
        return self._gather_rows(v, idxs[live[0]], live[0], shape, isz,
                                 repeat)

    def _p_index_select(self, node, repeat):
        v = self.read(node.args[0], repeat)
        idx = self.read(node.args[2], repeat)
        shape, isz = self._out(node)
        return self._gather_rows(v, idx, node.args[1] % v.ndim, shape, isz,
                                 repeat)

    def _p_gather(self, node, repeat):
        v = self.read(node.args[0], repeat)
        idx = self.read(node.args[2], repeat)
        shape, isz = self._out(node)
        ax = node.args[1] % v.ndim
        dims = []
        for j, s in enumerate(shape):
            if j != ax and v.shape[j] == s:
                dims.append(v.dims[j])
            elif idx.tensor is not None and idx.shape[j] == s:
                dims.append(idx.dims[j])
            else:
                dims.append(self.dt.new(s))
        out = self.tensor("gth", dims, shape, isz)
        self.ewise([x for x in (v, idx) if x.tensor is not None], out,
                   repeat)
        return out

    def _scatter_like(self, node, repeat):
        v = self.read(node.args[0], repeat)
        shape, isz = self._out(node)
        if not isinstance(v, _Val) or v.tensor is None:
            return self._fallback(aten_name(node.target), node, repeat)
        out = self.tensor("sct", v.dims, shape, isz)
        self.ewise(self._arrays(node, repeat), out, repeat)
        return out

    def _p_topk(self, node, repeat):
        v = self.read(node.args[0], repeat)
        ax = (node.args[2] if len(node.args) > 2
              else node.kwargs.get("dim", -1)) % v.ndim
        outs = []
        for m in _meta(node):
            shape, isz = m
            dims = list(v.dims)
            dims[ax] = self.dt.new(shape[ax])
            out = self.tensor("topk", dims, shape, isz)
            self.ewise([v], out, repeat,
                       align=[d for i, d in enumerate(v.dims) if i != ax])
            outs.append(out)
        return outs

    def _p_sort(self, node, repeat):
        v = self.read(node.args[0], repeat)
        ax = node.kwargs.get("dim", next((a for a in node.args[1:]
                                          if isinstance(a, int)
                                          and not isinstance(a, bool)),
                                         -1)) % v.ndim
        metas = _meta(node)
        metas = metas if isinstance(metas, list) else [metas]
        outs = []
        for shape, isz in metas:
            out = self.tensor("sort", v.dims, shape, isz)
            self.ewise([v], out, repeat,
                       align=[d for i, d in enumerate(v.dims) if i != ax])
            outs.append(out)
        return outs if len(outs) > 1 else outs[0]

    def _p_tril(self, node, repeat):
        # a mask of the input by its own positions (repro: iota compares
        # and a select against zeros): an alias, as a unary op is
        return self._alias(node, repeat)

    _p_triu = _p_tril

    def _p_log_sigmoid_forward(self, node, repeat):
        v = self._alias(node, repeat)
        return [v, v]

    def _p_searchsorted(self, node, repeat):
        seq = self.read(node.args[0], repeat)
        vals = self.read(node.args[1], repeat)
        shape, isz = self._out(node)
        if not isinstance(vals, _Val) or vals.tensor is None:
            return self._fallback("searchsorted", node, repeat)
        out = self.tensor("srch", vals.dims, shape, isz)
        self.ewise([x for x in (seq, vals) if isinstance(x, _Val)
                    and x.tensor is not None], out, repeat,
                   align=vals.dims[:-1])
        return out

    def _fill(self, node, repeat) -> _Val:
        m = _meta(node)
        if m is None or isinstance(m, list):
            return self._fallback(aten_name(node.target), node, repeat,
                                  record=False)
        shape, isz = m
        if not shape:
            return _Val(None, (), (), isz)
        return self.leaf("fill", shape, isz, kind="activation")

    # -- fallback --------------------------------------------------------
    def _fallback(self, name, node, repeat, record: bool = True):
        """Conservative ewise lowering.  ``record=False``: the caller
        judged the bail-out harmless (pure-scalar compute) — every other
        coarse lowering is surfaced in ``unknown_primitives`` so a coarse
        capture is never reported as exact."""
        if record and name not in self.unknown:
            self.unknown.append(name)
        arrs = self._arrays(node, repeat)
        metas = _meta(node)
        multi = isinstance(metas, list)
        outs = []
        for m in (metas if multi else [metas]):
            if m is None:
                outs.append(None)
                continue
            shape, isz = m
            if not shape:
                outs.append(_Val(None, (), (), isz))
                continue
            dims = None
            for v in arrs:
                if v.shape == tuple(shape):
                    dims = v.dims
                    break
            if dims is None:
                dims = self.new_dims(shape)
            out = self.tensor(name, dims, shape, isz)
            if arrs:
                self.ewise(arrs, out, repeat)
            outs.append(out)
        return outs if multi else outs[0]

    # -- finalize --------------------------------------------------------
    def val_axis_names(self, v) -> Tuple[str, ...]:
        """Final dim names of a view, aligned to ITS axis order (an alias
        view may permute / extend its tensor's axes).  Must be called
        after :meth:`finalize`."""
        if not isinstance(v, _Val) or v.tensor is None:
            return ()
        tdims = self.tensors[v.tensor].dims
        fdims = self._final_dims[v.tensor]
        out = []
        for k, d in enumerate(v.dims):
            try:
                out.append(fdims[tdims.index(d)])
            except ValueError:    # inserted size-1 axis: never cuttable
                out.append(f"_one{k}")
        return tuple(out)

    def finalize(self) -> Graph:
        names: Dict[int, str] = {}

        def dim_name(d: int) -> str:
            r = self.dt.find(d)
            if r not in names:
                names[r] = f"d{len(names)}"
            return names[r]

        g = Graph(self.name)
        final_dims: Dict[str, Tuple[str, ...]] = {}
        self._final_dims = final_dims
        for t in self.tensors.values():
            dims: List[str] = []
            used: Dict[str, int] = {}
            for d in t.dims:
                nm = dim_name(d)
                k = used.get(nm, 0)
                used[nm] = k + 1
                dims.append(nm if k == 0 else f"{nm}x{k}")
            units = {}
            for d, u in t.units.items():
                nm = dim_name(d)
                if nm in dims and u > 1:
                    units[nm] = u
            final_dims[t.name] = tuple(dims)
            g.tensor(t.name, dims, t.shape, t.bytes_per_elem, t.kind,
                     role=None, units=units)

        for i, op in enumerate(self.ops):
            nm = f"{op.kind[:2]}{i}:{op.output}"
            if op.kind == "einsum":
                g.einsum(nm, op.inputs[0], op.inputs[1], op.output,
                         op.repeat)
            elif op.kind == "ewise":
                align = None
                if op.align is not None:
                    out_dims = set(final_dims[op.output])
                    align = tuple(d for d in
                                  dict.fromkeys(dim_name(a)
                                                for a in op.align)
                                  if d in out_dims)
                g.ewise(nm, op.inputs, op.output, op.repeat,
                        align_dims=align, update=op.update)
            elif op.kind == "reduce":
                axis = final_dims[op.inputs[0]][op.axis]
                g.reduce(nm, op.inputs[0], op.output, axis, op.repeat)
            else:
                forms = []
                for spec, pen in op.forms:
                    form = {}
                    for tname, s in spec.items():
                        if s == "r":
                            form[tname] = REPLICATE
                        else:
                            form[tname] = Part(final_dims[tname][s[1]])
                    forms.append((form, pen))
                g.custom(nm, op.inputs, op.output, forms, op.repeat)
        return g


def _reshape_groups(src: Tuple[int, ...], dst: Tuple[int, ...]):
    """Greedy factorization of a reshape into groups of axes whose size
    products match; None when the shapes cannot be grouped (should not
    happen for equal element counts, but stay safe)."""
    groups = []
    i = j = 0
    while i < len(src) or j < len(dst):
        si, sj = [i], [j]
        if i >= len(src) or j >= len(dst):
            # trailing size-1 axes on one side
            rest_i = list(range(i, len(src)))
            rest_j = list(range(j, len(dst)))
            if all(src[a] == 1 for a in rest_i) and \
                    all(dst[a] == 1 for a in rest_j):
                if groups and (rest_i or rest_j):
                    groups.append((rest_i, rest_j))
                break
            return None
        pi, pj = src[i], dst[j]
        i += 1
        j += 1
        while pi != pj:
            if pi < pj:
                if i >= len(src):
                    return None
                pi *= src[i]
                si.append(i)
                i += 1
            else:
                if j >= len(dst):
                    return None
                pj *= dst[j]
                sj.append(j)
                j += 1
        groups.append((si, sj))
    return groups


def _merge_groups(src: Tuple[int, ...], dst: Tuple[int, ...]):
    """Per ``dst`` axis, the ``src`` axes it holds, when the reshape only
    merges runs of consecutive axes (size-1 axes on either side belong to
    no group); None when it splits an axis."""
    sa = [i for i, s in enumerate(src) if s != 1]
    da = [j for j, s in enumerate(dst) if s != 1]
    groups = _reshape_groups(tuple(src[i] for i in sa),
                             tuple(dst[j] for j in da))
    if groups is None:
        return None
    out: List[Tuple[int, ...]] = [() for _ in dst]
    for gs, gd in groups:
        if len(gd) != 1:
            return None
        out[da[gd[0]]] = tuple(sa[i] for i in gs)
    return tuple(out)


# ---------------------------------------------------------------------------
# loop folding
# ---------------------------------------------------------------------------

_MAX_FOLD_TRIES = 48


def _signature(node) -> tuple:
    """What makes two nodes the same step of a loop: the op, the shapes
    and dtypes of its tensor arguments and outputs, and its constant
    arguments (a ``select``'s index excepted: the iteration's slice)."""
    import torch
    from torch.fx import Node

    def arg(a, wild=False):
        if isinstance(a, Node):
            v = a.meta.get("val")
            if isinstance(v, torch.Tensor):
                return ("N", tuple(v.shape), str(v.dtype))
            return ("N",)
        if isinstance(a, (list, tuple)):
            return tuple(arg(x) for x in a)
        if wild:
            return "*"
        return repr(a)
    sel = aten_name(node.target) == "select" \
        if node.target is not operator.getitem else False
    args = tuple(arg(a, wild=sel and i == 2)
                 for i, a in enumerate(node.args))
    kw = tuple(sorted((k, arg(v)) for k, v in node.kwargs.items()))
    v = node.meta.get("val")
    if isinstance(v, torch.Tensor):
        out = (tuple(v.shape), str(v.dtype))
    elif isinstance(v, (list, tuple)):
        out = tuple((tuple(x.shape), str(x.dtype))
                    if isinstance(x, torch.Tensor) else None for x in v)
    else:
        out = None
    return (str(node.target), args, kw, out)


def _stacked_slice(n):
    """(base, dim, index) when node ``n`` is a constant slice of a stacked
    tensor: ``getitem(unbind(base, dim), i)`` or ``select(base, dim, i)``;
    else None."""
    from torch.fx import Node
    if not isinstance(n, Node) or n.op != "call_function":
        return None
    if n.target is operator.getitem:
        u = n.args[0]
        if isinstance(u, Node) and u.op == "call_function" and \
                u.target is not operator.getitem and \
                aten_name(u.target) == "unbind":
            d = u.args[1] if len(u.args) > 1 else 0
            return (u.args[0], d, n.args[1])
        return None
    if aten_name(n.target) == "select":
        return (n.args[0], n.args[1], n.args[2])
    return None


def _verify_fold(nodes, pos, s: int, p: int, k: int):
    """Check that ``nodes[s : s + k p]`` is k iterations of one body of
    ``p`` nodes; returns (count that hold, carries, loop slices)."""
    from torch.fx import Node
    carries: Dict[Tuple[int, int], int] = {}    # (q, arg i) -> offset r
    carry_src: Dict[Tuple[int, int], Any] = {}
    steps: Dict[Tuple[int, int], int] = {}      # slice progressions
    slices: set = set()

    def flat(args):
        out = []
        for a in args:
            if isinstance(a, (list, tuple)):
                out.extend(flat(a))
            else:
                out.append(a)
        return out

    def seg_of(x):
        i = pos.get(x)
        if i is None or i < s or i >= s + k * p:
            return None, None
        return (i - s) // p, (i - s) % p

    for j in range(1, k):
        ok = True
        for q in range(p):
            n0, nj = nodes[s + q], nodes[s + j * p + q]
            if n0.target != nj.target:
                ok = False
                break
            a0 = flat(list(n0.args) + list(n0.kwargs.values()))
            aj = flat(list(nj.args) + list(nj.kwargs.values()))
            if len(a0) != len(aj):
                ok = False
                break
            sel = n0.target is not operator.getitem and \
                aten_name(n0.target) == "select"
            for i, (x0, xj) in enumerate(zip(a0, aj)):
                if not isinstance(x0, Node) or not isinstance(xj, Node):
                    if isinstance(x0, Node) or isinstance(xj, Node):
                        ok = False
                        break
                    if x0 != xj:
                        if sel and i == 2 and n0.args[0] is nj.args[0] \
                                and seg_of(n0.args[0])[0] is None:
                            step = steps.setdefault((q, i), xj - x0) \
                                if j == 1 else steps.get((q, i))
                            if step and xj - x0 == j * step:
                                slices.add(n0)
                                continue
                        ok = False
                        break
                    continue
                sg0, off0 = seg_of(x0)
                sgj, offj = seg_of(xj)
                if sg0 == 0:
                    if not (sgj == j and offj == off0):
                        ok = False
                        break
                    continue
                if sg0 is not None:         # seg 0 reading a later one
                    ok = False
                    break
                if xj is x0:
                    continue                # shared from before the loop
                if sgj == j - 1:            # a carry from the last step
                    r = carries.setdefault((q, i), offj)
                    if r != offj or carry_src.setdefault((q, i), x0) \
                            is not x0:
                        ok = False
                        break
                    continue
                s0, sj = _stacked_slice(x0), _stacked_slice(xj)
                if s0 is not None and sj is not None and \
                        s0[0] is sj[0] and s0[1] == sj[1] and \
                        seg_of(s0[0])[0] is None:
                    key = (q, i)
                    step = steps.setdefault(key, sj[2] - s0[2]) \
                        if j == 1 else steps.get(key)
                    if step and sj[2] - s0[2] == j * step:
                        continue
                ok = False
                break
            if not ok:
                break
        if not ok:
            return j, [], set()
    # intermediate iterations may be read after the run only by one
    # stack / cat of every iteration's value (repro's ys)
    end = s + k * p
    for q in range(p):
        for j in range(k - 1):
            n = nodes[s + j * p + q]
            for u in n.users:
                i = pos.get(u)
                if i is not None and s <= i < end:
                    continue
                want = [nodes[s + jj * p + q] for jj in range(k)]
                if u.op == "call_function" and \
                        u.target is not operator.getitem and \
                        aten_name(u.target) in ("stack", "cat") and \
                        list(u.args[0]) == want:
                    continue
                return 1, [], set()
    out = [(carry_src[key], r) for key, r in carries.items()]
    return k, out, slices


def _find_fold(cap: _Capture, nodes: List, a: int, b: int):
    """The fold of ``nodes[a:b]`` covering the most nodes: (start,
    period, count, carries, loop slices), or None."""
    import numpy as np
    if b - a < 2:
        return None
    ids: Dict[tuple, int] = {}
    cache = cap.signatures
    for nd in nodes[a:b]:
        if nd not in cache:
            cache[nd] = _signature(nd)
    sig = np.array([ids.setdefault(cache[nd], len(ids))
                    for nd in nodes[a:b]], dtype=np.int64)
    n = len(sig)
    if len(ids) == n:
        return None
    cands = []
    for p in range(1, n // 2 + 1):
        eq = sig[:-p] == sig[p:]
        if not eq.any():
            continue
        d = np.diff(np.concatenate(([0], eq.astype(np.int8), [0])))
        starts = np.flatnonzero(d == 1)
        ends = np.flatnonzero(d == -1)
        for i0, i1 in zip(starts, ends):
            r = int(i1 - i0)
            if r < p:
                continue
            k = (r + p) // p
            cands.append((-(k * p), p, int(i0), r))
    if not cands:
        return None
    cands.sort()
    pos = {nd: i for i, nd in enumerate(nodes)}
    for _, p, i0, r in cands[:_MAX_FOLD_TRIES]:
        for shift in range(min(p, r + 1)):
            s = a + i0 + shift
            k = (r + p - shift) // p
            if k < 2:
                break
            got, carries, slices = _verify_fold(nodes, pos, s, p, k)
            if got < 2:
                continue
            if got < k:
                got, carries, slices = _verify_fold(nodes, pos, s, p, got)
                if got < 2:
                    continue
            return s, p, got, carries, slices
    return None


# ---------------------------------------------------------------------------
# public capture API
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Traced:
    """A captured program: the semantic graph plus the mapping from the
    function's flattened inputs/outputs to graph tensor names (the
    generalized "roles" the sharding plan is keyed on).  ``in_dims`` /
    ``out_dims`` give each leaf's dim names in the LEAF's own axis order
    (an output may be an alias view that permutes its tensor's axes).
    ``unknown_primitives`` names the aten ops lowered by the fallback."""

    graph: Graph
    in_tensors: List[Optional[str]]       # per flattened input leaf
    out_tensors: List[Optional[str]]      # per flattened output leaf
    in_dims: List[Tuple[str, ...]]
    out_dims: List[Tuple[str, ...]]
    in_tree: Any                          # pytree spec of (args, kwargs)
    out_tree: Any                         # pytree spec of the output
    out_shape: List[Any]                  # per output leaf: (shape, dtype)
    unknown_primitives: List[str]
    folds: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)             # (start, period, count)

    def tensor_roles(self) -> Dict[str, str]:
        """Identity role map (tensor name -> itself) for
        ShardingPlan.from_solution — the plan is keyed by traced tensor
        ids, not hand-written role names."""
        return {t: t for t in self.graph.tensors}

    def dims_of(self, tensor: str):
        return self.graph.tensors[tensor].dims


def capture(fn: Callable, *example_args, name: Optional[str] = None,
            weight_argnums: Sequence[int] = (),
            **example_kwargs) -> Traced:
    """Trace ``fn`` on example arguments (tensors or pytrees of tensors;
    only their shapes and dtypes are read: the trace runs on meta
    tensors) and lower its aten graph to a semantic graph.  Tensor leaves
    of arguments listed in ``weight_argnums`` are marked kind="weight"
    (they then take part in the solver's capacity accounting like builder
    weights)."""
    from ..obs.tracing import span as _span
    with _span("trace.capture",
               fn=name or getattr(fn, "__name__", "traced")):
        return _capture_impl(fn, example_args, example_kwargs, name,
                             weight_argnums)


def _counters():
    from ..kernels import ops as kops
    return (kops.plain_calls, kops.bwd_recomputes, kops.plan_fallbacks,
            kops.all_to_all)


def _capture_impl(fn, example_args, example_kwargs, name,
                  weight_argnums) -> Traced:
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils import _pytree as pytree

    flat, in_tree = pytree.tree_flatten((example_args, example_kwargs))
    weight_leaf: List[bool] = []
    for i, a in enumerate(example_args):
        n = len(pytree.tree_leaves(a))
        weight_leaf.extend([i in set(weight_argnums)] * n)
    weight_leaf.extend([False] * len(pytree.tree_leaves(example_kwargs)))
    is_t = [isinstance(x, torch.Tensor) for x in flat]
    metas = [torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
             for x, t in zip(flat, is_t) if t]
    out_spec: List[Any] = [None]

    def flat_fn(*tensors):
        it = iter(tensors)
        leaves = [next(it) if t else x for x, t in zip(flat, is_t)]
        args, kwargs = pytree.tree_unflatten(leaves, in_tree)
        out_leaves, out_spec[0] = pytree.tree_flatten(fn(*args, **kwargs))
        return out_leaves

    saved = [dict(c) for c in _counters()]
    try:
        with torch.no_grad():
            gm = make_fx(flat_fn, tracing_mode="real")(*metas)
    finally:
        for c, s in zip(_counters(), saved):
            c.clear()
            c.update(s)

    cap = _Capture(name or getattr(fn, "__name__", "traced"))
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    in_vals: List[Optional[_Val]] = []
    ph = iter(placeholders)
    for i, (x, t) in enumerate(zip(flat, is_t)):
        if not t:
            in_vals.append(None)
            continue
        node = next(ph)
        kind = "weight" if i < len(weight_leaf) and weight_leaf[i] \
            else "input"
        v = cap.leaf(f"arg{i}", tuple(x.shape), _itemsize(x.dtype),
                     kind=kind)
        cap.env[node] = v
        in_vals.append(v)
    # constants the trace captured (a mask fill value made in every
    # layer): equal ones become one node, so the layers stay equal
    consts: Dict[Any, Any] = {}
    for node in list(gm.graph.nodes):
        if node.op != "get_attr":
            continue
        c = getattr(gm, node.target)
        key = (tuple(c.shape), str(c.dtype),
               None if c.device.type == "meta" or c.numel() > 4096
               else c.detach().cpu().numpy().tobytes())
        if key in consts:
            node.replace_all_uses_with(consts[key])
            gm.graph.erase_node(node)
        else:
            consts[key] = node
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            c = getattr(gm, node.target)
            cap.env[node] = _Val(None, (), (), _itemsize(c.dtype)) \
                if c.ndim == 0 else cap.leaf("const", tuple(c.shape),
                                             _itemsize(c.dtype),
                                             kind="activation")
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"]
    cap.lower_nodes(nodes, 0, len(nodes), 1.0)
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    outs = out_node.args[0]
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    out_vals = [cap.read(o, 1.0) if isinstance(o, torch.fx.Node) else None
                for o in outs]
    out_vals = [v if isinstance(v, _Val) and v.tensor is not None else None
                for v in out_vals]
    out_shape = [(tuple(o.meta["val"].shape), o.meta["val"].dtype)
                 if isinstance(o, torch.fx.Node)
                 and isinstance(o.meta.get("val"), torch.Tensor) else None
                 for o in outs]
    g = cap.finalize()
    return Traced(g, [v.tensor if v is not None else None for v in in_vals],
                  [v.tensor if v is not None else None for v in out_vals],
                  [cap.val_axis_names(v) for v in in_vals],
                  [cap.val_axis_names(v) for v in out_vals],
                  in_tree, out_spec[0], out_shape, cap.unknown, cap.folds)
