"""Param-path -> (role, physical dim names) rules: how the solver's
role-level tilings land on the param and cache trees (the port's copy of
``repro.models.sharding``; ``RULES`` and ``CACHE_RULES`` are repro's).

repro turns a leaf's ``PartitionSpec`` into a ``NamedSharding``; the port
turns the same spec into DTensor placements, one per mesh dim:
``Shard(i)`` where the mesh axis cuts tensor dim ``i``, ``Replicate()``
elsewhere.  Two mesh axes stacked on one dim (spec entry ``("data",
"model")``) become ``Shard(i)`` on both mesh dims; DTensor splits such a
dim by the mesh dims in mesh order, the first one major, which is JAX's
order for the tuple entry when the tuple follows the mesh order (a tuple
that does not is refused).

Stacked layer params carry a leading [L] axis (never sharded — layers are
replicated structure, sharding them is pipeline parallelism which is a
separate explicit axis)."""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ..core.plan import Spec

Tree = Dict[str, Any]

# (path regex, role, physical dims of the *unstacked* param)
RULES = [
    (r"(^|/)embed$", "embed", ("vocab", "d_model")),
    (r"(^|/)lm_head$", "lm_head", ("d_model", "vocab")),
    (r"attn/wq$", "wq", ("d_model", "heads")),
    (r"attn/wk$", "wk", ("d_model", "kv_heads")),
    (r"attn/wv$", "wv", ("d_model", "kv_heads")),
    (r"attn/wo$", "wo", ("heads", "d_model")),
    (r"attn/bq$", "wq", ("heads",)),
    (r"attn/b[kv]$", "wk", ("kv_heads",)),
    (r"mlp/wg$", "w_gate", ("d_model", "d_ff")),
    (r"mlp/wu$", "w_up", ("d_model", "d_ff")),
    (r"mlp/wd$", "w_down", ("d_ff", "d_model")),
    (r"moe/router$", "moe_gate", ("d_model", "expert")),
    (r"moe/w_gate$", "moe_up", ("expert", "d_model", "e_ff")),
    (r"moe/w_up$", "moe_up", ("expert", "d_model", "e_ff")),
    (r"moe/w_down$", "moe_down", ("expert", "e_ff", "d_model")),
    (r"w_in$", "ssm_in", ("d_model", "inner")),
    (r"w_bcdt$", "norm", ()),
    (r"(^|/)w_out$", "ssm_out", ("inner", "d_model")),
    (r"conv_w$", "ssm_conv", ("conv", "inner")),
    (r"slstm/\d*/?w_gates$|w_gates$", "ssm_in", ("d_model", "inner")),
    (r"w_up$", "w_up", ("d_model", "d_ff")),
    (r"w_down$", "w_down", ("d_ff", "d_model")),
    (r"norm$|ln\w*$|ln$|A_log$|(^|/)D$|dt_bias$|r_gates$", "norm", ()),
]

# cache / batch tensors
CACHE_RULES = [
    # paged serving tier: the block *pool* has no batch/seq axis (its
    # "blocks"/"block_len" dims deliberately don't alias "seq_kv", so a
    # solved flash-decoding seq_kv cut can't split a softmax block), and
    # the block table carries the batch cut of the cache it indexes.
    # These must precede the generic (^|/)k$ rule below.
    (r"pages/k$", "kv_cache",
     ("layer", "blocks", "block_len", "kv_heads", "hd")),
    (r"pages/v$", "kv_cache",
     ("layer", "blocks", "block_len", "kv_heads", "hd")),
    (r"block_table$", "block_table", ("batch", "blocks")),
    (r"kv?/k$|shared/k$|(^|/)k$", "kv_cache",
     ("layer", "batch", "seq_kv", "kv_heads", "hd")),
    (r"kv?/v$|shared/v$|(^|/)v$", "kv_cache",
     ("layer", "batch", "seq_kv", "kv_heads", "hd")),
    (r"ssm$", "ssm_state", ("layer", "batch", "inner", "hd", "sdim")),
    (r"conv$", "ssm_state", ("layer", "batch", "conv", "inner")),
    (r"(^|/)C$", "ssm_state", ("layer", "batch", "inner", "hd", "hd2")),
    (r"(^|/)[hcn]$", "ssm_state", ("layer", "batch", "inner", "hd")),
    (r"pos$", "norm", ()),
]


def _match(path: str, rules) -> Optional[Tuple[str, Tuple[str, ...]]]:
    for rx, role, dims in rules:
        if re.search(rx, path):
            return role, dims
    return None


def leaf_spec(plan, path: str, ndim: int, rules=RULES,
              suffixes: Tuple[str, ...] = ()) -> Spec:
    """The partition spec of one leaf (repro's ``leaf_pspec``, as a
    tuple; handles the stacked [L] axis).  ``suffixes``: derived-state
    lookup — the first ``role + suffix`` present in the plan wins, with
    the weight role itself as the final fallback."""
    m = _match(path, rules)
    if m is None or plan is None:
        return ()
    role, dims = m
    extra = ndim - len(dims)
    if extra > 0:
        dims = ("layer",) * extra + tuple(dims)
    elif extra < 0:
        dims = tuple(dims)[-ndim:] if ndim else ()
    for s in suffixes:
        if plan.has_role(role + s):
            return plan.pspec(role + s, dims)
    return plan.pspec(role, dims, default=())


def spec_placements(spec: Spec, mesh_axis_names: Sequence[str]) -> List:
    """DTensor placements of a partition spec on a mesh whose dims are
    named ``mesh_axis_names``: ``Shard(i)`` for each mesh dim that cuts
    tensor dim ``i``, ``Replicate()`` for the others."""
    names = list(mesh_axis_names)
    out: List = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"stacked axes {axes} on dim {i} do not follow the mesh "
                f"order {tuple(names)}: DTensor splits a dim by its mesh "
                "dims in mesh order, the first one major")
        for j in order:
            out[j] = Shard(i)
    return out


def leaf_placements(plan, path: str, ndim: int,
                    mesh_axis_names: Sequence[str], rules=RULES,
                    suffixes: Tuple[str, ...] = ()) -> List:
    """DTensor placements of one leaf under ``plan`` (replaces repro's
    ``leaf_pspec``): one per mesh dim."""
    return spec_placements(leaf_spec(plan, path, ndim, rules, suffixes),
                           mesh_axis_names)


def tree_placements(plan, tree: Tree, mesh_axis_names: Sequence[str],
                    rules=RULES, suffixes: Tuple[str, ...] = (),
                    prefix: str = "") -> Tree:
    """Placements for every leaf of a nested dict of tensors, keyed by
    its ``a/b/c`` path as repro keys its pytree paths."""
    out: Tree = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out[k] = tree_placements(plan, v, mesh_axis_names, rules,
                                     suffixes, path)
        else:
            out[k] = leaf_placements(plan, path, v.ndim, mesh_axis_names,
                                     rules, suffixes)
    return out


def batch_placements(plan, mesh_axis_names: Sequence[str],
                     kind: str = "train"):
    """Placements of the input batch (repro's ``batch_pspec``): tokens
    and labels [B, S] for ``train`` / ``prefill``, the rank-1 [B] token
    vector for ``decode``."""
    if plan is None:
        tok: Spec = ()
    else:
        tok = plan.pspec("x", ("batch", "seq", "d_model"))
    bspec = (tok[0] if len(tok) else None, tok[1] if len(tok) > 1 else None)
    if kind == "decode":
        return spec_placements(bspec[:1], mesh_axis_names)
    pl = spec_placements(bspec, mesh_axis_names)
    if kind == "train":
        return {"tokens": pl, "labels": pl}
    return pl


def place_tree(tree: Tree, mesh, plan, rules=RULES) -> Tree:
    """Every leaf of ``tree`` as a DTensor on ``mesh`` under ``plan``.
    A leaf that is a DTensor already is taken as it stands, so callers
    may pass full tensors (the same on every rank) or placed ones.  On a
    mesh of more than one rank every leaf takes rank 0's values; on one
    rank the DTensor holds the leaf's own storage (``place``)."""
    pl = tree_placements(plan, tree, mesh.mesh_dim_names, rules)

    def go(t: Tree, p: Tree) -> Tree:
        out: Tree = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = go(v, p[k])
            elif isinstance(v, torch.distributed.tensor.DTensor):
                out[k] = v
            elif mesh.size() == 1:
                out[k] = place(v, mesh, p[k])
            else:
                out[k] = distribute_tensor(v, mesh, p[k])
        return out
    return go(tree, pl)


def _whole_locally(placements: Sequence, mesh) -> bool:
    """Whether every cut of ``placements`` is of a mesh dim of size 1, so
    that each rank's shard is the whole tensor."""
    return all(not isinstance(p, Shard) or mesh.size(j) == 1
               for j, p in enumerate(placements))


def place(t: torch.Tensor, mesh, placements: Sequence):
    """``t``, the same full tensor on every rank, as a DTensor under
    ``placements``: each rank keeps its own slice and nothing moves
    between ranks.  Where that slice is all of ``t`` (every cut on a mesh
    dim of size 1: one card's (1, 1) mesh) the DTensor holds ``t``'s own
    storage, as a replicated one does; ``distribute_tensor`` would copy
    it (a 17.7 GB copy of moonshot's stacked experts under a plan that
    cuts them on "model")."""
    if _whole_locally(placements, mesh):
        d = from_local(t.detach().contiguous(), mesh, placements, t.shape)
        return d.requires_grad_(t.requires_grad)
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def from_local(x: torch.Tensor, mesh, placements: Sequence,
               shape: Sequence[int]):
    """This rank's shard ``x`` as a DTensor of global ``shape``
    (contiguous) under ``placements``: nothing is checked and nothing
    moves between ranks."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(
        x, mesh, placements, run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def like_placed(x: torch.Tensor, ref):
    """Local tensor ``x`` as a DTensor placed and shaped as ``ref`` (``x``
    itself when ``ref`` is a plain tensor)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(ref, DTensor):
        return x
    return from_local(x, ref.device_mesh, ref.placements, ref.shape)


def zeros_placed(shape: Sequence[int], dtype, mesh, placements: Sequence,
                 device=None):
    """A DTensor of zeros of global ``shape`` under ``placements``.  Each
    rank allocates only its own shard, of the local shape
    ``distribute_tensor`` would give it, so no rank ever holds the whole
    tensor."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    lshape, _ = compute_local_shape_and_global_offset(shape, mesh,
                                                      placements)
    return from_local(torch.zeros(lshape, dtype=dtype, device=device), mesh,
                      placements, shape)


def zeros_tree(shapes: Tree, mesh, plan, rules=RULES, device=None) -> Tree:
    """DTensors of zeros for a tree of (shape, dtype) leaves, placed under
    ``plan``, each rank allocating its shard only (``zeros_placed``).  The
    linear cache cut on ``batch`` leaves each card its part; the paged
    pool [L, NB, BL, KV, hd] takes the ``kv_cache`` cuts on (blocks,
    block_len, kv_heads, hd), so having no batch dim it is replicated over
    the data axis, and its table [B, MB] the ``block_table`` cuts on
    (batch, blocks)."""
    def go(t: Tree, prefix: str) -> Tree:
        out: Tree = {}
        for k, v in t.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = go(v, path)
                continue
            shape, dtype = v
            pl = leaf_placements(plan, path, len(shape),
                                 mesh.mesh_dim_names, rules)
            out[k] = zeros_placed(shape, dtype, mesh, pl, device)
        return out
    return go(shapes, "")


def global_offset(t) -> Tuple[int, ...]:
    """Global offset, per tensor dim, of this rank's local shard of
    DTensor ``t`` (zeros for a plain tensor: all of it is local)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    if not isinstance(t, DTensor):
        return (0,) * t.ndim
    return tuple(compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)[1])


def even_placements(placements: Sequence, shape: Sequence[int],
                    mesh) -> List:
    """``placements`` without the cuts whose degree does not divide
    their dim (for_pool's rule: of the mesh dims that cut one tensor dim,
    in mesh order, the largest prefix whose product divides the dim
    stays), and without those of a mesh dim of size 1, which cut
    nothing.  A one-row prefill chunk thus stays whole on a batch cut
    (DTensor refuses to flatten a cut dim of size 1, as the chunk's
    matmuls do, even on a mesh dim of size 1)."""
    out = list(placements)
    prod: Dict[int, int] = {}
    for j, p in enumerate(placements):
        if isinstance(p, Shard) and mesh.size(j) == 1:
            out[j] = Replicate()
        elif isinstance(p, Shard):
            d = p.dim % len(shape)
            n = prod.get(d, 1) * mesh.size(j)
            if shape[d] % n:
                out[j] = Replicate()
            else:
                prod[d] = n
    return out


def redistribute(t, placements: Sequence):
    """``t.redistribute(t.device_mesh, placements)``, with every gather of
    a one-row DTensor (dim 0 of size 1) run on its leading dim: the
    tensor is squeezed first and unsqueezed after.  torch's functional
    all-gather of a local tensor whose dim 0 has size 1, along a later
    dim, returns a view of the collective's output before it has been
    waited for; on gloo ranks such gathers (a batch-1 scan step's query
    or ``zx`` cut on heads or inner) aborted with a corrupted heap now and
    then."""
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    if list(placements) == list(t.placements):
        return t
    if t.ndim < 2 or t.shape[0] != 1 or any(
            isinstance(p, Shard) and p.dim == 0
            for p in list(t.placements) + list(placements)):
        return t.redistribute(mesh, placements)
    down = [Shard(p.dim - 1) if isinstance(p, Shard) else p
            for p in placements]
    return t.squeeze(0).redistribute(mesh, down).unsqueeze(0)



def matmul(x, w):
    """``x @ w``: x [..., d] (an activation, as the layers' projections
    take it), w [d, n].  DTensor's matmul flattens x's leading dims into
    one first, and torch 2.11 refuses that view where a leading dim other
    than the first is cut ("Attempted to flatten multiple dimensions,
    with dimension 1 being sharded": a prefill's ``x`` cut on batch and
    seq).  There each rank's local product runs in ``local_map``, which
    is the product DTensor runs on torch 2.13 for these placements, so
    the numbers are the same.  Per mesh dim: x cut on a leading dim and
    w whole give the output that cut (w's gradient a pending sum over
    it); x whole and w cut on its output dim give the output cut on its
    last dim (x's gradient a pending sum); without autograd, w cut on
    the contracted dim gives a pending sum (x cut there too, or whole:
    each rank then takes its slice of x, a local copy).  Anything else
    gathers x's cuts of its leading dims but the first, then is ``x @
    w`` (``_gathered_product``).  Where x has no such cut the route is
    DTensor's ``x @ w``, whose output gradient is taken with only its
    first leading dim cut (``_product``)."""
    from torch.distributed.tensor import DTensor, Partial
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)
            and x.ndim >= 3 and w.ndim == 2):
        return x @ w
    lead = x.ndim - 1
    if not any(type(p) is Shard and 0 < p.dim < lead for p in x.placements):
        return _product(x, w)
    grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    xin, out, gx, gw = [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        if isinstance(px, Replicate) and isinstance(pw, Replicate):
            out.append(px), gx.append(px), gw.append(pw)
        elif type(px) is Shard and px.dim < lead and \
                isinstance(pw, Replicate):
            out.append(px), gx.append(px), gw.append(Partial())
        elif isinstance(px, Replicate) and type(pw) is Shard and \
                pw.dim == 1:
            out.append(Shard(lead)), gx.append(Partial()), gw.append(pw)
        elif not grad and type(pw) is Shard and pw.dim == 0 and (
                isinstance(px, Replicate)
                or (type(px) is Shard and px.dim == lead)):
            px = Shard(lead)
            out.append(Partial()), gx.append(px), gw.append(pw)
        else:
            return _gathered_product(x, w)
        xin.append(px)
    from torch.distributed.tensor.experimental import local_map
    return local_map(torch.matmul, out_placements=out,
                     in_placements=(xin, w.placements),
                     in_grad_placements=(gx, gw),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, w)


def _gathered_product(x, w):
    """``x @ w`` with the cuts of x's leading dims other than the first
    gathered first (the flatten torch 2.11 refuses): ``matmul``'s route
    for placements it has no local rule for, such as x cut on seq and w
    on its output dim over one mesh dim under autograd (a Megatron plan
    with the activations cut on seq)."""
    return _product(_lead_whole(x), w)


def _product(x, w):
    """DTensor's ``x @ w``, x with no cut of its leading dims but the
    first.  Its backward flattens the output gradient's leading dims,
    and that gradient can arrive cut on another (the output a pending
    sum that the next op scatters onto seq: a Megatron plan with the
    activations cut on seq, in the MLP's down projection); torch 2.11
    refuses that flatten, so under autograd the gradient's cut is
    gathered first (``_lead_whole``), what DTensor's backward does on
    2.13 for these placements."""
    from torch.distributed.tensor import DTensor
    y = x @ w
    if isinstance(y, DTensor) and y.requires_grad:
        y.register_hook(_lead_whole)
    return y


def _lead_whole(t):
    """``t`` [..., d] (a DTensor) with its cuts of the leading dims other
    than the first gathered."""
    lead = t.ndim - 1
    pl = [Replicate() if type(p) is Shard and 0 < p.dim < lead else p
          for p in t.placements]
    return t if pl == list(t.placements) else t.redistribute(
        t.device_mesh, pl)


def lookup(table, ids):
    """``table[ids]``: the rows of an embedding table [V, D] for token ids
    [...].  Where the ids or the table are DTensors cut on a mesh dim of
    more than one rank (``_Lookup``), each rank looks its own ids' rows up
    in its own shard of the table, with no DTensor op in the forward or
    the backward: torch 2.11's DTensor builds the backward's
    ``index_put`` placement from the ids' cut as ``Shard(-1)`` and refuses
    it ("must be normalized"), for a whole table and, under autograd, for
    one cut on vocab (a Megatron plan) alike.  A vocab cut is gathered
    first where the table is the smaller transfer (what DTensor's index
    does), else looked up where the rows are.  Without autograd a cut
    table goes to DTensor's index (the serving steps' collectives).  The values are DTensor's index's (on 8 gloo
    ranks the data-parallel dense-train step of ``verify`` moved 471,040
    bytes fewer than DTensor's own route).  Anything else is
    ``table[ids]``."""
    from torch.distributed.tensor import DTensor, Partial
    if not (isinstance(ids, DTensor) and isinstance(table, DTensor)):
        return table[ids]
    mesh = ids.device_mesh
    pls = list(table.placements) + list(ids.placements)
    table_cut = any(isinstance(p, Shard) and mesh.size(j) > 1
                    for j, p in enumerate(table.placements))
    if any(isinstance(p, Partial) for p in pls) or any(
            isinstance(p, Shard) and p.dim > 1 for p in table.placements) \
            or not any(isinstance(p, Shard) and mesh.size(j % mesh.ndim) > 1
                       for j, p in enumerate(pls)) \
            or (table_cut and not (torch.is_grad_enabled()
                                   and table.requires_grad)):
        return table[ids]
    # a vocab cut: gather the table's rows where they are fewer than twice
    # the output's (the sum of a pending output moves 2x its bytes);
    # else each rank looks up the ids its rows hold (zeros elsewhere,
    # summed over that dim)
    if table.numel() <= 2 * ids.numel() * table.shape[-1] and any(
            isinstance(p, Shard) and p.dim == 0 for p in table.placements):
        table = table.redistribute(mesh, [
            Replicate() if isinstance(p, Shard) and p.dim == 0 else p
            for p in table.placements])
    # a mesh dim that cuts the table sees every id: over a d_model cut
    # each rank looks up its columns of every id's row
    want = [Replicate() if isinstance(t, Shard) else p
            for t, p in zip(table.placements, ids.placements)]
    if want != list(ids.placements):
        ids = ids.redistribute(mesh, want)
    return _Lookup.apply(table, ids)


class _Lookup(torch.autograd.Function):
    """``lookup``'s local route: forward and backward on each rank's own
    shards (the ids as placed, the table's rows and columns as cut), the
    output placed as the ids (a Partial sum over a mesh dim that cuts the
    vocab, ``Shard`` of the last dim over one that cuts d_model) and the
    table's gradient as the table (a Partial sum over the ids' cuts)."""

    @staticmethod
    def forward(ctx, table, ids):
        from torch.distributed.tensor import Partial
        mesh, n = ids.device_mesh, ids.ndim
        out_pl, grad_pl = [], []
        for t, p in zip(table.placements, ids.placements):
            if isinstance(t, Shard) and t.dim == 0:
                out_pl.append(Partial())
                grad_pl.append(t)
            elif isinstance(t, Shard):
                out_pl.append(Shard(n))
                grad_pl.append(t)
            else:
                out_pl.append(p)
                grad_pl.append(Partial() if isinstance(p, Shard) else t)
        tl, il = table.to_local(), ids.to_local().long()
        rows = il
        mask = None
        if any(isinstance(p, Partial) for p in out_pl):
            rows = il - global_offset(table)[0]
            mask = (rows >= 0) & (rows < tl.shape[0])
            rows = rows.clamp(0, tl.shape[0] - 1)
        out = tl[rows]
        if mask is not None:
            out = out * mask[..., None].to(out.dtype)
        ctx.save_for_backward(rows, *(() if mask is None else (mask,)))
        ctx.meta = (mesh, tuple(table.shape), tuple(tl.shape), table.dtype,
                    out_pl, grad_pl)
        return from_local(out, mesh, out_pl,
                          tuple(ids.shape) + (table.shape[-1],))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial
        mesh, shape, lshape, dtype, out_pl, grad_pl = ctx.meta
        rows, *mask = ctx.saved_tensors
        gl = g.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                   else p for p in out_pl]).to_local()
        if mask:
            gl = gl * mask[0][..., None].to(gl.dtype)
        gt = torch.zeros(lshape, dtype=gl.dtype, device=gl.device)
        gt.index_put_((rows,), gl, accumulate=True)
        return from_local(gt.to(dtype), mesh, grad_pl, shape), None


def moves(src: Sequence, dst: Sequence, mesh) -> bool:
    """Whether redistributing from ``src`` to ``dst`` moves data: some
    mesh dim of more than one rank changes its placement."""
    return any(a != b and mesh.size(j) > 1
               for j, (a, b) in enumerate(zip(src, dst)))


def batch_rows(plan, mesh, b: int) -> List:
    """Placements of a [B, ...] activation on the rows a per-row region
    runs on: ``Shard(0)`` on the mesh dims of the batch entry of
    ``plan.pspec("ssm_h", ("batch", "seq", "inner"))`` (repro's
    shard_map rule for the SSD scan), else of the activations' role
    ``x``, which holds the same rows; ``Replicate()`` elsewhere.  A cut
    whose degree does not divide ``b`` is dropped."""
    role = "ssm_h" if plan.has_role("ssm_h") else "x"
    spec = plan.pspec(role, ("batch", "seq", "inner"))
    pl = spec_placements(spec[:1], mesh.mesh_dim_names)
    return even_placements(pl, (b,), mesh)


def rows_region(fn, acts: Sequence, small: Sequence, plan, mesh):
    """``fn(*acts, *small)`` in one ``local_map`` region on each rank's
    batch rows (``batch_rows``): the activations [B, ...] in and the
    output [B, ...] on those rows, the small params whole.  A small
    param's gradient on a rank is its rows' share: a pending sum over the
    batch cut (``in_grad_placements``), reduced where the trainer places
    it.  Nothing in the region is a DTensor op."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    rows = batch_rows(plan, mesh, acts[0].shape[0])
    whole = [Replicate()] * mesh.ndim
    summed = [Partial() if isinstance(p, Shard) else Replicate()
              for p in rows]
    na, ns = len(acts), len(small)
    region = local_map(
        fn, out_placements=list(rows),
        in_placements=(rows,) * na + (whole,) * ns,
        in_grad_placements=(rows,) * na + (summed,) * ns,
        device_mesh=mesh, redistribute_inputs=True)
    return region(*acts, *small)


def step_rows(fn, acts: Sequence, small: Sequence, states: Sequence,
              width: int, key: str, slot: Optional[int] = None,
              heads: bool = False):
    """A decode step's per-row state update under a plan: ``fn(*acts,
    *small, *states) -> y`` f32, writing the states in place, run in one
    ``local_map`` region on the rows of the states' batch cut (DTensors
    [B, ...], one role, so one cut), the activations on the same rows and
    the small params whole; y is [b, width].  A state cut on another axis
    (an ``inner`` cut splits a head's update over ranks) is gathered
    whole on its other axes for the update and its local part copied back
    after, counted in ``ops.plan_fallbacks[key]``.

    ``heads``: the update is per head (a head's update reads only that
    head): the states and activations are [B, H, ...], the small params
    [H, ...], and y is [b, h, ...].  Where every state is cut on batch
    and heads only, alike, the region runs on each rank's own rows and
    heads (the activations at the states' placements, the small params
    cut on their heads as the states are) and nothing is gathered but y,
    whose heads are gathered after.  y is returned as [B, width] either
    way.

    ``slot``: the activations are one row, replicated; the ranks whose
    shard holds row ``slot`` step it and the others give zeros, which the
    batch mesh dims sum."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from ..kernels import ops as kops
    mesh = states[0].device_mesh
    pl = list(states[0].placements)
    rows = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in pl]
    keep = heads and slot is None and all(
        list(t.placements) == pl for t in states[1:]) and not any(
        isinstance(p, Partial) or (isinstance(p, Shard) and p.dim > 1)
        for p in pl)
    cut = pl if keep else rows
    if heads:
        per_head = fn

        def fn(*a):
            y = per_head(*a)
            return y if keep else y.flatten(1)
    work = []
    for t in states:
        if list(t.placements) == cut:
            work.append(t)
            continue
        if moves(t.placements, cut, mesh):
            kops.plan_fallbacks[key] += 1
        work.append(t.redistribute(mesh, cut))
    rep = [Replicate()] * mesh.ndim
    spl = [Shard(0) if isinstance(p, Shard) and p.dim == 1
           else Replicate() for p in cut]
    na, ns = len(acts), len(small)
    if slot is None:
        xin, out, region = cut, cut, fn
    else:
        xin = rep
        out = [Partial() if isinstance(p, Shard) else p for p in rows]
        b0 = global_offset(work[0])[0]

        def region(*a):
            st = a[na + ns:]
            r = slot - b0
            if not st[0].numel() or not 0 <= r < st[0].shape[0]:
                return torch.zeros((1, width), dtype=torch.float32,
                                   device=a[0].device)
            return fn(*a[:na + ns], *(s[r:r + 1] for s in st))
    y = local_map(region, out_placements=list(out),
                  in_placements=((xin,) * na + (tuple(spl),) * ns
                                 + (cut,) * len(states)),
                  device_mesh=mesh, redistribute_inputs=True)(
                      *acts, *small, *work)
    for t, w in zip(states, work):
        if w is not t:
            t.to_local().copy_(w.redistribute(mesh, t.placements).to_local())
    if slot is not None:
        y = y.redistribute(mesh, rep)
    if keep:
        y = redistribute(y, rows).flatten(1)
    return y


def layer_of(t, layer: int):
    """Layer ``layer`` of a stacked [L, ...] state: a view, and for a
    DTensor a DTensor view of this rank's shard (the layer axis is never
    cut), so writes to it land in the cache."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t[layer]
    pl = [Shard(p.dim - 1) if isinstance(p, Shard) else p
          for p in t.placements]
    return from_local(t.to_local()[layer], t.device_mesh, pl, t.shape[1:])
