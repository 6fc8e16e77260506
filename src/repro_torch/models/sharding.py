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
    may pass full tensors (the same on every rank) or placed ones."""
    pl = tree_placements(plan, tree, mesh.mesh_dim_names, rules)

    def go(t: Tree, p: Tree) -> Tree:
        out: Tree = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = go(v, p[k])
            elif isinstance(v, torch.distributed.tensor.DTensor):
                out[k] = v
            else:
                out[k] = distribute_tensor(v, mesh, p[k])
        return out
    return go(tree, pl)


def place(t: torch.Tensor, mesh, placements: Sequence):
    """``t``, the same full tensor on every rank, as a DTensor under
    ``placements``: each rank keeps its own slice and nothing moves
    between ranks."""
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
