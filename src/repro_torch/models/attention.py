"""GQA attention entry points (counterpart of ``repro.models.attention``).

All go through ``kernels/ops.py``, which picks the CUDA kernel for CUDA
tensors and the plain version for CPU tensors.  ``attention`` routes as
repro's kernel route: a static ``q_offset`` of 0 goes through the
differentiable ``ops.flash_attention`` (training), anything else through
the forward-only offset kernel (chunked prefill).  ``impl`` exists for
signature parity with repro, where it chose between XLA and Pallas; the
port has one route, so it accepts only ``"auto"``.

Under a sharding plan the arguments are DTensors.  Training
(``attention_sharded``) runs the differentiable kernel op on each rank's
local (batch, heads) shards through ``local_map``, where repro trains on
its XLA attention.  Serving updates the cache in place, so the K/V write
and the kernel run together on each rank's local shards through
``local_map`` (repro's ``shard_map`` rule):

- the linear cache [L,B,S,KV,hd] (``attend_cache_sharded``,
  ``prefill_attention_sharded``, ``attend_slot_sharded``): the kernel
  takes the local shards when the cache's cut is on ``batch`` and/or
  ``kv_heads`` only and each degree divides its dim;
- the paged pool [L,NB,BL,KV,hd] and its block table [B,MB]
  (``attend_paged_sharded``, ``prefill_attention_paged_sharded``):
  repro's ``attend_paged_pallas`` rule, the table cut on ``batch``, the
  pool on ``kv_heads`` only (so it is replicated over the data shards,
  and every rank writes every row's K/V into its replica);
- the speculative re-score (``rescore_sharded``, both tiers): each rank
  attends the rows its shard owns and gives zeros for the others, which
  the batch mesh dims sum.

Any other cut (a ``seq_kv`` cut would split the softmax, a pool cut on
``blocks`` would split a row's blocks over ranks) gathers the query and
the layer's cache (pool and table) whole on every rank and runs the same
kernel on them, as repro runs its XLA attention on the global arrays
there.  Each gather is counted in ``ops.plan_fallbacks``."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..kernels import ops as kops
from .sharding import global_offset, redistribute

IMPLS = ("auto",)


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"attention impl must be one of {IMPLS}, got "
                         f"{impl!r} (the device picks the kernel)")


def attention(q, k, v, *, impl: str = "auto", **kw):
    """q [B,Sq,H,hd]; k/v [B,Sk,KV,hd] -> [B,Sq,H,hd].  Keyword rules as
    repro's kernel route: ``k_chunk`` (a tiling knob of repro's XLA path
    with no kernel equivalent) is dropped, ``q_offset`` (int or 1-element
    int32 tensor) is forwarded, anything but causal/window/scale is a
    TypeError.  Without an offset, DTensor arguments go to
    :func:`attention_sharded` (each rank's kernel on its local shards)."""
    _check_impl(impl)
    kw.pop("k_chunk", None)
    q_offset = kw.pop("q_offset", 0)
    unknown = set(kw) - {"causal", "window", "scale"}
    if unknown:
        raise TypeError(
            f"attention(impl={impl!r}) got unsupported kwargs "
            f"{sorted(unknown)}")
    causal, window, scale = (kw.get("causal", True), kw.get("window"),
                             kw.get("scale"))
    if isinstance(q_offset, int) and q_offset == 0:
        from torch.distributed.tensor import DTensor
        if isinstance(q, DTensor):
            # DTensors without a model plan (``trace.autoshard``): the
            # kernel runs on each rank's local shards, as under a plan
            return attention_sharded(q, k, v, causal=causal, window=window,
                                     scale=scale)
        return kops.flash_attention(q, k, v, causal, window, scale)
    o, _ = kops.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                    scale=scale, q_offset=q_offset)
    return o


def attend_cache(q, k_cache, v_cache, length, *,
                 window: Optional[int] = None,
                 scale: Optional[float] = None, impl: str = "auto"):
    """Decode attention: q [B,H,hd] against caches [B,S,KV,hd]; ``length``
    [B] int32 = valid cache entries (the new token already written at
    length - 1)."""
    _check_impl(impl)
    return kops.flash_attention_decode(q, k_cache, v_cache, length,
                                       window=window, scale=scale)


def attend_paged(q, k_pool, v_pool, table, length, *,
                 scale: Optional[float] = None, impl: str = "auto"):
    """Paged decode attention: q [B,H,hd] against block pools
    [NB,BL,KV,hd] through the per-row block ``table`` [B,MB] int32;
    ``length`` [B] int32 = valid entries (at most MB*BL).  No window: the
    paged tier serves full-attention configurations only.  The kernel
    reads the blocks through the table; nothing is gathered into a
    per-row view."""
    _check_impl(impl)
    return kops.flash_attention_paged_decode(q, k_pool, v_pool, table,
                                             length, scale=scale)


# -- under a sharding plan ----------------------------------------------------
# Linear caches are [L, B, S, KV, hd] DTensors: tensor dims 1 (batch), 2
# (seq_kv), 3 (kv_heads).  Paged pools are [L, NB, BL, KV, hd]: dims 1
# (blocks), 2 (block_len), 3 (kv_heads); their block tables [B, MB]: dims
# 0 (batch), 1 (blocks).

def kernel_placements(cache_placements: Sequence, mesh, b: int, h: int,
                      kv: int, batch_dim: Optional[int], head_dim: int
                      ) -> Optional[Tuple]:
    """The shard rule: the query's placements for the kernel on local
    shards, or None when the cache's cut cannot run there.  A mesh dim
    that cuts the cache's batch cuts the query's ``batch_dim`` (None: a
    one-row prefill chunk, replicated there, whose row one rank owns);
    one that cuts ``kv_heads`` cuts its ``head_dim``; any other cut, or a
    degree that does not divide B, KV or H, has no local rule."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    deg_b = deg_h = 1
    for j, p in enumerate(cache_placements):
        if isinstance(p, Replicate):
            out.append(Replicate())
        elif isinstance(p, Shard) and p.dim == 1:
            deg_b *= mesh.size(j)
            out.append(Replicate() if batch_dim is None else Shard(batch_dim))
        elif isinstance(p, Shard) and p.dim == 3:
            deg_h *= mesh.size(j)
            out.append(Shard(head_dim))
        else:
            return None
    if b % deg_b or kv % deg_h or h % deg_h:
        return None
    return tuple(out)


def gathered_placements(cache_placements: Sequence, mesh, b: int, h: int,
                        kv: int, batch_dim: int, head_dim: int) -> Tuple:
    """The query's placements where ``kernel_placements`` has no local
    rule (the counted fallbacks): a mesh dim that cuts the cache's batch,
    or its ``kv_heads``, keeps that cut on ``batch_dim`` / ``head_dim``
    while the degree so far divides B (KV and H), in mesh order; every
    other mesh dim is gathered (replicated)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    deg_b = deg_h = 1
    for j, p in enumerate(cache_placements):
        n = mesh.size(j)
        if isinstance(p, Shard) and p.dim == 1 and b % (deg_b * n) == 0:
            deg_b *= n
            out.append(Shard(batch_dim))
        elif (isinstance(p, Shard) and p.dim == 3
              and kv % (deg_h * n) == 0 and h % (deg_h * n) == 0):
            deg_h *= n
            out.append(Shard(head_dim))
        else:
            out.append(Replicate())
    return tuple(out)


def paged_placements(pool_placements: Sequence, table_placements: Sequence
                     ) -> Optional[List]:
    """The pool's and the table's cuts as the linear cache placements that
    ``kernel_placements`` reads (repro's ``attend_paged_pallas`` rule): a
    mesh dim that cuts the table's batch is the cache's batch cut, one
    that cuts the pool's kv_heads its kv_heads cut.  None where the rule
    has no local form: the pool cut on blocks, block_len or hd, the table
    on blocks, or one mesh dim cutting both."""
    from torch.distributed.tensor import Replicate, Shard
    out: List = []
    for pp, tp in zip(pool_placements, table_placements):
        if isinstance(tp, Shard):
            if tp.dim != 0 or not isinstance(pp, Replicate):
                return None
            out.append(Shard(1))
        elif isinstance(pp, Shard) and pp.dim != 3:
            return None
        else:
            out.append(pp)
    return out


def _owner_placements(cache_placements: Sequence,
                      qpl: Optional[Sequence]) -> Optional[List]:
    """The output placements of an owner region (one rank's rows, the
    others' zeros): Partial on the mesh dims that cut the cache's batch,
    whose sum is exact (x + 0 + ... + 0), the query's kernel placements
    ``qpl`` elsewhere."""
    from torch.distributed.tensor import Partial, Shard
    if qpl is None:
        return None
    return [Partial() if isinstance(p, Shard) and p.dim == 1 else qp
            for p, qp in zip(cache_placements, qpl)]


def _local_region(region, q, k, v, state: Sequence, qpl, opl=None):
    """``region(q_l, k_l, v_l, *state_l)`` on every rank's local shards
    through ``local_map``: q at the kernel placements ``qpl`` (as placed
    where qpl is None: the region then only writes and returns None), the
    new K/V replicated, the state (caches, pools, a table) as placed.  The
    result takes ``opl``, qpl by default."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = state[0].device_mesh
    rep = (Replicate(),) * mesh.ndim
    # one output: its placements go as a list (a tuple would name
    # several); None for a region that returns None
    out = None if qpl is None else list(qpl if opl is None else opl)
    # the inputs moved here (a one-row step's gathers on its leading dim,
    # sharding.redistribute), so local_map moves nothing
    if qpl is not None:
        q = redistribute(q, qpl)
    k, v = redistribute(k, rep), redistribute(v, rep)
    return local_map(region, out_placements=out,
                     in_placements=(q.placements, rep, rep)
                     + tuple(t.placements for t in state),
                     device_mesh=mesh, redistribute_inputs=True)(
                         q, k, v, *state)


def _replicated(t: torch.Tensor, mesh):
    """Plain tensor ``t``, the same on every rank, as a replicated
    DTensor."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def attention_sharded(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None,
                      scale: Optional[float] = None):
    """Training attention under a plan: q [B,S,H,hd] and k/v [B,S,KV,hd]
    are DTensors.  The differentiable ``ops.flash_attention`` (the
    forward kernel, and the dq and dk/dv kernels in the backward) runs on
    each rank's local shards in one ``local_map`` region when q's cut is
    on batch and/or heads and each degree divides B, H and KV
    (``kernel_placements``: a [B,S,H,hd] tensor is a cache leaf without
    its layer axis, so its dim d is the cache's d + 1).  A contiguous
    heads cut keeps each rank's query heads with the KV heads of their
    group only because both H and KV divide.  Any other cut (seq, hd, a
    degree that does not divide) is counted in
    ``ops.plan_fallbacks["attention"]``: ``gathered_placements`` keeps
    the batch and heads cuts whose degrees divide and gathers every other
    mesh dim, and the same op runs on what each rank then holds.
    Without autograd (a prefill forward), a mesh dim that cuts q's seq
    keeps it: only k and v are gathered there, and each rank's queries
    run the forward kernel at their offset (the backward kernels take
    none).  Returns o [B,S,H,hd] (DTensor)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    b, _, h, _ = q.shape
    as_cache = [Replicate() if isinstance(p, (Replicate, Partial))
                else Shard(p.dim + 1) for p in q.placements]
    qpl = kernel_placements(as_cache, mesh, b, h, k.shape[2],
                            batch_dim=0, head_dim=2)
    if qpl is None:
        kops.plan_fallbacks["attention"] += 1
        qpl = gathered_placements(as_cache, mesh, b, h, k.shape[2],
                                  batch_dim=0, head_dim=2)
        if not torch.is_grad_enabled():
            seq = [Shard(1) if isinstance(p, Shard) and p.dim == 1 else r
                   for p, r in zip(q.placements, qpl)]
            if seq != list(qpl):
                q = q.redistribute(mesh, seq)
                off = global_offset(q)[1]

                def offset_region(q_l, k_l, v_l):
                    return kops.flash_attention_fwd(
                        q_l, k_l, v_l, causal=causal, window=window,
                        scale=scale, q_offset=off)[0]
                return local_map(offset_region, out_placements=seq,
                                 in_placements=(seq, qpl, qpl),
                                 device_mesh=mesh,
                                 redistribute_inputs=True)(q, k, v)

    def region(q_l, k_l, v_l):
        return kops.flash_attention(q_l, k_l, v_l, causal, window, scale)

    return local_map(region, out_placements=list(qpl),
                     in_placements=(qpl, qpl, qpl), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def attend_cache_sharded(q, k, v, k_all, v_all, layer: int,
                         idx: torch.Tensor, keep: torch.Tensor,
                         length: torch.Tensor):
    """A decode step's K/V write and attention for one layer under a
    plan.  q [B,H,hd], the new k/v [B,KV,hd] and the caches ``k_all`` /
    ``v_all`` [L,B,S,KV,hd] are DTensors; ``idx`` [B] (the write
    position), ``keep`` [B] bool (write or drop) and ``length`` [B] are
    plain tensors, the same on every rank.  Each rank writes the rows of
    its local shard; then the kernel attends its shard, or, where the cut
    has no local rule, what ``_gathered_decode`` gathers.  Returns o
    [B,H,hd] (DTensor)."""
    mesh = k_all.device_mesh
    b, h, _ = q.shape
    qpl = kernel_placements(k_all.placements, mesh, b, h, k_all.shape[3],
                            batch_dim=0, head_dim=1)
    _, b0, s0, h0, d0 = global_offset(k_all)

    def region(q_l, k_n, v_n, kc, vc):
        bl, sl, kvl, hdl = kc.shape[1:]
        if kc.numel():
            # rows of this shard; a dropped row rewrites its own local
            # position 0 with the value already there (rows are distinct,
            # so no two writes collide)
            rows = torch.arange(bl, device=kc.device)
            lpos = idx[b0:b0 + bl].long() - s0
            ok = keep[b0:b0 + bl] & (lpos >= 0) & (lpos < sl)
            wpos = torch.where(ok, lpos, torch.zeros_like(lpos))
            keep3 = ok[:, None, None]
            for c, n in ((kc[layer], k_n), (vc[layer], v_n)):
                new = n[b0:b0 + bl, h0:h0 + kvl, d0:d0 + hdl].to(c.dtype)
                c[rows, wpos] = torch.where(keep3, new, c[rows, wpos])
        if qpl is None:
            return None
        return kops.flash_attention_decode(q_l, kc[layer], vc[layer],
                                           length[b0:b0 + bl])

    o = _local_region(region, q, k, v, (k_all, v_all), qpl)
    if qpl is not None:
        return o
    kops.plan_fallbacks["attend_cache"] += 1
    return _gathered_decode(q, k_all[layer], v_all[layer], length)


def _gathered_decode(q, kc, vc, length: torch.Tensor):
    """A decode step's attention on cache layers ``kc`` / ``vc``
    [B,S,KV,hd] (DTensors) whose cut has no local rule: the batch and
    kv_heads cuts that ``gathered_placements`` keeps stay, every other
    mesh dim is gathered, and the kernel attends what each rank then
    holds.  Returns o [B,H,hd] (DTensor)."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = kc.device_mesh
    b, h, _ = q.shape
    qpl = gathered_placements(
        [Shard(p.dim + 1) if isinstance(p, Shard) else p
         for p in kc.placements], mesh, b, h, kc.shape[2], batch_dim=0,
        head_dim=1)
    kept = [Shard(2) if isinstance(p, Shard) and p.dim == 1 else p
            for p in qpl]
    kc, vc = redistribute(kc, kept), redistribute(vc, kept)
    b0 = global_offset(kc)[0]

    def region(q_l, k_l, v_l):
        return kops.flash_attention_decode(q_l, k_l, v_l,
                                           length[b0:b0 + k_l.shape[0]])

    return local_map(region, out_placements=list(qpl),
                     in_placements=(qpl, kept, kept), device_mesh=mesh,
                     redistribute_inputs=True)(q, kc, vc)


def attend_slot_sharded(q, k, v, k_all, v_all, layer: int, slot: int,
                        idx: torch.Tensor, keep: torch.Tensor,
                        length: torch.Tensor):
    """One slot's batch-1 decode step (the scan prefill of a ring-cache
    config) for one layer under a plan.  q [1,H,hd] and the new k/v
    [1,KV,hd] are DTensors (one row, whole on the batch cut), the caches
    [L,B,S,KV,hd] DTensors; ``idx`` [1] (the write position: pos % S on
    a ring), ``keep`` [1] bool and ``length`` [1] are plain tensors, the
    same on every rank.  The ranks whose shard holds row ``slot`` write
    it and run the decode kernel on it (the ring is the window); the
    others give zeros, which the batch mesh dims sum.  Every rank joins
    the collectives around the call.  Returns o [1,H,hd] (DTensor)."""
    mesh = k_all.device_mesh
    h = q.shape[1]
    qpl = kernel_placements(k_all.placements, mesh, k_all.shape[1], h,
                            k_all.shape[3], batch_dim=None, head_dim=1)
    _, b0, s0, h0, d0 = global_offset(k_all)

    def region(q_l, k_n, v_n, kc, vc):
        bl, sl, kvl, hdl = kc.shape[1:]
        own = kc.numel() > 0 and b0 <= slot < b0 + bl
        r = slot - b0
        if own:
            lpos = idx.long() - s0
            ok = keep & (lpos >= 0) & (lpos < sl)
            wpos = torch.where(ok, lpos, torch.zeros_like(lpos))
            for c, n in ((kc[layer, r], k_n), (vc[layer, r], v_n)):
                new = n[:, h0:h0 + kvl, d0:d0 + hdl].to(c.dtype)
                c[wpos] = torch.where(ok[:, None, None], new, c[wpos])
        if qpl is None:
            return None
        if not own:
            return torch.zeros_like(q_l)
        return kops.flash_attention_decode(q_l, kc[layer, r:r + 1],
                                           vc[layer, r:r + 1], length)

    o = _local_region(region, q, k, v, (k_all, v_all), qpl,
                      _owner_placements(k_all.placements, qpl))
    if qpl is not None:
        return o.redistribute(mesh, qpl)
    kops.plan_fallbacks["attend_cache"] += 1
    out = attend_cache(q.full_tensor(),
                       k_all[layer].full_tensor()[slot:slot + 1],
                       v_all[layer].full_tensor()[slot:slot + 1], length)
    return _replicated(out, mesh)


def prefill_attention_sharded(q, k, v, k_all, v_all, layer: int, slot: int,
                              pos0: torch.Tensor):
    """A prefill chunk's K/V write and offset attention for one layer
    under a plan.  q [1,C,H,hd] and the chunk's k/v [1,C,KV,hd] are
    DTensors (one row, replicated over the cache's batch cut); the caches
    [L,B,S,KV,hd] are DTensors; ``pos0`` [1] is the slot's position (a
    plain tensor, the same on every rank).  The slot's row lives on the
    ranks whose shard holds batch row ``slot``: only they write and
    attend, the others give zeros, and the batch mesh dims sum the
    result (one term is not zero).  Every rank joins the collectives
    around the call.  Causal, no window (the parallel prefill's rule).
    Returns o [1,C,H,hd] (DTensor)."""
    mesh = k_all.device_mesh
    _, c, h, _ = q.shape
    qpl = kernel_placements(k_all.placements, mesh, k_all.shape[1], h,
                            k_all.shape[3], batch_dim=None, head_dim=2)
    _, b0, s0, h0, d0 = global_offset(k_all)

    def region(q_l, k_n, v_n, kc, vc):
        bl, sl, kvl, hdl = kc.shape[1:]
        own = kc.numel() > 0 and b0 <= slot < b0 + bl
        if own:
            # the chunk lands on positions [pos0, pos0 + C) of the row;
            # rebuild this shard's positions [s0, s0 + sl) of it
            src = (torch.arange(s0, s0 + sl, device=kc.device)
                   - pos0.long())
            ok = ((src >= 0) & (src < c))[:, None, None]
            src = src.clamp(0, c - 1)
            for cc, n in ((kc[layer], k_n), (vc[layer], v_n)):
                row = cc[slot - b0]                         # [sl,kvl,hdl]
                new = n[0, src, h0:h0 + kvl, d0:d0 + hdl].to(cc.dtype)
                row.copy_(torch.where(ok, new, row))
        if qpl is None:
            return None
        if not own:
            return torch.zeros_like(q_l)
        r = slot - b0
        o, _ = kops.flash_attention_fwd(
            q_l, kc[layer][r:r + 1], vc[layer][r:r + 1], causal=True,
            q_offset=pos0)
        return o

    o = _local_region(region, q, k, v, (k_all, v_all), qpl,
                      _owner_placements(k_all.placements, qpl))
    if qpl is not None:
        return o.redistribute(mesh, qpl)
    kops.plan_fallbacks["prefill_attention"] += 1
    kf = k_all[layer].full_tensor()[slot:slot + 1]
    vf = v_all[layer].full_tensor()[slot:slot + 1]
    out = attention(q.full_tensor(), kf, vf, causal=True, q_offset=pos0)
    return _replicated(out, mesh)


def _pool_layout(pool) -> Tuple[Tuple[int, ...], bool]:
    """This rank's shard of a pool DTensor [L,NB,BL,KV,hd]: its global
    offsets on (blocks, block_len, kv_heads, hd), and whether no mesh dim
    cuts blocks or block_len (every write then lands in every shard)."""
    from torch.distributed.tensor import Shard
    whole = not any(isinstance(p, Shard) and p.dim in (1, 2)
                    for p in pool.placements)
    return global_offset(pool)[1:], whole


def _pool_write(pool: torch.Tensor, off: Sequence[int], whole: bool,
                wblk: torch.Tensor, woff: torch.Tensor,
                new: torch.Tensor) -> None:
    """Write the rows ``new`` [R,KV,hd] at (block ``wblk``, offset
    ``woff``) [R] into ``pool`` [NBl,BLl,KVl,HDl], this rank's shard of
    one layer's pool at global offsets ``off``.  Every rank writes every
    row: the pool is replicated over the data shards.  A shard ``whole``
    on blocks and block_len takes every write, the null block 0's
    included, as the unplanned step writes, so the replicas stay
    bit-equal; otherwise only the writes that land in the shard are kept
    (a host-side selection: the gathered route only)."""
    if not pool.numel():
        return
    nb0, bl0, h0, d0 = off
    nbl, bll, kvl, hdl = pool.shape
    val = new[:, h0:h0 + kvl, d0:d0 + hdl].to(pool.dtype)
    if whole:
        pool[wblk, woff] = val
        return
    sel = ((wblk >= nb0) & (wblk < nb0 + nbl)
           & (woff >= bl0) & (woff < bl0 + bll))
    pool[wblk[sel] - nb0, woff[sel] - bl0] = val[sel]


def attend_paged_sharded(q, k, v, k_all, v_all, table, layer: int,
                         wblk: torch.Tensor, woff: torch.Tensor,
                         length: torch.Tensor):
    """A paged decode step's K/V write and attention for one layer under
    a plan.  q [B,H,hd], the new k/v [B,KV,hd], the pools ``k_all`` /
    ``v_all`` [L,NB,BL,KV,hd] and the block ``table`` [B,MB] int32 are
    DTensors; ``wblk`` / ``woff`` [B] (each row's write block, the null
    block 0 for a dropped row, from the whole table, and its offset) and
    ``length`` [B] are plain tensors, the same on every rank.  Every rank
    writes every row's K/V into its pool replica (a rank that wrote only
    its own rows would leave the other data shards' replicas stale); then
    the paged kernel attends the local query rows through the local table
    rows on the pool's local heads (``paged_placements``), or, where the
    cut has no local rule, the gathered query, pool and table.  Returns
    o [B,H,hd] (DTensor)."""
    mesh = k_all.device_mesh
    b, h, _ = q.shape
    lin = paged_placements(k_all.placements, table.placements)
    qpl = None if lin is None else kernel_placements(
        lin, mesh, b, h, k_all.shape[3], batch_dim=0, head_dim=1)
    off, whole = _pool_layout(k_all)
    t0 = global_offset(table)[0]

    def region(q_l, k_n, v_n, kp, vp, tbl):
        for pool, n in ((kp[layer], k_n), (vp[layer], v_n)):
            _pool_write(pool, off, whole, wblk, woff, n)
        if qpl is None:
            return None
        return kops.flash_attention_paged_decode(
            q_l, kp[layer], vp[layer], tbl, length[t0:t0 + tbl.shape[0]])

    o = _local_region(region, q, k, v, (k_all, v_all, table), qpl)
    if qpl is not None:
        return o
    kops.plan_fallbacks["attend_paged"] += 1
    out = attend_paged(q.full_tensor(), k_all[layer].full_tensor(),
                       v_all[layer].full_tensor(), table.full_tensor(),
                       length)
    return _replicated(out, mesh)


def prefill_attention_paged_sharded(q, k, v, k_all, v_all, table,
                                    layer: int, slot: int, row, wblk, woff,
                                    pos0: torch.Tensor):
    """A paged prefill chunk's K/V write and offset attention for one
    layer under a plan.  q [1,C,H,hd] and the chunk's k/v [1,C,KV,hd] are
    DTensors (one row, whole on the batch cut), the pools and the table
    as in ``attend_paged_sharded``; ``row`` [MB] (the slot's table row),
    ``wblk`` / ``woff`` [C] (each chunk row's write block, the null block
    0 for padding and for rows past the table, and its offset) and
    ``pos0`` [1] are plain tensors, the same on every rank.  Every rank
    writes the chunk into its pool replica; the ranks whose table shard
    holds row ``slot`` run the offset forward on the slot's view
    [1, MB*BL, KV, hd], as the unplanned chunk does, and the others give
    zeros, which the batch mesh dims sum.  Causal, no window.  Returns o
    [1,C,H,hd] (DTensor)."""
    mesh = k_all.device_mesh
    h = q.shape[2]
    lin = paged_placements(k_all.placements, table.placements)
    qpl = None if lin is None else kernel_placements(
        lin, mesh, table.shape[0], h, k_all.shape[3], batch_dim=None,
        head_dim=2)
    off, whole = _pool_layout(k_all)
    t0 = global_offset(table)[0]
    span = row.shape[0] * k_all.shape[2]

    def view(pool):                       # [NB,BL,KV,hd] -> [1,MB*BL,KV,hd]
        return pool[row].reshape(1, span, *pool.shape[2:])

    def region(q_l, k_n, v_n, kp, vp, tbl):
        for pool, n in ((kp[layer], k_n[0]), (vp[layer], v_n[0])):
            _pool_write(pool, off, whole, wblk, woff, n)
        if qpl is None:
            return None
        if not t0 <= slot < t0 + tbl.shape[0]:
            return torch.zeros_like(q_l)
        o, _ = kops.flash_attention_fwd(q_l, view(kp[layer]),
                                        view(vp[layer]), causal=True,
                                        q_offset=pos0)
        return o

    o = _local_region(region, q, k, v, (k_all, v_all, table), qpl,
                      _owner_placements(lin, qpl))
    if qpl is not None:
        return o.redistribute(mesh, qpl)
    kops.plan_fallbacks["prefill_attention"] += 1
    out = attention(q.full_tensor(), view(k_all[layer].full_tensor()),
                    view(v_all[layer].full_tensor()), causal=True,
                    q_offset=pos0)
    return _replicated(out, mesh)


def rescore_sharded(q, k_all, v_all, layer: int, rows: torch.Tensor,
                    length: torch.Tensor, table=None):
    """The speculative re-score's attention for one layer under a plan:
    q [N,H,hd] (a DTensor) for cache rows ``rows`` [N] at lengths
    ``length`` [N] (plain tensors, the same on every rank), against the
    linear caches [L,B,S,KV,hd] or, with the block ``table`` [B,MB], the
    pools [L,NB,BL,KV,hd] (DTensors).  Read only.  The N rows cross the
    batch shards: each rank attends the rows its cache (or table) shard
    owns and gives length 0, exact zeros, for the others, and the batch
    mesh dims sum the results; no cache moves, one sum of [N,H,hd] a
    layer, as in ``prefill_attention_sharded``.  Where the cut has no
    local rule the query and the layer's cache (pool and table) are
    gathered, counted in ``ops.plan_fallbacks["rescore"]``.  Returns o
    [N,H,hd] (DTensor)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = k_all.device_mesh
    h = q.shape[1]
    if table is None:
        lin, n_rows, b0 = k_all.placements, k_all.shape[1], \
            global_offset(k_all)[1]
        state = (k_all, v_all)
    else:
        lin = paged_placements(k_all.placements, table.placements)
        n_rows, b0 = table.shape[0], global_offset(table)[0]
        state = (k_all, v_all, table)
    qpl = None if lin is None else kernel_placements(
        lin, mesh, n_rows, h, k_all.shape[3], batch_dim=None, head_dim=1)
    if qpl is None:
        kops.plan_fallbacks["rescore"] += 1
        qf = q.full_tensor()
        kf, vf = k_all[layer].full_tensor(), v_all[layer].full_tensor()
        out = (attend_cache(qf, kf[rows], vf[rows], length) if table is None
               else attend_paged(qf, kf, vf, table.full_tensor()[rows],
                                 length))
        return _replicated(out, mesh)

    def region(q_l, kc, vc, *tbl):
        m = tbl[0].shape[0] if tbl else kc.shape[1]
        own = (rows >= b0) & (rows < b0 + m)
        r = (rows - b0).clamp(0, m - 1)
        ln = torch.where(own, length, torch.zeros_like(length))
        if tbl:
            o = kops.flash_attention_paged_decode(q_l, kc[layer], vc[layer],
                                                  tbl[0][r], ln)
        else:
            o = kops.flash_attention_decode(q_l, kc[layer][r], vc[layer][r],
                                            ln)
        return torch.where(own[:, None, None], o, torch.zeros_like(o))

    o = local_map(region, out_placements=_owner_placements(lin, qpl),
                  in_placements=(qpl,) + tuple(t.placements for t in state),
                  device_mesh=mesh, redistribute_inputs=True)(q, *state)
    return o.redistribute(mesh, qpl)
