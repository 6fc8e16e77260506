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
its XLA attention.  Serving (``attend_cache_sharded``,
``prefill_attention_sharded``) updates the slot cache in place, so the
K/V write and the kernel run together on each rank's local shard
through ``local_map`` (repro's ``shard_map`` rule).  The kernel
takes the local shards when the cache's cut is on ``batch`` and/or
``kv_heads`` only and each degree divides its dim; any other cut (a
``seq_kv`` cut would split the softmax) gathers the query and the
layer's cache whole on every rank and runs the same kernel on them, as
repro runs its XLA attention on the global arrays there.  Each gather is
counted in ``ops.plan_fallbacks``."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..kernels import ops as kops
from .sharding import global_offset

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
    TypeError."""
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
# Caches are [L, B, S, KV, hd] DTensors: tensor dims 1 (batch), 2 (seq_kv),
# 3 (kv_heads).

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
    degree that does not divide) gathers q, k and v whole on every rank
    and runs the same op on them, counted in
    ``ops.plan_fallbacks["attention"]``.  Returns o [B,S,H,hd]
    (DTensor)."""
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
        qpl = (Replicate(),) * mesh.ndim

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
    has no local rule, the gathered query and caches.  Returns o
    [B,H,hd] (DTensor)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = k_all.device_mesh
    b, h, _ = q.shape
    qpl = kernel_placements(k_all.placements, mesh, b, h, k_all.shape[3],
                            batch_dim=0, head_dim=1)
    _, b0, s0, h0, d0 = global_offset(k_all)
    rep = (Replicate(),) * mesh.ndim

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

    # one output: its placements go as a list (a tuple would name several);
    # None for the fallback's region, which returns None
    o = local_map(region,
                  out_placements=None if qpl is None else list(qpl),
                  in_placements=(qpl if qpl is not None else q.placements,
                                 rep, rep, k_all.placements,
                                 v_all.placements),
                  device_mesh=mesh, redistribute_inputs=True)(
                      q, k, v, k_all, v_all)
    if qpl is not None:
        return o
    kops.plan_fallbacks["attend_cache"] += 1
    out = attend_cache(q.full_tensor(), k_all[layer].full_tensor(),
                       v_all[layer].full_tensor(), length)
    return DTensor.from_local(out, mesh, rep, run_check=False)


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
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = k_all.device_mesh
    _, c, h, _ = q.shape
    qpl = kernel_placements(k_all.placements, mesh, k_all.shape[1], h,
                            k_all.shape[3], batch_dim=None, head_dim=2)
    _, b0, s0, h0, d0 = global_offset(k_all)
    rep = (Replicate(),) * mesh.ndim

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

    # the batch mesh dims sum the owner's rows with the others' zeros
    opl = None if qpl is None else [
        Partial() if isinstance(p, Shard) and p.dim == 1 else
        Shard(2) if isinstance(p, Shard) else Replicate()
        for p in k_all.placements]
    o = local_map(region, out_placements=opl,
                  in_placements=(qpl if qpl is not None else q.placements,
                                 rep, rep, k_all.placements,
                                 v_all.placements),
                  device_mesh=mesh, redistribute_inputs=True)(
                      q, k, v, k_all, v_all)
    if qpl is not None:
        return o.redistribute(mesh, qpl)      # x + 0 + ... + 0: exact
    kops.plan_fallbacks["prefill_attention"] += 1
    kf = k_all[layer].full_tensor()[slot:slot + 1]
    vf = v_all[layer].full_tensor()[slot:slot + 1]
    out = attention(q.full_tensor(), kf, vf, causal=True, q_offset=pos0)
    return DTensor.from_local(out, mesh, rep, run_check=False)
