"""Plain PyTorch versions of the attention kernels.

They are what a CPU tensor runs (``kernels/ops.py`` dispatches by device)
and what ``chip_smoke.py`` and the tests hold the CUDA kernels to.  All
materialise the full score matrix in f32 and mask with the kernels'
finite sentinel ``NEG_INF``.

``flash_attention_fwd_ref`` is the counterpart of repro's
``kernels/ref.py::attention_ref`` extended with ``q_offset`` and the
logsumexp; ``flash_attention_bwd_ref`` of repro's Pallas backward (its
formulas, not autograd); ``flash_attention_decode_ref`` of
``models/attention.py::attend_cache``; ``flash_attention_paged_decode_ref``
of ``models/attention.py::attend_paged`` (the table gather, then the
decode).  A query row that sees no key at all (only possible with
a window and an offset past the cache end) has no defined output: the
TPU kernel returns an average that depends on its tile padding.  No
caller produces such rows."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def check_gqa(h: int, kv: int) -> None:
    """Counterpart of repro's ``flash_attention._check_gqa``."""
    if kv <= 0 or h % kv != 0:
        raise ValueError(
            f"GQA head mapping needs q_heads divisible by kv_heads, got "
            f"h={h} kv={kv}")


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True,
                            window: Optional[int] = None,
                            scale: Optional[float] = None,
                            q_offset=None):
    """q [B,Sq,H,hd]; k/v [B,Sk,KV,hd] -> (o [B,Sq,H,hd] q.dtype,
    lse [B,H,Sq] f32).  Query row i sits at absolute position
    ``q_offset + i`` (an int or a 1-element integer tensor)."""
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    check_gqa(h, kv)
    g = h // kv
    scale = scale if scale is not None else hd ** -0.5
    qf = q.reshape(b, sq, kv, g, hd).float() * scale
    s = torch.einsum("bqKgd,bkKd->bKgqk", qf, k.float())
    off = 0 if q_offset is None else q_offset
    if isinstance(off, torch.Tensor):
        off = off.reshape(()).long()
    qpos = off + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    lse = torch.logsumexp(s, -1)                       # [b, KV, g, sq]
    p = torch.softmax(s, -1)
    o = torch.einsum("bKgqk,bkKd->bqKgd", p, v.float())
    return (o.reshape(b, sq, h, hd).to(q.dtype),
            lse.reshape(b, h, sq))


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: Optional[int] = None,
                            scale: Optional[float] = None):
    """Gradients of flash attention (no offset) in the formulas of repro's
    ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``, not autograd: P is recomputed
    from the forward's ``lse`` under the causal/window mask, ``delta =
    rowsum(o * do)`` in f32, ``ds = p * (dp - delta)``; ``dq = ds k scale``
    in q.dtype, and ``dk = ds^T q scale``, ``dv = p^T do`` summed over the
    g query heads of each KV head in f32, then cast to k.dtype.

    q/o/do [B,S,H,hd]; k/v [B,Sk,KV,hd]; lse [B,H,S] f32."""
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    check_gqa(h, kv)
    g = h // kv
    scale = scale if scale is not None else hd ** -0.5
    qraw = q.reshape(b, sq, kv, g, hd).float()
    dof = do.reshape(b, sq, kv, g, hd).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqKgd,bkKd->bKgqk", qraw * scale, kf)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    lse5 = lse.reshape(b, kv, g, sq)[..., None].float()
    p = torch.where(mask, torch.exp(s - lse5), torch.zeros((), device=q.device))
    delta = (o.float() * do.float()).sum(-1)               # [b, sq, h]
    delta = delta.reshape(b, sq, kv, g).permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bqKgd,bkKd->bKgqk", dof, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bKgqk,bkKd->bqKgd", ds, kf) * scale
    dk = torch.einsum("bKgqk,bqKgd->bkKd", ds, qraw) * scale
    dv = torch.einsum("bKgqk,bqKgd->bkKd", p, dof)
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_decode_ref(q, k_cache, v_cache, lengths, *,
                               window: Optional[int] = None,
                               scale: Optional[float] = None):
    """q [B,H,hd] against caches [B,S,KV,hd] with per-slot valid
    ``lengths`` [B]; an optional ``window`` keeps positions
    ``[len - window, len)``.  -> [B,H,hd] q.dtype."""
    b, h, hd = q.shape
    _, s, kv, _ = k_cache.shape
    check_gqa(h, kv)
    g = h // kv
    scale = scale if scale is not None else hd ** -0.5
    qf = q.reshape(b, kv, g, hd).float() * scale
    sc = torch.einsum("bKgd,bcKd->bKgc", qf, k_cache.float())
    pos = torch.arange(s, device=q.device)[None, :]
    length = lengths.to(q.device).long()[:, None]
    valid = pos < length
    if window is not None:
        valid &= pos >= length - window
    sc = torch.where(valid[:, None, None, :], sc,
                     torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(sc, -1)
    out = torch.einsum("bKgc,bcKd->bKgd", p, v_cache.float())
    return out.reshape(b, h, hd).to(q.dtype)


def flash_attention_paged_decode_ref(q, k_pool, v_pool, table, lengths, *,
                                     scale: Optional[float] = None):
    """q [B,H,hd] against block pools [NB,BL,KV,hd] through the block
    ``table`` [B,MB] with per-slot valid ``lengths`` [B] (at most MB*BL)
    -> [B,H,hd] q.dtype.  Gathers each slot's view ``pool[table]`` into
    [B, MB*BL, KV, hd] and attends it as ``flash_attention_decode_ref``
    with no window, after zeroing the rows at or past the length (the
    kernel's ``_clean``): a row there may lie in the null block 0 or in
    another request's block, and no value of it, NaN included, may reach
    the output."""
    b, mb = table.shape
    _, bl, kv, hd = k_pool.shape
    idx = table.long()
    kc = k_pool[idx].reshape(b, mb * bl, kv, hd)
    vc = v_pool[idx].reshape(b, mb * bl, kv, hd)
    live = (torch.arange(mb * bl, device=q.device)[None, :]
            < lengths.to(q.device).long()[:, None])[:, :, None, None]
    zero = torch.zeros((), dtype=kc.dtype, device=kc.device)
    return flash_attention_decode_ref(q, torch.where(live, kc, zero),
                                      torch.where(live, vc, zero), lengths,
                                      scale=scale)
