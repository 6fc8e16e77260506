"""Plain PyTorch versions of the attention kernels and the SSD scan.

They are what a CPU tensor runs (``kernels/ops.py`` dispatches by device)
and what ``chip_smoke.py`` and the tests hold the CUDA kernels to.  All
materialise the full score matrix in f32 and mask with the kernels'
finite sentinel ``NEG_INF``.

``flash_attention_fwd_ref`` is the counterpart of repro's
``kernels/ref.py::attention_ref`` extended with ``q_offset`` and the
logsumexp; ``flash_attention_bwd_ref`` of repro's Pallas backward (its
formulas, not autograd); ``flash_attention_decode_ref`` of repro's Pallas
``flash_attention_decode`` (``models/attention.py::attend_cache`` but for
an empty slot, see there); ``flash_attention_paged_decode_ref`` of
``models/attention.py::attend_paged`` (the table gather, then the
decode); ``ssd_ref`` of repro's ``kernels/ref.py::ssd_ref``, and
``ssd_chunk_scan_split_ref`` of the CUDA scan's passes (tests only).  A
query row that sees no key at all (only possible with a window and an
offset past the cache end) has no defined output: the TPU kernel returns
an average that depends on its tile padding.  No caller produces such
rows."""
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
    ``[len - window, len)``.  -> [B,H,hd] q.dtype.  V rows outside the
    valid range are zeroed before P·V, as repro's Pallas decode kernel
    does (``_clean``): a slot with no valid position (length 0) gives
    exact zeros, where ``attend_cache``'s XLA softmax gives the mean of V
    over all S positions.  A slot with a valid position gets the same
    bits either way (P is exactly 0 off the valid range)."""
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
    vf = torch.where(valid[:, :, None, None], v_cache.float(),
                     torch.zeros((), device=q.device))
    out = torch.einsum("bKgc,bcKd->bKgd", p, vf)
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


def flash_attention_decode_split_ref(q, k_cache, v_cache, lengths, *,
                                     split: int,
                                     window: Optional[int] = None,
                                     scale: Optional[float] = None):
    """The decode kernels' split pass in plain PyTorch (only the tests use
    it): per slot, every range [s split, (s + 1) split) of positions that
    meets the live range [lo, len) gives f32 partials over its live keys
    (the max m, the sum l of exp(score - m), the unnormalised acc), and
    they are merged in split order, as the kernels' last block merges
    them: an online softmax over the splits.  Split 0 counts as live for
    an empty slot, which gives zeros.  Shapes as
    ``flash_attention_decode_ref``."""
    b, h, hd = q.shape
    _, s, kv, _ = k_cache.shape
    check_gqa(h, kv)
    g = h // kv
    scale = scale if scale is not None else hd ** -0.5
    qf = q.reshape(b, kv, g, hd).float() * scale
    kf, vf = k_cache.float(), v_cache.float()
    out = torch.zeros((b, kv, g, hd), dtype=torch.float32, device=q.device)
    for r in range(b):
        ln = min(int(lengths[r]), s)
        lo = max(0, ln - window) if window is not None else 0
        m = torch.full((kv, g), NEG_INF, device=q.device)
        l = torch.zeros((kv, g), device=q.device)
        acc = torch.zeros((kv, g, hd), device=q.device)
        for sp in range(lo // split, max(ln - 1, lo) // split + 1):
            k0, k1 = max(lo, sp * split), min(ln, (sp + 1) * split)
            if k1 > k0:
                sc = torch.einsum("Kgd,cKd->Kgc", qf[r], kf[r, k0:k1])
                m_s = sc.max(-1).values
                p = torch.exp(sc - m_s[..., None])
                l_s = p.sum(-1)
                a_s = torch.einsum("Kgc,cKd->Kgd", p, vf[r, k0:k1])
            else:
                m_s = torch.full_like(m, NEG_INF)
                l_s, a_s = torch.zeros_like(l), torch.zeros_like(acc)
            mn = torch.maximum(m, m_s)
            c_old, c_new = torch.exp(m - mn), torch.exp(m_s - mn)
            acc = acc * c_old[..., None] + a_s * c_new[..., None]
            l = l * c_old + l_s * c_new
            m = mn
        out[r] = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(b, h, hd).to(q.dtype)


def flash_attention_paged_decode_split_ref(q, k_pool, v_pool, table,
                                           lengths, *, split: int,
                                           scale: Optional[float] = None):
    """``flash_attention_decode_split_ref`` through a block table: the
    paged kernel's split pass over MB*BL positions, on the view the table
    spells (only the tests use it)."""
    b, mb = table.shape
    _, bl, kv, hd = k_pool.shape
    idx = table.long()
    return flash_attention_decode_split_ref(
        q, k_pool[idx].reshape(b, mb * bl, kv, hd),
        v_pool[idx].reshape(b, mb * bl, kv, hd), lengths, split=split,
        scale=scale)


def ssd_ref(xh, a_log, bb, cc):
    """Sequential state-space recurrence (the SSD oracle).  xh [B,S,H,P]
    (dt folded in), a_log [B,S,H] (per-step log decay), bb/cc [B,S,N]
    shared across heads:  h_t = exp(a_log_t) h_{t-1} + x_t (x) B_t,
    y_t = C_t . h_t.  -> (y [B,S,H,P] f32, final state [B,H,P,N] f32)."""
    b, s, h, p = xh.shape
    n = bb.shape[-1]
    x32, a32 = xh.float(), a_log.float()
    b32, c32 = bb.float(), cc.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(s):
        state = (state * torch.exp(a32[:, t])[..., None, None]
                 + x32[:, t, :, :, None] * b32[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, c32[:, t]))
    y = (torch.stack(ys, 1) if ys
         else torch.zeros((b, 0, h, p), dtype=torch.float32,
                          device=xh.device))
    return y, state


def _split(t):
    """hi = bf16(t) and lo = bf16(t - hi), as f32: the two bf16 operands
    the CUDA scan makes of an f32 operand."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _split_mm(a, b):
    """a @ b as the CUDA scan forms it on the tensor cores: hi.hi + hi.lo
    + lo.hi (lo.lo dropped), each product of bf16 values exact in f32."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return ah @ bh + ah @ bl + al @ bh


def ssd_chunk_scan_split_ref(xh, a_log, bb, cc, chunk: int):
    """The CUDA chunk scan's passes in plain PyTorch (only the tests use
    it): xh [B,S,H,P], a_log [B,S,H], bb/cc [B,S,N], S a multiple of the
    chunk -> y [B,S,H,P] f32.  cum is the in-chunk prefix sum of a_log;
    per chunk the local end state S_local = (tail o x)^T B; the states
    carried across chunks as S = d S + S_local in chunk order, d the
    chunk's clipped decay exp(clip(cum_last)), so the carried decay is a
    product of per-chunk clipped decays; C.B^T formed once and shared by
    the heads; y = exp(clip(cum_q)) C.S_prev^T + (C.B^T o L) x with L =
    exp(clip(cum_q - cum_t)), exactly 0 above the diagonal.  Every
    product takes its operands split into bf16 hi + lo (``_split_mm``),
    as the kernel does."""
    b, s, h, p = xh.shape
    n = bb.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"S={s} is not a multiple of the chunk {q}")
    nc = s // q

    def clip_exp(t):
        return torch.exp(t.clamp(-60.0, 0.0))

    x = xh.float().reshape(b, nc, q, h, p)
    cum = torch.cumsum(a_log.float().reshape(b, nc, q, h), 2)
    bq = bb.float().reshape(b, nc, q, n)
    cq = cc.float().reshape(b, nc, q, n)

    tail = clip_exp(cum[:, :, -1:, :] - cum)                  # [B,nc,Q,H]
    xt = (x * tail[..., None]).permute(0, 1, 3, 4, 2)          # [B,nc,H,P,Q]
    s_local = _split_mm(xt, bq[:, :, None])                    # [B,nc,H,P,N]
    decay = clip_exp(cum[:, :, -1, :])                         # [B,nc,H]
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = decay[:, c, :, None, None] * state + s_local[:, c]
    s_prev = torch.stack(prevs, 1)                             # [B,nc,H,P,N]

    cb = _split_mm(cq, bq.transpose(-1, -2))                   # [B,nc,Q,T]
    dec = clip_exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    mask = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    w = torch.where(mask[:, :, None], cb[..., None] * dec,
                    torch.zeros((), device=xh.device))         # [B,nc,Q,T,H]
    y_intra = _split_mm(w.permute(0, 1, 4, 2, 3),
                        x.permute(0, 1, 3, 2, 4))              # [B,nc,H,Q,P]
    din = clip_exp(cum).permute(0, 1, 3, 2)[..., None]         # [B,nc,H,Q,1]
    y_inter = din * _split_mm(cq[:, :, None], s_prev.transpose(-1, -2))
    return (y_inter + y_intra).permute(0, 1, 3, 2, 4).reshape(b, s, h, p)
