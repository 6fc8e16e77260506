"""Public attention ops, dispatched by the tensors' device.

A CUDA tensor launches the hand-written kernel (``flash_attention.py``)
or raises; a CPU tensor runs the plain version (``ref.py``).  There is no
environment switch and no fallback from one to the other: this is the
counterpart of repro's ``kernels/ops.py``, which chose the Pallas
interpret mode by backend.  ``plain_calls`` counts the plain versions'
calls made through here, so a run on the card can show it made none.

``flash_attention`` is the differentiable op (the counterpart of repro's
``jax.custom_vjp``): its forward and backward each go through the same
device dispatch."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import flash_attention as fa
from . import ref

plain_calls: Dict[str, int] = {"flash_attention_fwd_ref": 0,
                               "flash_attention_bwd_ref": 0,
                               "flash_attention_decode_ref": 0,
                               "flash_attention_paged_decode_ref": 0}


def reset_plain_calls() -> None:
    for name in plain_calls:
        plain_calls[name] = 0


def _route(*tensors: torch.Tensor) -> str:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    kind = tensors[0].device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no attention path for device type {kind!r}")
    return kind


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None, q_offset=None):
    """-> (o [B,Sq,H,hd], lse [B,H,Sq] f32); see ref.flash_attention_fwd_ref
    for the semantics."""
    if _route(q, k, v) == "cuda":
        return fa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                      scale=scale, q_offset=q_offset)
    plain_calls["flash_attention_fwd_ref"] += 1
    return ref.flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                       scale=scale, q_offset=q_offset)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """-> (dq, dk, dv); see ref.flash_attention_bwd_ref for the
    semantics."""
    if _route(q, k, v, o, lse, do) == "cuda":
        return fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                      window=window, scale=scale)
    plain_calls["flash_attention_bwd_ref"] += 1
    return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, scale=scale)


class _FlashAttention(torch.autograd.Function):
    """Saves (q, k, v, o, lse) in the forward; the backward recomputes P
    from lse in flash_attention_bwd."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable attention without offset: q [B,S,H,hd]; k/v
    [B,S,KV,hd] -> o [B,S,H,hd] (counterpart of repro's
    ``ops.flash_attention``)."""
    return _FlashAttention.apply(q, k, v, causal, window, scale)


def flash_attention_decode(q, k_cache, v_cache, lengths, *,
                           window: Optional[int] = None,
                           scale: Optional[float] = None):
    """One decode step against the slot cache; see
    ref.flash_attention_decode_ref for the semantics."""
    if _route(q, k_cache, v_cache, lengths) == "cuda":
        return fa.flash_attention_decode(q, k_cache, v_cache, lengths,
                                         window=window, scale=scale)
    plain_calls["flash_attention_decode_ref"] += 1
    return ref.flash_attention_decode_ref(q, k_cache, v_cache, lengths,
                                          window=window, scale=scale)


def flash_attention_paged_decode(q, k_pool, v_pool, table, lengths, *,
                                 scale: Optional[float] = None):
    """One decode step against the paged tier's block pools, read through
    the block table; see ref.flash_attention_paged_decode_ref for the
    semantics."""
    if _route(q, k_pool, v_pool, table, lengths) == "cuda":
        return fa.flash_attention_paged_decode(q, k_pool, v_pool, table,
                                               lengths, scale=scale)
    plain_calls["flash_attention_paged_decode_ref"] += 1
    return ref.flash_attention_paged_decode_ref(q, k_pool, v_pool, table,
                                                lengths, scale=scale)
