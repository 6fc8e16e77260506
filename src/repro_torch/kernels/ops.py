"""Public attention and SSD ops, dispatched by the tensors' device.

A CUDA tensor launches the hand-written kernel (``flash_attention.py``)
or raises; a CPU tensor runs the plain version (``ref.py``).  There is no
environment switch and no fallback from one to the other: this is the
counterpart of repro's ``kernels/ops.py``, which chose the Pallas
interpret mode by backend.  ``plain_calls`` counts the plain versions'
calls made through here, so a run on the card can show it made none.

``flash_attention`` is the differentiable op (the counterpart of repro's
``jax.custom_vjp``): its forward and backward each go through the same
device dispatch.  ``ssd_chunk_scan_diff`` is the counterpart of repro's
``models/mamba._ssd_pallas``: the forward through the device dispatch,
the backward by autograd through the chunked ``ssd.ssd_scan``
(repro's backward is ``jax.vjp`` of its XLA scan, not a kernel);
``bwd_recomputes`` counts those backward passes, ``plan_fallbacks`` the
calls under a sharding plan that could not run on local shards, and
``all_to_all`` the MoE layer's expert-parallel exchanges."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import flash_attention as fa
from . import ref
from . import ssd

plain_calls: Dict[str, int] = {"flash_attention_fwd_ref": 0,
                               "flash_attention_bwd_ref": 0,
                               "flash_attention_decode_ref": 0,
                               "flash_attention_paged_decode_ref": 0,
                               "ssd_ref": 0}
bwd_recomputes: Dict[str, int] = {"ssd_chunk_scan": 0}
# calls under a sharding plan whose cut the kernel cannot run on each
# rank's local shards (models/attention.py), which ran the same kernel
# wrapper on the gathered tensors instead: the linear decode step, a
# prefill chunk (both tiers), training attention, the paged decode step,
# the speculative re-score (both tiers); the copy-on-write of a pool
# block whose blocks are cut across ranks (runtime/serve.py); and a
# Mamba decode step whose state is cut on an axis other than batch
# (models/mamba.py), whose update ran on the gathered state; and an MoE
# layer whose expert weights or activations are cut on an axis it cannot
# run on locally (models/moe.py), which ran on the gathered tensors; and an
# xLSTM block whose fused projection is cut on its output axis or whose
# decode state is cut on an axis other than batch (models/xlstm.py), which
# ran on the gathered tensor
plan_fallbacks: Dict[str, int] = {"attend_cache": 0, "prefill_attention": 0,
                                  "attention": 0, "attend_paged": 0,
                                  "rescore": 0, "copy_block": 0,
                                  "mamba_state": 0, "moe": 0, "xlstm": 0}
# the MoE layer's expert-parallel all-to-alls under a training plan
# (models/moe.py): one "dispatch" and one "combine" a layer a forward
# (the remat recompute runs them again), counted per mesh axis they
# cross; their backward twins are autograd's and are not counted
all_to_all: Dict[str, int] = {"moe_dispatch": 0, "moe_combine": 0}


def reset_plain_calls() -> None:
    for counts in (plain_calls, bwd_recomputes, plan_fallbacks, all_to_all):
        for name in counts:
            counts[name] = 0


def _route(*tensors: torch.Tensor) -> str:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    kind = tensors[0].device.type
    if kind not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no kernel path for device type {kind!r}")
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


def ssd_chunk_scan(xh, a_log, bb, cc, *, chunk: int):
    """y [B,S,H,P] f32 of the SSD scan (S % min(chunk, S) == 0); see
    ref.ssd_ref for the semantics.  The plain version returns the final
    state too; the kernel, as repro's, does not."""
    if _route(xh, a_log, bb, cc) == "cuda":
        return ssd.ssd_chunk_scan(xh, a_log, bb, cc, chunk=chunk)
    s = xh.shape[1]
    q = min(int(chunk), s)
    if s and (q < 1 or s % q):
        raise ValueError(f"S={s} is not a multiple of the chunk {q}")
    plain_calls["ssd_ref"] += 1
    return ref.ssd_ref(xh, a_log, bb, cc)[0]


class _SSDChunkScan(torch.autograd.Function):
    """Saves the inputs; the backward recomputes the chunked scan under
    autograd and returns its input grads (dy cast to f32, as repro's
    ``_ssd_pallas_bwd``)."""

    @staticmethod
    def forward(ctx, xh, a_log, bb, cc, chunk):
        ctx.save_for_backward(xh, a_log, bb, cc)
        ctx.chunk = chunk
        return ssd_chunk_scan(xh, a_log, bb, cc, chunk=chunk)

    @staticmethod
    def backward(ctx, dy):
        bwd_recomputes["ssd_chunk_scan"] += 1
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, _ = ssd.ssd_scan(*ins, ctx.chunk)
            grads = torch.autograd.grad(y, ins, dy.float())
        return (*grads, None)


def ssd_chunk_scan_diff(xh, a_log, bb, cc, chunk: int) -> torch.Tensor:
    """Differentiable ``ssd_chunk_scan`` (f32 inputs, S a multiple of the
    chunk)."""
    return _SSDChunkScan.apply(xh, a_log, bb, cc, chunk)
