"""GQA attention entry points (counterpart of ``repro.models.attention``).

All go through ``kernels/ops.py``, which picks the CUDA kernel for CUDA
tensors and the plain version for CPU tensors.  ``attention`` routes as
repro's kernel route: a static ``q_offset`` of 0 goes through the
differentiable ``ops.flash_attention`` (training), anything else through
the forward-only offset kernel (chunked prefill).  ``impl`` exists for
signature parity with repro, where it chose between XLA and Pallas; the
port has one route, so it accepts only ``"auto"``."""
from __future__ import annotations

from typing import Optional

from ..kernels import ops as kops

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
