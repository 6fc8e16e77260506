"""GQA attention entry points (counterpart of ``repro.models.attention``).

Both go through ``kernels/ops.py``, which picks the CUDA kernel for CUDA
tensors and the plain version for CPU tensors.  ``impl`` exists for
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
    o, _ = kops.flash_attention_fwd(q, k, v, causal=kw.get("causal", True),
                                    window=kw.get("window"),
                                    scale=kw.get("scale"), q_offset=q_offset)
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
