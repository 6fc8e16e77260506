"""Public attention ops, dispatched by the tensors' device.

A CUDA tensor launches the hand-written kernel (``flash_attention.py``)
or raises; a CPU tensor runs the plain version (``ref.py``).  There is no
environment switch and no fallback from one to the other: this is the
counterpart of repro's ``kernels/ops.py``, which chose the Pallas
interpret mode by backend.  ``plain_calls`` counts the plain versions'
calls made through here, so a run on the card can show it made none."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import flash_attention as fa
from . import ref

plain_calls: Dict[str, int] = {"flash_attention_fwd_ref": 0,
                               "flash_attention_decode_ref": 0}


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
