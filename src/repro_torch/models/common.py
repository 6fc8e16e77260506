"""Shared model components (counterpart of ``repro.models.common``).

Params are plain dicts of tensors in JAX's ``[in, out]`` layout, used as
``x @ w``.  ``shard`` waits for the mesh slice."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` without a card is an
    error, never a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return dev


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * gamma.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding, half-split.  x: [..., seq, heads, hd];
    positions: [..., seq].  The frequencies are computed as repro computes
    them, ``exp(-log(theta) * i / half)`` in f32."""
    hd = x.shape[-1]
    half = hd // 2
    # built on x's device (torch.full, not torch.tensor: no host copy)
    log_theta = torch.full((), theta, dtype=torch.float32,
                           device=x.device).log()
    freqs = torch.exp(-log_theta * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].float() * freqs
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    if 2 * half != hd:
        rot = torch.cat([rot, x[..., 2 * half:].float()], -1)
    return rot.to(x.dtype)


def dense_init(shape: Sequence[int], generator: torch.Generator, *,
               in_axis: int = 0, dtype=torch.bfloat16,
               device="cpu") -> torch.Tensor:
    fan_in = shape[in_axis]
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return (w / math.sqrt(max(fan_in, 1))).to(dtype)


def embed_init(shape: Sequence[int], generator: torch.Generator, *,
               dtype=torch.bfloat16, device="cpu") -> torch.Tensor:
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def causal_mask(sq: int, sk: int, q_off, k_off,
                window: Optional[int] = None, device=None) -> torch.Tensor:
    """[sq, sk] boolean mask (True = attend) for absolute offsets;
    ``q_off`` may be an int or a 0-d / 1-element tensor."""
    if isinstance(q_off, torch.Tensor):
        q_off = q_off.reshape(()).long()
        device = q_off.device
    qi = q_off + torch.arange(sq, device=device)[:, None]
    ki = k_off + torch.arange(sk, device=device)[None, :]
    m = ki <= qi
    if window is not None:
        m &= ki > qi - window
    return m
