"""Shared model components (counterpart of ``repro.models.common``).

Params are plain dicts of tensors in JAX's ``[in, out]`` layout, used as
``x @ w``."""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

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


def device_sync(device: torch.device) -> Callable[[], None]:
    """What ends a timed section: a device synchronise on the card,
    nothing on the CPU."""
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def shard(x, plan, role: str, phys_dims: Sequence[str]):
    """Redistribute DTensor ``x`` to the placements the plan gives
    ``role`` (repro's ``with_sharding_constraint``).  A no-op without a
    plan, for a role the plan does not know (replicating would be a
    constraint too), and for a plain tensor.  A cut whose degree does not
    divide its dim is left out (``sharding.even_placements``)."""
    if plan is None or not plan.has_role(role):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from .sharding import even_placements, spec_placements
    mesh = x.device_mesh
    pl = even_placements(spec_placements(plan.pspec(role, phys_dims),
                                         mesh.mesh_dim_names),
                         x.shape, mesh)
    if tuple(pl) == tuple(x.placements):
        return x
    return x.redistribute(mesh, pl)


def whole(t):
    """A DTensor gathered whole on every rank (``full_tensor``), or ``t``
    itself."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def local(t):
    """The local tensor of a DTensor (all of it when it is replicated),
    or ``t`` itself."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


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


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          vocab: int) -> torch.Tensor:
    """Token-mean cross entropy in f32 (repro's ``softmax_cross_entropy``;
    ``vocab`` is kept for its signature)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


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
