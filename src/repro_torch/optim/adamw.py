"""AdamW with f32 moments, global-norm clipping and a warmup + cosine
schedule (counterpart of ``repro.optim.adamw``) on nested dicts of
tensors.

Differences from repro, none in the arithmetic:
  - the update is in place: ``params``, ``m``, ``v`` and ``step`` are
    rewritten inside the tensors given, and the same dicts are returned;
  - ``state["step"]`` is a 0-d int32 tensor on the params' device, and the
    learning rate and the bias corrections are computed from it there, so
    a step never waits for the device.
As in repro, weight decay applies to every leaf with ``ndim >= 2``: with
stacked ``[L, d]`` layers that includes ``ln1``, ``ln2`` and the stacked
QKV biases, and excludes ``ln_f``."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from .. import tree

Tree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor), computed where it lives."""
    step = step.float()
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_state(params: Tree) -> Tree:
    """{"step": 0-d int32, "m", "v": f32 zeros like params}, on the
    params' device."""
    dev = tree.leaves(params)[0].device

    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree.tree_map(zeros32, params),
            "v": tree.tree_map(zeros32, params)}


def global_norm(t: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.leaves(t)))


@torch.no_grad()
def apply_updates(params: Tree, grads: Tree, state: Tree,
                  cfg: AdamWConfig) -> Tuple[Tree, Tree, torch.Tensor]:
    """One AdamW step, in place.  Returns (params, state, grad_norm)."""
    state["step"] += 1
    step = state["step"].float()
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
            if cfg.clip_norm is not None else None)
    lr = schedule(cfg, state["step"])
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - torch.pow(b1, step)
    bc2 = 1 - torch.pow(b2, step)
    for (path, p), g, m, v in zip(tree.flatten(params), tree.leaves(grads),
                                  tree.leaves(state["m"]),
                                  tree.leaves(state["v"])):
        g = g.float() * clip if clip is not None else g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        decay = cfg.weight_decay if p.dim() >= 2 else 0.0
        p32 = p.float()
        p.copy_(p32 - lr * (delta + decay * p32))
    return params, state, gnorm
