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
QKV biases, and excludes ``ln_f``.

Under a sharding plan the leaves are DTensors.  ``global_norm`` is the
norm of the whole gradient, summed from every rank's shard in one
all-reduce.  The update is elementwise: it runs on the local shards
where a leaf's grad, ``m``, ``v`` and param (or master) share placements;
where they do not, the grad and the param are moved into the moments'
placements first and the new param is moved back."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from .. import tree
from ..models.common import local
from ..models.sharding import from_local

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


def _owned(g) -> bool:
    """Whether this rank's shard of DTensor ``g`` counts towards a sum over
    the whole tensor: on each mesh dim that replicates ``g``, one rank
    (coordinate 0) holds the copy that counts."""
    from torch.distributed.tensor import Partial, Replicate
    coord = g.device_mesh.get_coordinate()
    for j, p in enumerate(g.placements):
        if isinstance(p, Partial):
            raise ValueError("global_norm of a pending sum: reduce the "
                             "gradient first")
        if isinstance(p, Replicate) and coord[j]:
            return False
    return True


def global_norm(t: Tree) -> torch.Tensor:
    """The L2 norm of every leaf of ``t`` together, as a plain 0-d f32
    tensor.  DTensor leaves (a mesh spanning the default group): each
    rank sums the squares of the shards it owns (``_owned``) and one
    all-reduce adds the ranks' sums."""
    from torch.distributed.tensor import DTensor
    leaves = tree.leaves(t)
    if not any(isinstance(g, DTensor) for g in leaves):
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in leaves))
    terms = []
    for g in leaves:
        sq = torch.sum(torch.square(g.to_local().float()))
        terms.append(sq if _owned(g) else torch.zeros_like(sq))
    total = sum(terms)
    torch.distributed.all_reduce(total)
    return torch.sqrt(total)


def _aligned(p, g, m, v):
    """Local tensors (p, g, m, v) for the elementwise update, and what
    writes the new p back.  Plain tensors are their own locals.  DTensors
    are taken in the moments' placements: a grad or param placed
    otherwise is redistributed there, and the param's new value is
    redistributed back into its own placements by the write-back."""
    from torch.distributed.tensor import DTensor
    if not isinstance(p, DTensor):
        return p, g, m, v, None
    mesh, pl = m.device_mesh, m.placements
    if g.placements != pl:
        g = g.redistribute(mesh, pl)
    if p.placements == pl:
        return p.to_local(), g.to_local(), m.to_local(), v.to_local(), None
    p_l = p.redistribute(mesh, pl).to_local().clone()

    def write_back():
        new = from_local(p_l, mesh, pl, p.shape)
        p.to_local().copy_(new.redistribute(mesh, p.placements).to_local())
    return p_l, g.to_local(), m.to_local(), v.to_local(), write_back


@torch.no_grad()
def apply_updates(params: Tree, grads: Tree, state: Tree,
                  cfg: AdamWConfig) -> Tuple[Tree, Tree, torch.Tensor]:
    """One AdamW step, in place.  Returns (params, state, grad_norm); the
    norm is a plain 0-d tensor, the whole gradient's under a plan."""
    step_t = local(state["step"])
    step_t += 1
    step = step_t.float()
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
            if cfg.clip_norm is not None else None)
    lr = schedule(cfg, step_t)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - torch.pow(b1, step)
    bc2 = 1 - torch.pow(b2, step)
    for (path, p0), g0, m0, v0 in zip(tree.flatten(params),
                                      tree.leaves(grads),
                                      tree.leaves(state["m"]),
                                      tree.leaves(state["v"])):
        p, g, m, v, write_back = _aligned(p0, g0, m0, v0)
        g = g.float() * clip if clip is not None else g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        decay = cfg.weight_decay if p0.dim() >= 2 else 0.0
        p32 = p.float()
        p.copy_(p32 - lr * (delta + decay * p32))
        if write_back is not None:
            write_back()
    return params, state, gnorm
