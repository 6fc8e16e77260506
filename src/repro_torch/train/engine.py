"""The training engine on one card (counterpart of
``repro.train.engine.TrainEngine`` without a mesh or a plan).

One step carries what repro's jitted step carries, in eager PyTorch:
  - microbatch gradient accumulation in f32 (equal to the full batch);
  - gradient sync: on one card there is no collective, so the uncompressed
    path is the f32 cast, and the compressed path is error-feedback int8
    with one scale per bucket (``optim/compression.compress_bucketed``);
  - bf16 compute params with f32 master weights and f32 AdamW moments; the
    update runs on the master copy, which is then cast down into the
    params.
Unlike repro's donated jit, the step updates the state's tensors in place
and returns the same dict.  It never waits for the device: the loss and
the gradient norm come back as device scalars.

State (a nested dict, checkpointable as is, with repro's keys):
  ``params``  compute weights (``cfg.dtype``; the leaves require grad)
  ``opt``     {step: 0-d int32, m, v: f32}
  ``master``  f32 master weights   (present iff master_fp32)
  ``err``     f32 residuals        (present iff grad_compression)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import tree
from ..checkpoint import ckpt
from ..models.common import resolve_device
from ..models.mamba import SSD_IMPLS
from ..models.model import LM
from ..optim import adamw
from ..optim.adamw import AdamWConfig, apply_updates
from ..optim.compression import compress_bucketed, init_error

Tree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    microbatches: int = 1          # gradient-accumulation factor
    buckets: int = 4               # gradient-sync buckets
    grad_compression: bool = False  # error-feedback int8 sync
    master_fp32: bool = True       # bf16 compute / f32 master weights
    optim: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    # "auto" | "kernel" | "chunked": the SSD scan of the hybrid family's
    # Mamba layers, replacing the model's ssd_impl unless "auto" (which
    # keeps it; the model's own "auto" takes the CUDA kernel on the card,
    # as repro's engine takes Pallas on the TPU)
    kernels: str = "auto"


class TrainEngine:
    """One (model, device) training executor."""

    def __init__(self, model: LM, cfg: Optional[EngineConfig] = None,
                 device="cuda", mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "the port trains on one card; mesh= waits for the "
                "multi-card slice")
        self.cfg = cfg or EngineConfig()
        self.device = resolve_device(device)
        kernels = self.cfg.kernels
        if kernels not in SSD_IMPLS:
            raise ValueError(f"kernels must be one of {SSD_IMPLS}, got "
                             f"{kernels!r}")
        if kernels != "auto":
            model = dataclasses.replace(model, ssd_impl=kernels)
        self.model = model

    # -- state ---------------------------------------------------------------
    def init_state(self, seed: int = 0, params: Optional[Tree] = None
                   ) -> Tree:
        """Fresh state from ``model.init(seed)``, or around ``params``
        (used as given, on this engine's device)."""
        if params is None:
            params = self.model.init(seed, device=self.device)
        state: Tree = {"params": params, "opt": adamw.init_state(params)}
        if self.cfg.master_fp32:
            state["master"] = tree.tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params)
        if self.cfg.grad_compression:
            state["err"] = init_error(params)
        return state

    def state_like(self) -> Tree:
        """The state's shapes and dtypes as ``meta`` tensors (no memory),
        the restore target."""
        def meta(spec, dtype=None):
            shape, dt = spec
            return torch.empty(shape, dtype=dtype or dt, device="meta")

        specs = self.model.param_shapes()
        is_spec = lambda s: isinstance(s, tuple)      # noqa: E731

        def walk(t, dtype=None):
            return {k: meta(v, dtype) if is_spec(v) else walk(v, dtype)
                    for k, v in t.items()}

        f32 = torch.float32
        like: Tree = {"params": walk(specs),
                      "opt": {"step": torch.empty((), dtype=torch.int32,
                                                  device="meta"),
                              "m": walk(specs, f32), "v": walk(specs, f32)}}
        if self.cfg.master_fp32:
            like["master"] = walk(specs, f32)
        if self.cfg.grad_compression:
            like["err"] = walk(specs, f32)
        return like

    # -- the step --------------------------------------------------------------
    def _batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def _grads(self, params: Tree, leaves: List[torch.Tensor],
               batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        with torch.enable_grad():
            loss = self.model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads

    def step(self, state: Tree, batch: Dict[str, Any]
             ) -> Tuple[Tree, Dict[str, torch.Tensor]]:
        """One training step, in place.  ``batch`` holds ``tokens`` and
        ``labels`` [B, S] (tensors or numpy).  Returns (state, {"loss",
        "gnorm"} as device scalars)."""
        cfg = self.cfg
        batch = self._batch(batch)
        params = state["params"]
        flat = tree.flatten(params)
        leaves = [p for _, p in flat]
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        n = cfg.microbatches
        b = batch["tokens"].shape[0]
        if b % n:
            raise ValueError(f"batch {b} is not divisible by "
                             f"{n} microbatches")
        if n == 1:
            loss, g = self._grads(params, leaves, batch)
            grads = [x.float() for x in g]
        else:
            mb = b // n
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(n):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                li, g = self._grads(params, leaves, part)
                for a, gi in zip(grads, g):
                    a.add_(gi)                 # f32 accumulation
                loss = loss + li
                del g
            for a in grads:
                a.div_(n)
            loss = loss / n
        gtree = tree.unflatten([(p, g) for (p, _), g in zip(flat, grads)])
        del grads
        gtree = self._sync_grads(gtree, state)
        ref = state["master"] if cfg.master_fp32 else params
        _, _, gnorm = apply_updates(ref, gtree, state["opt"], cfg.optim)
        if cfg.master_fp32:
            with torch.no_grad():
                for p, m in zip(leaves, tree.leaves(state["master"])):
                    p.copy_(m)               # cast down to the compute dtype
        return state, {"loss": loss, "gnorm": gnorm}

    def _sync_grads(self, grads: Tree, state: Tree) -> Tree:
        """On one card: the f32 grads as they are, or the error-feedback
        int8 round trip (which updates ``state["err"]``)."""
        if not self.cfg.grad_compression:
            return grads
        grads, state["err"] = compress_bucketed(grads, state["err"],
                                                self.cfg.buckets)
        return grads

    # -- checkpointing -----------------------------------------------------------
    def save(self, directory: str, step: int, state: Tree,
             extra: Optional[Dict[str, Any]] = None) -> str:
        return ckpt.save(directory, step, state, extra=extra)

    def restore(self, directory: str, step: Optional[int] = None
                ) -> Optional[Tuple[Tree, Dict[str, Any], int]]:
        """The latest (or given) step's state on this engine's device, or
        None when the directory holds no checkpoint."""
        if step is None:
            step = ckpt.latest_step(directory)
        if step is None:
            return None
        state, extra = ckpt.restore(directory, step, self.state_like(),
                                    device=self.device)
        return state, extra, step
