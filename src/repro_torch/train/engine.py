"""The training engine (counterpart of ``repro.train.engine.TrainEngine``),
on one card or under a solved sharding plan on a ``DeviceMesh``.

One step carries what repro's jitted step carries, in eager PyTorch:
  - microbatch gradient accumulation in f32 (equal to the full batch);
  - bucketed gradient sync (``optim/compression.bucket_slices``);
  - optional error-feedback int8 with one scale per bucket
    (``optim/compression.compress_bucketed``);
  - bf16 compute params with f32 master weights and f32 AdamW moments; the
    update runs on the master copy, which is then cast down into the
    params.
Unlike repro's donated jit, the step updates the state's tensors in place
and returns the same dict.

Under a plan (``LM.plan`` with a mesh) every state tree is a tree of
DTensors placed under its own solved roles (``state_placements``):
params under the weight roles, ``opt`` under ``<w>.opt``, ``master`` under
``<w>.master`` (else ``.opt``), ``err`` under ``<w>.err`` (else ``.opt``).
The gradient is carried in the optimizer state's layout (``.opt``, else
``.grad``), as repro carries it, so the update runs on local shards:
  - each microbatch's grads (a pending sum over the cut batch) are
    redistributed leaf by leaf into the accumulator's placements, in f32,
    the leaves of one ``bucket_slices`` bucket issued together and waited
    for together (repro fuses a bucket's per-leaf constraints with
    ``optimization_barrier``); the accumulator never gathers;
  - with compression the accumulator is in the ``.err`` placements, so
    every sum is reduced in f32 before the quantizer, and only the int8
    values ride the reshard into the gradient's layout (``on_wire``);
  - AdamW on the master, then the cast-down: bf16 in the master's
    placements first, then redistributed into the params', so a gather
    moves bf16;
  - the loss and the gradient norm come back as full scalars.
On one card, nothing waits for the device: the loss and the gradient
norm come back as device scalars.

State (a nested dict, checkpointable as is, with repro's keys):
  ``params``  compute weights (``cfg.dtype``; the leaves require grad)
  ``opt``     {step: 0-d int32, m, v: f32}
  ``master``  f32 master weights   (present iff master_fp32)
  ``err``     f32 residuals        (present iff grad_compression)
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import tree
from ..checkpoint import ckpt
from ..models.common import resolve_device
from ..models.mamba import SSD_IMPLS
from ..models.model import LM
from ..obs.tracing import span as _span
from ..models.sharding import (batch_placements, from_local, like_placed,
                               place, tree_placements, zeros_placed)
from ..optim import adamw
from ..optim.adamw import AdamWConfig, apply_updates
from ..optim.compression import (bucket_slices, compress_bucketed,
                                 init_error)

Tree = Dict[str, Any]


def _batch_size(batch: Dict[str, Any]) -> int:
    """The leading dim the batch's leaves share (``tokens`` or ``embeds``
    with ``labels``; a layer stack's ``x`` and ``y``)."""
    sizes = {v.shape[0] for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError("batch leaves disagree on the batch size: "
                         + str({k: tuple(v.shape) for k, v in batch.items()}))
    return sizes.pop()


def _flat_group(mesh, dims: Tuple[int, ...]):
    """This rank's process group over mesh dims ``dims`` (the ranks that
    share its coordinates on the other dims), made with its siblings by
    every rank of the default group."""
    import torch.distributed as dist
    other = [j for j in range(mesh.ndim) if j not in dims]
    size = math.prod(mesh.size(j) for j in dims)
    groups = mesh.mesh.permute(*other, *dims).reshape(-1, size).tolist()
    return dist.new_subgroups_by_enumeration(groups)[0]


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
    """One (model, device) training executor, placed under ``model.plan``
    on ``mesh`` (default ``model.mesh``) when the model has a plan.  A
    mesh without a plan trains unsharded, as repro's engine does."""

    def __init__(self, model: LM, cfg: Optional[EngineConfig] = None,
                 device="cuda", mesh=None):
        self.cfg = cfg or EngineConfig()
        self.device = resolve_device(device)
        kernels = self.cfg.kernels
        if kernels not in SSD_IMPLS:
            raise ValueError(f"kernels must be one of {SSD_IMPLS}, got "
                             f"{kernels!r}")
        if kernels != "auto":
            model = dataclasses.replace(model, ssd_impl=kernels)
        self.mesh = mesh if mesh is not None else model.mesh
        self.plan = model.plan
        self.sharded = self.plan is not None
        if self.sharded:
            if self.mesh is None:
                raise ValueError("a sharding plan needs a mesh to place on "
                                 "(TrainEngine(mesh=) or LM.mesh)")
            if model.mesh is not self.mesh:
                model = dataclasses.replace(model, mesh=self.mesh)
        self.model = model
        self._placements: Optional[Tree] = None
        # the grad sync's process groups over several mesh dims, by dims
        self._flat: Dict[Tuple[int, ...], Any] = {}

    # -- state ---------------------------------------------------------------
    def state_placements(self) -> Tree:
        """DTensor placements of every state leaf under the plan, by role
        (repro's ``state_pspecs``): params under the weight roles, ``opt``
        under ``<w>.opt``, ``master`` under ``<w>.master`` then ``.opt``,
        ``err`` under ``<w>.err`` then ``.opt``, each falling back to the
        weight's own cut; ``opt/step`` replicated."""
        if not self.sharded:
            raise ValueError("state_placements needs a sharding plan")
        if self._placements is None:
            like = self.state_like()
            names = self.mesh.mesh_dim_names

            def pl(t: Tree, suffixes: Tuple[str, ...] = ()) -> Tree:
                return tree_placements(self.plan, t, names,
                                       suffixes=suffixes)
            out = {"params": pl(like["params"]),
                   "opt": pl(like["opt"], (".opt",))}
            if "master" in like:
                out["master"] = pl(like["master"], (".master", ".opt"))
            if "err" in like:
                out["err"] = pl(like["err"], (".err", ".opt"))
            self._placements = out
        return self._placements

    def grad_placements(self) -> Tree:
        """The gradient's placements: the optimizer state's layout
        (``.opt``, else ``.grad``), as repro carries it (a raw ``.grad``
        layout made repro re-gather f32 state where the two cuts
        differ), so the update runs on local shards."""
        return tree_placements(self.plan, self.state_like()["params"],
                               self.mesh.mesh_dim_names,
                               suffixes=(".opt", ".grad"))

    def batch_placements(self) -> Dict[str, List]:
        """Placements of the host batch's ``tokens`` and ``labels``, and of
        an embedding-stub batch's ``embeds`` [B, S, D] under the prefill
        placements, d_model whole (repro's ``batch_shardings`` and
        ``_batch_spec``; ``data/pipeline.BatchFeed`` feeds batches placed
        under them)."""
        names = self.mesh.mesh_dim_names
        return dict(batch_placements(self.plan, names, "train"),
                    embeds=batch_placements(self.plan, names, "prefill"))

    def init_state(self, seed: int = 0, params: Optional[Tree] = None
                   ) -> Tree:
        """Fresh state from ``model.init(seed)``, or around ``params``
        (used as given, on this engine's device).  Under a plan every
        leaf is placed from the seeded full tensors (each rank keeps its
        slice), so every mesh starts from the same weights; the moments
        and residuals are allocated shard by shard."""
        if params is None:
            params = self.model.init(seed, device=self.device)
        if not self.sharded:
            state: Tree = {"params": params,
                           "opt": adamw.init_state(params)}
            if self.cfg.master_fp32:
                state["master"] = tree.tree_map(
                    lambda p: p.detach().to(torch.float32, copy=True),
                    params)
            if self.cfg.grad_compression:
                state["err"] = init_error(params)
            return state
        from torch.distributed.tensor import DTensor
        pl, mesh = self.state_placements(), self.mesh

        def full(p):
            return (p.full_tensor() if isinstance(p, DTensor) else p).detach()

        def zeros(p, q):
            return zeros_placed(p.shape, torch.float32, mesh, q, self.device)

        step = torch.zeros((), dtype=torch.int32, device=self.device)
        state = {"params": tree.tree_map(lambda p, q: place(full(p), mesh, q),
                                         params, pl["params"]),
                 "opt": {"step": place(step, mesh, pl["opt"]["step"]),
                         "m": tree.tree_map(zeros, params, pl["opt"]["m"]),
                         "v": tree.tree_map(zeros, params, pl["opt"]["v"])}}
        if self.cfg.master_fp32:
            state["master"] = tree.tree_map(
                lambda p, q: place(full(p).to(torch.float32, copy=True),
                                   mesh, q), params, pl["master"])
        if self.cfg.grad_compression:
            state["err"] = tree.tree_map(zeros, params, pl["err"])
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
               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The loss and the grad of every leaf.  A leaf the loss does not
        use (an embedding-stub batch leaves ``embed`` unused) gets zeros,
        as ``jax.grad`` gives it: AdamW still decays it."""
        with torch.enable_grad():
            loss = self.model.loss(params, batch)
            if self.sharded:
                loss = loss.full_tensor()     # seeds the backward once
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def step(self, state: Tree, batch: Dict[str, Any]
             ) -> Tuple[Tree, Dict[str, torch.Tensor]]:
        """One training step, in place.  ``batch`` holds ``tokens`` (or
        an embedding-stub frontend's ``embeds`` [B, S, D]) and ``labels``
        [B, S] (tensors or numpy; DTensors under a plan, as ``BatchFeed``
        places them); whatever its keys, its leaves share the leading
        dim that the microbatches split.  Returns (state, {"loss",
        "gnorm"} as 0-d tensors: the full values under a plan).  Traced
        as the span ``train.step`` (host time: the launches, not the
        device's work)."""
        with _span("train.step"):
            if self.sharded:
                return self._step_planned(state, batch)
            return self._step_local(state, batch)

    def _step_local(self, state: Tree, batch: Dict[str, Any]
                    ) -> Tuple[Tree, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        batch = self._batch(batch)
        params = state["params"]
        flat = tree.flatten(params)
        leaves = [p for _, p in flat]
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        n = cfg.microbatches
        b = _batch_size(batch)
        if b % n:
            raise ValueError(f"batch {b} is not divisible by "
                             f"{n} microbatches")
        if n == 1:
            loss, g = self._grads(params, leaves, batch)
            # each grad into f32 as its compute-dtype copy is dropped, so
            # the two copies of the whole tree never coexist
            grads = [g.pop(0).float() for _ in range(len(g))]
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

    # -- the step under a plan -----------------------------------------------
    def _micro_batches(self, batch: Dict[str, Any], n: int
                       ) -> List[Dict[str, Any]]:
        """The batch cut into ``n`` microbatches as one card and repro cut
        it (microbatch i is the global rows i*B/n to (i+1)*B/n), each
        placed under the train batch placements.  An MoE model's routing,
        capacity and aux depend on which rows share a data shard, so this
        split is the one that gives repro's result for every family."""
        from torch.distributed.tensor import DTensor, Shard
        mesh, want = self.mesh, self.batch_placements()
        full = {k: v.full_tensor() if isinstance(v, DTensor)
                else torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}
        b = _batch_size(full)
        shards = math.prod(mesh.size(j) for j, p in
                           enumerate(want["labels"]) if isinstance(p, Shard))
        if b % n or (b // n) % shards:
            raise ValueError(f"batch {b} does not split into {n} "
                             f"microbatches that split evenly over {shards} "
                             "data shards")
        mb = b // n
        return [{k: place(v[i * mb:(i + 1) * mb], mesh, want[k])
                 for k, v in full.items()} for i in range(n)]

    def _reshard(self, grads: List, placements: List) -> List:
        """Each grad into its placements, in f32 (reducing the pending
        sum over the cut batch), bucket by bucket: a bucket's leaves are
        issued together and waited for together.  A grad already in its
        placements is returned as it is, in its own dtype."""
        mesh, out = self.mesh, list(grads)
        for idxs in bucket_slices([g.numel() * 4 for g in grads],
                                  self.cfg.buckets):
            moved = []
            for i in idxs:
                if tuple(out[i].placements) != tuple(placements[i]):
                    g = self._reduce_flat(out[i].float(), placements[i])
                    if tuple(g.placements) != tuple(placements[i]):
                        g = g.redistribute(mesh, placements[i],
                                           async_op=True)
                    out[i] = g
                    moved.append(i)
            for i in moved:
                g = out[i]
                lt = g.to_local()
                if hasattr(lt, "wait"):           # AsyncCollectiveTensor
                    lt = lt.wait()
                out[i] = like_placed(lt, g)
        return out

    def _reduce_flat(self, g, placements: List):
        """``g`` with its pending sums over the mesh dims (of more than one
        rank) that ``placements`` replicates reduced by one all-reduce
        over those dims' flattened group, where there are two or more of
        them; else ``g`` itself.  DTensor's redistribute runs one
        all-reduce a mesh dim: on a (4, 2) mesh 2 s x 3/4 + 2 s x 1/2 =
        2.5 s ring wire bytes for a grad of s bytes, where one all-reduce
        over the 8 ranks moves 2 s x 7/8 = 1.75 s.  The group is a plain
        process group (``_flat_group``), not a flattened ``DeviceMesh``:
        torch 2.13's redistribute would find one of those and use it for
        every later collective over those dims, so a step's collectives
        would depend on whether a grad sync had run before it."""
        from torch.distributed._functional_collectives import all_reduce
        from torch.distributed.tensor import Partial, Replicate
        mesh = self.mesh
        dims = tuple(j for j, (p, q) in enumerate(zip(g.placements,
                                                      placements))
                     if isinstance(p, Partial) and p.reduce_op == "sum"
                     and isinstance(q, Replicate) and mesh.size(j) > 1)
        if len(dims) < 2:
            return g
        if dims not in self._flat:
            self._flat[dims] = _flat_group(mesh, dims)
        lt = all_reduce(g.to_local(), "sum", self._flat[dims])
        mid = [Replicate() if j in dims else p
               for j, p in enumerate(g.placements)]
        return from_local(lt, mesh, mid, g.shape)

    def _to_grads(self, placements: List, i: int, q):
        """``compress_bucketed``'s ``on_wire`` under a plan: leaf i's int8
        values into the gradient's placements, the one reshard that
        carries int8."""
        if tuple(q.placements) == tuple(placements[i]):
            return q
        return q.redistribute(self.mesh, placements[i])

    def _step_planned(self, state: Tree, batch: Dict[str, Any]
                      ) -> Tuple[Tree, Dict[str, torch.Tensor]]:
        cfg, mesh = self.cfg, self.mesh
        pl = self.state_placements()
        params = state["params"]
        flat = tree.flatten(params)
        leaves = [p for _, p in flat]
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        n = cfg.microbatches
        parts = self._micro_batches(batch, n)
        grad_pl = tree.leaves(self.grad_placements())
        # the f32 accumulator's placements: the gradient's, or under
        # compression the residuals' (every sum reduced before the
        # quantizer; int8 then rides the reshard into the grads')
        acc_pl = tree.leaves(pl["err"]) if cfg.grad_compression else grad_pl
        if n == 1:
            loss, g = self._grads(params, leaves, parts[0])
            g = self._reshard(g, acc_pl)
            grads = [g.pop(0).float() for _ in range(len(g))]
        else:
            grads = [zeros_placed(p.shape, torch.float32, mesh, q,
                                  self.device)
                     for p, q in zip(leaves, acc_pl)]
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            for part in parts:
                li, g = self._grads(params, leaves, part)
                g = self._reshard(list(g), acc_pl)
                for a, gi in zip(grads, g):
                    a.to_local().add_(gi.to_local())   # into f32, local
                loss = loss + li
                del g
            for a in grads:
                a.to_local().div_(n)
            loss = loss / n
        gtree = tree.unflatten([(p, g) for (p, _), g in zip(flat, grads)])
        del grads
        if cfg.grad_compression:
            gtree, state["err"] = compress_bucketed(
                gtree, state["err"], cfg.buckets,
                on_wire=functools.partial(self._to_grads, grad_pl))
        ref = state["master"] if cfg.master_fp32 else params
        _, _, gnorm = apply_updates(ref, gtree, state["opt"], cfg.optim)
        if cfg.master_fp32:
            with torch.no_grad():
                for p, m in zip(leaves, tree.leaves(state["master"])):
                    # bf16 in the master's placements, then into the
                    # params': a gather there moves bf16, not f32
                    y = like_placed(m.to_local().to(p.dtype), m)
                    if tuple(y.placements) != tuple(p.placements):
                        y = y.redistribute(mesh, p.placements)
                    p.to_local().copy_(y.to_local())
        return state, {"loss": loss, "gnorm": gnorm}

    # -- checkpointing -----------------------------------------------------------
    def save(self, directory: str, step: int, state: Tree,
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Write the state (gathered whole under a plan; rank 0 writes,
        every rank returns once it is committed)."""
        with _span("train.ckpt_write", step=step):
            return ckpt.save(directory, step, state, extra=extra)

    def restore(self, directory: str, step: Optional[int] = None
                ) -> Optional[Tuple[Tree, Dict[str, Any], int]]:
        """The latest (or given) step's state on this engine's device, or
        None when the directory holds no checkpoint.  Under a plan each
        leaf is placed straight into this engine's placements, whatever
        mesh wrote it: the elastic restart (4x2 -> 2x4)."""
        if step is None:
            step = ckpt.latest_step(directory)
        if step is None:
            return None
        placer = None
        if self.sharded:
            flat = {tree.key(p): q
                    for p, q in tree.flatten(self.state_placements())}
            mesh = self.mesh

            def placer(key: str, t: torch.Tensor):
                return place(t, mesh, flat[key])
        state, extra = ckpt.restore(directory, step, self.state_like(),
                                    device=self.device, place=placer)
        return state, extra, step
