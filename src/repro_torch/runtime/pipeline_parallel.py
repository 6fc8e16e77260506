"""Plan-driven pipeline-parallel stage runner (counterpart of
``repro.runtime.pipeline_parallel``).

The solver's joint stage search (``core/solver.solve_pipeline``) picks
layer-range cuts and per-stage tilings; this module executes them: the
layer stack [L, ...] is split into S contiguous stages over the ``stage``
dim of a DeviceMesh, microbatches flow through the stages in GPipe's
(n_micro + S - 1)-step schedule, and params and activations sit under
the solved tilings of the *inner* mesh dims (``stage_tensor_spec`` maps a
``PipelineSolution``'s tiling onto placements over those dims).

Transport: point-to-point ``send`` / ``recv`` on the stage dim's process
group, inside one ``torch.autograd.Function`` (``_Schedule``) whose
backward runs the schedule in reverse, microbatch n_micro - 1 first on
every stage, as the transpose of repro's ``lax.scan`` does; the order of
every send and its receive is fixed by the code, not by the autograd
engine.  A hop carries only this rank's shard of the microbatch under
the solved boundary placement (``x_spec``), never the whole microbatch:
the bytes fall by the inner degree, counted per rank in ``hop_bytes``.
The last stage's outputs reach every rank (a broadcast over the stage
group, then a gather over the inner dims), as repro's ``psum`` over the
stage axis does; only one copy of their gradient flows back.  A stage
computes only the microbatches it holds: the bubble steps, which repro
fills with masked work, run nothing here.

``PipelineTrainer`` is the training-side runner.  With n_stages == 1 it
delegates to ``train/engine.TrainEngine`` (the layer stack wrapped as a
model, ``_StackModel``), so the flat path is the engine's trajectory bit
for bit.  With n_stages > 1 the loss is the mean of the per-microbatch
losses, the gradients come through the schedule's backward (each stage
its own, reduced over the inner dims where the batch is cut), and the
update is the engine's ``apply_updates`` on the staged params and
moments, placed per stage over the mesh as DTensors.

Params are nested dicts of tensors, each leaf with a leading [L] layer
axis (``split_stages`` makes it [S, L/S]); a layer function takes one
layer's view of that tree."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import tree
from ..models.common import local, resolve_device
from ..models.model import _unbind
from ..models.sharding import spec_placements
from ..obs.tracing import span as _span
from ..optim.adamw import AdamWConfig, apply_updates

Tree = Dict[str, Any]

# bytes this rank sent over stage boundaries since the last reset: the
# forward's activations and the backward's gradients of them
hop_bytes: Dict[str, int] = {"forward": 0, "backward": 0}


def reset_hop_bytes() -> None:
    for k in hop_bytes:
        hop_bytes[k] = 0


def split_stages(params_stacked: Tree, n_stages: int) -> Tree:
    """[L, ...] layer stack -> [S, L/S, ...] staged stack."""
    def r(a):
        if a.shape[0] % n_stages:
            raise ValueError(f"{a.shape[0]} layers do not split into "
                             f"{n_stages} stages")
        return a.reshape(n_stages, a.shape[0] // n_stages, *a.shape[1:])
    return tree.tree_map(r, params_stacked)


def make_stage_fn(layer_fn: Callable[[Tree, torch.Tensor], torch.Tensor]
                  ) -> Callable[[Tree, torch.Tensor], torch.Tensor]:
    """A stage: its L/S layers in turn."""
    def stage(params_stage: Tree, x: torch.Tensor) -> torch.Tensor:
        for p in _unbind(params_stage):
            x = layer_fn(p, x)
        return x
    return stage


def stage_tensor_spec(psol, tensor: str, dims: Sequence[Optional[str]],
                      inner_names: Optional[Sequence[str]] = None) -> List:
    """Placements over the inner mesh dims ``inner_names`` (default: the
    solution's inner axes, slowest first) of a tensor whose physical dims
    carry the graph dim names ``dims`` (None for a dim the graph does not
    know, e.g. the stacked-layer axis): ``Shard(i)`` on each inner dim
    that the solved tiling cuts along ``dims[i]``.  As in repro, the
    tiling of the first solved stage holding the tensor is taken
    (homogeneous stacks solve every stage alike)."""
    from ..core.tiling import Part

    entries: List[List[str]] = [[] for _ in dims]
    for st in psol.stages:
        if tensor not in st.graph.tensors:
            continue
        for ax, assign in zip(psol.inner_axes, st.per_axis):
            t = assign.get(tensor)
            if isinstance(t, Part) and t.dim in dims:
                i = list(dims).index(t.dim)
                if ax.name not in entries[i]:
                    entries[i].append(ax.name)
        break
    spec = tuple(tuple(e) if len(e) > 1 else (e[0] if e else None)
                 for e in entries)
    if inner_names is None:
        inner_names = [ax.name for ax in psol.inner_axes]
    return spec_placements(spec, inner_names)


# -- the schedule --------------------------------------------------------------

@dataclasses.dataclass
class _Ring:
    """This rank's place in the stage dim: its stage, the stage count,
    the stage group and the global ranks of its neighbours and of the
    last stage (all at this rank's inner coordinates)."""
    idx: int
    n: int
    group: Any
    prev: Optional[int]
    next: Optional[int]
    last: int

    @classmethod
    def of(cls, mesh, stage_axis: str) -> "_Ring":
        names = list(mesh.mesh_dim_names)
        d = names.index(stage_axis)
        coord = list(mesh.get_coordinate())
        ranks = mesh.mesh

        def at(i):
            c = list(coord)
            c[d] = i
            return int(ranks[tuple(c)])
        idx, n = coord[d], mesh.size(d)
        return cls(idx, n, mesh.get_group(stage_axis),
                   at(idx - 1) if idx > 0 else None,
                   at(idx + 1) if idx < n - 1 else None, at(n - 1))


def _send(t: torch.Tensor, dst: int, group, kind: str) -> None:
    t = t.contiguous()
    dist.send(t, dst, group=group)
    hop_bytes[kind] += t.numel() * t.element_size()


def _recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    buf = torch.empty_like(like, memory_format=torch.contiguous_format)
    dist.recv(buf, src, group=group)
    return buf


class _Schedule(torch.autograd.Function):
    """GPipe over the stage group.  Forward: at step t stage i runs
    microbatch t - i (received from stage i - 1, or this rank's shard of
    ``xm`` on stage 0) and sends its output to stage i + 1; the last
    stage's outputs are broadcast over the group.  Backward: microbatch
    n_micro - 1 first, each stage receives its output's gradient from
    stage i + 1 (the last stage takes its own), runs its recorded graph
    back, adds the param grads and sends its input's gradient to stage
    i - 1.  Inputs: (ring, stage_fn, paths, xm [n_micro, mb, ...], *this
    stage's param leaves); the gradient of ``xm`` is not formed."""

    @staticmethod
    def forward(ctx, ring: _Ring, stage_fn, paths, xm, *leaves):
        n_micro = xm.shape[0]
        ps = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        params = tree.unflatten(list(zip(paths, ps)))
        ins: List[Optional[torch.Tensor]] = [None] * n_micro
        outs: List[Optional[torch.Tensor]] = [None] * n_micro
        with torch.enable_grad():
            for t in range(n_micro + ring.n - 1):
                m = t - ring.idx
                if not 0 <= m < n_micro:
                    continue                      # a bubble step
                if ring.idx == 0:
                    inp = xm[m].detach()
                else:
                    inp = _recv(xm[m], ring.prev, ring.group)
                    inp.requires_grad_(True)
                out = stage_fn(params, inp)
                if out.shape != inp.shape or out.dtype != inp.dtype:
                    raise ValueError(
                        f"a stage maps {tuple(inp.shape)} {inp.dtype} to "
                        f"{tuple(out.shape)} {out.dtype}: the stages of a "
                        "pipeline keep their input's shape and dtype")
                if ring.next is not None:
                    _send(out.detach(), ring.next, ring.group, "forward")
                ins[m], outs[m] = inp, out
        if ring.next is None:
            result = torch.stack([o.detach() for o in outs])
        else:
            result = torch.empty_like(xm)
        dist.broadcast(result, ring.last, group=ring.group)
        ctx.ring, ctx.ins, ctx.outs, ctx.params = ring, ins, outs, ps
        return result

    @staticmethod
    def backward(ctx, g_result):
        ring, ins, outs, ps = ctx.ring, ctx.ins, ctx.outs, ctx.params
        want = [p for p in ps if p.requires_grad]
        acc: List[Optional[torch.Tensor]] = [None] * len(want)
        for m in reversed(range(len(outs))):
            if ring.next is None:
                g = (torch.zeros_like(outs[m]) if g_result is None
                     else g_result[m])
            else:
                g = _recv(outs[m], ring.next, ring.group)
            first = [ins[m]] if ring.prev is not None else []
            gs = torch.autograd.grad(outs[m], first + want, g,
                                     allow_unused=True)
            if ring.prev is not None:
                gin = gs[0] if gs[0] is not None else torch.zeros_like(g)
                _send(gin, ring.prev, ring.group, "backward")
            for i, gi in enumerate(gs[len(first):]):
                if gi is not None:
                    acc[i] = gi if acc[i] is None else acc[i] + gi
        it = iter(acc)
        grads = [next(it) if p.requires_grad else None for p in ps]
        ctx.ins = ctx.outs = ctx.params = None
        return (None, None, None, None, *grads)


def _inner(mesh, stage_axis: str) -> List[str]:
    return [n for n in mesh.mesh_dim_names if n != stage_axis]


def _shifted(placements: Sequence) -> List:
    """Placements of one microbatch [mb, ...] as placements of the
    stacked microbatches [n_micro, mb, ...]."""
    from torch.distributed.tensor import Shard
    return [Shard(p.dim + 1) if isinstance(p, Shard) else p
            for p in placements]


def _local_rows(t: torch.Tensor, mesh, names: Sequence[str],
                placements: Sequence) -> torch.Tensor:
    """This rank's shard of ``t`` (the same full tensor on every rank)
    under ``placements`` over the mesh dims ``names``, cut in mesh
    order, the first dim major, as DTensor cuts."""
    from torch.distributed.tensor import Shard
    for name, p in zip(names, placements):
        if isinstance(p, Shard):
            n = mesh.size(list(mesh.mesh_dim_names).index(name))
            if t.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not "
                                 f"split over {name}'s {n} ranks")
            t = t.chunk(n, p.dim)[mesh.get_local_rank(name)]
    return t


def _grad_placements(p, x_pl: Sequence, names: Sequence[str]) -> List:
    """The placements of a staged param's local gradient: where the
    batch is cut on an inner dim that replicates the param, each rank
    holds its rows' share, a pending sum."""
    from torch.distributed.tensor import Partial, Replicate
    cut = {n for n, q in zip(names, x_pl) if not isinstance(q, Replicate)}
    return [Partial() if isinstance(q, Replicate) and n in cut else q
            for n, q in zip(p.device_mesh.mesh_dim_names, p.placements)]


def pipeline_forward(mesh, stage_axis: str,
                     stage_fn: Callable[[Tree, torch.Tensor], torch.Tensor],
                     params_staged: Tree, x: torch.Tensor, n_micro: int,
                     x_spec: Optional[Sequence] = None) -> torch.Tensor:
    """Run ``stage_fn`` S times (once per stage) over microbatched ``x``.

    params_staged: leaves with a leading [S] axis (one slice a stage): plain
    tensors when S == 1, DTensors over ``mesh`` when S > 1, cut on the
    stage dim (``PipelineTrainer.place``; a cut on an inner dim hands the
    stage function its local block, as repro's ``params_spec`` does).
    x: [B, ...], the same on every rank; B % n_micro == 0.
    x_spec: placements of one microbatch [mb, ...] over the mesh's inner
    (non-stage) dims, in mesh order: the solved boundary tiling.  None
    replicates it (every hop ships the whole microbatch).
    Returns the last stage's outputs, [B, ...], whole on every rank."""
    s = (mesh.size(list(mesh.mesh_dim_names).index(stage_axis))
         if mesh is not None and stage_axis in mesh.mesh_dim_names else 1)
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} is not divisible by {n_micro} "
                         "microbatches")
    mb = b // n_micro
    xm = x.reshape(n_micro, mb, *x.shape[1:])
    if s == 1:
        # the flat path: no schedule, no transfer
        params = tree.tree_map(lambda a: local(a)[0], params_staged)
        return torch.cat([stage_fn(params, xm[i]) for i in range(n_micro)])
    from torch.distributed.tensor import DTensor, Replicate
    names = _inner(mesh, stage_axis)
    x_pl = list(x_spec) if x_spec is not None else [Replicate()] * len(names)
    if len(x_pl) != len(names):
        raise ValueError(f"x_spec has {len(x_pl)} placements for the inner "
                         f"dims {names}")
    flat = tree.flatten(params_staged)
    leaves = []
    for path, p in flat:
        if not isinstance(p, DTensor):
            raise TypeError(f"{'/'.join(path)}: S > 1 takes the staged "
                            "params as DTensors over the mesh "
                            "(PipelineTrainer.place)")
        leaves.append(p.to_local(
            grad_placements=_grad_placements(p, x_pl, names))[0])
    ring = _Ring.of(mesh, stage_axis)
    xm_pl = _shifted(x_pl)
    xm_local = _local_rows(xm, mesh, names, xm_pl)
    out = _Schedule.apply(ring, stage_fn, [p for p, _ in flat], xm_local,
                          *leaves)
    if any(not isinstance(q, Replicate) for q in xm_pl):
        out = DTensor.from_local(out, mesh[tuple(names)], xm_pl,
                                 run_check=False).full_tensor()
    return out.reshape(b, *out.shape[2:])


# -- training ----------------------------------------------------------------

class _StackModel:
    """A homogeneous layer stack presented as the model the port's
    ``TrainEngine`` drives (``param_shapes`` / ``init`` / ``loss``, no
    plan): the S == 1 delegation.  Its batch is {"x", "y"}."""

    plan = None
    mesh = None

    def __init__(self, layer_fn, loss_fn, params_stacked: Tree):
        self._layer_fn = layer_fn
        self._loss_fn = loss_fn
        self._params = params_stacked

    def param_shapes(self) -> Tree:
        return tree.tree_map(lambda p: (tuple(p.shape), p.dtype),
                             self._params)

    def init(self, seed: int = 0, device="cuda") -> Tree:
        """Copies of the stack on ``device`` (the engine updates its state
        in place; the caller's stack must survive).  ``seed`` is unused."""
        del seed
        dev = resolve_device(device)
        return tree.tree_map(
            lambda p: p.detach().to(dev, copy=True), self._params)

    def loss(self, params: Tree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        h = batch["x"]
        for p in _unbind(params):
            h = self._layer_fn(p, h)
        return self._loss_fn(h, batch["y"])


class PipelineTrainer:
    """Training runner for a solved pipeline over a homogeneous stack.

    n_stages == 1: wraps the stack in ``_StackModel`` and runs the port's
    ``TrainEngine`` (microbatch accumulation, AdamW ``apply_updates``), so
    the flat trajectory is the engine's by construction.  n_stages > 1:
    the loss is the mean of the per-microbatch losses through
    ``pipeline_forward``, the grads come through the schedule, and the
    update is the engine's ``apply_updates`` on the staged params and
    moments, placed per stage over ``mesh`` (``place``) and replicated
    over its inner dims, as repro's runner places them by default.

    ``x_spec``: placements over the inner mesh dims of one microbatch (the
    solved boundary tiling, ``stage_tensor_spec``); None replicates.
    ``y`` is given whole on every rank, as ``x`` is."""

    def __init__(self, layer_fn, loss_fn, *, n_stages: int, n_micro: int,
                 mesh=None, stage_axis: str = "stage",
                 optim: Optional[AdamWConfig] = None,
                 x_spec: Optional[Sequence] = None, device="cuda"):
        self.layer_fn = layer_fn
        self.loss_fn = loss_fn
        self.n_stages = n_stages
        self.n_micro = n_micro
        self.mesh = mesh
        self.stage_axis = stage_axis
        self.optim = optim or AdamWConfig()
        self.x_spec = x_spec
        self.device = resolve_device(device)
        self._engine = None
        if n_stages > 1:
            if mesh is None or stage_axis not in mesh.mesh_dim_names:
                raise ValueError(f"{n_stages} stages need a mesh with a "
                                 f"{stage_axis!r} dim")
            have = mesh.size(list(mesh.mesh_dim_names).index(stage_axis))
            if have != n_stages:
                raise ValueError(f"the mesh's {stage_axis!r} dim has {have} "
                                 f"ranks, not {n_stages}")

    # -- S == 1: the engine is the trainer -------------------------------
    def _make_engine(self, params_stacked: Tree):
        from ..train.engine import EngineConfig, TrainEngine
        model = _StackModel(self.layer_fn, self.loss_fn, params_stacked)
        cfg = EngineConfig(microbatches=self.n_micro, master_fp32=False,
                           optim=self.optim)
        return TrainEngine(model, cfg, device=self.device)

    # -- state -------------------------------------------------------------
    def place(self, staged: Tree, dtype=None) -> Tree:
        """[S, L/S, ...] leaves (the same on every rank) as DTensors over
        the mesh: cut on the stage dim, each rank holding its stage's
        slice, replicated over the inner dims."""
        from torch.distributed.tensor import Replicate, Shard

        from ..models.sharding import place
        pl = [Shard(0) if n == self.stage_axis else Replicate()
              for n in self.mesh.mesh_dim_names]
        return tree.tree_map(
            lambda p: place(p.detach().to(self.device, dtype or p.dtype,
                                          copy=True), self.mesh, pl),
            staged)

    def init(self, params_stacked: Tree) -> Tree:
        """The state for ``params_stacked`` ([L, ...] leaves): the engine's
        state when S == 1, else {"params", "opt": {"step", "m", "v"}}
        placed per stage (moments in f32)."""
        if self.n_stages == 1:
            self._engine = self._make_engine(params_stacked)
            return self._engine.init_state(0)
        staged = split_stages(params_stacked, self.n_stages)
        params = self.place(staged)
        zeros = self.place(tree.tree_map(torch.zeros_like, staged),
                           torch.float32)
        return {"params": params,
                "opt": {"step": torch.zeros((), dtype=torch.int32,
                                            device=self.device),
                        "m": zeros,
                        "v": tree.tree_map(lambda z: z.clone(), zeros)}}

    # -- the step ------------------------------------------------------------
    def _pipe_loss(self, params: Tree, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
        out = pipeline_forward(self.mesh, self.stage_axis,
                               make_stage_fn(self.layer_fn), params, x,
                               self.n_micro, x_spec=self.x_spec)
        mb = x.shape[0] // self.n_micro
        return torch.stack([
            self.loss_fn(out[i * mb:(i + 1) * mb], y[i * mb:(i + 1) * mb])
            for i in range(self.n_micro)]).mean()

    def step(self, state: Tree, x, y):
        """One step, in place -> (state, {"loss", "gnorm"} as 0-d
        tensors)."""
        if self.n_stages == 1:
            if self._engine is None:
                raise RuntimeError("call init() first")
            return self._engine.step(state, {"x": x, "y": y})
        x = torch.as_tensor(x, device=self.device)
        y = torch.as_tensor(y, device=self.device)
        with _span("train.pipeline_step", n_stages=self.n_stages):
            params = state["params"]
            leaves = tree.leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            with torch.enable_grad():
                loss = self._pipe_loss(params, x, y)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            # each grad whole over the inner dims that cut the batch, in
            # f32, in its param's placements
            gs = []
            for p, g in zip(leaves, grads):
                if g is None:
                    g = torch.zeros_like(p)
                g = g.float()
                if tuple(g.placements) != tuple(p.placements):
                    g = g.redistribute(p.device_mesh, p.placements)
                gs.append(g)
            gtree = tree.unflatten([(path, g) for (path, _), g
                                    in zip(tree.flatten(params), gs)])
            _, _, gnorm = apply_updates(params, gtree, state["opt"],
                                        self.optim)
        return state, {"loss": loss.detach(), "gnorm": gnorm}
