"""Per-device cost of one step, traced on ``meta`` tensors (the port's
stand-in for XLA's ``cost_analysis`` and ``memory_analysis`` of repro's
compiled dry-run step).

The step is the one repro's ``launch/compile.compile_step`` builds for
the cell's kind, run through the port's own entry points: ``decode``
the model's ``decode_step`` on its cache, ``prefill`` its ``forward`` on
the batch, ``train`` the engine's step (loss, backward, AdamW).  Params,
optimizer state, cache and batch are DTensors on the given mesh under
the plan, built with ``DTensor.from_local`` on meta shards of the local
shape and the global ``shape`` (``models/sharding.zeros_placed``), so
nothing is allocated; on a fake process group (``launch/mesh.
make_production_mesh``) no rank runs either.

One ``TorchDispatchMode`` counts, per device:

- FLOPs of the *local* ops.  The mode declines every op that has a
  DTensor among its types (as ``CommDebugMode`` does), so DTensor runs
  its own dispatch and the mode sees the ops on the local shards (and
  skips those DTensor runs on fake tensors of the global shapes to
  propagate shardings): a
  product cut over 256 cards counts its shard's 2 m n k, and work
  repeated on replicated shards counts in full on every card, as XLA's
  per-device partitioned module counts it.  Products (mm, bmm, addmm,
  baddbmm, convolution, SDPA) by torch's flop registry
  (``torch.utils.flop_counter``); a pointwise op one FLOP per output
  element, a reduction one per input element (XLA's rule).  Attention
  on a meta tensor takes the plain math of ``kernels/ref.py``
  (``kernels/ops._route``), which materialises the whole score matrix:
  repro's dry run lowers attention as plain XLA and counts it the same
  way.
- HBM bytes: operand plus result bytes of every op that is not a view
  (XLA's "bytes accessed", which ignores fusion).
- Collectives: ``analysis/comm.py``'s rules (kind, per-device result
  bytes, group size), each also with the mesh dims its group spans, for
  the per-axis pricing of ``analysis/roofline``.
- Peak bytes: the state's local bytes (params, optimizer state, cache,
  batch) plus the most that the step's own tensors held at once.  Each
  non-view result's storage is counted once from its creation until the
  last tensor on it is freed (weak-reference finalizers): activations saved for the backward
  live until the backward frees them.  Limits: the allocator's rounding
  and fragmentation, workspace of library calls and the CUDA kernels'
  own footprint are not seen (the plain attention holds a score matrix
  the flash kernels never write), and in-place updates are taken as
  made in place.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

from . import comm

Tree = Dict[str, Any]


@dataclasses.dataclass
class StepCost:
    """One step's per-device cost (see the module docstring)."""
    flops: float
    matmul_flops: float
    hbm_bytes: float
    collectives: comm.CollectiveStats
    ops: List[Tuple[str, float, int]]            # each collective (comm's)
    wire_by_axes: Dict[Tuple[str, ...], float]   # ring wire bytes by group
    peak_bytes: float
    state_bytes: float
    n_ops: int
    trace_s: float


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return [x] if isinstance(x, torch.Tensor) else []


# ops that hand back their input under another tensor object (on a
# device; on meta they make a new storage): neither bytes nor memory
_REWRAPS = {"_c10d_functional._wrap_tensor_autograd",
            "_c10d_functional.wait_tensor"}


class CostMode(TorchDispatchMode):
    """Counts the local ops' FLOPs and bytes, notes the collectives and
    tallies live bytes.  ``group_axes`` maps a process group's name to
    the mesh dims it spans (a group it does not know spans them all)."""

    def __init__(self, group_axes: Optional[Dict[str, Tuple[str, ...]]] = None,
                 all_axes: Tuple[str, ...] = ()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self._note = comm.collective_note()
        self.group_axes = group_axes or {}
        self.all_axes = all_axes
        self.flops = 0.0
        self.matmul_flops = 0.0
        self.hbm_bytes = 0.0
        self.n_ops = 0
        self.ops: List[Tuple[str, float, int]] = []
        self.op_axes: List[Tuple[str, ...]] = []
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, List[int]] = {}   # key -> [bytes, refs]

    def _drop(self, key: int) -> None:
        entry = self._storages[key]
        entry[1] -= 1
        if not entry[1]:
            self.live -= entry[0]
            del self._storages[key]

    def _hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage while any tensor on it is alive (an op
        may return a new tensor on an input's storage unannounced)."""
        st = t.untyped_storage()
        key = st._cdata
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [st.nbytes(), 0]
            self.live += entry[0]
        entry[1] += 1
        weakref.finalize(t, self._drop, key)

    def _axes(self, args) -> Tuple[str, ...]:
        for a in args:
            if isinstance(a, str) and a in self.group_axes:
                return self.group_axes[a]
            name = getattr(a, "group_name", None)
            if name in self.group_axes:
                return self.group_axes[name]
        return self.all_axes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out          # DTensor's sharding propagation, on fakes
        self.n_ops += 1
        n = len(self.ops)
        self._note(self.ops, func, args)
        if len(self.ops) > n:
            self.op_axes.append(self._axes(args))
        schema = func._schema
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in schema.returns)
        if view or str(func._overloadpacket) in _REWRAPS:
            return out
        self.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
        packet = func._overloadpacket
        rule = self._flop_registry.get(packet)
        if rule is not None:
            f = float(rule(*args, **kwargs, out_val=out))
            self.flops += f
            self.matmul_flops += f
        elif torch.Tag.pointwise in func.tags:
            self.flops += float(sum(t.numel() for t in outs))
        elif torch.Tag.reduction in func.tags:
            self.flops += float(sum(t.numel() for t in ins))
        written = any(r.alias_info is not None for r in schema.returns)
        if not written:
            for t in outs:
                self._hold(t)
            self.peak = max(self.peak, self.live)
        return out


def _group_axes(mesh) -> Dict[str, Tuple[str, ...]]:
    """Process-group name -> the mesh dims it spans, for every single dim
    of ``mesh`` and the default (whole-world) group."""
    import torch.distributed as dist
    names = tuple(mesh.mesh_dim_names)
    out = {mesh.get_group(n).group_name: (n,) for n in names}
    out[dist.group.WORLD.group_name] = names
    return out


def _local_bytes(tree) -> float:
    from torch.distributed.tensor import DTensor
    total = 0.0
    for t in _tensors(tree):
        total += _nbytes(t.to_local() if isinstance(t, DTensor) else t)
    return total


def _placed(like: Tree, placements: Tree, mesh) -> Tree:
    """A tree of meta DTensors shaped and typed as ``like`` (meta
    tensors), under ``placements``: each a meta shard of its local
    shape."""
    from ..models.sharding import zeros_placed
    return {k: _placed(v, placements[k], mesh) if isinstance(v, dict)
            else zeros_placed(v.shape, v.dtype, mesh, placements[k], "meta")
            for k, v in like.items()}


def build_step(cfg, shape, plan, mesh, microbatches: int = 1,
               device="meta"):
    """(step, state, inputs): the cell's step as a function of (state,
    inputs), with its state and inputs as meta DTensors under ``plan`` on
    ``mesh`` (``plan`` None: plain meta tensors, one device).  With a
    real ``device`` (``verify/calibration`` runs the step): the params
    and optimizer state from ``init(0)``, the cache and the inputs zeros,
    on that device, placed the same way."""
    from ..launch.compile import input_specs, normalize_moe_plan
    from ..models.model import LM
    from ..models.sharding import (CACHE_RULES, batch_placements,
                                   place_tree, tree_placements, zeros_placed,
                                   zeros_tree)
    real = torch.device(device).type != "meta"
    ins = input_specs(cfg, shape)
    if real:
        ins = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
               for k, v in ins.items()}
    if shape.kind == "train":
        from ..runtime.train_loop import TrainConfig, make_engine
        eng = make_engine(LM(cfg), TrainConfig(microbatches=microbatches),
                          device=device, mesh=mesh, plan=plan)
        if real:
            state = eng.init_state(0)
        elif plan is None:
            state = eng.state_like()
        else:
            state = _placed(eng.state_like(), eng.state_placements(), mesh)
        if plan is None:
            batch = ins
        else:
            bp = eng.batch_placements()
            batch = {k: zeros_placed(v.shape, v.dtype, mesh, bp[k], device)
                     for k, v in ins.items()}

        def train_step(state, batch):
            _, m = eng.step(state, batch)
            return m["loss"]
        return train_step, state, batch
    if plan is not None:
        plan = normalize_moe_plan(plan, cfg)
    model = LM(cfg, plan=plan, mesh=mesh if plan is not None else None)

    def meta_tree(shapes):
        return {k: meta_tree(v) if isinstance(v, dict)
                else torch.empty(v[0], dtype=v[1], device="meta")
                for k, v in shapes.items()}
    names = None if plan is None else mesh.mesh_dim_names
    if real:
        params = model.init(0, device=device)
        if plan is not None:
            params = place_tree(params, mesh, plan)
    else:
        like = meta_tree(model.param_shapes())
        params = like if plan is None else _placed(
            like, tree_placements(plan, like, names), mesh)
    if shape.kind == "decode":
        cshapes = model.cache_shapes(shape.global_batch, shape.seq_len)
        if real:
            cache = (model.init_cache(shape.global_batch, shape.seq_len,
                                      device=device) if plan is None else
                     zeros_tree(cshapes, mesh, plan, CACHE_RULES, device))
        else:
            clike = meta_tree(cshapes)
            cache = clike if plan is None else _placed(
                clike, tree_placements(plan, clike, names, CACHE_RULES),
                mesh)

        def decode_step(state, inputs):
            logits, _ = model.decode_step(state["params"], state["cache"],
                                          inputs["tokens"])
            return logits
        return decode_step, {"params": params, "cache": cache}, ins
    if plan is not None:
        bp = batch_placements(plan, names, "prefill")
        ins = {k: zeros_placed(v.shape, v.dtype, mesh, bp, device)
               for k, v in ins.items()}

    def prefill_step(state, inputs):
        with torch.no_grad():
            return model.forward(state["params"], inputs.get("tokens"),
                                 inputs.get("embeds"))
    return prefill_step, {"params": params}, ins


def trace_step(cfg, shape, plan, mesh, microbatches: int = 1) -> StepCost:
    """Trace the cell's step once on meta tensors and return its
    per-device cost (module docstring).  ``mesh``: a ``DeviceMesh`` (a
    fake group's for the production meshes), or None with ``plan`` None
    for one device."""
    step, state, inputs = build_step(cfg, shape, plan, mesh, microbatches)
    state_bytes = _local_bytes(state) + _local_bytes(inputs)
    axes = () if mesh is None else tuple(mesh.mesh_dim_names)
    mode = CostMode(_group_axes(mesh) if mesh is not None else {}, axes)
    t0 = time.perf_counter()
    with mode:
        out = step(state, inputs)
    del out
    trace_s = time.perf_counter() - t0
    stats = comm.collect(mode.ops)
    wire: Dict[Tuple[str, ...], float] = {}
    for (kind, s, g), ax in zip(mode.ops, mode.op_axes):
        wire[ax] = wire.get(ax, 0.0) + comm.ring_wire_bytes(kind, s, g)
    return StepCost(flops=mode.flops, matmul_flops=mode.matmul_flops,
                    hbm_bytes=mode.hbm_bytes, collectives=stats,
                    ops=list(mode.ops), wire_by_axes=wire, peak_bytes=state_bytes + mode.peak,
                    state_bytes=state_bytes, n_ops=mode.n_ops,
                    trace_s=trace_s)
