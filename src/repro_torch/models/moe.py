"""Mixture-of-Experts layer with capacity-based scatter/gather routing
(counterpart of ``repro.models.moe``: ``_capacity``, ``moe_ffn``,
``_moe_local`` and ``moe_ffn_sharded``).

Routing is repro's, op for op: an f32 router product, softmax, top-k
gates renormalised, the Switch-style load-balancing aux, each
(token, choice) ranked within its expert by a stable sort of the flat
expert ids (so the drop priority is the flat token order), a capacity
``_capacity(tokens)`` per expert, kept choices scattered into an
[E * cap + 1, d] buffer whose last row takes every dropped one and is
discarded, the experts' products batched over E (``torch.bmm``), and the
combine a gather weighted by the gates.  Repro computes all of it
outside any Pallas kernel, so it is plain tensor code here too.

Under a sharding plan there are two routes, as in repro:

- training (``moe_ffn_sharded``, repro's ``shard_map`` one): one
  ``local_map`` region on each rank's tokens (the batch and seq cuts of
  the activations), routing and capacity on the local tokens, the aux a
  mean over every rank.  Where the experts' weights are cut on
  ``expert`` (expert parallelism: ``launch/compile.normalize_moe_plan``)
  the dispatch buffer goes through an all-to-all over each cutting mesh
  axis and back (``all_to_all_single_autograd``, counted in
  ``ops.all_to_all``).  The gradients follow ``shard_map``'s transpose:
  the output's cotangent is divided by the size of the mesh dims that do
  not cut the tokens, and the inputs' gradients are pending sums over
  them;
- serving (``moe_ffn_placed``; repro passes no mesh there and runs the
  global formula): the tokens are gathered whole, routed on every rank
  with the capacity of the whole call, each rank runs its own experts'
  rows of the buffer, and the experts' outputs are gathered over the
  expert cut before the combine, so the result is the one-process one.

Weights cut on anything but ``expert`` are refused by ``check_plan``
(``LM`` calls it); weights placed that way all the same are gathered and
counted in ``ops.plan_fallbacks["moe"]``."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops as kops

Params = Dict[str, torch.Tensor]
EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def moe_shapes(cfg: ArchConfig, dtype: torch.dtype) -> Dict[str, tuple]:
    """(shape, dtype) of one layer's MoE params (repro's ``init_moe``):
    the router [d, E] in f32, ``w_gate`` / ``w_up`` [E, d, f] and
    ``w_down`` [E, f, d] in ``dtype``."""
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
    return {"router": ((d, e), torch.float32), "w_gate": ((e, d, f), dtype),
            "w_up": ((e, d, f), dtype), "w_down": ((e, f, d), dtype)}


def _capacity(tokens: int, cfg: ArchConfig) -> int:
    m = cfg.moe
    c = int(tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, min(c, tokens))


def check_plan(plan) -> None:
    """Refuse a plan whose MoE roles cut anything but ``expert`` (the
    router role ``moe_gate`` nothing): the layer routes on whole rows and
    runs whole experts (``launch/compile.normalize_moe_plan`` gives the
    canonical layout)."""
    if plan is None:
        return
    for role, allowed in (("moe_gate", ()), ("moe_up", ("expert",)),
                          ("moe_down", ("expert",))):
        bad = {a: d for a, d in plan.role_cuts.get(role, {}).items()
               if d is not None and d not in allowed}
        if bad:
            raise ValueError(
                f"the MoE layer cannot run role {role} cut as {bad}: only "
                "the expert dim of the experts' weights may be cut "
                "(launch.compile.normalize_moe_plan)")


def route(xf: torch.Tensor, router: torch.Tensor, cfg: ArchConfig,
          cap: int):
    """Routing of the tokens ``xf`` [T, d] (repro's, op for op): returns
    (gate [T, K] f32, keep [T * K] bool, dest [T * K] int64 rows of the
    [E * cap + 1, d] buffer, the last one the overflow row, aux 0-d f32)."""
    m = cfg.moe
    t = xf.shape[0]
    e, k = m.n_experts, m.top_k
    probs = torch.softmax(xf.float() @ router, -1)          # [T, E]
    gate, eid = torch.topk(probs, k, dim=-1)                # [T, K]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(0)
    flat_e = eid.reshape(-1)                                # [T * K]
    # choices per expert, bincount's counts with a shape that does not
    # depend on the data (a meta trace has no bincount)
    counts = torch.zeros(e, dtype=torch.int64, device=xf.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    ce = counts.float() / (t * k)
    aux = e * torch.sum(me * ce)
    order = torch.argsort(flat_e, stable=True)              # by expert
    sorted_e = flat_e[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(e, device=xf.device))        # [E], left
    ranks_sorted = torch.arange(t * k, device=xf.device) - starts[sorted_e]
    rank = torch.empty_like(ranks_sorted)
    rank[order] = ranks_sorted
    keep = rank < cap
    dest = torch.where(keep, flat_e * cap + rank,
                       torch.full_like(flat_e, e * cap))
    return gate, keep, dest, aux


def dispatch(xf: torch.Tensor, dest: torch.Tensor, e: int, k: int,
             cap: int) -> torch.Tensor:
    """The tokens, each repeated K times, into [E, cap, d]: every kept
    choice into its row (distinct rows), the dropped ones all into the
    overflow row E * cap, which is cut off (any of them may land there
    last: it is never read)."""
    d = xf.shape[-1]
    buf = xf.new_zeros((e * cap + 1, d)).index_copy(
        0, dest, xf.repeat_interleave(k, dim=0))
    return buf[:e * cap].view(e, cap, d)


def experts(xe: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
            wd: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on their rows: xe [E, C, d] -> [E, C, d] (the
    gate's silu in f32, as repro)."""
    h = torch.bmm(xe, wg)
    hh = F.silu(h.float()).to(xe.dtype) * torch.bmm(xe, wu)
    return torch.bmm(hh, wd)


def combine(ye: torch.Tensor, gate: torch.Tensor, keep: torch.Tensor,
            dest: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's K rows of ``ye`` [E, cap, d] weighted by its gates
    (a dropped choice reads the zero overflow row and weighs 0), summed
    over K -> [T, d]."""
    e, cap, d = ye.shape
    dt = ye.dtype
    yb = torch.cat([ye.reshape(e * cap, d), ye.new_zeros((1, d))], 0)
    yk = yb[dest] * (gate.reshape(-1, 1).to(dt) * keep[:, None].to(dt))
    return yk.view(-1, k, d).sum(1)


def moe_ffn(params: Params, x: torch.Tensor, cfg: ArchConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux): the global formula, the capacity
    that of all B * S tokens (repro's ``moe_ffn`` without a mesh)."""
    return _moe_local(params, x, cfg, ())


def _moe_local(params: Params, x: torch.Tensor, cfg: ArchConfig,
               ep: Sequence[Tuple[object, int]]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """repro's ``_moe_local``: routing and capacity on the tokens of
    ``x``; ``ep`` lists (process group, size) of each mesh axis that cuts
    the experts, the buffer exchanged over each in turn (and back in
    reverse order), ``params``' experts then this rank's own."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    cap = _capacity(b * s, cfg)
    xf = x.reshape(b * s, d)
    gate, keep, dest, aux = route(xf, params["router"], cfg, cap)
    xe = dispatch(xf, dest, e, k, cap)
    for group, n in ep:
        xe = _to_experts(xe, group, n)
    ye = experts(xe, params["w_gate"], params["w_up"], params["w_down"])
    for group, n in reversed(ep):
        ye = _from_experts(ye, group, n)
    y = combine(ye, gate, keep, dest, k)
    return y.view(b, s, d), aux


def _to_experts(xe: torch.Tensor, group, n: int) -> torch.Tensor:
    """``lax.all_to_all(xe, split_axis=0, concat_axis=1, tiled=True)``:
    [E', C, d] -> [E' / n, n * C, d], peer p's rows of my experts at
    columns p * C onwards."""
    from torch.distributed._functional_collectives import \
        all_to_all_single_autograd
    e, c, d = xe.shape
    kops.all_to_all["moe_dispatch"] += 1
    out = all_to_all_single_autograd(xe.contiguous(), None, None, group)
    return out.view(n, e // n, c, d).transpose(0, 1).reshape(e // n, n * c, d)


def _from_experts(ye: torch.Tensor, group, n: int) -> torch.Tensor:
    """The inverse of ``_to_experts``: [E' / n, n * C, d] -> [E', C, d],
    each peer's columns sent back to it."""
    from torch.distributed._functional_collectives import \
        all_to_all_single_autograd
    el, nc, d = ye.shape
    c = nc // n
    kops.all_to_all["moe_combine"] += 1
    out = ye.view(el, n, c, d).transpose(0, 1).reshape(n * el, c, d)
    return all_to_all_single_autograd(out.contiguous(), None, None, group)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the backward multiplies the cotangent by
    ``scale`` (``shard_map``'s transpose of an output that is the same on
    every rank of some mesh dims: its cotangent is divided by their
    size)."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _expert_placements(ws: Sequence, mesh) -> Tuple[List, bool]:
    """The placements the experts' weights ``ws`` (DTensors [E, ...]) are
    used in: ``Shard(0)`` on each mesh dim that cuts their expert dim in
    all three, ``Replicate()`` elsewhere; and whether any of them is
    placed otherwise (cut on another dim, or unlike the others), which
    gathers it."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for j in range(mesh.ndim):
        pj = {w.placements[j] for w in ws}
        out.append(Shard(0) if pj == {Shard(0)} else Replicate())
    return out, any(list(w.placements) != out for w in ws)


def _token_placements(x) -> Tuple[List, bool]:
    """The placements of the activations ``x`` [B, S, d] in the training
    region: its batch and seq cuts kept, any other gathered (and whether
    one was)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
           for p in x.placements]
    return out, out != list(x.placements)


def moe_ffn_sharded(params: Params, x, cfg: ArchConfig, mesh
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training route under a plan (repro's ``moe_ffn_sharded``; the
    module docstring): x [B, S, d] and ``params`` DTensors on ``mesh``.
    Returns (y placed as x, aux replicated)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    ws = [params[n] for n in EXPERT_KEYS]
    wpl, w_moved = _expert_placements(ws, mesh)
    xpl, x_moved = _token_placements(x)
    if w_moved or x_moved or any(isinstance(p, Shard)
                                 for p in params["router"].placements):
        kops.plan_fallbacks["moe"] += 1
    ep = [(mesh.get_group(j), mesh.size(j)) for j, p in enumerate(wpl)
          if isinstance(p, Shard) and mesh.size(j) > 1]
    # mesh dims on which every rank holds the same tokens
    same = 1
    for j, p in enumerate(xpl):
        if not isinstance(p, Shard):
            same *= mesh.size(j)
    n_ranks = mesh.size()
    whole = [Replicate()] * mesh.ndim
    summed = [Partial()] * mesh.ndim
    x_grad = [p if isinstance(p, Shard) else Partial() for p in xpl]
    w_grad = [p if isinstance(p, Shard) else Partial() for p in wpl]

    def region(xl, router, wg, wu, wd):
        y, aux = _moe_local({"router": router, "w_gate": wg, "w_up": wu,
                             "w_down": wd}, xl, cfg, ep)
        if same > 1:
            y = _ScaleGrad.apply(y, 1.0 / same)
        return y, aux / n_ranks

    y, aux = local_map(
        region, out_placements=(xpl, summed),
        in_placements=(xpl, whole, wpl, wpl, wpl),
        in_grad_placements=(x_grad, summed, w_grad, w_grad, w_grad),
        device_mesh=mesh, redistribute_inputs=True)(
            x, params["router"], *ws)
    return y, aux.redistribute(mesh, whole)


def moe_ffn_placed(params: Params, x, cfg: ArchConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serving route under a plan (repro's global formula; the module
    docstring): x [B, S, d] and ``params`` DTensors, never differentiated.
    Returns (y placed as x, aux as a plain 0-d tensor)."""
    from torch.distributed.tensor import Replicate, Shard

    from .common import local
    from .sharding import from_local, global_offset, place, redistribute
    mesh = x.device_mesh
    ws = [params[n] for n in EXPERT_KEYS]
    wpl, moved = _expert_placements(ws, mesh)
    if moved or any(isinstance(p, Shard)
                    for p in params["router"].placements):
        kops.plan_fallbacks["moe"] += 1
        ws = [w.redistribute(mesh, wpl) for w in ws]
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    cap = _capacity(b * s, cfg)
    xf = local(redistribute(x, [Replicate()] * mesh.ndim)).reshape(b * s, d)
    router = params["router"].full_tensor()
    gate, keep, dest, aux = route(xf, router, cfg, cap)
    xe = dispatch(xf, dest, e, k, cap)
    e0 = global_offset(ws[0])[0]
    wl = [w.to_local() for w in ws]
    ye = experts(xe[e0:e0 + wl[0].shape[0]], *wl)
    ye = from_local(ye, mesh, wpl, (e, cap, d)).full_tensor()
    y = combine(ye, gate, keep, dest, k).view(b, s, d)
    return place(y, mesh, x.placements), aux
