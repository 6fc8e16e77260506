"""Mamba2 (SSD) block (counterpart of ``repro.models.mamba``:
``init_mamba``'s shapes, ``_split_proj``, ``_causal_conv``,
``_ssd_dispatch``, ``mamba_forward``, ``init_mamba_state`` and
``mamba_step``; its chunked ``ssd_scan`` is ``kernels/ssd.ssd_scan``).

State-space:  h_t = a_t * h_{t-1} + dt_t * x_t (x) B_t ;  y_t = C_t . h_t
with a_t = exp(dt_t * A) per head (A < 0), B/C shared across heads (one
group), head channels P, state N.  The stepwise decode is ``mamba_step``
on the state of ``init_mamba_state`` (repro's), updated in place.

Under a sharding plan (``plan`` and ``mesh`` given, x a DTensor) the
projections run as DTensor ops and the per-row work on each rank's local
batch rows through ``local_map``:

- ``w_in`` is [z | x] on one ``inner`` axis of 2 * d_inner, so a cut of
  that axis gives whole halves to whole ranks (degree 2: all of z on one,
  all of x on the other) and ``_split_proj`` would slice across shards.
  ``_inner_whole`` gathers ``zx``'s inner axis first, explicitly;
- the SSD scan (the CUDA kernel or the chunked scan, ``ssd_dispatch``)
  runs on the batch cut of ``plan.pspec("ssm_h", ("batch", "seq",
  "inner"))`` (repro's shard_map rule), heads and sequence whole, inside
  one ``local_map`` region that holds the whole block between its
  projections (the conv, the scan, the gate, the norm:
  ``_mixer_sharded``).  Where the plan has no ``ssm_h`` role (no builder
  gives the scan's activations one, so no solved plan has it, and repro
  then runs the scan whole on every device) the region takes the batch
  cut of the activations' role ``x``, which holds the same rows: the
  same arithmetic per row, no gather.  A cut that does not divide B is
  dropped;
- ``mamba_step``'s state update runs in a ``local_map`` region on the
  state's batch rows, in place.  The conv state's last axis is [xs | B |
  C] (d_inner + 2N): an ``inner`` cut of it does not line up with
  ``w_in``'s cut of x, and an ``inner`` / ``sdim`` cut of the SSM state
  splits a head's update over ranks, so a state cut on anything but
  ``batch`` is gathered whole on its other axes for the update and cut
  back after (counted in ``ops.plan_fallbacks["mamba_state"]``;
  ``sharding.step_rows``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops as kops
from ..kernels.ssd import pad_seq, ssd_scan
from .common import rms_norm
from .sharding import matmul

SSD_IMPLS = ("auto", "kernel", "chunked")


def mamba_shapes(cfg: ArchConfig, dtype: torch.dtype) -> Dict[str, tuple]:
    """(shape, dtype) of each of ``init_mamba``'s params (one layer)."""
    d, di = cfg.d_model, cfg.d_inner
    n, p, cd = cfg.ssm.state_dim, cfg.ssm.head_dim, cfg.ssm.conv_dim
    h = di // p
    f32 = torch.float32
    return {"w_in": ((d, 2 * di), dtype), "w_bcdt": ((d, 2 * n + h), dtype),
            "conv_w": ((cd, di + 2 * n), dtype), "A_log": ((h,), f32),
            "D": ((h,), f32), "dt_bias": ((h,), f32), "norm": ((di,), f32),
            "w_out": ((di, d), dtype)}


def _split_proj(cfg: ArchConfig, zx: torch.Tensor, bcdt: torch.Tensor):
    di, n = cfg.d_inner, cfg.ssm.state_dim
    return (zx[..., :di], zx[..., di:], bcdt[..., :n], bcdt[..., n:2 * n],
            bcdt[..., 2 * n:])


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x [B, S, C], w [K, C]: summed in f32 in
    repro's order, then rounded to x's dtype."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + s, :].float() * w[i].float()
    return out.to(x.dtype)


def ssd_dispatch(xh, a_log, bb, cc, chunk: int, impl: str) -> torch.Tensor:
    """Route the SSD scan (repro's ``_ssd_dispatch``): "chunked" is the
    chunked ``kernels/ssd.ssd_scan``; "kernel" pads S to a multiple of
    ``q = min(chunk, S)`` and runs ``ops.ssd_chunk_scan_diff`` (the CUDA
    kernel for a CUDA tensor, the plain version for a CPU one), then
    slices back to S; "auto" is "kernel" on a CUDA tensor and "chunked"
    elsewhere.  Under a plan it runs on each rank's local batch rows,
    inside ``_mixer_sharded``'s region (module docstring).  Returns y
    only."""
    if impl not in SSD_IMPLS:
        raise ValueError(f"ssd impl must be one of {SSD_IMPLS}, got "
                         f"{impl!r}")
    if impl == "auto":
        impl = "kernel" if xh.is_cuda else "chunked"
    if impl == "chunked":
        return ssd_scan(xh, a_log, bb, cc, chunk)[0]
    s = xh.shape[1]
    q = min(chunk, s)
    pad = -s % q
    ins = [pad_seq(t, pad).float().contiguous() for t in (xh, a_log, bb, cc)]
    return kops.ssd_chunk_scan_diff(*ins, q)[:, :s]


def _inner_whole(t, dim: int):
    """DTensor ``t`` with no mesh dim cutting tensor dim ``dim``: ``zx``'s
    [z | x] axis before ``_split_proj`` slices it (a plain tensor is
    returned as it is)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from .sharding import redistribute
    if not isinstance(t, DTensor):
        return t
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in t.placements]
    return redistribute(t, pl)


def mamba_forward(params, x: torch.Tensor, cfg: ArchConfig, plan=None, *,
                  impl: str = "auto", mesh=None) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D] (training; returns no state).  Under a
    plan the projections are DTensor ops, ``zx`` is constrained at
    repro's site (role ``ssm_h``) and its inner axis gathered, and the
    per-row work between the projections runs on the local batch rows
    (``_mixer_sharded``)."""
    from .common import shard
    zx = shard(matmul(x, params["w_in"]), plan, "ssm_h",
               ("batch", "seq", "inner"))
    bcdt = matmul(x, params["w_bcdt"])
    small = tuple(params[k] for k in _MIXER_PARAMS)
    if plan is None or mesh is None:
        y = _mixer(cfg, impl, x.dtype, zx, bcdt, *small)
    else:
        y = _mixer_sharded(cfg, impl, x.dtype, _inner_whole(zx, 2), bcdt,
                           small, plan, mesh)
    return matmul(y, params["w_out"])


_MIXER_PARAMS = ("conv_w", "dt_bias", "A_log", "D", "norm")


def _mixer(cfg: ArchConfig, impl: str, dtype: torch.dtype, zx, bcdt, conv_w,
           dt_bias, a_log_param, d, norm) -> torch.Tensor:
    """The block between its projections (repro's ``mamba_forward`` from
    ``_split_proj`` to the norm): the causal conv, the SSD scan
    (``ssd_dispatch``), the skip, the gate and the norm.  zx [B, S,
    2 d_inner], bcdt [B, S, 2N + H] -> [B, S, d_inner] in ``dtype``."""
    b, s, _ = zx.shape
    di, n = cfg.d_inner, cfg.ssm.state_dim
    p = cfg.ssm.head_dim
    h = di // p
    z, xs, bb, cc, dt = _split_proj(cfg, zx, bcdt)
    conv_in = torch.cat([xs, bb, cc], -1)
    conv_out = F.silu(_causal_conv(conv_in, conv_w).float())
    xs = conv_out[..., :di]
    bb = conv_out[..., di:di + n]
    cc = conv_out[..., di + n:]
    dt = F.softplus(dt.float() + dt_bias)                   # [B,S,H]
    a = -torch.exp(a_log_param)                             # [H]
    a_log = dt * a                                          # [B,S,H]
    xh = xs.reshape(b, s, h, p) * dt[..., None]
    y = ssd_dispatch(xh, a_log, bb, cc, cfg.ssm.chunk, impl)
    y = y + d[None, None, :, None] * xs.reshape(b, s, h, p)
    y = y.reshape(b, s, di) * F.silu(z.float())
    return rms_norm(y.to(dtype), norm, cfg.norm_eps)


def _mixer_sharded(cfg: ArchConfig, impl: str, dtype: torch.dtype, zx, bcdt,
                   small, plan, mesh):
    """``_mixer`` under a plan, in one ``local_map`` region on the rows of
    ``ssd_dispatch``'s batch cut (``sharding.rows_region``), the block's
    small params whole.  Nothing between the projections is a DTensor
    op: slicing a DTensor on its last dim gave the gradient a malformed
    placement under the card's torch 2.11."""
    from .sharding import rows_region
    return rows_region(lambda *a: _mixer(cfg, impl, dtype, *a), (zx, bcdt),
                       small, plan, mesh)


# -- the stepwise decode ------------------------------------------------------

def mamba_state_shapes(cfg: ArchConfig, batch: int) -> Dict[str, tuple]:
    """(shape, dtype) of one layer's decode state (repro's
    ``init_mamba_state``): ``ssm`` [B, H, P, N] f32 and ``conv`` [B,
    conv_dim - 1, d_inner + 2N], bf16 whatever the model dtype."""
    di, n = cfg.d_inner, cfg.ssm.state_dim
    p, cd = cfg.ssm.head_dim, cfg.ssm.conv_dim
    return {"ssm": ((batch, di // p, p, n), torch.float32),
            "conv": ((batch, cd - 1, di + 2 * n), torch.bfloat16)}


def init_mamba_state(cfg: ArchConfig, batch: int, device="cuda"
                     ) -> Dict[str, torch.Tensor]:
    """One layer's decode state of ``mamba_state_shapes``, zeroed."""
    from .common import resolve_device
    dev = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=dev)
            for k, (shape, dt) in mamba_state_shapes(cfg, batch).items()}


def _step_update(cfg: ArchConfig, zx, bcdt, conv_w, a_log_param, d,
                 dt_bias, ssm, conv) -> torch.Tensor:
    """The per-row part of a decode step (repro's ``mamba_step`` from the
    projections on): updates ``ssm`` [B, H, P, N] and ``conv`` [B, K-1,
    C] in place and returns y * silu(z) [B, d_inner] in f32, before the
    norm.  ``hist`` takes the projection's dtype (bf16 state promoted, as
    jnp.concatenate promotes), the conv is summed in f32, and ``hist[:,
    1:]`` is stored back as bf16."""
    b = zx.shape[0]
    di, n = cfg.d_inner, cfg.ssm.state_dim
    p = cfg.ssm.head_dim
    h = di // p
    z, xs, bb, cc, dt = _split_proj(cfg, zx, bcdt)
    conv_in = torch.cat([xs, bb, cc], -1)                       # [B, C]
    hist = torch.cat([conv.to(conv_in.dtype), conv_in[:, None]], 1)
    conv_out = F.silu((hist.float() * conv_w.float()).sum(1))
    xs = conv_out[:, :di]
    bb = conv_out[:, di:di + n]
    cc = conv_out[:, di + n:]
    dt = F.softplus(dt.float() + dt_bias)                       # [B, H]
    a = torch.exp(dt * -torch.exp(a_log_param))                 # [B, H]
    xh = xs.reshape(b, h, p) * dt[..., None]
    s_new = ssm * a[..., None, None] + xh[..., None] * bb[:, None, None, :]
    y = (s_new * cc[:, None, None, :]).sum(-1)                  # [B, H, P]
    y = y + d[None, :, None] * xs.reshape(b, h, p)
    ssm.copy_(s_new)
    conv.copy_(hist[:, 1:].to(torch.bfloat16))
    return y.reshape(b, di) * F.silu(z.float())


def mamba_step(params, x: torch.Tensor, state: Dict[str, torch.Tensor],
               cfg: ArchConfig, plan=None, mesh=None,
               layer: Optional[int] = None,
               slot: Optional[int] = None) -> torch.Tensor:
    """One decode step of one layer: x [B, D] -> y [B, D].  ``state`` is
    one layer's {"ssm", "conv"} (``init_mamba_state``), or, with
    ``layer``, the cache's stacked [L, B, ...] state of which that layer
    is stepped; it is updated in place for every row (repro churns an
    inactive row's state too; ``reset_slot`` clears it).  Under a plan
    (DTensor state) the update runs on the state's local batch rows
    (module docstring); with ``slot`` (x [1, D]: the scan prefill's step
    of that row of the pool's state) on the ranks that hold the row.
    Without a plan the scan prefill steps a batch-1 view of the state."""
    ssm, conv = state["ssm"], state["conv"]
    if layer is not None:
        from .sharding import layer_of
        ssm, conv = layer_of(ssm, layer), layer_of(conv, layer)
    zx = x @ params["w_in"]
    bcdt = x @ params["w_bcdt"]
    small = (params["conv_w"], params["A_log"], params["D"],
             params["dt_bias"])
    if plan is None or mesh is None:
        y = _step_update(cfg, zx, bcdt, *small, ssm, conv)
    else:
        y = _step_update_sharded(cfg, _inner_whole(zx, 1), bcdt, small, ssm,
                                 conv, slot)
    y = rms_norm(y.to(x.dtype), params["norm"], cfg.norm_eps)
    return y @ params["w_out"]


def _step_update_sharded(cfg: ArchConfig, zx, bcdt, small, ssm, conv,
                         slot: Optional[int] = None):
    """``_step_update`` under a plan (``sharding.step_rows``): the rows of
    the state's batch cut on each rank, the state (DTensors [B, ...])
    written in place; a state cut on another axis is gathered for the
    update (``ops.plan_fallbacks["mamba_state"]``).  ``slot``: zx and
    bcdt are one row, replicated, stepped on the ranks that hold row
    ``slot``."""
    from .sharding import step_rows
    return step_rows(lambda *a: _step_update(cfg, *a), (zx, bcdt), small,
                     (ssm, conv), cfg.d_inner, "mamba_state", slot)
