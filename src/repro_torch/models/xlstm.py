"""xLSTM blocks (counterpart of ``repro.models.xlstm``, arXiv:2405.04517):
the sLSTM block (scalar memory, a recurrent hidden-to-hidden product,
a sequential scan over time, then a GeLU up/down projection) and the
mLSTM block (matrix memory, chunkwise parallel: an mLSTM step C_t = f_t
C_{t-1} + i_t v_t (x) k_t is the Mamba2 recurrence with a scalar decay
per head, B = k and C = q, so the training path is the chunked
``kernels/ssd.ssd_scan`` with the heads folded into the batch, as repro
calls its XLA ``ssd_scan``: no TPU kernel runs here, and the SSD kernel,
which takes P and N up to 64, is not called at hd = 2 d / H).

The parameter shapes of one layer are ``mlstm_shapes`` / ``slstm_shapes``
(repro's ``init_mlstm`` / ``init_slstm``); the decode states are
``mlstm_state_shapes`` ({"C": [B, H, hd, hd] f32}, hd = 2 d / H) and
``slstm_state_shapes`` ({"h", "c", "n": [B, H, d / H] f32}), updated in
place by ``mlstm_step`` / ``slstm_step``.  repro's f32 casts are kept:
the gates, the recurrence and k * hd^-0.5 are f32 on both paths.  The
forward takes log_sigmoid of the forget gate (summed by the scan), the
step sigmoid; the input gate is exp(clip(gi, -10, 10)) on both, with no
stabiliser, as in repro.

sLSTM's ``w_gates`` columns are laid out per head, [head][gate][hd]:
``xg.reshape(B, H, 4 hd)`` is split on its last axis into i, f, z, o.

Under a sharding plan (``plan`` and ``mesh`` given, x a DTensor) the
projections are DTensor ops and the per-row work between them runs on
each rank's batch rows in one ``local_map`` region
(``sharding.rows_region``; in a decode step ``sharding.step_rows``,
which writes the state's local rows in place).  A fused projection cut on
its output axis (mLSTM's [z | q | k | v | i | f], sLSTM's per-head
gates: role ``ssm_in``, dims (d_model, inner)) would split its parts over
ranks, so it is gathered whole on that axis first; a state cut on an axis
other than batch is gathered for the update and cut back after.  Both
are counted in ``ops.plan_fallbacks["xlstm"]``."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops as kops
from ..kernels.ssd import ssd_scan
from .common import rms_norm
from .sharding import matmul


def _mlstm_dims(cfg: ArchConfig):
    """(dm, H, hd): the mLSTM's inner width, heads and head dim."""
    dm = int(cfg.d_model * cfg.xlstm.proj_factor_mlstm)
    return dm, cfg.n_heads, dm // cfg.n_heads


def mlstm_shapes(cfg: ArchConfig, dtype: torch.dtype) -> Dict[str, tuple]:
    """(shape, dtype) of each of ``init_mlstm``'s params (one layer): the
    fused projection ``w_in`` [d, 4 dm + 2H] (z, q, k, v, then the input
    and forget gates per head), the norm (f32) and ``w_out``."""
    d = cfg.d_model
    dm, h, _ = _mlstm_dims(cfg)
    return {"w_in": ((d, 4 * dm + 2 * h), dtype),
            "norm": ((dm,), torch.float32), "w_out": ((dm, d), dtype)}


def slstm_shapes(cfg: ArchConfig, dtype: torch.dtype) -> Dict[str, tuple]:
    """(shape, dtype) of each of ``init_slstm``'s params (one layer):
    ``w_gates`` [d, 4d] (per head: i, f, z, o), the recurrent ``r_gates``
    [H, hd, 4 hd] (fan-in hd), and the up/down projection of width
    ``int(d * proj_factor_slstm)``."""
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    df = int(d * cfg.xlstm.proj_factor_slstm)
    return {"w_gates": ((d, 4 * d), dtype), "r_gates": ((h, hd, 4 * hd), dtype),
            "w_up": ((d, df), dtype), "w_down": ((df, d), dtype)}


def mlstm_state_shapes(cfg: ArchConfig, batch: int) -> Dict[str, tuple]:
    """One mLSTM layer's decode state (repro's ``init_mlstm_state``)."""
    _, h, hd = _mlstm_dims(cfg)
    return {"C": ((batch, h, hd, hd), torch.float32)}


def slstm_state_shapes(cfg: ArchConfig, batch: int) -> Dict[str, tuple]:
    """One sLSTM layer's decode state (repro's ``init_slstm_state``)."""
    h = cfg.n_heads
    shape = ((batch, h, cfg.d_model // h), torch.float32)
    return {"h": shape, "c": shape, "n": shape}


def _gathered(t, dim: int):
    """``mamba._inner_whole``: DTensor ``t`` with no mesh dim cutting
    tensor dim ``dim`` (a fused projection's output axis before its parts
    are sliced), counted in ``ops.plan_fallbacks["xlstm"]`` when that
    moves data; a plain tensor is returned as it is."""
    from .mamba import _inner_whole
    from .sharding import moves
    out = _inner_whole(t, dim)
    if out is not t and moves(t.placements, out.placements, t.device_mesh):
        kops.plan_fallbacks["xlstm"] += 1
    return out


# --------------------------- mLSTM ----------------------------------------

def _mlstm_parts(cfg: ArchConfig, proj: torch.Tensor):
    dm, h, _ = _mlstm_dims(cfg)
    return (proj[..., :dm], proj[..., dm:2 * dm], proj[..., 2 * dm:3 * dm],
            proj[..., 3 * dm:4 * dm], proj[..., 4 * dm:4 * dm + h],
            proj[..., 4 * dm + h:])


def _mlstm_mix(cfg: ArchConfig, dtype: torch.dtype, proj: torch.Tensor,
               norm: torch.Tensor) -> torch.Tensor:
    """The mLSTM block between its projections (repro's ``mlstm_forward``
    from ``_mlstm_parts`` to the norm): proj [B, S, 4 dm + 2H] -> the
    normed [B, S, dm] in ``dtype``."""
    b, s, _ = proj.shape
    dm, h, hd = _mlstm_dims(cfg)
    z, q, k, v, gi, gf = _mlstm_parts(cfg, proj)
    logf = F.logsigmoid(gf.float())                          # [B,S,H]
    i_g = torch.exp(gi.float().clamp(-10.0, 10.0))
    # f32 before the scale, as the step takes it
    vh = v.reshape(b, s, h, hd).float() * i_g[..., None]
    kh = k.reshape(b, s, h, hd).float() * (hd ** -0.5)
    qh = q.reshape(b, s, h, hd).float()
    # heads folded into the batch: one head a row, its k / q as B / C
    vf = vh.transpose(1, 2).reshape(b * h, s, 1, hd)
    kf = kh.transpose(1, 2).reshape(b * h, s, hd)
    qf = qh.transpose(1, 2).reshape(b * h, s, hd)
    af = logf.transpose(1, 2).reshape(b * h, s, 1)
    y, _ = ssd_scan(vf, af, kf, qf, min(256, s))
    y = y.reshape(b, h, s, hd).transpose(1, 2).reshape(b, s, dm)
    y = y * F.silu(z.float())
    return rms_norm(y.to(dtype), norm, cfg.norm_eps)


def mlstm_forward(params, x: torch.Tensor, cfg: ArchConfig, plan=None,
                  mesh=None) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D] (the chunkwise-parallel training path)."""
    proj = matmul(x, params["w_in"])
    if plan is None or mesh is None:
        y = _mlstm_mix(cfg, x.dtype, proj, params["norm"])
    else:
        from .sharding import rows_region
        y = rows_region(lambda p, n: _mlstm_mix(cfg, x.dtype, p, n),
                        (_gathered(proj, 2),), (params["norm"],), plan, mesh)
    return matmul(y, params["w_out"])


def _mlstm_heads(z: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, gi: torch.Tensor, gf: torch.Tensor,
                 c_state: torch.Tensor) -> torch.Tensor:
    """The mLSTM decode update of the heads ``c_state`` [B, Hl, hd, hd]
    holds (all of them, or a rank's own under a plan): z, q, k, v [B, Hl,
    hd] and the gates gi, gf [B, Hl] of those heads.  Writes ``c_state``
    in place and returns y * silu(z) [B, Hl, hd] in f32."""
    hd = c_state.shape[-1]
    f = torch.sigmoid(gf.float())                             # [B, Hl]
    i_g = torch.exp(gi.float().clamp(-10.0, 10.0))
    vh = v.float() * i_g[..., None]
    kh = k.float() * (hd ** -0.5)
    qh = q.float()
    c_new = c_state * f[..., None, None] + vh[..., :, None] * kh[..., None, :]
    y = (c_new @ qh[..., None])[..., 0]
    c_state.copy_(c_new)
    return y * F.silu(z.float())


def _mlstm_head_parts(cfg: ArchConfig, proj: torch.Tensor):
    """``_mlstm_parts`` of proj [B, 4 dm + 2H] with z, q, k, v as [B, H,
    hd]."""
    b = proj.shape[0]
    _, h, hd = _mlstm_dims(cfg)
    z, q, k, v, gi, gf = _mlstm_parts(cfg, proj)
    return tuple(t.reshape(b, h, hd) for t in (z, q, k, v)) + (gi, gf)


def _mlstm_update(cfg: ArchConfig, proj: torch.Tensor,
                  c_state: torch.Tensor) -> torch.Tensor:
    """The per-row part of an mLSTM decode step (repro's ``mlstm_step``
    from the projection to the gate): writes ``c_state`` [B, H, hd, hd] in
    place and returns y * silu(z) [B, dm] in f32, before the norm."""
    y = _mlstm_heads(*_mlstm_head_parts(cfg, proj), c_state)
    return y.reshape(proj.shape[0], _mlstm_dims(cfg)[0])


def mlstm_step(params, x: torch.Tensor, state: Dict[str, torch.Tensor],
               cfg: ArchConfig, plan=None, mesh=None,
               layer: Optional[int] = None,
               slot: Optional[int] = None) -> torch.Tensor:
    """One decode step of one mLSTM layer: x [B, D] -> y [B, D].
    ``state`` is {"C"} (``mlstm_state_shapes``), or with ``layer`` the
    cache's stacked [L/2, B, ...] state of which that layer is stepped,
    updated in place for every row.  Under a plan the update runs on each
    rank's own rows, and own heads where the state's cut is on batch and
    heads only (``sharding.step_rows(heads=True)``); with ``slot`` (x [1,
    D], the scan prefill's step of that row) on the ranks that hold
    it."""
    c_state = state["C"]
    if layer is not None:
        from .sharding import layer_of
        c_state = layer_of(c_state, layer)
    proj = x @ params["w_in"]
    dm = _mlstm_dims(cfg)[0]
    if plan is None or mesh is None:
        y = _mlstm_update(cfg, proj, c_state)
    else:
        from .sharding import step_rows
        y = step_rows(_mlstm_heads,
                      _mlstm_head_parts(cfg, _gathered(proj, 1)), (),
                      (c_state,), dm, "xlstm", slot, heads=True)
    y = rms_norm(y.to(x.dtype), params["norm"], cfg.norm_eps)
    return y @ params["w_out"]


# --------------------------- sLSTM ----------------------------------------

def _slstm_cell(r32: torch.Tensor, xg: torch.Tensor, h: torch.Tensor,
                c: torch.Tensor, n: torch.Tensor):
    """One sLSTM step (repro's ``_slstm_cell``, op for op): r32 [H, hd,
    4 hd] f32, xg [B, H, 4 hd] f32 (the input gates, [gate][hd] per head),
    carry h, c, n [B, H, hd] f32 -> the new (h, c, n)."""
    rec = torch.einsum("bhk,hkf->bhf", h, r32)
    gi, gf, gz, go = (xg + rec).chunk(4, dim=-1)
    i_g = torch.exp(gi.clamp(-10.0, 10.0))
    f_g = torch.sigmoid(gf)
    c_new = f_g * c + i_g * torch.tanh(gz)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(go) * c_new / n_new.abs().clamp(min=1.0)
    return h_new, c_new, n_new


def _slstm_scan(cfg: ArchConfig, xg: torch.Tensor,
                r_gates: torch.Tensor) -> torch.Tensor:
    """The sLSTM recurrence over time, a Python loop of S steps (repro's
    ``lax.scan``): xg [B, S, 4D] -> the hidden states [B, S, D] f32."""
    b, s, _ = xg.shape
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    x32 = xg.reshape(b, s, nh, 4 * hd).float()
    r32 = r_gates.float()
    h = torch.zeros((b, nh, hd), dtype=torch.float32, device=xg.device)
    c, n = h, h
    hs = []
    for t in range(s):
        h, c, n = _slstm_cell(r32, x32[:, t], h, c, n)
        hs.append(h)
    return torch.stack(hs, 1).reshape(b, s, nh * hd)


def _up_down(params, y: torch.Tensor) -> torch.Tensor:
    """The sLSTM block's position-wise projection (proj factor 4/3, tanh
    GeLU in f32, as jax.nn.gelu's default)."""
    u = F.gelu(matmul(y, params["w_up"]).float(), approximate="tanh")
    return matmul(u.to(y.dtype), params["w_down"])


def slstm_forward(params, x: torch.Tensor, cfg: ArchConfig, plan=None,
                  mesh=None) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D] (the sequential scan over time)."""
    xg = matmul(x, params["w_gates"])
    if plan is None or mesh is None:
        hs = _slstm_scan(cfg, xg, params["r_gates"])
    else:
        from .sharding import rows_region
        hs = rows_region(lambda g, r: _slstm_scan(cfg, g, r),
                         (_gathered(xg, 2),), (params["r_gates"],), plan,
                         mesh)
    return _up_down(params, hs.to(x.dtype))


def _slstm_heads(xg: torch.Tensor, r_gates: torch.Tensor, h: torch.Tensor,
                 c: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The sLSTM decode update of the heads h, c, n [B, Hl, hd] hold (all
    of them, or a rank's own under a plan): xg [B, Hl, 4 hd] and r_gates
    [Hl, hd, 4 hd] of those heads.  Writes h, c, n in place and returns
    the new h [B, Hl, hd] f32."""
    new = _slstm_cell(r_gates.float(), xg.float(), h, c, n)
    for t, v in zip((h, c, n), new):
        t.copy_(v)
    return new[0]


def _slstm_update(cfg: ArchConfig, xg: torch.Tensor, r_gates: torch.Tensor,
                  h: torch.Tensor, c: torch.Tensor,
                  n: torch.Tensor) -> torch.Tensor:
    """The per-row part of an sLSTM decode step: writes h, c, n [B, H,
    hd] in place and returns the new h as [B, D] f32."""
    b, nh, hd = h.shape
    return _slstm_heads(xg.reshape(b, nh, 4 * hd), r_gates, h, c,
                        n).reshape(b, nh * hd)


def slstm_step(params, x: torch.Tensor, state: Dict[str, torch.Tensor],
               cfg: ArchConfig, plan=None, mesh=None,
               layer: Optional[int] = None,
               slot: Optional[int] = None) -> torch.Tensor:
    """One decode step of one sLSTM layer: x [B, D] -> y [B, D];
    ``state`` {"h", "c", "n"}, ``layer`` and ``slot`` as ``mlstm_step``'s."""
    hcn = [state[k] for k in ("h", "c", "n")]
    if layer is not None:
        from .sharding import layer_of
        hcn = [layer_of(t, layer) for t in hcn]
    xg = x @ params["w_gates"]
    if plan is None or mesh is None:
        h = _slstm_update(cfg, xg, params["r_gates"], *hcn)
    else:
        from .sharding import step_rows
        xg = _gathered(xg, 1)
        h = step_rows(_slstm_heads, (xg.reshape(xg.shape[0], cfg.n_heads,
                                                -1),),
                      (params["r_gates"],), hcn, cfg.d_model, "xlstm", slot,
                      heads=True)
    return _up_down(params, h.to(x.dtype))
