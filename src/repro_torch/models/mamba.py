"""Mamba2 (SSD) block, training path (counterpart of
``repro.models.mamba``: ``init_mamba``'s shapes, ``_split_proj``,
``_causal_conv``, ``_ssd_dispatch`` and ``mamba_forward``; its chunked
``ssd_scan`` is ``kernels/ssd.ssd_scan``).

State-space:  h_t = a_t * h_{t-1} + dt_t * x_t (x) B_t ;  y_t = C_t . h_t
with a_t = exp(dt_t * A) per head (A < 0), B/C shared across heads (one
group), head channels P, state N.  The stepwise decode (``mamba_step``,
``init_mamba_state``) belongs to the serving slice and is not here."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops as kops
from ..kernels.ssd import pad_seq, ssd_scan
from .common import rms_norm

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
    elsewhere.  Returns y only."""
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


def mamba_forward(params, x: torch.Tensor, cfg: ArchConfig, *,
                  impl: str = "auto") -> torch.Tensor:
    """x [B, S, D] -> [B, S, D] (training; returns no state)."""
    b, s, _ = x.shape
    di, n = cfg.d_inner, cfg.ssm.state_dim
    p = cfg.ssm.head_dim
    h = di // p
    z, xs, bb, cc, dt = _split_proj(cfg, x @ params["w_in"],
                                    x @ params["w_bcdt"])
    conv_in = torch.cat([xs, bb, cc], -1)
    conv_out = F.silu(_causal_conv(conv_in, params["conv_w"]).float())
    xs = conv_out[..., :di]
    bb = conv_out[..., di:di + n]
    cc = conv_out[..., di + n:]
    dt = F.softplus(dt.float() + params["dt_bias"])         # [B,S,H]
    a = -torch.exp(params["A_log"])                         # [H]
    a_log = dt * a                                          # [B,S,H]
    xh = xs.reshape(b, s, h, p) * dt[..., None]
    y = ssd_dispatch(xh, a_log, bb, cc, cfg.ssm.chunk, impl)
    y = y + params["D"][None, None, :, None] * xs.reshape(b, s, h, p)
    y = y.reshape(b, s, di) * F.silu(z.float())
    y = rms_norm(y.to(x.dtype), params["norm"], cfg.norm_eps)
    return y @ params["w_out"]
