"""The SSD scan on the card: the ctypes wrapper of the CUDA chunk-scan
kernel (``csrc/ssd_scan.cu``), the counterpart of repro's Pallas
``kernels/ssd.py::ssd_chunk_scan``, and the chunked PyTorch scan
``ssd_scan`` (repro's XLA ``models/mamba.ssd_scan``), which is the
hybrid model's "chunked" route and the backward of the kernel route
(``ops.ssd_chunk_scan_diff``).

The wrapper checks what the kernel takes (device, f32, contiguity, shapes,
``S % chunk == 0``, P and N at most 64) and raises on anything else,
allocates y and the kernel's scratch (the in-chunk prefix sums ``cum``
[B, H, S] and the states of all chunks but the last, [B, S / chunk - 1, H,
P, N], f32) with ``torch.empty``, launches on the current stream without
synchronising (three CUDA launches: the chunks' states, their carry, the
output), raises if a launch returned an error, and counts the call once
in ``launches``.
The kernel reads xh, B and C by TMA, in rows of whole 16-byte units from
16-byte aligned bases (``_check`` refuses a misaligned input): a P or N
that is not a multiple of 4 is padded with zeros here (and y cut back).
It takes
CUDA tensors only: ``kernels/ops.py`` sends CPU tensors to the plain
``ref.ssd_ref``."""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .flash_attention import _check, _check_cuda, _ptr, _raise_on

MAX_DIM = 64              # largest P (head channels) and N (state)
MAX_CHUNK = 8192          # the largest chunk taken (the model's is 256)

# launches since the last reset_launches(), read by chip_smoke.py
launches: Dict[str, int] = {"ssd_chunk_scan": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def ssd_chunk_scan(xh, a_log, bb, cc, *, chunk: int):
    """xh [B,S,H,P], a_log [B,S,H], bb/cc [B,S,N], all f32 and contiguous
    on one CUDA device -> y [B,S,H,P] f32.  The chunk is ``min(chunk,
    S)`` and must divide S (the caller pads, as repro's dispatcher
    does)."""
    from .build import load_library

    _check_cuda(xh)
    dev = xh.device
    f32 = (torch.float32,)
    _check("xh", xh, 4, f32, dev)
    _check("a_log", a_log, 3, f32, dev)
    _check("bb", bb, 3, f32, dev)
    _check("cc", cc, 3, f32, dev)
    b, s, h, p = xh.shape
    n = bb.shape[2]
    if (tuple(a_log.shape) != (b, s, h) or tuple(bb.shape) != (b, s, n)
            or cc.shape != bb.shape):
        raise ValueError(f"a_log {tuple(a_log.shape)} / bb "
                         f"{tuple(bb.shape)} / cc {tuple(cc.shape)} do not "
                         f"match xh {tuple(xh.shape)}")
    if not (1 <= p <= MAX_DIM and 1 <= n <= MAX_DIM):
        raise ValueError(f"P={p}, N={n}: the kernel takes 1 to {MAX_DIM}")
    y = torch.empty_like(xh)
    if y.numel() == 0:
        return y
    q = min(int(chunk), s)
    if q < 1 or s % q:
        raise ValueError(f"S={s} is not a multiple of the chunk {q}; pad "
                         "it (models/mamba.ssd_dispatch does)")
    if q > MAX_CHUNK:
        raise ValueError(f"chunk {q} above the kernel's {MAX_CHUNK}")
    pp, pn = -p % 4, -n % 4
    xk, bk, ck = _pad_last(xh, pp), _pad_last(bb, pn), _pad_last(cc, pn)
    yk = y if not pp else torch.empty_like(xk)
    cum = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    s_local = torch.empty((b, s // q - 1, h, p + pp, n + pn),
                          dtype=torch.float32, device=dev)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.repro_ssd_chunk_scan(
        _ptr(xk), _ptr(a_log), _ptr(bk), _ptr(ck), _ptr(yk), _ptr(cum),
        _ptr(s_local), b, s, h, p + pp, n + pn, q, ctypes.c_void_p(stream))
    _raise_on(code, lib, "ssd_chunk_scan")
    launches["ssd_chunk_scan"] += 1
    if pp:
        y.copy_(yk[..., :p])
    return y


def _pad_last(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` with its last axis zero-padded by ``pad`` (a new tensor), so
    that its rows are whole 16-byte units for the kernel's tensor maps."""
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero rows appended to axis 1."""
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)


def ssd_scan(xh, a_log, bb, cc, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (repro's XLA path).  xh [B,S,H,P] (dt folded in),
    a_log [B,S,H] (<= 0), bb/cc [B,S,N] -> (y [B,S,H,P] f32, final state
    [B,H,P,N] f32).  repro's three-operand einsums are written as
    pairwise products, so no [B,nc,Q,Q,H,P] tensor is ever formed."""
    b, s, h, p = xh.shape
    n = bb.shape[-1]
    q = min(chunk, s)
    nc = (s + q - 1) // q
    pad = nc * q - s
    xh = pad_seq(xh, pad).reshape(b, nc, q, h, p).float()
    al = pad_seq(a_log, pad).reshape(b, nc, q, h).float()
    bb = pad_seq(bb, pad).reshape(b, nc, q, n).float()
    cc = pad_seq(cc, pad).reshape(b, nc, q, n).float()

    cum = torch.cumsum(al, 2)                              # [B,nc,Q,H]
    # intra-chunk: scores[q,t] = (C_q.B_t) exp(cum_q - cum_t), t <= q
    cb = cc @ bb.transpose(-1, -2)                         # [B,nc,Q,T]
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # [B,nc,Q,T,H]
    mask = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    w = torch.where(mask[:, :, None], torch.exp(dec.clamp(-60.0, 0.0)),
                    torch.zeros((), device=xh.device))
    m = (cb[..., None] * w).permute(0, 1, 4, 2, 3)         # [B,nc,H,Q,T]
    y_intra = (m @ xh.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)

    # chunk-local end states: S_local = sum_t exp(cumQ - cum_t) x_t (x) B_t
    tail = torch.exp((cum[:, :, -1:, :] - cum).clamp(-60.0, 0.0))
    xt = (xh * tail[..., None]).permute(0, 1, 3, 4, 2)     # [B,nc,H,P,T]
    s_local = xt @ bb[:, :, None]                          # [B,nc,H,P,N]

    # carry the states across chunks
    chunk_decay = torch.exp(cum[:, :, -1, :].clamp(-60.0, 0.0))  # [B,nc,H]
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = state * chunk_decay[:, c, :, None, None] + s_local[:, c]
    s_prevs = torch.stack(prevs, 1)                        # [B,nc,H,P,N]

    # inter-chunk: y_q += exp(cum_q) C_q . S_prev
    decay_in = torch.exp(cum.clamp(-60.0, 0.0))            # [B,nc,Q,H]
    y_inter = (cc[:, :, None] @ s_prevs.transpose(-1, -2))  # [B,nc,H,Q,P]
    y_inter = y_inter.permute(0, 1, 3, 2, 4) * decay_in[..., None]
    y = (y_intra + y_inter).reshape(b, nc * q, h, p)[:, :s]
    return y, state
