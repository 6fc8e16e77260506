"""ctypes wrappers of the CUDA attention kernels (``csrc/flash_fwd.cu``,
``csrc/flash_decode.cu``).

Each wrapper checks what the kernel takes (device, dtype, shape,
contiguity, alignment, head dim) and raises on anything else, allocates
its outputs with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch returned an error, and counts the
launch in ``launches``.  They take CUDA tensors only: ``kernels/ops.py``
sends CPU tensors to the plain versions in ``kernels/ref.py``."""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from .ref import check_gqa

HEAD_DIMS = (16, 64, 128)
MAX_GROUP = 16            # decode: query heads per KV head (8 warps x 2)

# launches per kernel since the last reset_launches(); a plain integer
# each, read by chip_smoke.py to show the main path ran the kernels
launches: Dict[str, int] = {"flash_fwd": 0, "flash_decode": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(name: str, t: torch.Tensor, ndim: int, dtypes, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.shape}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_cuda(q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel takes CUDA tensors, got {q.device}; "
            "kernels/ops.py routes CPU tensors to the plain version")


def _raise_on(code: int, lib, what: str) -> None:
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed ({code}): {msg}")


def _window_arg(window: Optional[int]) -> int:
    if window is None:
        return 0
    if window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    return int(window)


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None, q_offset=None):
    """q [B,Sq,H,hd] bf16|f32; k/v [B,Sk,KV,hd] bf16 -> (o like q,
    lse [B,H,Sq] f32).  ``q_offset``: None, an int, or a 1-element int32
    tensor on q's device (read by the kernel, so the caller never syncs)."""
    from .build import load_library

    _check_cuda(q)
    dev = q.device
    _check("q", q, 4, (torch.bfloat16, torch.float32), dev)
    _check("k", k, 4, (torch.bfloat16,), dev)
    _check("v", v, 4, (torch.bfloat16,), dev)
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    check_gqa(h, kv)
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} has no kernel instance {HEAD_DIMS}")
    if q_offset is None or isinstance(q_offset, int):
        off = torch.tensor([q_offset or 0], dtype=torch.int32, device=dev)
    else:
        off = q_offset.reshape(-1)
        if off.numel() != 1 or off.dtype != torch.int32 or off.device != dev:
            raise ValueError("q_offset tensor must be one int32 element on "
                             f"{dev}, got {off.dtype} {tuple(off.shape)} on "
                             f"{off.device}")
    scale = scale if scale is not None else hd ** -0.5
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    if q.numel() == 0:
        return o, lse
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.repro_flash_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse), _ptr(off),
        b, sq, sk, h, kv, hd, int(causal), _window_arg(window),
        float(scale), int(q.dtype == torch.float32),
        ctypes.c_void_p(stream))
    _raise_on(code, lib, "flash_fwd")
    launches["flash_fwd"] += 1
    return o, lse


def flash_attention_decode(q, k_cache, v_cache, lengths, *,
                           window: Optional[int] = None,
                           scale: Optional[float] = None):
    """q [B,H,hd] bf16|f32 against caches [B,S,KV,hd] bf16 with per-slot
    ``lengths`` [B] int32 (valid positions, at most S) -> [B,H,hd] like
    q."""
    from .build import load_library

    _check_cuda(q)
    dev = q.device
    _check("q", q, 3, (torch.bfloat16, torch.float32), dev)
    _check("k_cache", k_cache, 4, (torch.bfloat16,), dev)
    _check("v_cache", v_cache, 4, (torch.bfloat16,), dev)
    _check("lengths", lengths, 1, (torch.int32,), dev)
    b, h, hd = q.shape
    _, s, kv, _ = k_cache.shape
    check_gqa(h, kv)
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != b
            or k_cache.shape[3] != hd or lengths.shape[0] != b):
        raise ValueError(f"caches {tuple(k_cache.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} has no kernel instance {HEAD_DIMS}")
    if h // kv > MAX_GROUP:
        raise ValueError(f"GQA group {h // kv} exceeds the decode kernel's "
                         f"{MAX_GROUP} heads per KV head")
    scale = scale if scale is not None else hd ** -0.5
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.repro_flash_decode(
        _ptr(q), _ptr(k_cache), _ptr(v_cache), _ptr(o), _ptr(lengths),
        b, s, h, kv, hd, _window_arg(window), float(scale),
        int(q.dtype == torch.float32), ctypes.c_void_p(stream))
    _raise_on(code, lib, "flash_decode")
    launches["flash_decode"] += 1
    return o
