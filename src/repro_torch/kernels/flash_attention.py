"""ctypes wrappers of the CUDA attention kernels (``csrc/flash_fwd.cu``,
``csrc/flash_fwd_f32.cu``, ``csrc/flash_bwd.cu``, ``csrc/flash_bwd_f32.cu``,
``csrc/flash_decode.cu``, ``csrc/flash_paged_decode.cu``).

Each wrapper checks what the kernel takes (device, dtype, shape,
contiguity, alignment, head dim) and raises on anything else, allocates
its outputs with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch returned an error, and counts the
launch in ``launches``.  They take CUDA tensors only: ``kernels/ops.py``
sends CPU tensors to the plain versions in ``kernels/ref.py``."""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .ref import check_gqa

HEAD_DIMS = (16, 64, 80, 120, 128)
MAX_GROUP = 16            # decode: query heads per KV head (16 mma rows)
TILE = 64                 # q rows / keys per tile (flash_fwd.cu, flash_bwd.cu)
DEC_MAX_SPLITS = 64       # decode: splits per row (csrc/flash_decode.cuh)

# launches per kernel since the last reset_launches(); a plain integer
# each, read by chip_smoke.py to show the main path ran the kernels
launches: Dict[str, int] = {"flash_fwd": 0, "flash_fwd_f32": 0,
                             "flash_decode": 0, "flash_paged_decode": 0,
                             "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                             "flash_bwd_dq_f32": 0, "flash_bwd_dkv_f32": 0}
# of the forward's launches, those given a q_offset (serving's prefill
# chunks at a cache offset), per forward kernel
offset_launches: Dict[str, int] = {"flash_fwd": 0, "flash_fwd_f32": 0}


def reset_launches() -> None:
    for counts in (launches, offset_launches):
        for name in counts:
            counts[name] = 0


def _ptr(t: Optional[torch.Tensor]) -> Optional[ctypes.c_void_p]:
    return None if t is None else ctypes.c_void_p(t.data_ptr())


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


def offset_arg(q_offset, device: torch.device
               ) -> Tuple[Optional[torch.Tensor], int]:
    """(device tensor or None, value) for the forward kernel's offset.  An
    int or None is passed by value and builds no tensor: a host-to-device
    copy of a pageable tensor would make the host wait for the stream on
    every launch.  A tensor must be one int32 element on ``device``."""
    if q_offset is None or isinstance(q_offset, int):
        return None, int(q_offset or 0)
    off = q_offset.reshape(-1)
    if off.numel() != 1 or off.dtype != torch.int32 or off.device != device:
        raise ValueError("q_offset tensor must be one int32 element on "
                         f"{device}, got {off.dtype} {tuple(off.shape)} on "
                         f"{off.device}")
    return off, 0


def _check_qkv(q, k, v) -> Tuple[int, int, int, int, int, int]:
    """Device, dtype, shape and head-dim checks shared by the forward and
    the backward; -> (b, sq, sk, h, kv, hd)."""
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
    return b, sq, sk, h, kv, hd


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None, q_offset=None):
    """q [B,Sq,H,hd] bf16|f32; k/v [B,Sk,KV,hd] bf16 -> (o like q,
    lse [B,H,Sq] f32).  ``q_offset``: None, an int (passed by value), or
    a 1-element int32 tensor on q's device (read by the kernel, so the
    caller never syncs).  bf16 queries take the wgmma kernel
    (``flash_fwd``), f32 ones the f32 kernel (``flash_fwd_f32``)."""
    from .build import load_library

    _check_cuda(q)
    dev = q.device
    b, sq, sk, h, kv, hd = _check_qkv(q, k, v)
    off, off_value = offset_arg(q_offset, dev)
    scale = scale if scale is not None else hd ** -0.5
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    if q.numel() == 0:
        return o, lse
    lib = load_library()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    args = [_ptr(t) for t in (q, k, v, o, lse)] + [
        _ptr(off), off_value, b, sq, sk, h, kv, hd,
        int(causal), _window_arg(window), float(scale)]
    name = "flash_fwd_f32" if q.dtype == torch.float32 else "flash_fwd"
    code = getattr(lib, "repro_" + name)(*args, stream)
    _raise_on(code, lib, name)
    launches[name] += 1
    if q_offset is not None:
        offset_launches[name] += 1
    return o, lse


def _check_bwd(q, k, v, lse, do, o=None):
    _check_cuda(q)
    dev = q.device
    b, sq, sk, h, kv, hd = _check_qkv(q, k, v)
    for name, t in (("o", o), ("do", do)):
        if t is None:
            continue
        _check(name, t, 4, (q.dtype,), dev)
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)}")
    _check("lse", lse, 3, (torch.float32,), dev)
    if tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"lse {tuple(lse.shape)}, expected {(b, h, sq)}")
    return b, sq, sk, h, kv, hd


def _bwd_args(q, b, sq, sk, h, kv, hd, causal, window, scale):
    scale = scale if scale is not None else hd ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return (b, sq, sk, h, kv, hd, int(causal), _window_arg(window),
            float(scale), ctypes.c_void_p(stream))


def flash_attention_bwd_dq(q, k, v, o, lse, do, *, causal: bool = True,
                           window: Optional[int] = None,
                           scale: Optional[float] = None):
    """The dq kernel: -> (dq like q, delta [B,H,S] f32 = rowsum(o * do)).
    Shapes and dtypes as flash_attention_bwd; bf16 queries take the
    wgmma kernel (``flash_bwd_dq``), f32 ones the f32 kernel
    (``flash_bwd_dq_f32``)."""
    from .build import load_library

    b, sq, sk, h, kv, hd = _check_bwd(q, k, v, lse, do, o)
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), delta.zero_()
    lib = load_library()
    name = "flash_bwd_dq_f32" if q.dtype == torch.float32 else "flash_bwd_dq"
    code = getattr(lib, "repro_" + name)(
        _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(do), _ptr(lse),
        _ptr(delta), _ptr(dq),
        *_bwd_args(q, b, sq, sk, h, kv, hd, causal, window, scale))
    _raise_on(code, lib, name)
    launches[name] += 1
    return dq, delta


def dkv_split(b: int, sk: int, kv: int, g: int, sms: int) -> int:
    """Blocks per group of g query heads in the dk/dv kernel: the least
    divisor of g that fills every SM with the two blocks it holds at a
    time, else g.  A larger split writes and reads more f32 partials: at
    qwen2's shape (128 key-tile blocks, g 6) splits 1 / 2 / 3 / 6 took
    0.2917 / 0.2283 / 0.1919 / 0.2323 ms on an H100 80GB HBM3 at 700 W
    (``chip_smoke.py`` phase 5 times every split)."""
    blocks = -(-sk // TILE) * kv * b
    for d in range(1, g + 1):
        if g % d == 0 and blocks * d >= 2 * sms:
            return d
    return g


def flash_attention_bwd_dkv(q, k, v, lse, delta, do, *, causal: bool = True,
                            window: Optional[int] = None,
                            scale: Optional[float] = None,
                            split: Optional[int] = None):
    """The dk/dv kernel, summing over each KV head's g query heads inside
    the kernel: -> (dk, dv like k).  ``delta`` as flash_attention_bwd_dq
    returns it.  bf16 queries take the wgmma kernel (``flash_bwd_dkv``),
    where ``split`` (a divisor of g; by default ``dkv_split``) is the
    number of blocks that share a group's heads; their f32 partials are
    summed in a fixed order, so the bits depend on it and on nothing else.
    f32 queries take the f32 kernel (``flash_bwd_dkv_f32``), one block
    per key tile and group (``split`` None or 1)."""
    from .build import load_library

    b, sq, sk, h, kv, hd = _check_bwd(q, k, v, lse, do)
    _check("delta", delta, 3, (torch.float32,), q.device)
    if delta.shape != lse.shape:
        raise ValueError(f"delta {tuple(delta.shape)} does not match lse "
                         f"{tuple(lse.shape)}")
    g = h // kv
    f32 = q.dtype == torch.float32
    if split is None:
        split = 1 if f32 else dkv_split(
            b, sk, kv, g,
            torch.cuda.get_device_properties(q.device).multi_processor_count)
    if split < 1 or g % split or (f32 and split != 1):
        raise ValueError(f"split {split} does not divide the group {g}"
                         + (" (f32 queries take 1)" if f32 else ""))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dk.zero_(), dv.zero_()
    groups = -(-sk // TILE) * kv * b
    partial = arrived = None
    if split > 1:
        partial = torch.empty((groups * split, 128 * hd), dtype=torch.float32,
                              device=q.device)
        arrived = torch.zeros(groups, dtype=torch.int32, device=q.device)
    lib = load_library()
    args = _bwd_args(q, b, sq, sk, h, kv, hd, causal, window, scale)
    ptrs = [_ptr(t) for t in (q, k, v, do, lse, delta, dk, dv)]
    if f32:
        name = "flash_bwd_dkv_f32"
        code = lib.repro_flash_bwd_dkv_f32(*ptrs, *args)
    else:
        name = "flash_bwd_dkv"
        code = lib.repro_flash_bwd_dkv(
            *ptrs, _ptr(partial), _ptr(arrived), *args[:6], split,
            *args[6:])
    _raise_on(code, lib, name)
    launches[name] += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """Gradients of ``flash_attention_fwd`` at no offset: q/o/do
    [B,S,H,hd] of one dtype (bf16|f32), k/v [B,Sk,KV,hd] bf16, lse
    [B,H,S] f32 from the forward -> (dq like q, dk, dv like k).  Two
    launches on the current stream: dq, which also writes delta =
    rowsum(o * do), then dk/dv, which reads it."""
    kw = dict(causal=causal, window=window, scale=scale)
    dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, lse, delta, do, **kw)
    return dq, dk, dv


DEC_SPLIT = 128           # decode: positions per block (PERF.md, the sweep)


def decode_split(positions: int) -> int:
    """Key positions per block of the decode kernels: DEC_SPLIT, doubled
    until no row has more than DEC_MAX_SPLITS splits.  From the position
    count alone: the lengths live on the device (reading them would make
    the host wait for the stream), and a split that followed the batch
    size would give a row other bits in a 16-row draft step than in a
    64-row verify re-score, and speculative decoding would accept fewer
    drafts.  ``positions`` is S for the slot cache and MB x BL for the
    pools, so the pools and their gathered view get the same split (and
    the same bits)."""
    split = DEC_SPLIT
    while -(-positions // split) > DEC_MAX_SPLITS:
        split *= 2
    return split


def decode_positions(k: torch.Tensor,
                     table: Optional[torch.Tensor] = None) -> int:
    """Key positions a decode launch covers, from which its split is
    chosen: S of the caches ``k`` [B,S,KV,hd], or MB x BL of the pools
    ``k`` [NB,BL,KV,hd] read through ``table`` [B,MB]."""
    return k.shape[1] * (1 if table is None else table.shape[1])


# per (device, stream): the decode kernels' arrival counters, one int per
# (row, KV head), zero between launches (the merging block resets its
# own).  Launches on one stream run in turn; two streams never share
# counters, so their launches may overlap.
_dec_arrived: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _decode_scratch(dev: torch.device, stream: int, b: int, kv: int, g: int,
                    hd: int, positions: int, split: Optional[int]):
    """-> (split, f32 partials or None, counters or None) for a decode
    launch on ``stream`` over ``positions`` key positions.  One split per
    row needs neither; the counters are allocated (zeroed) once per device
    and stream and grown, never cleared per call."""
    if split is None:
        split = decode_split(positions)
    nsplit = max(1, -(-positions // split))
    if split < TILE or split % TILE or nsplit > DEC_MAX_SPLITS:
        raise ValueError(f"split {split} must be a positive multiple of "
                         f"{TILE} giving at most {DEC_MAX_SPLITS} splits of "
                         f"{positions} positions")
    if nsplit == 1:
        return split, None, None
    arrived = _dec_arrived.get((dev, stream))
    if arrived is None or arrived.numel() < b * kv:
        arrived = _dec_arrived[dev, stream] = torch.zeros(
            max(b * kv, 256), dtype=torch.int32, device=dev)
    rec = -(-g * (hd + 2) // 4) * 4    # csrc/flash_decode.cuh::dec_record
    part = torch.empty((b * kv * nsplit, rec), dtype=torch.float32,
                       device=dev)
    return split, part, arrived


def flash_attention_decode(q, k_cache, v_cache, lengths, *,
                           window: Optional[int] = None,
                           scale: Optional[float] = None,
                           split: Optional[int] = None):
    """q [B,H,hd] bf16|f32 against caches [B,S,KV,hd] bf16 with per-slot
    ``lengths`` [B] int32 (valid positions, at most S) -> [B,H,hd] like
    q.  ``split``: key positions per block (a multiple of 64; by default
    ``decode_split``); the bits depend on it and on nothing else."""
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    split, part, arrived = _decode_scratch(
        dev, stream, b, kv, h // kv, hd, decode_positions(k_cache), split)
    lib = load_library()
    code = lib.repro_flash_decode(
        _ptr(q), _ptr(k_cache), _ptr(v_cache), _ptr(o), _ptr(lengths),
        _ptr(part), _ptr(arrived), b, s, h, kv, hd, _window_arg(window),
        split, float(scale), int(q.dtype == torch.float32),
        ctypes.c_void_p(stream))
    _raise_on(code, lib, "flash_decode")
    launches["flash_decode"] += 1
    return o


def flash_attention_paged_decode(q, k_pool, v_pool, table, lengths, *,
                                 scale: Optional[float] = None,
                                 split: Optional[int] = None):
    """q [B,H,hd] bf16|f32 against block pools [NB,BL,KV,hd] bf16 through
    the block ``table`` [B,MB] int32, with per-row ``lengths`` [B] int32
    (valid positions) -> [B,H,hd] like q.  Any block length BL >= 1 is
    taken.  The table's entries must lie in [0, NB) (the host allocator
    hands out nothing else).  A length above MB*BL is clamped to MB*BL in
    the kernel, as ``flash_attention_decode`` clamps to S: checking it
    here would make the host wait for the stream on every launch.
    ``split`` as for ``flash_attention_decode``, over MB*BL positions:
    at the same split the result is bit-equal to ``flash_attention_decode``
    on the gathered view [B, MB*BL, KV, hd]."""
    from .build import load_library

    _check_cuda(q)
    dev = q.device
    _check("q", q, 3, (torch.bfloat16, torch.float32), dev)
    _check("k_pool", k_pool, 4, (torch.bfloat16,), dev)
    _check("v_pool", v_pool, 4, (torch.bfloat16,), dev)
    _check("table", table, 2, (torch.int32,), dev)
    _check("lengths", lengths, 1, (torch.int32,), dev)
    b, h, hd = q.shape
    _, bl, kv, _ = k_pool.shape
    mb = table.shape[1]
    check_gqa(h, kv)
    if (k_pool.shape != v_pool.shape or k_pool.shape[3] != hd
            or table.shape[0] != b or lengths.shape[0] != b):
        raise ValueError(f"pools {tuple(k_pool.shape)} / table "
                         f"{tuple(table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} has no kernel instance {HEAD_DIMS}")
    if h // kv > MAX_GROUP:
        raise ValueError(f"GQA group {h // kv} exceeds the decode kernel's "
                         f"{MAX_GROUP} heads per KV head")
    if bl < 1 or mb < 1:
        raise ValueError(f"pool blocks of {bl} rows and a table of {mb} "
                         "blocks per row; the kernel takes >= 1 of each")
    scale = scale if scale is not None else hd ** -0.5
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    stream = torch.cuda.current_stream(dev).cuda_stream
    split, part, arrived = _decode_scratch(
        dev, stream, b, kv, h // kv, hd, decode_positions(k_pool, table),
        split)
    lib = load_library()
    code = lib.repro_flash_paged_decode(
        _ptr(q), _ptr(k_pool), _ptr(v_pool), _ptr(o), _ptr(table),
        _ptr(lengths), _ptr(part), _ptr(arrived), b, mb, bl, h, kv, hd,
        split, float(scale), int(q.dtype == torch.float32),
        ctypes.c_void_p(stream))
    _raise_on(code, lib, "flash_paged_decode")
    launches["flash_paged_decode"] += 1
    return o
