"""Error-feedback int8 gradient compression (counterpart of
``repro.optim.compression``) on nested dicts of tensors.

Gradients are quantized to int8 with an f32 scale, and the quantization
residual is carried into the next step's gradient.  ``compress_bucketed``
shares one scale per bucket of leaves.  The buckets follow the leaf order,
and that order is JAX's sorted-key flatten order (``repro_torch.tree``),
not the params dicts' insertion order: a different order gives different
buckets, hence different scales and a different trajectory.  Rounding is
half to even in both ``jnp.round`` and ``torch.round``."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import tree
from ..models.common import local
from ..models.sharding import like_placed

Tree = Dict[str, Any]


def init_error(params: Tree) -> Tree:
    return tree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 values, f32 scale); symmetric per-tensor scaling."""
    g32 = g.float()
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def bucket_slices(nbytes: List[float], n_buckets: int) -> List[List[int]]:
    """Split leaf indices into <= n_buckets contiguous groups balanced by
    byte volume, order preserved (repro's rule, copied)."""
    n_buckets = max(1, min(n_buckets, len(nbytes)))
    total = float(sum(nbytes)) or 1.0
    target = total / n_buckets
    out: List[List[int]] = []
    cur: List[int] = []
    acc = 0.0
    for i, b in enumerate(nbytes):
        cur.append(i)
        acc += b
        if len(out) < n_buckets - 1 and acc >= target * (len(out) + 1):
            out.append(cur)
            cur = []
    if cur:
        out.append(cur)
    return out


def _peak(t) -> torch.Tensor:
    lt = local(t)
    if not lt.numel():                     # an empty shard of an uneven cut
        return torch.zeros((), dtype=lt.dtype, device=lt.device)
    return lt.abs().max()


def compress_bucketed(grads: Tree, errors: Tree, n_buckets: int,
                      on_wire: Optional[Callable[[int, torch.Tensor],
                                                 torch.Tensor]] = None
                      ) -> Tuple[Tree, Tree]:
    """Error-feedback int8 with one f32 scale per bucket.  ``on_wire(i,
    q_int8)`` sees each leaf's int8 values between quantize and
    dequantize, where a collective would carry them.  Returns (dequantized
    f32 grads, new error tree).

    DTensor leaves (grads and errors in the same placements, every pending
    sum already reduced in f32: an int8 sum would overflow) are quantized
    shard by shard; the bucket's scale is the max over every rank's
    shards, one all-reduce a bucket.  ``on_wire`` may move the int8
    DTensor into other placements (the engine's reshard into the
    optimizer state's layout): the dequantized grad comes out in those,
    the new error stays in the errors' placements."""
    from torch.distributed.tensor import DTensor
    flat_g = tree.flatten(grads)
    flat_e = tree.leaves(errors)
    sharded = any(isinstance(g, DTensor) for _, g in flat_g)
    buckets = bucket_slices([g.numel() * 4 for _, g in flat_g], n_buckets)
    out: List[Any] = [None] * len(flat_g)
    new_e: List[Any] = [None] * len(flat_g)
    for idxs in buckets:
        corrected = {i: flat_g[i][1].float() + flat_e[i] for i in idxs}
        peaks = torch.stack([_peak(corrected[i]) for i in idxs])
        if sharded:
            torch.distributed.all_reduce(peaks,
                                         op=torch.distributed.ReduceOp.MAX)
        scale = torch.clamp(peaks.max(), min=1e-12) / 127.0
        for i in idxs:
            c = local(corrected[i])
            q = torch.clamp(torch.round(c / scale), -127, 127).to(torch.int8)
            new_e[i] = like_placed(c - q.float() * scale, corrected[i])
            wire = like_placed(q, corrected[i])
            if on_wire is not None:
                wire = on_wire(i, wire)
            out[i] = like_placed(local(wire).float() * scale, wire)
    paths = [p for p, _ in flat_g]
    return (tree.unflatten(list(zip(paths, out))),
            tree.unflatten(list(zip(paths, new_e))))
