"""Checkpoints with atomic commit (counterpart of ``repro.checkpoint.ckpt``,
single device), in repro's on-disk layout.

Layout: ``<dir>/step_<N:08d>/manifest.json`` + ``arrays.npz``, written to
a tmp dir and renamed into place, so a crash mid-write never corrupts the
latest checkpoint (``latest_step`` sees only committed dirs).  Keys are
the leaf paths in JAX's flatten order (``params/layers/attn/wq``,
``opt/step``, ...); bf16 arrays are stored as f32 with ``bfloat16`` in the
manifest's dtypes.  A checkpoint written by repro restores here and the
other way round.

With a process group up (a mesh, planned or not) ``save`` is called by
every rank: it gathers each DTensor leaf whole (``full_tensor``), one
leaf at a time, rank 0 writes, and every rank waits at a barrier until
the step is committed.  ``restore(place=)``
puts each leaf straight into the restoring engine's placements (repro's
``tree_sharding_fn``), whatever mesh wrote it: the elastic restart.  The
layout on disk is the same either way."""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import tree

Tree = Dict[str, Any]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def save(directory: str, step: int, state: Tree,
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Atomic checkpoint write of a nested dict of tensors (or DTensors,
    gathered whole first).  With a process group up every rank must call
    it: the DTensor leaves are gathered one at a time, rank 0 copies each
    to the host and writes, the other ranks drop theirs, and every rank
    returns once the step is committed.  Returns the committed path."""
    from torch.distributed.tensor import DTensor
    dist = torch.distributed
    grouped = dist.is_available() and dist.is_initialized()
    writer = not grouped or dist.get_rank() == 0
    final = os.path.join(directory, f"step_{step:08d}")
    leaves = []
    for p, v in tree.flatten(state):
        # one leaf at a time: the gathered copy goes to the host on rank 0
        # and is dropped elsewhere, so no device holds the whole state
        if isinstance(v, DTensor):
            v = v.full_tensor()
        if writer:
            leaves.append((tree.key(p), v.detach().cpu()))
    try:
        if writer:
            _write(directory, final, step, leaves, extra)
    finally:
        if grouped:
            dist.barrier()
    return final


def _write(directory: str, final: str, step: int, leaves, extra) -> None:
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        arrays, dtypes = {}, {}
        for k, t in leaves:
            dtypes[k] = _dtype_name(t)
            if t.dtype == torch.bfloat16:
                t = t.float()
            arrays[k] = t.numpy()
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "keys": [k for k, _ in leaves],
            "dtypes": dtypes,
            "treedef": "nested dict, sorted keys",
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)        # atomic commit
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _committed_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(n.split("_")[1]) for n in os.listdir(directory)
        if n.startswith("step_")
        and os.path.exists(os.path.join(directory, n, "manifest.json")))


def latest_step(directory: str) -> Optional[int]:
    steps = _committed_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, like: Tree, device=None,
            place: Optional[Callable[[str, torch.Tensor], Any]] = None
            ) -> Tuple[Tree, Dict[str, Any]]:
    """Restore into the structure, shapes and dtypes of ``like`` (a tree of
    tensors, which may be on the ``meta`` device).  Each leaf lands on
    ``device``, or on its ``like`` leaf's device when ``device`` is None;
    then ``place(key, tensor)``, if given, places it (a DTensor under the
    restoring engine's plan).  Raises on a missing key or a shape that
    differs."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = [(tree.key(p), p, v) for p, v in tree.flatten(like)]
        missing = [k for k, _, _ in flat if k not in data.files]
        if missing:
            raise ValueError(
                f"checkpoint step {step} in {directory} lacks keys "
                f"{missing[:5]}{'...' if len(missing) > 5 else ''} that the "
                f"restore target expects (saved with other master_fp32 / "
                f"grad_compression flags?)")
        for k, p, leaf in flat:
            arr = data[k]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{k}: shape {arr.shape} in the checkpoint, "
                                 f"expected {tuple(leaf.shape)}")
            dev = leaf.device if device is None else torch.device(device)
            t = torch.from_numpy(np.array(arr)).to(device=dev,
                                                   dtype=leaf.dtype)
            out.append((p, t if place is None else place(k, t)))
    return tree.unflatten(out), manifest["extra"]


def gc_old(directory: str, keep: int = 3) -> None:
    """Keep the newest ``keep`` committed checkpoints."""
    for s in _committed_steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
