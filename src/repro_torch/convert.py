"""Weights from repro's JAX param tree into the port's params.

Both packages keep weights ``[in, out]`` with the same keys, so the
conversion is a copy.  ``np.asarray`` of a JAX bf16 array is an
``ml_dtypes.bfloat16`` array, which ``torch.from_numpy`` rejects; it goes
through float32 and back to bfloat16, which is exact.  The caller does
the ``np.asarray`` (the port imports no JAX)."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .configs.base import ArchConfig
from .models.common import resolve_device
from .models.model import LM


def _leaf(arr: Any, shape, dtype: torch.dtype, where: str,
          device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{where}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{where}: dtype {t.dtype}, expected {dtype}")
    return t.to(device)


def params_from_jax(np_tree: Dict[str, Any], cfg: ArchConfig,
                    device="cuda") -> Dict[str, Any]:
    """Nested dict of numpy arrays (repro's ``LM(cfg).init`` tree) -> the
    port's params on ``device``, value for value.  Raises on a missing or
    extra key, a shape or a dtype that ``LM(cfg)`` does not expect."""
    dev = resolve_device(device)

    def walk(tree, spec, where):
        if set(tree) != set(spec):
            raise KeyError(f"{where or 'params'}: keys {sorted(tree)}, "
                           f"expected {sorted(spec)}")
        out = {}
        for k, s in spec.items():
            w = f"{where}.{k}" if where else k
            out[k] = (walk(tree[k], s, w) if isinstance(s, dict)
                      else _leaf(tree[k], s[0], s[1], w, dev))
        return out

    return walk(np_tree, LM(cfg).param_shapes(), "")
