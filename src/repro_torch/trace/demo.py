"""Shared autoshard demo fixture: the un-modeled plain-torch MLP used by
both the CLI smoke (``python -m repro_torch.trace``) and the trace cell
(verify/trace_cell.py), one definition, so the smoke runs exactly the
program the cell gates (the port's ``repro.trace.demo``)."""
from __future__ import annotations


def mlp_fixture(seed: int = 0, device="cpu"):
    """Returns (fn, example_args, weight_argnums) for a 3-layer tanh MLP
    in plain torch (no builder, no roles, no config), repro's shapes in
    f32, the values drawn with numpy from ``seed``."""
    import numpy as np
    import torch

    def mlp(x, w1, b1, w2, b2, w3):
        h = torch.tanh(x @ w1 + b1)
        h = torch.tanh(h @ w2 + b2)
        return h @ w3

    rng = np.random.default_rng(seed)
    shapes = [((16, 64), 1.0), ((64, 128), 0.1), ((128,), 0.1),
              ((128, 128), 0.1), ((128,), 0.1), ((128, 32), 0.1)]
    args = tuple(torch.from_numpy((rng.standard_normal(s) * k)
                                  .astype(np.float32)).to(device)
                 for s, k in shapes)
    return mlp, args, (1, 2, 3, 4, 5)
