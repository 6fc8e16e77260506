"""Training-step calibration projection (the port's copy of
``repro.verify.train_cell.train_faithful_assignments``).

The trainer places optimizer moments and f32 masters with exactly their
solved tilings, while its grad sync brings each weight gradient whole
(an all-reduce, then a local slice into the state's layout), so the
as-executed prediction prices weight gradients replicated and everything
else as solved.  Stdlib-only at import.
"""
from __future__ import annotations

from typing import List, Sequence

from ..core.tiling import REPLICATE


def train_faithful_assignments(g, per_axis: Sequence[dict]) -> List[dict]:
    """The solved per-axis assignments with every weight-gradient tensor
    replicated (its reduction is an all-reduce; the slice into the state
    layout is local); the ``.opt`` / ``.master`` / ``.err`` state
    tensors and the rest as solved."""
    out = []
    for assign in per_axis:
        a = dict(assign)
        for name, ts in g.tensors.items():
            if ts.kind != "grad":
                continue
            base = name[2:].split("#")[0].split(".sum")[0]
            if base in g.tensors and g.tensors[base].kind == "weight":
                a[name] = REPLICATE
        out.append(a)
    return out
