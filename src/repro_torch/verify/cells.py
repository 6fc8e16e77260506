"""Conformance cell registry (the port's copy of ``repro.verify.cells``):
(architecture family x phase) cells small enough to solve, run and
measure on the verification mesh's 8 ranks, yet structurally faithful
(the same builders, models and steps as the dry run and the launchers).
Stdlib-only at import, like the port's ``configs``."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from ..configs.base import ArchConfig, ShapeConfig, get_arch

# the verification mesh: 8 ranks as data=4 x model=2 (repro's), gloo CPU
# processes or one card a rank; the solver's axes mirror it
# (calibration.verify_axes)
MESH_SHAPE = (4, 2)
MESH_AXES = ("data", "model")
N_DEVICES = 8


@dataclasses.dataclass(frozen=True)
class CellSpec:
    name: str          # e.g. "dense-train"
    arch: str          # registry arch id (reduced() is applied)
    family: str        # dense | moe | hybrid/ssd | xlstm
    kind: str          # train | prefill | decode
    seq_len: int = 32
    batch: int = 16

    def cfg(self) -> ArchConfig:
        return get_arch(self.arch).reduced()

    def shape(self) -> ShapeConfig:
        return ShapeConfig(f"conf_{self.kind}", self.seq_len, self.batch,
                           self.kind)


# decode/prefill cells use batch=4 < n_devices: a pure batch partition
# cannot cover the mesh, so the solved plan must shard model dims and the
# executed step issues *real* collectives; calibration then checks a
# meaningful ratio instead of 0-vs-0.
CELLS: List[CellSpec] = [
    CellSpec("dense-train", "llama3.2-3b", "dense", "train"),
    CellSpec("dense-decode", "llama3.2-3b", "dense", "decode", batch=4),
    CellSpec("gqa-prefill", "qwen2-1.5b", "dense", "prefill", batch=4),
    CellSpec("moe-train", "moonshot-v1-16b-a3b", "moe", "train"),
    CellSpec("moe-decode", "moonshot-v1-16b-a3b", "moe", "decode",
             batch=4),
    CellSpec("hybrid-train", "zamba2-2.7b", "hybrid/ssd", "train"),
    CellSpec("hybrid-decode", "zamba2-2.7b", "hybrid/ssd", "decode",
             batch=4),
    CellSpec("xlstm-train", "xlstm-125m", "xlstm", "train"),
    CellSpec("xlstm-decode", "xlstm-125m", "xlstm", "decode", batch=4),
]


def get_cells(names: Optional[Sequence[str]] = None) -> List[CellSpec]:
    if not names:
        return list(CELLS)
    by_name = {c.name: c for c in CELLS}
    missing = [n for n in names if n not in by_name]
    if missing:
        raise KeyError(f"unknown cells {missing}; known: "
                       f"{sorted(by_name)}")
    return [by_name[n] for n in names]
