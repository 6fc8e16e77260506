"""Automatic frontend: FX capture -> named-dims IR -> solved placements
and a DTensor-placed callable (the port's ``repro.trace``)."""
from .autoshard import AutoShard, autoshard
from .capture import DimTable, Traced, capture

__all__ = ["AutoShard", "autoshard", "capture", "Traced", "DimTable"]
