"""Tiling algebra (paper §4.1, §4.2.1).

A *tiling* of a tensor along one cut is either:
  - ``Part(dim_name)`` — even partition along the named dimension
    (the paper's R / C, generalized to named dims), or
  - ``REPLICATE``      — full replication (the paper's ``r``), or
  - ``REDUCED``        — the pseudo-tiling ``red``: every device holds a
    full-shape *partial sum* awaiting reduction.  ``red`` only appears as
    the output of a contraction-partitioned einsum; it is never assigned
    to a stored tensor (the solver always converts it away, Eq. 2).

A *k-cut tiling* is a tuple of per-cut tilings, one per mesh axis, applied
outermost (slowest interconnect) first — the paper's tiling composition.
Theorem 2 (flattening) lets us treat the composition as a multiset of
(dim → number-of-cuts) assignments; we exploit that when converting to
``PartitionSpec`` in plan.py.

Conversion costs (total bytes on the wire across the whole cut group of
arity A, ring collectives; exact match with the paper's A=2 costs):

  t1 == t2                      : 0
  r  -> anything                : 0            (local slice)
  P(i) -> P(j), i != j          : s·(A-1)/A    (all-to-all; paper Fig.7: s/2)
  P  -> r                       : s·(A-1)      (all-gather;  paper: s)
  red -> P                      : s·(A-1)      (reduce-scatter; paper: s)
  red -> r                      : 2·s·(A-1)    (all-reduce;  paper: 2s)

where s = bytes of the *full* tensor at the current recursion level (i.e.
already divided by all previous cuts).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union


class _Singleton:
    __slots__ = ("_name",)

    def __init__(self, name: str):
        self._name = name

    def __repr__(self) -> str:
        return self._name

    def __deepcopy__(self, memo):  # singletons stay singletons
        return self

    def __copy__(self):
        return self

    def __reduce__(self):
        # Pickle to the module-level singleton so identity checks
        # (``t is REPLICATE``) survive a round-trip into worker processes
        # (the parallel brute-force oracle ships Graphs across processes).
        return (_lookup_singleton, (self._name,))


def _lookup_singleton(name: str) -> "_Singleton":
    return {"r": REPLICATE, "red": REDUCED}[name]


REPLICATE = _Singleton("r")
REDUCED = _Singleton("red")


@dataclasses.dataclass(frozen=True)
class Part:
    """Partition along the named dimension."""

    dim: str

    def __repr__(self) -> str:
        return f"P({self.dim})"


Tiling = Union[Part, _Singleton]
# A composed tiling: one entry per cut (mesh axis), outermost first.
CutVector = Tuple[Tiling, ...]


def is_part(t: Tiling) -> bool:
    return isinstance(t, Part)


def conversion_cost(src: Tiling, dst: Tiling, nbytes: float, arity: int) -> float:
    """Total wire bytes to convert ``src`` tiling into ``dst`` across one
    cut group of ``arity`` devices/groups.  ``nbytes`` is the full tensor
    size in bytes at the current recursion level."""
    if arity <= 1:
        return 0.0
    a = float(arity)
    if src is REDUCED:
        if dst is REDUCED:
            return 0.0
        if dst is REPLICATE:
            return 2.0 * nbytes * (a - 1.0)  # all-reduce (ring)
        return nbytes * (a - 1.0)  # reduce-scatter
    if dst is REDUCED:
        # A stored tensor can never be converted *into* a pending reduction.
        return float("inf")
    if src == dst:
        return 0.0
    if src is REPLICATE:
        return 0.0  # local slicing
    if dst is REPLICATE:
        return nbytes * (a - 1.0)  # all-gather
    # partitioned -> partitioned along a different dim: re-shard
    return nbytes * (a - 1.0) / a


def conversion_kind(src: Tiling, dst: Tiling):
    """The ring collective a (priced) conversion lowers to, named as in
    compiled HLO (analysis/hlo.py), or None for free/identity moves.
    Infeasible conversions (stored -> red) also return None — their cost
    is inf and no collective exists for them."""
    if src is REDUCED:
        if dst is REDUCED:
            return None
        return "all-reduce" if dst is REPLICATE else "reduce-scatter"
    if dst is REDUCED or src == dst or src is REPLICATE:
        return None
    if dst is REPLICATE:
        return "all-gather"
    return "all-to-all"


def paper_naive_conversion_cost(src: Tiling, dst: Tiling, nbytes: float,
                                arity: int) -> float:
    """The paper's §2.2 *illustrative* parameter-server accounting:
    an aggregate+broadcast of a tensor across n workers costs s·n·2 (each
    worker ships its copy to the PS and receives the result), a gather
    costs s·n.  Used only for reproducing the paper's §2.2 numbers; the
    solver optimizes :func:`conversion_cost`."""
    if arity <= 1:
        return 0.0
    a = float(arity)
    if src is REDUCED:
        if dst is REDUCED:
            return 0.0
        return 2.0 * nbytes * a if dst is REPLICATE else nbytes * a
    if dst is REDUCED:
        return float("inf")
    if src == dst or src is REPLICATE:
        return 0.0
    if dst is REPLICATE:
        return nbytes * a
    # partitioned -> partitioned via central reorganization (PS-style)
    return nbytes * a
