"""Conformance & calibration (the port's ``repro.verify``).

Three pillars, each checking a different link between the tiling solver
and what actually runs:

- **differential numerics** (``numerics.py``): a solved plan's sharded
  train / prefill / decode step must compute the same numbers as the
  one-device serial program, per architecture family.
- **cost-model calibration** (``calibration.py``): the solver's predicted
  wire bytes must agree, within a declared tolerance band, with the
  collectives the executed step issues, and the solved plan must never
  measure worse than the pure-data-parallel baseline.
- **randomized graph fuzzing** (``fuzz.py``): solver invariants
  (brute-force-oracle optimality, dim/tensor permutation invariance,
  replication feasibility, sharded-vs-serial execution equality) on
  random small semantic graphs.

CLI: ``python -m repro_torch.verify``; it starts the verification mesh's
8 ranks itself (gloo CPU processes with ``--device cpu``, one card a
rank with ``--device cuda``).  The trace cell waits for the port's trace
frontend.  This package imports nothing heavy at import.
"""
