"""repro's trace cell families leg (``repro.verify.trace_cell``) on the
installed JAX, for a like-for-like reference to the port's trace cell.

repro's capture reads ``jax.core.Literal`` (and its siblings), which JAX
0.9 moved to ``jax.extend.core``, and has its handler for the pjit
primitive, which JAX 0.9 names ``jit``, under the old name; this script
points the old names at the new ones before it captures, and changes
nothing of ``src/repro``.
For each family (dense, moe, xlstm) it captures repro's reduced forward,
solves it on the verification axes at the cell's beam, and prints one
JSON line: the op count, the traced and builder solved bytes, their
ratio, and the traced solution's bytes by kind and by mesh axis.

  PYTHONPATH=src JAX_PLATFORMS=cpu \\
      python experiments/conformance/repro_trace_families.py
"""
import json

import jax.core as jc
import jax.extend.core as jec

for _name in ("Literal", "Var", "ClosedJaxpr", "Jaxpr", "JaxprEqn",
              "DropVar"):
    if not hasattr(jc, _name) and hasattr(jec, _name):
        setattr(jc, _name, getattr(jec, _name))


def _jit_as_pjit() -> None:
    # JAX 0.9 names the pjit primitive "jit": without this repro's capture
    # finds no handler for it and lowers every jitted call (jnp.where,
    # jnp.cumsum, ...) by its fallback
    import importlib
    cls = importlib.import_module("repro.trace.capture")._Capture
    if not hasattr(cls, "_p_jit"):
        cls._p_jit = cls._p_pjit


def main() -> None:
    import jax

    from repro.configs import get_arch
    from repro.core.builders import build_graph
    from repro.core.solver import solution_breakdown, solve_mesh
    from repro.configs.base import ShapeConfig
    from repro.models.model import LM
    from repro.trace import capture
    from repro.verify import trace_cell
    from repro.verify.calibration import verify_axes

    _jit_as_pjit()
    axes = verify_axes()
    for family, arch in trace_cell.TRACE_FAMILIES:
        cfg = get_arch(arch).reduced()
        model = LM(cfg)
        key = jax.random.PRNGKey(0)
        params = model.init(key)
        toks = jax.random.randint(key, (trace_cell.BATCH, trace_cell.SEQ),
                                  0, cfg.vocab)
        traced = capture(lambda p, t: model.forward(p, t)[0], params, toks,
                         weight_argnums=(0,), name=arch)
        tsol = solve_mesh(traced.graph, axes, beam=trace_cell.TRACE_BEAM)
        bsol = solve_mesh(build_graph(cfg, ShapeConfig(
            "tr", trace_cell.SEQ, trace_cell.BATCH, "prefill")), axes)
        bd = solution_breakdown(traced.graph, tsol.axes, tsol.per_axis)
        print(json.dumps({
            "family": family, "arch": arch, "ops": len(traced.graph.ops),
            "traced_bytes": tsol.total_bytes,
            "builder_bytes": bsol.total_bytes,
            "ratio": tsol.total_bytes / max(bsol.total_bytes, 1.0),
            "unknown_primitives": traced.unknown_primitives,
            "by_kind": bd["by_kind"], "by_axis": bd["by_axis"]}),
            flush=True)


if __name__ == "__main__":
    main()
