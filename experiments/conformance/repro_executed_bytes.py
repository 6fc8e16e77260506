"""repro's conformance cells: the wire bytes its compiled step issues as
counted (each collective of the HLO text once, ``repro.analysis.hlo``)
and as executed (a collective inside a ``while`` body counted once per
iteration, by the loop's known trip count).

repro's ``verify`` prices the collectives of the compiled SPMD program's
text, where the layer scan is a ``while`` loop: the gradient all-reduce
that the backward issues once a layer appears once.  The port's
``analysis/comm.record`` counts what a step dispatches, once a layer.
This script puts both of repro's numbers side by side, so the port's
measured bytes (``python -m repro_torch.verify --device cpu``) have a
like-for-like reference.

  PYTHONPATH=src python experiments/conformance/repro_executed_bytes.py \\
      --cells dense-train,dense-decode,xlstm-decode

It runs repro (JAX) on the CPU with 8 forced host devices, solves each
cell as repro's calibration does and prints one JSON line a cell:
counted and executed system-wide wire bytes, by collective kind, and the
executed collectives per kind.  Nothing of the port is imported.
"""
from repro.hostdev import force_host_devices

force_host_devices(8)

import argparse  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402

_HEAD = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_WHILE = re.compile(r"while\(.*?condition=%?([\w.\-]+),\s*body=%?([\w.\-]+)")
_TRIP = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_CALLS = re.compile(r"(?:calls|to_apply|branch_computations|"
                    r"called_computations)=\{?([%\w.\-, ]+)\}?")


def computations(text: str):
    """{name: body text} and the entry computation's name."""
    comps, entry, cur, lines = {}, None, None, []
    for line in text.splitlines():
        if not line.startswith(" ") and line.rstrip().endswith("{"):
            m = _HEAD.match(line.strip())
            if m:
                cur, lines = m.group(1), []
                if line.startswith("ENTRY"):
                    entry = cur
                continue
        if line.startswith("}") and cur is not None:
            comps[cur] = "\n".join(lines)
            cur = None
            continue
        if cur is not None:
            lines.append(line)
    return comps, entry


def multipliers(comps, entry):
    """Executions of each computation per step: a while body runs its
    known trip count per execution of its caller, anything else called
    once."""
    edges = {c: [] for c in comps}
    for c, body in comps.items():
        for line in body.splitlines():
            w = _WHILE.search(line)
            if w:
                t = _TRIP.search(line)
                n = int(t.group(1)) if t else 1
                edges[c].append((w.group(2), n))
                edges[c].append((w.group(1), n + 1))
                continue
            for m in _CALLS.finditer(line):
                for callee in m.group(1).replace("%", "").split(","):
                    callee = callee.strip()
                    if callee in comps:
                        edges[c].append((callee, 1))
    mult = {c: 0 for c in comps}
    mult[entry] = 1

    def visit(c, k):
        for callee, n in edges[c]:
            mult[callee] += k * n
            visit(callee, k * n)
    visit(entry, 1)
    return mult


def cell_bytes(spec):
    from repro.analysis import hlo
    from repro.compat import make_compat_mesh
    from repro.core.builders import build_graph
    from repro.core.plan import ShardingPlan
    from repro.core.solver import TilingSolution, solve_mesh
    from repro.launch.compile import (compile_step, input_specs,
                                      normalize_moe_plan)
    from repro.verify import calibration as C
    from repro.verify.cells import MESH_AXES, MESH_SHAPE, N_DEVICES

    cfg, shape = spec.cfg(), spec.shape()
    axes = C.verify_axes()
    g = build_graph(cfg, shape)
    sol = solve_mesh(g, axes, fixed_per_axis=C._moe_pins(g, cfg, axes))
    ex = C.faithful_assignments(g, sol.per_axis)
    plan = normalize_moe_plan(ShardingPlan.from_graph_solution(
        TilingSolution(list(axes), ex, [0.0] * len(axes), 0.0, 0.0), g),
        cfg)
    mesh = make_compat_mesh(MESH_SHAPE, MESH_AXES)
    compiled, _, _ = compile_step(cfg, shape, plan, mesh,
                                  input_specs(cfg, shape))
    text = compiled.as_text()
    comps, entry = computations(text)
    mult = multipliers(comps, entry)
    counted = hlo.collect(text, N_DEVICES)
    executed, counts = {}, {}
    for c, body in comps.items():
        if not mult.get(c):
            continue
        st = hlo.collect(body, N_DEVICES)
        for k, v in st.wire_by_kind.items():
            executed[k] = executed.get(k, 0.0) + v * mult[c] * N_DEVICES
        for k, v in st.counts.items():
            counts[k] = counts.get(k, 0) + v * mult[c]
    return {
        "cell": spec.name,
        "counted_total": counted.wire_bytes_per_device * N_DEVICES,
        "counted_by_kind": {k: v * N_DEVICES
                            for k, v in counted.wire_by_kind.items()},
        "counted_counts": counted.counts,
        "executed_total": sum(executed.values()),
        "executed_by_kind": executed,
        "executed_counts": counts,
        "loops": {c: m for c, m in mult.items() if m > 1
                  and any(k in comps[c] for k in ("all-reduce(",
                                                  "all-gather(",
                                                  "all-to-all(",
                                                  "reduce-scatter(",
                                                  "collective-permute("))},
    }


def main():
    from repro.verify.cells import get_cells
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="dense-train,dense-decode,"
                                       "xlstm-decode")
    args = ap.parse_args()
    for spec in get_cells(args.cells.split(",")):
        print(json.dumps(cell_bytes(spec)), flush=True)


if __name__ == "__main__":
    main()
