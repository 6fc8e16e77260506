"""Conformance & calibration CLI (the port's ``python -m repro.verify``).

Usage:
  python -m repro_torch.verify --device cpu          # all cells + fuzz 25
  python -m repro_torch.verify --device cpu --cells dense-train,xlstm-decode
  python -m repro_torch.verify --device cpu --fuzz 200
  python -m repro_torch.verify --device cpu --no-cells --fuzz 500
  python -m repro_torch.verify --device cpu --json   # report to stdout
  python -m repro_torch.verify --list                # known cells

The verification mesh is 8 ranks as data=4 x model=2, which this command
starts itself (``launch/mesh.spawn``): ``--device cpu`` runs them as gloo
CPU processes (repro's 8 forced host devices), ``--device cuda`` (the
default) as one card a rank over NCCL, and stops with an error on a
machine with fewer than 8 cards; it never falls back to the CPU.  The
compute cell traces on torch's fake process group in this process before
the ranks start; the fuzz's execution mesh is ``(4,)`` "fz" on the first
4 ranks.  Rank 0 writes the report to --out (default
experiments/conformance/CONFORMANCE_torch.json) and the command exits
non-zero when any gate fails.  The trace cell (verify/trace_cell.py)
runs on every rank: its families leg captures and solves in each, its
MLP leg runs ``autoshard`` on the verification mesh.
"""
import argparse
import json
import os
import sys
import tempfile
import time

# the pseudo-cells, in the order a run takes them (repro's)
PSEUDO = ("serve", "serve-paged", "train-engine", "pipeline", "compute",
          "trace")
FUZZ_RANKS = 4


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.verify",
        description="verify solver plans against executed numerics and "
                    "the collectives the executed steps issue")
    ap.add_argument("--cells", default=None,
                    help="comma-separated cell names (default: all)")
    ap.add_argument("--no-cells", action="store_true",
                    help="skip conformance cells (fuzz only)")
    ap.add_argument("--fuzz", type=int, default=25, metavar="N",
                    help="number of random graphs (default 25; 0 skips)")
    ap.add_argument("--fuzz-seed", type=int, default=0)
    ap.add_argument("--exec-every", type=int, default=10,
                    help="run the sharded-execution fuzz invariant on "
                         "every N-th graph")
    ap.add_argument("--no-numerics", action="store_true")
    ap.add_argument("--no-baseline", action="store_true",
                    help="skip the pure-data-parallel measured baseline")
    ap.add_argument("--json", action="store_true",
                    help="print the full report as JSON to stdout")
    ap.add_argument("--out", default="experiments/conformance/"
                                     "CONFORMANCE_torch.json",
                    help="report path ('' disables the file)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome/Perfetto trace of the verify "
                         "run (rank 0's spans and the compute cell's)")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the ranks' devices: one card a rank (NCCL), or "
                         "gloo CPU processes")
    return ap


def _list() -> None:
    from .cells import CELLS
    for c in CELLS:
        print(f"{c.name:16s} {c.arch:22s} {c.family:12s} {c.kind}")
    print(f"{'serve':16s} {'(engine cell)':22s} {'dense':12s} serve")
    print(f"{'serve-paged':16s} {'(engine cell)':22s} "
          f"{'2 dense families':12s} serve")
    print(f"{'trace':16s} {'(frontend cell)':22s} {'3 families':12s}"
          f" trace")
    print(f"{'train-engine':16s} {'(engine cell)':22s} {'dense':12s}"
          f" train")
    print(f"{'pipeline':16s} {'(stage runner cell)':22s} "
          f"{'dense':12s} train")
    print(f"{'compute':16s} {'(kernel-aware cell)':22s} "
          f"{'3 families':12s} calib")


def _selected(args, name: str) -> bool:
    names = args.cells.split(",") if args.cells else None
    return names is None or name in names


def _pseudo(name, run, label, kind, mesh, verbose):
    """Run pseudo-cell ``name`` (``run(mesh)``) in its span and print its
    line; returns its record."""
    from .. import obs
    t0 = time.time()
    with obs.span("verify.cell", cell=name, kind=kind):
        rec = run(mesh)
    if verbose:
        print(f"[{rec['status']}] {name:16s} {label(rec)} "
              f"({time.time() - t0:.0f}s)", flush=True)
        if rec["status"] == "error":
            print(rec["traceback"], flush=True)
    return rec


def _fmt(x, spec=".2f"):
    return "nan" if x is None else format(x, spec)


def _rank_main(rank: int, world: int, args: argparse.Namespace,
               compute_rec, parent_trace, result_path: str) -> None:
    """One rank of the verification mesh: every rank runs every cell and
    the fuzz; rank 0 prints, writes the report and the trace."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from .. import obs
    from ..launch.mesh import make_mesh
    from .cells import MESH_AXES, MESH_SHAPE, get_cells

    verbose = rank == 0 and not args.json
    if args.trace_out and rank == 0:
        obs.enable(args.trace_out)
    t_start = time.time()
    mesh = make_mesh(MESH_SHAPE, MESH_AXES, args.device)
    report = {"meta": {"torch": torch.__version__, "device": args.device,
                       "n_devices": world,
                       "mesh": dict(zip(MESH_AXES, MESH_SHAPE))}}
    if args.device == "cuda":
        report["meta"]["kind"] = torch.cuda.get_device_name()
    ok = True
    if not args.no_cells:
        from .calibration import (ABS_FLOOR, DP_SLACK, RATIO_HI,
                                  RATIO_LO, run_cells)
        report["meta"]["tolerance"] = {
            "ratio_band": [RATIO_LO, RATIO_HI],
            "abs_floor_bytes": ABS_FLOOR,
            "dp_slack": DP_SLACK,
        }
        names = args.cells.split(",") if args.cells else None
        phase = None if names is None else [n for n in names
                                            if n not in PSEUDO]
        specs = get_cells(phase) if phase is None or phase else []
        recs = run_cells(specs, mesh, numerics=not args.no_numerics,
                         baseline=not args.no_baseline, verbose=verbose)
        report["cells"] = recs
        ok &= all(r["status"] == "ok" for r in recs)
        # the serve cells are pure numerics checks: --no-numerics skips
        # them too
        if _selected(args, "serve") and not args.no_numerics:
            from .serve_cell import run_serve_cell
            report["serve"] = _pseudo(
                "serve", run_serve_cell,
                lambda r: (f"prefill_err={r.get('prefill_max_abs_err')} "
                           f"decode_err={r.get('decode_max_abs_err')}"),
                "serve", mesh, verbose)
            ok &= report["serve"]["status"] == "ok"
        if _selected(args, "serve-paged") and not args.no_numerics:
            from .serve_paged_cell import run_serve_paged_cell
            report["serve_paged"] = _pseudo(
                "serve-paged", run_serve_paged_cell,
                lambda r: " ".join(
                    f"{l['arch']}:bit={int(l.get('bit_equal', False))}"
                    f"/err={l.get('sharded_decode_max_abs_err')}"
                    for l in r.get("legs", [])), "serve", mesh, verbose)
            ok &= report["serve_paged"]["status"] == "ok"
        if _selected(args, "train-engine"):
            from .train_cell import run_train_cell
            report["train_engine"] = _pseudo(
                "train-engine",
                lambda m: run_train_cell(m, numerics=not args.no_numerics),
                lambda r: (
                    f"ratio={_fmt(r.get('calibration', {}).get('ratio'))} "
                    f"dloss={r.get('trajectory', {}).get('max_abs_dloss')} "
                    f"accum={r.get('accumulation', {}).get('max_abs_dloss')}"),
                "train", mesh, verbose)
            ok &= report["train_engine"]["status"] == "ok"
        if _selected(args, "pipeline"):
            from .pipeline_cell import run_pipeline_cell
            report["pipeline"] = _pseudo(
                "pipeline", run_pipeline_cell,
                lambda r: (
                    f"S={r.get('solution', {}).get('n_stages')} "
                    f"modeled={_fmt(r.get('solution', {}).get('modeled_ms'), '.3f')}ms "
                    f"ratio={_fmt(r.get('calibration', {}).get('ratio'))} "
                    f"dloss={r.get('trajectory', {}).get('max_abs_dloss')}"),
                "train", mesh, verbose)
            ok &= report["pipeline"]["status"] == "ok"
        if compute_rec is not None:
            report["compute"] = compute_rec
            ok &= compute_rec["status"] == "ok"
        if _selected(args, "trace"):
            from .trace_cell import run_trace_cell
            report["trace"] = _pseudo(
                "trace",
                lambda m: run_trace_cell(m, numerics=not args.no_numerics),
                lambda r: " ".join(
                    [f"{f['family']}={_fmt(f.get('ratio'))}"
                     f"(repro {_fmt(f.get('repro_ratio'))})"
                     for f in r.get("families", [])]
                    + [f"mlp_oracle={r.get('mlp', {}).get('oracle_ok')} "
                       f"mlp_err={r.get('mlp', {}).get('max_abs_err')}"]),
                "trace", mesh, verbose)
            ok &= report["trace"]["status"] == "ok"

    if args.fuzz:
        from .fuzz import run_fuzz
        exec_mesh = DeviceMesh(args.device, list(range(FUZZ_RANKS)),
                               mesh_dim_names=("fz",))
        t0 = time.time()
        with obs.span("verify.fuzz", n=args.fuzz):
            fz = run_fuzz(args.fuzz, seed=args.fuzz_seed,
                          exec_mesh=exec_mesh,
                          exec_every=max(1, args.exec_every), share=True)
        report["fuzz"] = fz.to_dict() | {"seconds": time.time() - t0}
        if verbose:
            print(f"[{'ok' if fz.ok else 'FAIL'}] fuzz n={fz.n} "
                  f"oracle={fz.oracle_checked} "
                  f"perm={fz.permutation_checked} "
                  f"exec={fz.exec_checked} "
                  f"(local einsums {fz.exec_local_einsums}) "
                  f"trace={fz.trace_checked} "
                  f"trace_exec={fz.trace_exec_checked} "
                  f"({time.time() - t0:.0f}s)", flush=True)
            for f in fz.failures[:20]:
                print(f"  FAIL {f}", flush=True)
        ok &= fz.ok

    report["pass"] = bool(ok)
    report["seconds"] = time.time() - t_start
    if rank != 0:
        return
    if args.out:
        out_dir = os.path.dirname(args.out)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        if verbose:
            print(f"report -> {args.out}", flush=True)
    if args.trace_out:
        tracer = obs.tracing.get_tracer()
        events, epoch = parent_trace
        shift = (epoch - tracer._epoch) * 1e6
        tracer.events[:0] = [dict(ev, ts=ev["ts"] + shift) for ev in events]
        obs.export(args.trace_out)
        if verbose:
            print(f"trace -> {args.trace_out}", flush=True)
    with open(result_path, "w") as f:
        json.dump(report, f)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.list:
        _list()
        return 0
    names = args.cells.split(",") if args.cells else None
    if names is not None:
        from .cells import get_cells
        get_cells([n for n in names if n not in PSEUDO])   # unknown: raise

    import torch

    from .. import obs
    from ..launch.mesh import spawn
    from .cells import N_DEVICES
    if args.device == "cuda" and torch.cuda.device_count() < N_DEVICES:
        print(f"verify: --device cuda needs {N_DEVICES} cards, one a rank "
              f"of the verification mesh; this machine has "
              f"{torch.cuda.device_count()}.  Run the ranks as gloo CPU "
              f"processes with --device cpu.", file=sys.stderr)
        return 2
    t_start = time.time()
    compute_rec = None
    if args.trace_out:
        obs.enable()
    if not args.no_cells and _selected(args, "compute"):
        from .compute_cell import run_compute_cell
        t0 = time.time()
        with obs.span("verify.cell", cell="compute", kind="calib"):
            compute_rec = run_compute_cell()
        if not args.json:
            ratios = " ".join(f"{c['cell']}={_fmt(c.get('ratio'))}"
                              for c in compute_rec.get("cells", []))
            cal = compute_rec.get("calibration_fit", {}).get("calibration")
            print(f"[{compute_rec['status']}] {'compute':16s} "
                  f"cal={_fmt(cal, '.3f')} {ratios} "
                  f"({time.time() - t0:.0f}s)", flush=True)
            if compute_rec["status"] == "error":
                print(compute_rec["traceback"], flush=True)
    tracer = obs.tracing.get_tracer()
    parent_trace = (list(tracer.events), tracer._epoch)
    obs.disable()
    fd, result_path = tempfile.mkstemp(prefix="verify-", suffix=".json")
    os.close(fd)
    # the ranks unpickle _rank_main by its module's name, which
    # ``python -m`` leaves as "__main__": hand them this module's copy
    # imported under its package name
    import importlib
    ranks = importlib.import_module(__spec__.name)._rank_main
    try:
        spawn(ranks, N_DEVICES, args.device,
              (args, compute_rec, parent_trace, result_path))
        with open(result_path) as f:
            report = json.load(f)
    finally:
        os.unlink(result_path)
    report["seconds"] = time.time() - t_start
    ok = report["pass"]
    if args.json:
        json.dump(report, sys.stdout, indent=1)
        print()
    else:
        print(f"verify: {'PASS' if ok else 'FAIL'} "
              f"({report['seconds']:.0f}s)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
