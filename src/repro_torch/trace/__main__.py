"""Autoshard demo / smoke CLI (the port's ``python -m repro.trace``).

  python -m repro_torch.trace --device cpu                 # MLP on 4x2
  python -m repro_torch.trace --device cpu --arch llama3.2-3b
  python -m repro_torch.trace --device cpu --mesh 2x4 --verify

Captures the function (the plain-torch demo MLP, or an arch's reduced
``LM.forward``), solves it on the mesh's axes and prints the captured
graph's size, the solved per-tensor plan and the predicted wire-byte
breakdown; with --verify it also runs the DTensor-placed callable and the
serial function and reports the max abs error (non-zero exit outside the
band: the fuzz's EXEC_ATOL for the MLP, the conformance logits band for
an arch).  The mesh's ranks are started here (``launch/mesh.spawn``): one
card a rank over NCCL with ``--device cuda`` (the default), which stops
with an error on a machine with fewer cards than the mesh and never falls
back to the CPU; gloo CPU processes with ``--device cpu``.  Rank 0
prints."""
import argparse
import json
import os
import sys
import tempfile


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.trace")
    ap.add_argument("--arch", default=None,
                    help="trace this registry arch's reduced forward "
                         "instead of the demo MLP")
    ap.add_argument("--mesh", default="4x2",
                    help="DATAxMODEL mesh (default 4x2)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", action="store_true",
                    help="execute sharded vs serial and compare")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the ranks' devices: one card a rank (NCCL), or "
                         "gloo CPU processes")
    return ap


def _fixture(args, device):
    """(fn, example args, weight_argnums, name, band of the comparison
    or None to scale the fuzz's by the output)."""
    import numpy as np
    import torch

    if args.arch:
        from ..configs.base import get_arch
        from ..models.model import LM
        from ..verify.numerics import LOGITS_ATOL

        cfg = get_arch(args.arch).reduced()
        model = LM(cfg)
        params = model.init(args.seed, device=device)
        rng = np.random.default_rng(args.seed)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab, (args.batch, args.seq))).to(device)

        def fn(p, t):
            return model.forward(p, t)[0]
        return fn, (params, toks), (0,), args.arch, LOGITS_ATOL
    from .demo import mlp_fixture
    fn, ex, wn = mlp_fixture(args.seed, device=device)
    return fn, ex, wn, "mlp", None


def _rank_main(rank: int, world: int, args, shape, result_path: str):
    import torch

    from ..launch.mesh import make_mesh
    from ..verify.fuzz import EXEC_ATOL
    from . import autoshard

    mesh = make_mesh(shape, ("data", "model"), args.device)
    device = torch.device(args.device, torch.cuda.current_device()) \
        if args.device == "cuda" else torch.device("cpu")
    fn, ex, wn, name, band = _fixture(args, device)
    ash = autoshard(fn, mesh, *ex, weight_argnums=wn, name=name)
    out = {"ops": len(ash.traced.graph.ops),
           "predicted_bytes": ash.predicted_bytes, "ok": True}
    if rank == 0:
        print(ash.describe())
        print("predicted by kind:", {k: f"{v:.3e}" for k, v in
                                     ash.predicted["by_kind"].items()},
              flush=True)
    if args.verify:
        with torch.no_grad():
            ref = fn(*ex).float()
            got = ash(*ex).full_tensor().float()
        err = float((ref - got).abs().max())
        scale = float(ref.abs().max())
        band = EXEC_ATOL * max(1.0, scale) if band is None else band
        out.update(max_abs_err=err, scale=scale, band=band,
                   ok=bool(err <= band))
        if rank == 0:
            print(f"max abs err {err:.3e} (scale {scale:.3e}, band "
                  f"{band:.0e})", flush=True)
    if rank == 0:
        with open(result_path, "w") as f:
            json.dump(out, f)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    shape = tuple(int(x) for x in args.mesh.split("x"))
    n = shape[0] * shape[1]
    import torch

    from ..launch.mesh import spawn
    if args.device == "cuda" and torch.cuda.device_count() < n:
        print(f"trace: --device cuda needs {n} cards, one a rank of the "
              f"{args.mesh} mesh; this machine has "
              f"{torch.cuda.device_count()}.  Run the ranks as gloo CPU "
              "processes with --device cpu.", file=sys.stderr)
        return 2
    fd, result_path = tempfile.mkstemp(prefix="trace-", suffix=".json")
    os.close(fd)
    # the ranks unpickle _rank_main by its module's name, which
    # ``python -m`` leaves as "__main__": hand them this module's copy
    # imported under its package name
    import importlib
    ranks = importlib.import_module(__spec__.name)._rank_main
    try:
        spawn(ranks, n, args.device, (args, shape, result_path))
        with open(result_path) as f:
            out = json.load(f)
    finally:
        os.unlink(result_path)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
