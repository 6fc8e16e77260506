"""Serving harness: drives the continuous-batching engine
(runtime/serve.py) over a synthetic workload and reports prefill/decode
throughput and TTFT / inter-token latency percentiles (counterpart of
``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --slots 16 --max-len 2048 --prompt-len 512 --chunk 256 --gen 32
  # on the CPU, at the reduced size:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --reduced --device cpu
  # the paged tier on a small pool, with speculative decoding:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --reduced --device cpu --paged --n-blocks 9 --spec-k 4
  # under the solved decode plan on a 4x2 mesh of 8 gloo ranks:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --reduced --device cpu --mesh 4x2 --plan auto --slots 8
  # the paged tier with speculative decoding under the plan, 2x2:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --reduced --device cpu --mesh 2x2 --plan auto --slots 4 --paged \\
      --n-blocks 9 --spec-k 4
  # open-loop Poisson arrivals at 2 req/s, observed: a trace, the metrics
  # registry, an ITL SLO that an injected stall breaks (flight records in
  # --flight-dir):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --reduced --device cpu --requests 12 --arrivals poisson --rate 2.0 \\
      --trace-out /tmp/serve.trace.json --metrics-out /tmp/serve.jsonl \\
      --slo-itl-ms 50 --inject-spike-ms 200 --inject-at 2 --inject-steps 6

Runs on the card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it raises.  Weights are random, from
``torch.Generator(--seed)``.

``--mesh DxM`` serves on a ("data", "model") DeviceMesh of D*M ranks:
gloo ranks with ``--device cpu``, otherwise NCCL, one rank a card.  Under
``torchrun --nproc-per-node D*M`` each process is a rank; run directly,
the module spawns the D*M ranks itself.  ``--plan auto`` solves the
decode tiling of ``ShapeConfig(f"serve{tag}{slots}x{max_len}")`` for the
mesh (``launch/compile.solve_cell_plan``, cached under
``.cache/plans_torch/``; an MoE plan pinned by ``normalize_moe_plan``)
and places params and cache with it, on either
tier (``--paged``) and with ``--spec-k``; every rank runs the same
scheduler, and rank 0 prints and writes the record.

Observation (repro's flags): ``--trace-out`` writes a Chrome / Perfetto
trace of the run (the ``serve.*`` spans), ``--metrics-out`` the run's
metrics registry as JSONL (the TTFT / ITL histograms, the scheduler's
counters, the drift gauges); ``--slo-ttft-ms`` / ``--slo-itl-ms`` (p95
objectives) or ``--inject-spike-ms`` turn on the continuous monitor,
with a flight recorder writing ``flight-<trigger>.json`` into
``--flight-dir`` and, under ``--plan auto``, the replan advisor
(``launch/compile.solve_observed_regime``).  Under ``--plan auto`` the
drift check records one decode step's collectives
(``analysis/comm.record``) against the plan record's predicted bytes,
unless ``--no-drift``.  Under a mesh only rank 0 traces, keeps the
registry, the monitor, the flight recorder and the advisor; the other
ranks serve unobserved (a monitor never changes a scheduling decision).
``--arrivals poisson --rate R`` draws the arrival times as repro does:
``np.random.default_rng(--seed)`` after the prompts, so one seed gives
repro's arrivals.  ``python -m repro_torch.obs validate`` checks the
files."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..configs.base import get_arch
from ..models.common import device_sync, resolve_device
from ..models.model import LM
from ..obs.stats import percentile
from ..runtime.serve import ServeConfig, Server
from . import observe


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--gen", type=int, default=16,
                    help="max new tokens per request")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--requests", type=int, default=0,
                    help="number of requests (default: one per slot)")
    ap.add_argument("--chunk", type=int, default=16,
                    help="prefill chunk size")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV block pool + block-table cache")
    ap.add_argument("--block-len", type=int, default=16,
                    help="tokens per KV block (must divide --max-len)")
    ap.add_argument("--n-blocks", type=int, default=None,
                    help="pool size in blocks (default: slots * "
                         "max_len/block_len + 1, the linear cache's "
                         "capacity); smaller values serve memory-bound "
                         "through preemption")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable radix shared-prefix block reuse")
    ap.add_argument("--spec-k", type=int, default=1,
                    help="self-speculative draft length per round "
                         "(1 = plain decode)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="e.g. 4x2: serve on a (data, model) mesh of D*M "
                         "ranks (gloo with --device cpu, NCCL otherwise)")
    ap.add_argument("--plan", default=None, choices=[None, "auto"],
                    help="'auto' solves the decode tiling for the mesh "
                         "and shards params+cache with it")
    ap.add_argument("--arrivals", default="batch",
                    choices=["batch", "poisson"])
    ap.add_argument("--rate", type=float, default=4.0,
                    help="poisson arrival rate, requests/s")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome/Perfetto trace of the run "
                         "(admit/prefill/decode/preempt spans)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the run's metrics registry as JSONL "
                         "(TTFT/ITL histograms, pool utilization, "
                         "drift gauges)")
    ap.add_argument("--no-drift", action="store_true",
                    help="skip the predicted-vs-measured wire-byte drift "
                         "check (drift needs --plan auto)")
    ap.add_argument("--min-decode-tput", type=float, default=None,
                    help="exit non-zero unless decode tok/s exceeds this")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="TTFT SLO target in ms (p95 objective; enables "
                         "the continuous monitor)")
    ap.add_argument("--slo-itl-ms", type=float, default=None,
                    help="inter-token-latency SLO target in ms (p95 "
                         "objective; enables the continuous monitor)")
    ap.add_argument("--flight-dir", default="flight",
                    help="directory for flight-<trigger>.json dumps")
    ap.add_argument("--inject-spike-ms", type=float, default=0.0,
                    help="fault injection: sleep this long after each "
                         "decode step in the injection window")
    ap.add_argument("--inject-at", type=int, default=2,
                    help="decode step the injection window starts at")
    ap.add_argument("--inject-steps", type=int, default=20,
                    help="injection window length in decode steps")
    return ap


def run_workload(srv: Server, arrivals: Sequence[Tuple[float, List[int]]],
                 gen: int, step_hook: Optional[Callable[[int], None]] = None
                 ) -> Dict[str, object]:
    """Drive the engine over (t_arrival, prompt) pairs and return the
    metrics record.  Admission and decode are timed separately, each
    ending in a device synchronise.  ``step_hook(n_decode_steps)`` runs
    after each decode step (the fault-injection point), outside the
    timed decode interval."""
    sync = device_sync(srv.device)
    t0 = time.monotonic()
    pending = sorted(arrivals, key=lambda a: a[0])
    submit_t: Dict[int, float] = {}
    first_tok_t: Dict[int, float] = {}
    tok_times: Dict[int, List[float]] = {}
    prefill_s = decode_s = 0.0
    prompt_toks = decode_toks = 0
    n_decode_steps = 0

    def clock():
        return time.monotonic() - t0

    while pending or srv.waiting or srv.active.any():
        now = clock()
        while pending and pending[0][0] <= now:
            _, prompt = pending.pop(0)
            rid = srv.submit(prompt, max_new_tokens=gen)
            submit_t[rid] = clock()
            tok_times[rid] = []
        if not (srv.waiting or srv.active.any()):
            time.sleep(min(0.001, max(0.0, pending[0][0] - clock())))
            continue

        ta = time.monotonic()
        admit_evs = srv.admit_waiting()
        sync()
        tb = time.monotonic()
        if srv.scfg.spec_k > 1:
            dec_evs = srv.spec_once()
        else:
            dec_evs = srv.decode_once()
        sync()
        tc = time.monotonic()
        if admit_evs:
            prefill_s += tb - ta
        if dec_evs:
            decode_s += tc - tb
            n_decode_steps += 1
            if step_hook is not None:
                step_hook(n_decode_steps)
        # prefill-produced tokens are stamped at the end of admission
        for evs, t, from_decode in ((admit_evs, tb - t0, False),
                                    (dec_evs, tc - t0, True)):
            for kind, rid, val in evs:
                if kind == "admit":
                    prompt_toks += int(srv.prompt_len[val])
                elif kind == "token":
                    first_tok_t.setdefault(rid, t)
                    tok_times[rid].append(t)
                    if from_decode:
                        decode_toks += 1

    total = clock()
    itls: List[float] = []
    for ts in tok_times.values():
        itls += [b - a for a, b in zip(ts, ts[1:])]
    ttfts = [first_tok_t[r] - submit_t[r] for r in first_tok_t]
    gen_toks = sum(len(ts) for ts in tok_times.values())
    return {
        "requests": len(tok_times),
        "generated_tokens": gen_toks,
        "prompt_tokens": prompt_toks,
        "wall_s": total,
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "decode_steps": n_decode_steps,
        "prefill_tok_per_s": (prompt_toks / prefill_s
                              if prefill_s else None),
        "decode_tok_per_s": (decode_toks / decode_s
                             if decode_s else None),
        "total_tok_per_s": gen_toks / total if total else None,
        "ttft_p50_s": percentile(ttfts, 50.0),
        "ttft_p95_s": percentile(ttfts, 95.0),
        "itl_p50_s": percentile(itls, 50.0),
        "itl_p95_s": percentile(itls, 95.0),
        # raw samples (callers serializing this dict should drop them)
        "itl_s": itls,
        "ttft_s": ttfts,
    }


def _rank_main(rank: int, world: int, argv: List[str]) -> None:
    main(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = build_argparser()
    args = ap.parse_args(argv)
    if args.plan and not args.mesh:
        ap.error("--plan requires --mesh (the plan shards the pool across "
                 "a mesh)")
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    plan = mesh = plan_rec = None
    rank, ours = 0, False
    if args.mesh:
        import torch.distributed as dist

        from .mesh import init_distributed, make_mesh, solver_axes, spawn
        shape = tuple(int(s) for s in args.mesh.lower().split("x"))
        world = int(np.prod(shape))
        if not dist.is_initialized() and "RANK" not in os.environ:
            # no launcher: start the ranks here, each running this main
            spawn(_rank_main, world, device.type, (argv,))
            return 0
        ours = not dist.is_initialized()
        rank, _ = init_distributed(device.type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        names = ("data", "model")[:len(shape)]
        mesh = make_mesh(shape, names, device.type)
        if args.plan == "auto":
            from ..configs.base import ShapeConfig
            from .compile import (normalize_moe_plan, plan_from_record,
                                  solve_cell_plan)
            tag = "r" if args.reduced else ""
            dshape = ShapeConfig(f"serve{tag}{args.slots}x{args.max_len}",
                                 args.max_len, args.slots, "decode")
            t0 = time.time()
            plan_rec = solve_cell_plan(cfg, dshape,
                                       solver_axes(shape, names),
                                       mesh_name=f"mesh{args.mesh}")
            plan = normalize_moe_plan(plan_from_record(plan_rec), cfg)
            if rank == 0:
                print(f"decode plan ({time.time() - t0:.2f}s, solve "
                      f"{plan_rec['solve_time']:.2f}s):")
                print(plan.describe())
    try:
        return _serve(args, cfg, device, plan, mesh, plan_rec, rank)
    finally:
        if ours:
            import torch.distributed as dist
            dist.destroy_process_group()


def _monitor(args, cfg, registry, plan_rec):
    """The TTFT / ITL SLOs' monitor, recorder and advisor
    (``observe.make_monitor``)."""
    from .compile import solve_observed_regime
    slos = []
    if args.slo_ttft_ms is not None:
        slos.append(obs.SLO("ttft", target=args.slo_ttft_ms / 1e3))
    if args.slo_itl_ms is not None:
        slos.append(obs.SLO("itl", target=args.slo_itl_ms / 1e3))

    def solve_regime(axes, regime):
        # prefill-heavy is priced over the live prompt shape,
        # decode-heavy over the slot pool at full KV length
        s = (max(args.prompt_len, 8)
             if regime == "prefill-heavy" else args.max_len)
        return solve_observed_regime(cfg, axes, f"mesh{args.mesh}", regime,
                                     batch=args.slots, seq_len=s)

    return observe.make_monitor(args, slos, registry, plan_rec,
                                solve_regime)


def _serve(args, cfg, device, plan, mesh, plan_rec, rank: int) -> int:
    # rank 0 owns the trace, the registry, the monitor and its recorder
    if args.trace_out and rank == 0:
        obs.enable(args.trace_out)
    registry = obs.Registry() if rank == 0 else None
    model = LM(cfg, plan=plan, mesh=mesh)
    params = LM(cfg).init(args.seed, device=device)
    scfg = ServeConfig(slots=args.slots, max_len=args.max_len,
                       prefill_chunk=args.chunk,
                       temperature=args.temperature, top_k=args.top_k,
                       seed=args.seed, paged=args.paged,
                       block_len=args.block_len, n_blocks=args.n_blocks,
                       prefix_cache=not args.no_prefix_cache,
                       spec_k=args.spec_k)
    monitor = recorder = advisor = None
    if rank == 0:
        monitor, recorder, advisor = _monitor(args, cfg, registry, plan_rec)
    rng = np.random.default_rng(args.seed)
    n_req = args.requests or args.slots
    prompts = [rng.integers(0, cfg.vocab, size=args.prompt_len).tolist()
               for _ in range(n_req)]
    # arrival times: all at 0, or a Poisson process drawn after the
    # prompts from the same generator (repro's draw)
    t_arr = (np.cumsum(rng.exponential(1.0 / args.rate, size=n_req))
             if args.arrivals == "poisson" else np.zeros(n_req))

    # warm-up on a throwaway pool: the kernels' build and first launches
    # and the BLAS set-up stay out of the measurement.  Under a plan its
    # one decode step is the drift check's: the collectives it issues
    # against the plan record's predicted bytes (repro compiles the
    # decode cell and parses its HLO instead)
    warm = Server(model, params, scfg)
    warm.admit(prompts[0], 0, max_new_tokens=2)
    drift_rec = None
    if plan is not None and not args.no_drift:
        from ..analysis import comm
        _, stats = comm.record(warm.decode_once)
        if rank == 0:
            drift_rec = observe.check_drift(
                plan_rec, stats, int(np.prod(mesh.mesh.shape)), registry,
                monitor)
    warm.run()
    del warm

    srv = Server(model, params, scfg, registry=registry, monitor=monitor)
    if monitor is not None:
        # decode- vs prefill-heavy from the live emitted / prompt token
        # mix (this harness admits prompts of --prompt-len)
        def regime_fn():
            gen = sum(len(v) for v in srv.outputs.values())
            pro = max(1, len(srv.outputs) * args.prompt_len)
            return "decode-heavy" if gen >= pro else "prefill-heavy"

        monitor.regime_fn = regime_fn

    step_hook = None
    if args.inject_spike_ms:
        lo, hi = args.inject_at, args.inject_at + args.inject_steps

        def step_hook(n):
            if lo <= n < hi:
                time.sleep(args.inject_spike_ms / 1e3)

        if rank == 0:
            print(f"injecting {args.inject_spike_ms:.0f}ms stalls into "
                  f"decode steps [{lo}, {hi})")

    rec = run_workload(srv, list(zip(t_arr.tolist(), prompts)), args.gen,
                       step_hook=step_hook)
    rec["meta"] = {
        "arch": cfg.name, "reduced": args.reduced, "slots": args.slots,
        "max_len": args.max_len, "gen": args.gen,
        "prompt_len": args.prompt_len, "chunk": args.chunk,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "paged": args.paged, "spec_k": args.spec_k, "mesh": args.mesh,
        "plan": args.plan, "arrivals": args.arrivals,
        "rate": args.rate if args.arrivals == "poisson" else None,
    }
    if plan_rec is not None:
        rec["plan"] = {k: plan_rec[k] for k in
                       ("mesh_axes", "role_cuts", "total_bytes",
                        "solve_time")}
    if rank:
        return 0
    if args.paged:
        rec["meta"]["block_len"] = args.block_len
        rec["meta"]["n_blocks"] = srv.n_blocks
        rec["meta"]["prefix_cache"] = not args.no_prefix_cache
        rec["paged"] = {
            "prefill_dispatches": srv.prefill_dispatches,
            "decode_dispatches": srv.decode_dispatches,
            "verify_dispatches": srv.verify_dispatches,
            "preemptions": srv.preemptions,
            "prompt_cache_hits": srv.prompt_cache_hits,
        }
    if drift_rec is not None:
        rec["drift"] = drift_rec

    # registry sinks: latency histograms from the workload's samples, rate
    # gauges, and the solver's memo-cache counters from the global
    # registry (the solve ran in this process)
    registry.histogram("serve.ttft_s").observe_many(rec["ttft_s"])
    registry.histogram("serve.itl_s").observe_many(rec["itl_s"])
    if rec["decode_tok_per_s"] is not None:
        registry.gauge("serve.decode_tok_per_s").set(rec["decode_tok_per_s"])
    if rec["total_tok_per_s"] is not None:
        registry.gauge("serve.total_tok_per_s").set(rec["total_tok_per_s"])
    for m in obs.default_registry().collect():
        if m["name"].startswith("solver.") and m["type"] == "counter":
            registry.counter(m["name"]).inc(m["value"])
    if monitor is not None:
        observe.finish_monitor(rec, monitor, recorder, advisor)

    def fmt(v, unit=""):
        return "n/a" if v is None else f"{v:,.1f}{unit}"

    print(f"{rec['requests']} requests, {rec['generated_tokens']} tokens "
          f"generated, {rec['prompt_tokens']} prompt tokens in "
          f"{rec['wall_s']:.2f}s on {rec['meta']['device']}")
    print(f"  prefill  {fmt(rec['prefill_tok_per_s'], ' tok/s')}  "
          f"({rec['prefill_s']:.2f}s)")
    print(f"  decode   {fmt(rec['decode_tok_per_s'], ' tok/s')}  "
          f"({rec['decode_s']:.2f}s, {rec['decode_steps']} steps)")
    p50, p95 = rec["itl_p50_s"], rec["itl_p95_s"]
    print(f"  latency  per-token p50 {fmt(p50 and p50 * 1e3, ' ms')}, p95 "
          f"{fmt(p95 and p95 * 1e3, ' ms')}; ttft p50 "
          f"{fmt(rec['ttft_p50_s'] and rec['ttft_p50_s'] * 1e3, ' ms')}")
    if args.paged:
        print("  paged    " + ", ".join(f"{k} {v}"
                                        for k, v in rec["paged"].items()))
    observe.write_sinks(args, registry)
    if args.json_out:
        slim = {k: v for k, v in rec.items() if k not in ("itl_s", "ttft_s")}
        with open(args.json_out, "w") as f:
            json.dump(slim, f, indent=1)
        print(f"metrics -> {args.json_out}")
    if args.min_decode_tput is not None:
        tput = rec["decode_tok_per_s"] or 0.0
        if tput < args.min_decode_tput:
            print(f"FAIL: decode throughput {tput} < "
                  f"{args.min_decode_tput}")
            return 1
        print(f"decode throughput gate ok "
              f"({tput:.1f} >= {args.min_decode_tput})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
