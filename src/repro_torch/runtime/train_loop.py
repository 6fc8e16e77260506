"""Fault-tolerant training loop (counterpart of
``repro.runtime.train_loop``): a thin loop over ``train/engine.py``, on
one card or under a sharding plan on a mesh.

- On start it resumes from the latest committed checkpoint in
  ``ckpt_dir``; a killed and resumed run reproduces the uninterrupted loss
  trajectory exactly (the data is a function of the step).
- It checkpoints every ``ckpt_every`` steps and keeps the newest three.
- The host waits for the device only at flush boundaries, as repro's
  launch loop does: every ``log_every`` steps, at the end of the warmup,
  at a checkpoint and at the last step.  Losses stay on the device in
  between, and each flush's wall time, which ends in a device
  synchronise, is shared out over its steps.  Intervals after the warmup
  are the measured ones.

Under a plan (``train(mesh=, plan=)``) every rank runs the loop: the
feed places each batch under the engine's batch placements, the losses
are the full values.  With a process group up (a mesh, with or without a
plan) only rank 0 writes checkpoints and prunes old ones; every rank takes
part in gathering them.

Observation (repro's ``train(monitor=, straggler_cb=, step_hook=)``):
``monitor`` (``obs.monitor.Monitor``) observes each step's wall time
("step"), data wait ("data_wait") and device-sync time ("sync"), the
signals its burn-rate and MAD-z rules run on; ``straggler_cb(step,
seconds)`` fires for a step slower than ``TrainConfig.
straggler_timeout_s``.  Both need a step's own wall time, so with a
monitor or a straggler timeout set every step is a flush boundary (one
device synchronise a step, as repro's loop takes with ``float(loss)``).
Without them nothing changes: the flush boundaries, the timing and the
logged losses are those above, and the losses are the same values
either way (the device tensors are only read later or sooner).
``step_hook(step)`` runs right after each step's dispatch, inside its
timed interval (the launchers' fault-injection point).  Spans:
``train.data_wait`` (``BatchFeed.get``), ``train.step`` and
``train.ckpt_write`` (the engine), ``train.sync`` (each flush's device
synchronise)."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..checkpoint import ckpt
from ..data.pipeline import BatchFeed, DataConfig
from ..models.common import device_sync, resolve_device
from ..models.model import LM
from ..obs.tracing import span as _span
from ..optim.adamw import AdamWConfig
from ..train.engine import EngineConfig, TrainEngine

Tree = Dict[str, Any]


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    warmup: int = 0               # steps left out of the timing
    grad_compression: bool = False
    straggler_timeout_s: Optional[float] = None
    optim: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    microbatches: int = 1
    buckets: int = 4
    master_fp32: bool = True


def make_engine(model: LM, tcfg: TrainConfig, device="cuda", mesh=None,
                plan=None) -> TrainEngine:
    """The engine for ``tcfg``; with ``plan`` (and ``mesh``) the model
    runs under that plan, its MoE roles pinned by ``normalize_moe_plan``,
    and the state is placed under it."""
    if plan is not None:
        from ..launch.compile import normalize_moe_plan
        model = dataclasses.replace(
            model, plan=normalize_moe_plan(plan, model.cfg), mesh=mesh)
    return TrainEngine(
        model,
        EngineConfig(microbatches=tcfg.microbatches, buckets=tcfg.buckets,
                     grad_compression=tcfg.grad_compression,
                     master_fp32=tcfg.master_fp32, optim=tcfg.optim),
        device=device, mesh=mesh)


def train(model: LM, dcfg: DataConfig, tcfg: TrainConfig,
          params: Optional[Tree] = None, device="cuda", mesh=None,
          plan=None,
          straggler_cb: Optional[Callable[[int, float], None]] = None,
          monitor=None,
          step_hook: Optional[Callable[[int], None]] = None,
          collectives: bool = False) -> Dict[str, Any]:
    """Run (or resume) training, under ``plan`` on ``mesh`` if given.
    Returns the final state, the engine, the per-step ``history`` ({step,
    loss, gnorm, sec}) and the measured ``breakdown_s`` (data wait, step
    and checkpoint seconds after the warmup) with ``measured_steps``.
    ``monitor`` / ``straggler_cb`` / ``step_hook``: see the module
    docstring.  ``collectives``: record the first step's collectives
    (``analysis/comm.record``; its ``CollectiveStats`` in
    ``out["collectives"]``), the drift check's measured side."""
    dev = resolve_device(device)
    sync = device_sync(dev)
    engine = make_engine(model, tcfg, device=dev, mesh=mesh, plan=plan)
    dist = torch.distributed
    writer = (not (dist.is_available() and dist.is_initialized())
              or dist.get_rank() == 0)
    feed_at = ({} if not engine.sharded else
               dict(mesh=engine.mesh, placements=engine.batch_placements()))
    state = None
    start = 0
    if tcfg.ckpt_dir:
        restored = engine.restore(tcfg.ckpt_dir)
        if restored is not None:
            state, _, start = restored
    if state is None:
        state = engine.init_state(dcfg.seed, params=params)

    warmup = min(tcfg.warmup, max(0, (tcfg.steps - start) - 1))
    log_every = max(1, tcfg.log_every)
    # a monitor or a straggler timeout needs each step's own wall time
    per_step = monitor is not None or tcfg.straggler_timeout_s is not None
    comm_stats = None
    history: List[Dict[str, float]] = []
    data_s = step_s = ckpt_s = 0.0
    n_measured = 0
    pending = []                  # (step, device loss, device gnorm)
    int_t0 = None
    int_data = 0.0
    with BatchFeed(dcfg, start_step=start, device=dev, **feed_at) as feed:
        for step in range(start, tcfg.steps):
            ta = time.monotonic()
            if int_t0 is None:
                int_t0 = ta
            batch = feed.get()
            t_data = time.monotonic() - ta
            int_data += t_data
            if collectives and step == start:
                from ..analysis import comm
                (state, metrics), comm_stats = comm.record(engine.step, state,
                                                           batch)
            else:
                state, metrics = engine.step(state, batch)
            if step_hook is not None:
                step_hook(step)
            pending.append((step, metrics["loss"], metrics["gnorm"]))
            at_ckpt = bool(tcfg.ckpt_dir) and (step + 1) % tcfg.ckpt_every == 0
            if not (per_step or (step + 1 - start) % log_every == 0
                    or step - start == warmup - 1
                    or step == tcfg.steps - 1 or at_ckpt):
                continue
            ts = time.monotonic()
            with _span("train.sync", steps=len(pending)):
                sync()
            tc = time.monotonic()
            wall = tc - int_t0
            if monitor is not None:
                monitor.observe("step", wall)
                monitor.observe("data_wait", t_data)
                monitor.observe("sync", tc - ts)
            if (tcfg.straggler_timeout_s is not None
                    and wall > tcfg.straggler_timeout_s
                    and straggler_cb is not None):
                straggler_cb(step, wall)
            if pending[0][0] - start >= warmup:
                data_s += int_data
                step_s += wall - int_data
                n_measured += len(pending)
            for s, loss, gnorm in pending:
                history.append({"step": s, "loss": float(loss),
                                "gnorm": float(gnorm),
                                "sec": wall / len(pending)})
            pending, int_t0, int_data = [], None, 0.0
            if at_ckpt:
                engine.save(tcfg.ckpt_dir, step + 1, state,
                            extra={"loss": history[-1]["loss"]})
                if writer:
                    ckpt.gc_old(tcfg.ckpt_dir)
                ckpt_s += time.monotonic() - tc
    return {"params": state["params"], "opt": state["opt"], "state": state,
            "engine": engine, "history": history,
            "breakdown_s": {"data": data_s, "step": step_s, "ckpt": ckpt_s},
            "measured_steps": n_measured, "collectives": comm_stats}
