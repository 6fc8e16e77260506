"""Deterministic synthetic data and the device batch feed (counterpart of
``repro.data.pipeline``).

``host_batch`` is a numpy copy of repro's: the generator is seeded by
(seed, step, host), so the arrays are identical to repro's and a resumed
run sees the batches an uninterrupted one would.  ``vision_patch_embeds``
and ``audio_frame_embeds`` are repro's stub frontends, bit for bit: the
[B, S, d_model] embeddings an embedding-stub backbone takes in place of
token ids."""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab: int = 32000
    seq_len: int = 128
    global_batch: int = 8
    n_hosts: int = 1
    host_id: int = 0


def _rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))


def host_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """This host's shard of the global batch for ``step``: noisy successor
    sequences over a small alphabet, so the LM loss decreases quickly."""
    if cfg.global_batch % cfg.n_hosts:
        raise ValueError(f"global_batch {cfg.global_batch} is not divisible "
                         f"by n_hosts {cfg.n_hosts}")
    b = cfg.global_batch // cfg.n_hosts
    rng = _rng(cfg, step)
    alpha = max(8, min(64, cfg.vocab // 4))
    start = rng.integers(0, alpha, size=(b, 1))
    pos = np.arange(cfg.seq_len + 1)[None, :]
    toks = (start + pos) % alpha
    noise = rng.random((b, cfg.seq_len + 1)) < 0.02
    toks = np.where(noise, rng.integers(0, alpha, toks.shape), toks)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def batches(cfg: DataConfig, start_step: int = 0
            ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield host_batch(cfg, step)
        step += 1


class BatchFeed:
    """Prefetching batch feed.

    A producer thread makes the host batch for the next steps and copies
    it to ``device`` (pinned host memory, ``non_blocking=True``) while the
    engine still runs the current step; ``get()`` returns dicts of int32
    tensors.  With ``mesh`` and ``placements`` (key -> DTensor placements,
    the engine's ``batch_placements()``) each tensor is placed under its
    placements, every rank keeping its slice of the host batch (the same
    on every rank), so nothing moves between ranks.  An exception in the
    producer is re-raised by ``get()``.  Use as a context manager or call
    :meth:`close`."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 device: Optional[torch.device] = None, depth: int = 2,
                 mesh=None, placements: Optional[Dict[str, Any]] = None):
        self.cfg = cfg
        self.mesh, self.placements = mesh, placements
        self.device = torch.device(device) if device is not None else None
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(
            target=self._produce, name="batch-feed", daemon=True)
        self._thread.start()

    def _place(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {k: torch.from_numpy(v) for k, v in batch.items()}
        if self.device is not None and self.device.type != "cpu":
            out = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in out.items()}
        if self.placements is None:
            return out
        from ..models.sharding import place
        return {k: place(v, self.mesh, self.placements[k])
                for k, v in out.items()}

    def _produce(self) -> None:
        step = self._step
        while not self._stop.is_set():
            # a producer failure must surface in get(), not leave the
            # consumer waiting on an empty queue
            try:
                item = (step, self._place(host_batch(self.cfg, step)))
            except Exception as e:   # re-raised in get()
                item = (step, e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(item[1], Exception):
                return
            step += 1

    def get(self) -> Dict[str, torch.Tensor]:
        """Next step's batch (blocks on the prefetch queue).  Re-raises any
        exception the producer thread hit."""
        _, batch = self._q.get()
        if isinstance(batch, Exception):
            raise batch
        return batch

    def __enter__(self) -> "BatchFeed":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._stop.set()
        # drain so the producer's blocked put() can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


# -- stub modality frontends (the VLM and audio backbones take embeddings) ---

def vision_patch_embeds(cfg: ArchConfig, batch: int, seq: int,
                        seed: int = 0) -> np.ndarray:
    """Precomputed InternViT-style patch embeddings (stub frontend)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, seq, cfg.d_model),
                               dtype=np.float32) * 0.02


def audio_frame_embeds(cfg: ArchConfig, batch: int, seq: int,
                       seed: int = 0) -> np.ndarray:
    """Precomputed EnCodec frame embeddings (stub frontend)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, seq, cfg.d_model),
                               dtype=np.float32) * 0.02
