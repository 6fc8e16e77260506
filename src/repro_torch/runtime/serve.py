"""Continuous-batching slot-pool server, linear KV tier (counterpart of
``repro.runtime.serve``).

A fixed pool of ``slots`` requests decodes together in one pool-wide step;
admission and retirement happen between decode steps:

- chunked prefill: admitting a request zeroes its slot and fills its
  cache in ceil(prompt_len / prefill_chunk) dispatches
  (``LM.prefill_chunk``), touching only that slot's row.  The first output
  token is sampled from the prefill logits;
- slot scheduler: per-slot position and output count, EOS / length /
  max_len retirement, and a waiting queue that backfills freed slots;
- isolation: each slot attends only its own cache rows (per-slot
  lengths), and a freed slot is zeroed before reuse;
- sampling: greedy, temperature or top-k over the pool, with one
  ``torch.Generator`` per (request, token index) so that a request's
  sampled stream does not depend on what else is in the pool.  The bits
  differ from repro's ``jax.random`` streams; greedy streams match.

The paged tier, speculative decoding, plan sharding and the obs wiring
are not ported yet: ``ServeConfig`` raises on ``paged=True`` or
``spec_k > 1``."""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.model import LM

# budget sentinel for "generate until EOS / cache full"
_UNBOUNDED = 1 << 60
_MASK63 = (1 << 63) - 1


@dataclasses.dataclass
class ServeConfig:
    slots: int = 8
    max_len: int = 256
    prefill_chunk: int = 16
    prefill_impl: str = "auto"     # "auto" | "scan" | "parallel"
    eos_id: Optional[int] = None
    temperature: float = 0.0       # 0 -> greedy
    top_k: int = 0                 # 0 -> full distribution
    seed: int = 0
    paged: bool = False
    spec_k: int = 1

    def __post_init__(self):
        if self.paged:
            raise NotImplementedError(
                "the paged KV tier is not ported yet (paged=True)")
        if self.spec_k != 1:
            raise NotImplementedError(
                f"speculative decoding is not ported yet (spec_k="
                f"{self.spec_k})")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: Optional[int] = None


def stream_seed(seed: int, rid: int, count: int) -> int:
    """Seed of the sampling stream for token ``count`` of request ``rid``
    (a splitmix64-style mix, kept to 63 bits)."""
    x = (seed * 0x9E3779B97F4A7C15 + max(rid, 0)) & 0xFFFFFFFFFFFFFFFF
    x = (x * 0xBF58476D1CE4E5B9 + count) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    x = (x * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (x ^ (x >> 29)) & _MASK63


def sample_tokens(logits: torch.Tensor, generators=None,
                  temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """Batched sampling: logits [B, V] -> int64 tokens [B].  Greedy when
    temperature == 0; otherwise temperature softmax, restricted to the
    top_k logits when top_k > 0.  ``generators`` is one
    ``torch.Generator`` for the batch or a list with one per row."""
    logits = logits.float()
    if temperature <= 0.0:
        return logits.argmax(-1)
    scaled = logits / temperature
    idx = None
    if top_k:
        scaled, idx = torch.topk(scaled, top_k, dim=-1)
    probs = torch.softmax(scaled, -1)
    if isinstance(generators, (list, tuple)):
        s = torch.cat([torch.multinomial(probs[i], 1, generator=g)
                       for i, g in enumerate(generators)])
    else:
        s = torch.multinomial(probs, 1, generator=generators)[:, 0]
    if idx is not None:
        s = idx.gather(-1, s[:, None])[:, 0]
    return s


class Server:
    """Continuous-batching slot-pool server (see module docstring).

    Scheduler API:
      submit(prompt, max_new_tokens) -> rid     enqueue a request
      step() -> events                          admissions + one decode
      run(max_steps) -> {rid: tokens}           drive until drained
      pending() -> {rid: "waiting"|"inflight"}  what run() did not finish
    Lower-level pieces (the harness and the tests use them):
      admit_waiting() / decode_once(forced_tokens)
      admit(prompt, slot, ...) -> rid           direct admission
      generate(n) -> per-slot outputs           seed-era demo API
    """

    def __init__(self, model: LM, params: Dict[str, Any], scfg: ServeConfig):
        self.scfg = scfg
        self.device = params["embed"].device
        self.model = model
        self.params = params
        n = scfg.slots
        self.active = np.zeros((n,), bool)
        self.next_tok = np.zeros((n,), np.int64)
        self.pos = np.zeros((n,), np.int64)          # mirror of cache pos
        self.n_out = np.zeros((n,), np.int64)
        self.budget = np.full((n,), _UNBOUNDED, np.int64)
        self.prompt_len = np.zeros((n,), np.int64)
        self.slot_rid = np.full((n,), -1, np.int64)
        self.outputs: Dict[int, List[int]] = {}
        self.finished: Dict[int, str] = {}           # rid -> retire reason
        self.waiting: collections.deque = collections.deque()
        self.prefill_logits = np.zeros((n, model.cfg.vocab), np.float32)
        self.last_logits: Optional[torch.Tensor] = None
        self._next_rid = 0
        self.prefill_dispatches = 0
        self.decode_dispatches = 0
        self.cache = self.model.init_cache(n, scfg.max_len,
                                           device=self.device)

    # -- sampling ---------------------------------------------------------
    def _generators(self, rids, counts) -> List[torch.Generator]:
        return [torch.Generator(device=self.device).manual_seed(
            stream_seed(self.scfg.seed, int(r), int(c)))
            for r, c in zip(rids, counts)]

    def _sample(self, logits: torch.Tensor, rids, counts) -> np.ndarray:
        gens = (None if self.scfg.temperature <= 0.0
                else self._generators(rids, counts))
        return sample_tokens(logits, gens, self.scfg.temperature,
                             self.scfg.top_k).cpu().numpy()

    # -- request intake ---------------------------------------------------
    def _check_prompt(self, prompt: Sequence[int]) -> None:
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if len(prompt) > self.scfg.max_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens does not fit the "
                f"max_len={self.scfg.max_len} cache")

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None) -> int:
        """Enqueue a request; a later step() admits it when a slot frees."""
        self._check_prompt(prompt)
        rid = self._next_rid
        self._next_rid += 1
        self.waiting.append(Request(rid, list(prompt), max_new_tokens))
        return rid

    def admit(self, prompt: Sequence[int], slot: int,
              max_new_tokens: Optional[int] = None,
              method: str = "chunked") -> int:
        """Admit a request directly into free ``slot``.  ``method``:
        "chunked" (prefill_chunk-sized pieces) or "tokenwise" (chunk 1)."""
        if self.active[slot]:
            raise ValueError(f"slot {slot} is busy")
        rid = self._next_rid
        self._next_rid += 1
        self._admit(Request(rid, list(prompt), max_new_tokens), slot, method)
        return rid

    def _admit(self, req: Request, slot: int,
               method: str = "chunked") -> List[Tuple]:
        self._check_prompt(req.prompt)
        prompt = np.asarray(req.prompt, np.int64)
        logits = self._prefill_linear(prompt, slot, method)
        tok = int(self._sample(logits[None], [req.rid], [0])[0])
        self.prefill_logits[slot] = logits.cpu().numpy()
        self.active[slot] = True
        self.slot_rid[slot] = req.rid
        self.prompt_len[slot] = len(prompt)
        self.pos[slot] = len(prompt)
        self.n_out[slot] = 0
        self.budget[slot] = (req.max_new_tokens
                             if req.max_new_tokens is not None
                             else _UNBOUNDED)
        self.outputs.setdefault(req.rid, [])
        return [("admit", req.rid, slot)] + self._append(slot, tok)

    def _prefill_linear(self, prompt: np.ndarray, slot: int,
                        method: str) -> torch.Tensor:
        c = self.scfg.prefill_chunk if method == "chunked" else 1
        self.cache = self.model.reset_slot(self.cache, slot)
        logits = None
        for i in range(0, len(prompt), c):
            chunk = prompt[i:i + c]
            nv = len(chunk)
            if nv < c:
                chunk = np.pad(chunk, (0, c - nv))
            logits, self.cache = self.model.prefill_chunk(
                self.params, self.cache,
                torch.as_tensor(chunk, device=self.device), slot, nv,
                impl=self.scfg.prefill_impl)
            self.prefill_dispatches += 1
        return logits

    # -- slot bookkeeping -------------------------------------------------
    def _append(self, slot: int, tok: int) -> List[Tuple]:
        rid = int(self.slot_rid[slot])
        self.outputs[rid].append(tok)
        self.n_out[slot] += 1
        self.next_tok[slot] = tok
        events: List[Tuple] = [("token", rid, tok)]
        scfg = self.scfg
        if scfg.eos_id is not None and tok == scfg.eos_id:
            events.append(self._retire(slot, "eos"))
        elif self.n_out[slot] >= self.budget[slot]:
            events.append(self._retire(slot, "length"))
        elif self.pos[slot] >= scfg.max_len:
            # cache full: one more token would write past the cache end
            events.append(self._retire(slot, "max_len"))
        return events

    def _retire(self, slot: int, reason: str) -> Tuple:
        rid = int(self.slot_rid[slot])
        self.active[slot] = False
        self.slot_rid[slot] = -1
        self.finished[rid] = reason
        return ("retire", rid, reason)

    # -- the serving loop -------------------------------------------------
    def admit_waiting(self) -> List[Tuple]:
        """Backfill free slots from the waiting queue.  A request whose
        admission raises ValueError is retired as "rejected", never
        silently dropped."""
        events: List[Tuple] = []
        for slot in range(self.scfg.slots):
            if not self.waiting:
                break
            if self.active[slot]:
                continue
            req = self.waiting[0]
            try:
                ev = self._admit(req, slot)
            except ValueError:
                self.waiting.popleft()
                self.outputs.setdefault(req.rid, [])
                self.finished[req.rid] = "rejected"
                events.append(("retire", req.rid, "rejected"))
                continue
            self.waiting.popleft()
            events += ev
        return events

    def decode_once(self, forced_tokens: Optional[np.ndarray] = None
                    ) -> List[Tuple]:
        """One pool-wide decode step: feed each active slot's next token
        (or ``forced_tokens``, teacher forcing), sample, append, retire.
        Idle slots are masked out of the step (their cache position must
        not drift between requests)."""
        if not self.active.any():
            return []
        act = self.active.copy()
        feed = (self.next_tok if forced_tokens is None
                else np.asarray(forced_tokens, np.int64))
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, torch.as_tensor(feed, device=self.device),
            active=torch.as_tensor(act, device=self.device))
        logits = logits.float()
        toks = self._sample(logits, self.slot_rid, self.n_out)
        self.last_logits = logits
        self.decode_dispatches += 1
        self.pos[act] += 1
        events: List[Tuple] = []
        for slot in np.nonzero(act)[0]:
            events += self._append(int(slot), int(toks[slot]))
        return events

    def step(self) -> List[Tuple]:
        """Admissions, then one decode step.  Returns event tuples
        ("admit" | "token" | "retire", rid, value)."""
        return self.admit_waiting() + self.decode_once()

    def run(self, max_steps: Optional[int] = None) -> Dict[int, List[int]]:
        """Drive until the queue and the pool drain (or max_steps; see
        pending() for what a capped run left unfinished)."""
        steps = 0
        while self.waiting or self.active.any():
            if max_steps is not None and steps >= max_steps:
                break
            self.step()
            steps += 1
        return {rid: list(toks) for rid, toks in self.outputs.items()}

    def pending(self) -> Dict[int, str]:
        """rid -> "waiting" (still queued) or "inflight" (mid-generation)
        for the requests run() did not finish."""
        out = {req.rid: "waiting" for req in self.waiting}
        for slot in np.nonzero(self.active)[0]:
            out[int(self.slot_rid[slot])] = "inflight"
        return out

    def generate(self, n_tokens: int) -> List[List[int]]:
        """Decode until every currently active slot has ``n_tokens``
        outputs (the prefill-sampled first token included) and return the
        per-slot outputs.  The budget is clamped, never raised."""
        rids = [int(self.slot_rid[s]) if self.active[s] else None
                for s in range(self.scfg.slots)]
        for s in range(self.scfg.slots):
            if self.active[s]:
                self.budget[s] = min(self.budget[s], n_tokens)
        while any(self.active[s] for s in range(self.scfg.slots)
                  if rids[s] is not None):
            self.decode_once()
        return [list(self.outputs.get(r, []))[:n_tokens]
                if r is not None else [] for r in rids]
