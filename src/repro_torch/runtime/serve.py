"""Continuous-batching slot-pool server (counterpart of
``repro.runtime.serve``), linear and paged KV tiers.

A fixed pool of ``slots`` requests decodes together in one pool-wide step;
admission and retirement happen between decode steps:

- chunked prefill: admitting a request zeroes its slot and fills its
  cache in ceil(prompt_len / prefill_chunk) dispatches
  (``LM.prefill_chunk``), touching only that slot's row.  The first output
  token is sampled from the prefill logits;
- slot scheduler: per-slot position and output count, EOS / length /
  max_len retirement, and a waiting queue that backfills freed slots;
- isolation: each slot attends only its own cache rows (per-slot
  lengths), and a freed slot is zeroed (linear) or unmapped (paged)
  before reuse;
- sampling: greedy, temperature or top-k over the pool, with one
  ``torch.Generator`` per (request, token index) so that a request's
  sampled stream does not depend on what else is in the pool.  The bits
  differ from repro's ``jax.random`` streams; greedy streams match.

Paged tier (``ServeConfig.paged``):

- block-pool KV cache: one block pool per layer plus a per-slot block
  table (``LM.init_cache_paged``); the host side of the allocator is
  runtime/paged.py (``BlockPool`` refcounts, ``PrefixTrie``).  Memory is
  committed per block written; an admission that finds no free block
  stays queued (``NoFreeBlocks``), and decode-time growth preempts the
  youngest slot (LIFO) once the trie has nothing left to evict.  A
  preempted request is requeued at the front with its generated tokens
  folded into its prompt and resumes through prefill (and trie
  re-linking), continuing its stream exactly;
- shared-prefix reuse: an admission walks the trie, re-links the fully
  matched blocks, copies a partially matched block (copy-on-write) and
  prefills only the unmatched suffix;
- self-speculative decoding (``spec_k > 1``): one round drafts ``spec_k``
  tokens per slot by stepping the exact decode step, then one batched
  read-only re-score (``LM.decode_rescore``) verifies the draft; emitted
  tokens always come from the draft, so the stream equals sequential
  decoding while tokens arrive up to ``spec_k`` per round.

Plan sharding (both tiers, speculative decoding included): a model with
``LM.plan`` and ``LM.mesh`` serves under ``plan.for_pool(slots, axis
sizes)``: the params (full tensors, the same on every rank, or DTensors
placed already) are placed as DTensors by ``models/sharding.py``'s rules,
and each rank allocates only its own shard of the cache (the linear
cache, or the paged pool and its block table).  Every rank runs this
same host scheduler from the same seed (SPMD) and joins every step's
collectives; the logits that sampling reads are gathered whole on every
rank, so every rank takes the same decisions.  The host's table mirror
is written into each rank's table shard; the speculative rollback of
positions and table stays host-side.  The hybrid family (zamba2) serves
on the linear tier, on one card or under a plan: its cache holds each
layer's Mamba state beside the shared block's rings, its prompts go
through the scan prefill, and, as in repro, it has no paged tier (the
paged cache raises) and its speculative drafts are accepted without a
re-score (a recurrent state has none).

Observation (``Server(..., registry=, monitor=)``, repro's wiring): the
scheduler emits repro's spans and instants (``serve.admit``,
``serve.prefill``, ``serve.trie_match``, ``serve.decode``,
``serve.draft``, ``serve.verify``; ``serve.admitted``, ``serve.resume``,
``serve.preempt``, ``serve.retire``), ~free while tracing is off; the
registry gets repro's four scheduler metrics (``serve.tokens``,
``serve.preemptions``, ``serve.prompt_cache_hits``,
``serve.block_pool_utilization``; without a registry they are shared
no-ops); the monitor (``obs.monitor.Monitor``) gets each token's TTFT or
ITL, the queue depth at each admission pass and a bump per preemption.
Each monitor hook is one ``is None`` check, and no hook reads the device:
the token times are taken where the sampled tokens already reach the
host.  A monitor never changes a scheduling decision, so under a plan
every rank takes the same decisions whether or not it has one."""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard

from ..kernels import ops
from ..models.common import local, whole
from ..models.model import LM, paged_ok
from ..models.sharding import global_offset
from ..obs import metrics as _metrics
from ..obs.tracing import instant as _instant, span as _span
from .paged import BlockPool, NoFreeBlocks, PrefixTrie

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
    # -- paged KV tier (dense full-attention configurations only) ----------
    paged: bool = False
    block_len: int = 16            # must divide max_len
    # pool size; None -> slots * (max_len // block_len) + 1 (the +1 is the
    # reserved null block: the same capacity as the linear cache)
    n_blocks: Optional[int] = None
    prefix_cache: bool = True      # radix shared-prefix reuse
    # -- self-speculative decoding ------------------------------------------
    spec_k: int = 1                # tokens drafted per round; 1 = off
    spec_verify: bool = True       # batched re-score of the draft


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: Optional[int] = None
    # outputs already generated before a preemption; the resume prompt
    # carries them, and sampling continues at this token index
    prior_out: int = 0


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
                                                (or speculative) round
      run(max_steps) -> {rid: tokens}           drive until drained
      pending() -> {rid: "waiting"|"inflight"}  what run() did not finish
    Lower-level pieces (the harness and the tests use them):
      admit_waiting() / decode_once(forced_tokens) / spec_once()
      admit(prompt, slot, ...) -> rid           direct admission
      generate(n) -> per-slot outputs           seed-era demo API
    """

    def __init__(self, model: LM, params: Dict[str, Any], scfg: ServeConfig,
                 registry: Optional[_metrics.Registry] = None, monitor=None):
        self.scfg = scfg
        # scheduler-side metrics; None -> shared no-op instruments, so an
        # unobserved server (warm-up, tests) records nothing
        reg = registry if registry is not None else _metrics.NULL
        self.registry = registry
        # continuous SLO / anomaly monitor (obs.monitor.Monitor); when
        # None the token path pays one attribute check
        self.monitor = monitor
        self._t_submit: Dict[int, float] = {}   # rid -> submit time
        self._t_last: Dict[int, float] = {}     # rid -> last token time
        self._m_tokens = reg.counter(
            "serve.tokens", help="tokens emitted across all requests")
        self._m_preempt = reg.counter(
            "serve.preemptions", help="slot preemptions")
        self._m_prefix_hits = reg.counter(
            "serve.prompt_cache_hits",
            help="prompt tokens served from the prefix trie")
        self._m_pool_util = reg.gauge(
            "serve.block_pool_utilization",
            help="fraction of KV pool blocks in use (post-dispatch)")
        self.device = params["embed"].device
        n = scfg.slots
        self.mesh, self.plan = model.mesh, model.plan
        self.sharded = self.plan is not None
        if self.sharded:
            if self.mesh is None:
                raise ValueError("a sharding plan needs LM.mesh to place on")
            sizes = dict(zip(self.mesh.mesh_dim_names,
                             self.mesh.mesh.shape))
            self.plan = self.plan.for_pool(n, sizes)
            model = dataclasses.replace(model, plan=self.plan,
                                        mesh=self.mesh)
            from ..models.sharding import place_tree
            params = place_tree(params, self.mesh, self.plan)
        self.model = model
        self.params = params
        self.active = np.zeros((n,), bool)
        self.next_tok = np.zeros((n,), np.int64)
        self.pos = np.zeros((n,), np.int64)          # mirror of cache pos
        self.n_out = np.zeros((n,), np.int64)
        self.budget = np.full((n,), _UNBOUNDED, np.int64)
        self.prompt_len = np.zeros((n,), np.int64)
        self.slot_rid = np.full((n,), -1, np.int64)
        self.slot_seq = np.full((n,), -1, np.int64)  # admission order
        self.outputs: Dict[int, List[int]] = {}
        self.finished: Dict[int, str] = {}           # rid -> retire reason
        self.waiting: collections.deque = collections.deque()
        self.prefill_logits = np.zeros((n, model.cfg.vocab), np.float32)
        self.last_logits: Optional[torch.Tensor] = None
        self._next_rid = 0
        self._seq = itertools.count()
        self._slot_prompt: Dict[int, List[int]] = {}
        self._events: List[Tuple] = []               # preemptions, drained
        self.prefill_dispatches = 0
        self.decode_dispatches = 0
        self.verify_dispatches = 0
        self.preemptions = 0
        self.prompt_cache_hits = 0        # prompt tokens served from trie

        # paged allocator state (host side of the block pool)
        self.paged = scfg.paged
        self.pool: Optional[BlockPool] = None
        self.trie: Optional[PrefixTrie] = None
        if self.paged:
            self.bl = scfg.block_len
            if scfg.max_len % self.bl:
                raise ValueError(
                    f"block_len={self.bl} must divide "
                    f"max_len={scfg.max_len}")
            self.mb = scfg.max_len // self.bl
            nb = (scfg.n_blocks if scfg.n_blocks is not None
                  else n * self.mb + 1)
            if nb < self.mb + 1:
                raise ValueError(
                    f"n_blocks={nb} cannot hold one full-length request "
                    f"({self.mb} blocks + the reserved null block): the "
                    "scheduler could deadlock")
            self.n_blocks = nb
            self.pool = BlockPool(nb)
            if scfg.prefix_cache:
                self.trie = PrefixTrie(self.pool, self.bl)
            self.table = np.zeros((n, self.mb), np.int32)
            self.n_slot_blocks = np.zeros((n,), np.int64)
        if self.sharded:
            # each rank allocates only its shard of the cache
            from ..models.sharding import CACHE_RULES, zeros_tree
            shapes = (self.model.cache_shapes_paged(n, scfg.max_len, nb,
                                                    self.bl)
                      if self.paged else
                      self.model.cache_shapes(n, scfg.max_len))
            self.cache = zeros_tree(shapes, self.mesh, self.plan,
                                    CACHE_RULES, device=self.device)
        elif self.paged:
            self.cache = self.model.init_cache_paged(
                n, scfg.max_len, nb, self.bl, device=self.device)
        else:
            self.cache = self.model.init_cache(n, scfg.max_len,
                                               device=self.device)
        self._table_dirty = False
        self._pos_dirty = False
        self._can_verify = paged_ok(model.cfg)

    def _drain(self) -> List[Tuple]:
        ev, self._events = self._events, []
        return ev

    def _flush_host_state(self) -> None:
        """Push the host's truth (block table, positions) to the device
        cache.  The host mutates its mirrors freely between dispatches
        (admission, preemption, speculative rollback) and flushes once
        before the next dispatch.  The copies are blocking: the host
        waits until the stream has read its arrays, so it may write them
        again at once (an asynchronous copy from these arrays could read
        them after a later mutation).  Under a plan each rank writes its
        own shard of the table from the mirror."""
        if self._table_dirty:
            t = self.cache["block_table"]
            lt = local(t)
            r0, c0 = global_offset(t)
            lt.copy_(torch.from_numpy(
                self.table[r0:r0 + lt.shape[0], c0:c0 + lt.shape[1]]))
            self._table_dirty = False
        if self._pos_dirty:
            local(self.cache["pos"]).copy_(
                torch.from_numpy(self.pos.astype(np.int32)))
            self._pos_dirty = False

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
        if self.monitor is not None:
            self._t_submit[rid] = time.perf_counter()
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
        with _span("serve.admit", rid=req.rid, slot=slot,
                   prompt_len=len(req.prompt)):
            return self._admit_impl(req, slot, method)

    def _admit_impl(self, req: Request, slot: int,
                    method: str) -> List[Tuple]:
        self._check_prompt(req.prompt)
        prompt = np.asarray(req.prompt, np.int64)
        if self.paged:
            # may raise NoFreeBlocks, before any state is touched
            logits = self._prefill_paged(prompt, slot, method,
                                         resume_tail=req.prior_out)
        else:
            logits = self._prefill_linear(prompt, slot, method)
        if req.prior_out:
            _instant("serve.resume", rid=req.rid, slot=slot)
        else:
            _instant("serve.admitted", rid=req.rid, slot=slot)
        logits = whole(logits)     # the same on every rank under a plan
        tok = int(self._sample(logits[None], [req.rid], [req.prior_out])[0])
        self.prefill_logits[slot] = logits.cpu().numpy()
        self.active[slot] = True
        self.slot_rid[slot] = req.rid
        self.slot_seq[slot] = next(self._seq)
        self.prompt_len[slot] = len(prompt)
        self.pos[slot] = len(prompt)
        self.n_out[slot] = req.prior_out
        self.budget[slot] = (req.max_new_tokens
                             if req.max_new_tokens is not None
                             else _UNBOUNDED)
        # a resumed (preempted) request keeps its outputs so far
        self.outputs.setdefault(req.rid, [])
        # the request's own prompt, without the outputs a resume folds in:
        # a later preemption appends all its outputs to it, and the cache
        # holds this prompt followed by the outputs.  (repro keeps the
        # resume prompt here, so a second preemption of one request
        # duplicates its first outputs; ROADMAP C.)
        self._slot_prompt[slot] = [
            int(x) for x in prompt[:len(prompt) - req.prior_out]]
        return [("admit", req.rid, slot)] + self._append(slot, tok)

    def _prefill_linear(self, prompt: np.ndarray, slot: int,
                        method: str) -> torch.Tensor:
        c = self.scfg.prefill_chunk if method == "chunked" else 1
        with _span("serve.prefill", slot=slot, tokens=len(prompt)):
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

    # -- paged admission: trie match + CoW + suffix prefill ---------------
    def _prefill_paged(self, prompt: np.ndarray, slot: int, method: str,
                       resume_tail: int = 0) -> torch.Tensor:
        with _span("serve.prefill", slot=slot, tokens=len(prompt)):
            return self._prefill_paged_impl(prompt, slot, method,
                                            resume_tail)

    def _prefill_paged_impl(self, prompt: np.ndarray, slot: int,
                            method: str,
                            resume_tail: int = 0) -> torch.Tensor:
        """Build the slot's block-table row (re-linking trie-cached prefix
        blocks, copy-on-write for a partial block match, fresh blocks for
        the suffix), then prefill only the unmatched suffix.
        ``resume_tail`` > 0 marks a preempted request coming back: its
        last ``resume_tail`` prompt tokens were decode-written before the
        preemption, so they run again through the scan prefill (the
        decode step itself), while the original prompt keeps the
        configured prefill and its chunk boundaries; a full recompute
        then reproduces the first admission bit for bit.  Raises
        NoFreeBlocks, with every acquired reference rolled back, before
        touching any scheduler or device state."""
        scfg, bl = self.scfg, self.bl
        p_len = len(prompt)
        toks = [int(x) for x in prompt]
        acquired: List[int] = []    # one caller reference each
        row: List[int] = []
        pending_copy = None
        cached = 0
        full: List[int] = []
        part = cow = None
        take = 0
        try:
            # at least one suffix token must remain to produce logits
            limit = p_len - 1
            if self.trie is not None:
                with _span("serve.trie_match", slot=slot) as sp:
                    full, part = self.trie.match(toks)
                    sp.set(full_blocks=len(full),
                           partial=part is not None)
                acquired += full
                if part is not None:
                    acquired.append(part[0])
            keep = min(len(full), limit // bl)
            if len(full) > keep:
                # prompt fully covered: the next full block degrades to a
                # CoW source for its first (limit - keep * bl) tokens
                cow = (full[keep], bl)
            elif part is not None:
                cow = part
            row = list(full[:keep])
            cached = keep * bl
            if cow is not None:
                take = min(cow[1], limit - cached)
            if take > 0:
                dst = self._alloc_block()
                acquired.append(dst)
                pending_copy = (dst, cow[0])
                row.append(dst)
                cached += take
            while len(row) < (p_len - 1) // bl + 1:
                b = self._alloc_block()
                acquired.append(b)
                row.append(b)
        except NoFreeBlocks:
            for b in acquired:
                self.pool.decref(b)
            raise
        # drop the references not kept: unused full matches past the CoW
        # source, the partial match when a full block won the CoW slot,
        # and the CoW source itself when nothing was taken
        drop_now = list(full[keep + 1:])
        if part is not None and (cow is None or cow[0] != part[0]):
            drop_now.append(part[0])
        if cow is not None and take <= 0:
            drop_now.append(cow[0])
        for b in drop_now:
            self.pool.decref(b)

        self.table[slot, :] = 0
        self.table[slot, :len(row)] = row
        self.n_slot_blocks[slot] = len(row)
        self.pos[slot] = cached
        self._table_dirty = True
        self._pos_dirty = True
        self.prompt_cache_hits += cached
        self._m_prefix_hits.inc(cached)
        c = scfg.prefill_chunk if method == "chunked" else 1
        # the decode-written tail of a resumed prompt must scan; the
        # original prompt keeps the configured impl, with chunks capped at
        # the boundary exactly as the first admission capped them at its
        # prompt end
        split = p_len - resume_tail
        if pending_copy is not None:
            self._copy_block(*pending_copy)
            self.pool.decref(pending_copy[1])
        self._flush_host_state()
        logits = None
        i = cached
        while i < p_len:
            if i < split:
                j, impl = min(i + c, split), scfg.prefill_impl
            else:
                j, impl = min(i + c, p_len), "scan"
            chunk = prompt[i:j]
            nv = j - i
            if nv < c:
                chunk = np.pad(chunk, (0, c - nv))
            logits, self.cache = self.model.prefill_chunk(
                self.params, self.cache,
                torch.as_tensor(chunk, device=self.device), slot, nv,
                impl=impl)
            self.prefill_dispatches += 1
            i = j
        if self.trie is not None:
            self.trie.insert(toks, row[:p_len // bl])
        return logits

    def _copy_block(self, dst: int, src: int) -> None:
        """Copy-on-write: duplicate pool block ``src`` into ``dst`` in
        every layer, in place, once per pool (K and V).  Under a plan each
        rank copies within its own shard of the pool (its block_len,
        kv_heads and hd cuts hold the same part of both blocks); where a
        mesh dim cuts ``blocks``, ``src`` and ``dst`` may live on
        different ranks, so that cut is gathered first, counted in
        ``ops.plan_fallbacks["copy_block"]``."""
        for pool in self.cache["pages"].values():
            lp = local(pool)
            placed = list(getattr(pool, "placements", ()))
            whole_blocks = [Replicate() if isinstance(p, Shard) and p.dim == 1
                            else p for p in placed]
            if whole_blocks == placed:
                lp[:, dst] = lp[:, src]
                continue
            ops.plan_fallbacks["copy_block"] += 1
            src_row = local(pool.redistribute(pool.device_mesh,
                                              whole_blocks))[:, src]
            nb0 = global_offset(pool)[1]
            if lp.numel() and nb0 <= dst < nb0 + lp.shape[1]:
                lp[:, dst - nb0] = src_row

    # -- paged allocator glue ---------------------------------------------
    def _alloc_block(self, protect: Optional[int] = None,
                     allow_preempt: bool = False) -> int:
        """One free pool block, reclaiming in escalation order: free list
        -> trie LRU eviction -> (decode time only) preempting the youngest
        active slot.  Admissions never preempt: they requeue on
        NoFreeBlocks instead, so a burst cannot thrash the pool."""
        while True:
            try:
                return self.pool.alloc()
            except NoFreeBlocks:
                if self.trie is not None and self.trie.evict(1):
                    continue
                if not allow_preempt:
                    raise
                victim = self._pick_victim(protect)
                if victim is None:
                    raise
                self._preempt(victim)

    def _pick_victim(self, protect: Optional[int]) -> Optional[int]:
        best, best_seq = None, -1
        for s in range(self.scfg.slots):
            if s == protect or not self.active[s]:
                continue
            if self.slot_seq[s] > best_seq:
                best_seq, best = int(self.slot_seq[s]), s
        return best

    def _preempt(self, slot: int) -> None:
        """LIFO preemption: release the slot's blocks (registering its
        prefix in the trie, so the resume re-links instead of
        recomputing) and requeue the request at the front with its
        generated tokens folded into its prompt.  Sampling resumes at
        ``prior_out``, so the output stream continues exactly."""
        rid = int(self.slot_rid[slot])
        outs = list(self.outputs.get(rid, []))
        self._release_blocks(slot, rid)
        self.active[slot] = False
        self.slot_rid[slot] = -1
        self.pos[slot] = 0
        self._pos_dirty = True
        b = int(self.budget[slot])
        self.waiting.appendleft(Request(
            rid, self._slot_prompt.get(slot, []) + outs,
            None if b >= _UNBOUNDED else b, prior_out=len(outs)))
        self.preemptions += 1
        self._m_preempt.inc()
        if self.monitor is not None:
            self.monitor.bump("preempt")
        _instant("serve.preempt", rid=rid, slot=slot)
        self._events.append(("preempt", rid, slot))

    def _release_blocks(self, slot: int, rid: int) -> None:
        """Give the slot's block-table row back to the pool, first caching
        the full-block prefix of (prompt + outputs in the cache) in the
        trie for later shared-prefix admissions."""
        nb = int(self.n_slot_blocks[slot])
        row = [int(b) for b in self.table[slot, :nb]]
        if self.trie is not None and row:
            pos = int(self.pos[slot])
            seq = (self._slot_prompt.get(slot, [])
                   + self.outputs.get(rid, []))
            nfull = pos // self.bl
            self.trie.insert(seq[:pos], row[:nfull])
            # the partially filled tail block too: a preempted request
            # resumes by re-linking these exact bytes (CoW), which keeps
            # the resume bit-exact instead of recomputing K/V
            if pos % self.bl and nfull < len(row):
                self.trie.insert_partial(seq[:pos], row[nfull])
        for b in row:
            self.pool.decref(b)
        self.table[slot, :] = 0
        self.n_slot_blocks[slot] = 0
        self._table_dirty = True

    def _ensure_blocks(self, slot: int, last_pos: int) -> None:
        """Map pool blocks covering writes up to position ``last_pos``
        (escalating through trie eviction and preemption; the slot itself
        is protected)."""
        while int(self.n_slot_blocks[slot]) * self.bl <= last_pos:
            blk = self._alloc_block(protect=slot, allow_preempt=True)
            self.table[slot, int(self.n_slot_blocks[slot])] = blk
            self.n_slot_blocks[slot] += 1
            self._table_dirty = True

    def _ensure_active_blocks(self, last_pos) -> None:
        """_ensure_blocks for every active slot, up to ``last_pos(slot)``.
        Growing one slot can preempt a later one in the same loop, so each
        slot is checked again when its turn comes."""
        for slot in np.nonzero(self.active)[0]:
            s = int(slot)
            if self.active[s]:
                self._ensure_blocks(s, last_pos(s))

    # -- slot bookkeeping -------------------------------------------------
    def _observe_token(self, rid: int) -> None:
        """Feed the monitor one emitted token: the first since submit is a
        TTFT, every later one an ITL.  A preemption gap lands in the ITL
        stream: that is what the client sees."""
        now = time.perf_counter()
        last = self._t_last.get(rid)
        if last is None:
            t0 = self._t_submit.pop(rid, None)
            if t0 is not None:
                self.monitor.observe("ttft", now - t0)
        else:
            self.monitor.observe("itl", now - last)
        self._t_last[rid] = now

    def _append(self, slot: int, tok: int) -> List[Tuple]:
        rid = int(self.slot_rid[slot])
        self.outputs[rid].append(tok)
        self._m_tokens.inc()
        if self.monitor is not None:
            self._observe_token(rid)
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
        if self.paged:
            self._release_blocks(slot, rid)
        self.active[slot] = False
        self.slot_rid[slot] = -1
        self.finished[rid] = reason
        self._t_last.pop(rid, None)
        self._t_submit.pop(rid, None)
        _instant("serve.retire", rid=rid, slot=slot, reason=reason)
        return ("retire", rid, reason)

    # -- the serving loop -------------------------------------------------
    def admit_waiting(self) -> List[Tuple]:
        """Backfill free slots from the waiting queue.  A request whose
        admission fails is requeued (NoFreeBlocks: the paged pool is full
        for now; admission order is kept) or retired as "rejected" (an
        invalid request), never silently dropped."""
        if self.monitor is not None:
            self.monitor.observe("queue_depth", float(len(self.waiting)))
        events: List[Tuple] = []
        for slot in range(self.scfg.slots):
            if not self.waiting:
                break
            if self.active[slot]:
                continue
            req = self.waiting[0]
            try:
                ev = self._admit(req, slot)
            except NoFreeBlocks:
                break          # stays queued; retirements will free blocks
            except ValueError:
                self.waiting.popleft()
                self.outputs.setdefault(req.rid, [])
                self.finished[req.rid] = "rejected"
                events.append(("retire", req.rid, "rejected"))
                continue
            self.waiting.popleft()
            events += ev
        return self._drain() + events

    def decode_once(self, forced_tokens: Optional[np.ndarray] = None
                    ) -> List[Tuple]:
        """One pool-wide decode step: feed each active slot's next token
        (or ``forced_tokens``, teacher forcing), sample, append, retire.
        Idle slots are masked out of the step (their cache position must
        not drift between requests)."""
        events = self._drain()
        if not self.active.any():
            return events
        if self.paged:
            self._ensure_active_blocks(lambda s: int(self.pos[s]))
        act = self.active.copy()        # after any preemption
        events += self._drain()
        if not act.any():
            return events
        self._flush_host_state()
        feed = (self.next_tok if forced_tokens is None
                else np.asarray(forced_tokens, np.int64))
        slots = [int(s) for s in np.nonzero(act)[0]]
        with _span("serve.decode", slots=slots):
            logits, self.cache = self.model.decode_step(
                self.params, self.cache,
                torch.as_tensor(feed, device=self.device),
                active=torch.as_tensor(act, device=self.device))
            logits = whole(logits).float()
            toks = self._sample(logits, self.slot_rid, self.n_out)
        self.last_logits = logits
        self.decode_dispatches += 1
        if self.pool is not None:
            self._m_pool_util.set(1.0 - self.pool.n_free / self.n_blocks)
        self.pos[act] += 1
        for slot in slots:
            events += self._append(slot, int(toks[slot]))
        return events

    def spec_once(self) -> List[Tuple]:
        """One speculative round: draft ``spec_k`` tokens per active slot
        by stepping the decode step ``spec_k`` times (the steps, tokens
        and generators of ``spec_k`` decode_once calls), optionally verify
        them with one batched re-score, then accept the longest prefix on
        which draft and verify agree (at least one token).  Emitted tokens
        always come from the draft, so the stream equals decode_once's."""
        events = self._drain()
        if not self.active.any():
            return events
        kk, max_len = self.scfg.spec_k, self.scfg.max_len
        if self.paged:
            self._ensure_active_blocks(
                lambda s: min(int(self.pos[s]) + kk - 1, max_len - 1))
        act = self.active.copy()
        events += self._drain()
        if not act.any():
            return events
        self._flush_host_state()
        base_pos = self.pos.copy()
        base_out = self.n_out.copy()
        n = self.scfg.slots
        slots = [int(s) for s in np.nonzero(act)[0]]
        toks = np.zeros((kk, n), np.int64)
        feed, counts, dpos = self.next_tok.copy(), base_out.copy(), \
            base_pos.copy()
        logits = None
        with _span("serve.draft", slots=slots, k=kk):
            for j in range(kk):
                # a row reaching max_len freezes mid-draft
                a = act & (dpos < max_len)
                logits, self.cache = self.model.decode_step(
                    self.params, self.cache,
                    torch.as_tensor(feed, device=self.device),
                    active=torch.as_tensor(a, device=self.device))
                logits = whole(logits).float()
                nt = np.where(a, self._sample(logits, self.slot_rid, counts),
                              feed)
                counts = counts + a
                dpos = dpos + a
                toks[j] = nt
                feed = nt
        self.decode_dispatches += 1
        accept = np.full((n,), kk, np.int64)
        if kk > 1 and self.scfg.spec_verify and self._can_verify:
            # feed_v[j] is the token that produced draft token j
            feed_v = np.concatenate([self.next_tok[None], toks[:-1]], 0)
            with _span("serve.verify", slots=slots, k=kk):
                vt = self._verify(feed_v.T.reshape(-1), base_pos, base_out)
            self.verify_dispatches += 1
            agree = vt.T == toks                      # [K, B]
            for s in range(n):
                if not act[s] or agree[:, s].all():
                    continue
                accept[s] = max(1, int(np.argmin(agree[:, s])))
        self.last_logits = logits
        for slot in np.nonzero(act)[0]:
            s = int(slot)
            for j in range(int(accept[s])):
                if not self.active[s]:
                    break                             # retired mid-round
                self.pos[s] += 1
                events += self._append(s, int(toks[j, s]))
        # the device ran spec_k steps ahead of what was accepted (and a
        # retirement mid-round stops earlier): roll the positions back to
        # the host's truth.  The K/V written past them is overwritten by
        # the next write at the same position before any attention reads
        # it (length masking), so only pos needs the rollback.
        self._pos_dirty = True
        self._flush_host_state()
        return events + self._drain()

    def _verify(self, feed: np.ndarray, base_pos: np.ndarray,
                base_out: np.ndarray) -> np.ndarray:
        """Batched re-score of a K-token draft: tokens [B, K] sampled from
        the logits of feeding feed[b * K + j] at position base_pos[b] + j
        of row b, with the generators the draft used.  Read-only."""
        n, kk = self.scfg.slots, self.scfg.spec_k
        rows = np.repeat(np.arange(n), kk)
        positions = (base_pos[:, None] + np.arange(kk)).reshape(-1)
        logits = whole(self.model.decode_rescore(
            self.params, self.cache, torch.as_tensor(feed, device=self.device),
            torch.as_tensor(rows, device=self.device),
            torch.as_tensor(positions, device=self.device)))
        counts = (base_out[:, None] + np.arange(kk)).reshape(-1)
        return self._sample(logits.float(), np.repeat(self.slot_rid, kk),
                            counts).reshape(n, kk)

    def step(self) -> List[Tuple]:
        """Admissions, then one decode (or speculative) round.  Returns
        event tuples ("admit" | "token" | "retire" | "preempt", rid,
        value)."""
        events = self.admit_waiting()
        if self.scfg.spec_k > 1:
            return events + self.spec_once()
        return events + self.decode_once()

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
