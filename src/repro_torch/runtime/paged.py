"""Host-side state for the paged KV serving tier (runtime/serve.py): a
copy of ``repro.runtime.paged``, kept line for line so that the port's
scheduler takes the same refcounts, free-list order and LRU order as
the reference (its preemption and prefix-reuse decisions, and so its
dispatch counts, depend on them).

The device holds one block *pool* per layer (``[n_blocks, block_len,
kv, hd]``) plus a per-slot block table; everything that decides *which*
block a position lives in is host-side and lives here:

- **BlockPool** — free-list + refcount allocator over the pool's block
  ids.  Block 0 is permanently reserved as the null sink: zeroed block-
  table rows point at it, so a write routed through a cleared table can
  never corrupt a live block.
- **PrefixTrie** — radix-style shared-prefix cache at block granularity.
  Nodes key full ``block_len``-token runs; ``match`` returns the longest
  chain of cached blocks covering a prompt (plus one partially-matching
  block for copy-on-write), ``insert`` registers a resident request's
  full blocks so later admissions (and preempted-then-resumed requests)
  re-link instead of recomputing, and ``evict`` drops least-recently-
  used leaves under pool pressure.

Refcount protocol: a block's count is (number of slot tables holding
it) + (1 if the trie caches it).  ``match`` returns blocks with a
reference already taken on behalf of the caller, so a concurrent
eviction between match and table insertion cannot free them; the
caller must ``decref`` what it does not keep (e.g. the CoW source
after copying).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple


class NoFreeBlocks(RuntimeError):
    """The pool has no free block (after trie eviction); the scheduler
    reacts by requeueing the admission or preempting a slot."""


class BlockPool:
    """Free-list + refcount allocator over ``n_blocks`` block ids.
    Block 0 is reserved (never handed out): cleared block-table rows
    point at it and absorb any stray write."""

    RESERVED = 1          # block 0 = null sink

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(f"need >= 2 blocks (one is the reserved "
                             f"null sink), got {n_blocks}")
        self.n_blocks = n_blocks
        self.ref = [0] * n_blocks
        self.ref[0] = 1
        self._free = list(range(n_blocks - 1, 0, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise NoFreeBlocks(
                f"pool of {self.n_blocks} blocks exhausted")
        b = self._free.pop()
        assert self.ref[b] == 0
        self.ref[b] = 1
        return b

    def incref(self, b: int) -> int:
        assert self.ref[b] > 0, f"incref of free block {b}"
        self.ref[b] += 1
        return b

    def decref(self, b: int) -> bool:
        """Drop one reference; returns True when the block was freed."""
        assert self.ref[b] > 0, f"decref of free block {b}"
        self.ref[b] -= 1
        if self.ref[b] == 0:
            self._free.append(b)
            return True
        return False


class _Node:
    __slots__ = ("tokens", "block", "children", "last_use")

    def __init__(self, tokens: Tuple[int, ...], block: int, clock: int):
        self.tokens = tokens
        self.block = block
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_use = clock


class PrefixTrie:
    """Radix cache over full KV blocks.  Each node caches one block's
    ``block_len`` tokens; a path from the root spells a shared prefix."""

    def __init__(self, pool: BlockPool, block_len: int):
        self.pool = pool
        self.block_len = block_len
        self.root: Dict[Tuple[int, ...], _Node] = {}
        self._clock = itertools.count()
        self.n_nodes = 0

    # -- lookup -----------------------------------------------------------
    def match(self, tokens: Sequence[int]
              ) -> Tuple[List[int], Optional[Tuple[int, int]]]:
        """Longest cached cover of ``tokens``: a list of fully-matched
        block ids, plus an optional ``(block, n_matched)`` partial match
        (the next cached block agreeing on its first ``n_matched`` < BL
        tokens — the copy-on-write source).  Every returned block has one
        reference taken for the caller."""
        bl = self.block_len
        tokens = list(tokens)
        full: List[int] = []
        level = self.root
        now = next(self._clock)
        i = 0
        while i + bl <= len(tokens):
            node = level.get(tuple(tokens[i:i + bl]))
            if node is None:
                break
            node.last_use = now
            full.append(self.pool.incref(node.block))
            level = node.children
            i += bl
        partial = None
        rest = tokens[i:]
        if rest:
            best_n, best = 0, None
            for node in level.values():
                n = 0
                for a, b in zip(node.tokens, rest):
                    if a != b:
                        break
                    n += 1
                if n > best_n:
                    best_n, best = n, node
            if best is not None:
                best.last_use = now
                partial = (self.pool.incref(best.block), best_n)
        return full, partial

    # -- registration -----------------------------------------------------
    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Cache ``blocks`` (full blocks covering ``tokens``; len(blocks)
        * block_len <= len(tokens)).  Existing nodes win (the older
        shared copy stays canonical); newly-cached blocks gain a trie
        reference.  Returns the number of new nodes."""
        bl = self.block_len
        level = self.root
        now = next(self._clock)
        added = 0
        for j, b in enumerate(blocks):
            key = tuple(tokens[j * bl:(j + 1) * bl])
            if len(key) < bl:
                break
            node = level.get(key)
            if node is None:
                node = _Node(key, self.pool.incref(b), now)
                level[key] = node
                self.n_nodes += 1
                added += 1
            else:
                node.last_use = now
                if node.block != b:
                    # same tokens cached under an older block: keep it
                    # canonical, our copy stays slot-owned only
                    pass
            level = node.children
        return added

    def insert_partial(self, tokens: Sequence[int], block: int) -> bool:
        """Cache a partially-filled block: the full-block prefix of
        ``tokens`` must already be cached (it spells the path), the
        remainder (``len(tokens) % block_len`` tokens) keys the new
        node.  Preemption registers its slot's partial tail block this
        way so a resume re-links the original bytes instead of
        recomputing them (bit-exactness of preemption-resume).  Partial
        nodes are only ever found by ``match``'s copy-on-write scan —
        their short keys can never collide with a full-block lookup."""
        bl = self.block_len
        nfull = len(tokens) // bl
        level = self.root
        now = next(self._clock)
        for j in range(nfull):
            node = level.get(tuple(tokens[j * bl:(j + 1) * bl]))
            if node is None:
                return False       # prefix path not cached
            node.last_use = now
            level = node.children
        key = tuple(tokens[nfull * bl:])
        if not key or key in level:
            return False           # nothing to add / older copy wins
        level[key] = _Node(key, self.pool.incref(block), now)
        self.n_nodes += 1
        return True

    # -- eviction ---------------------------------------------------------
    def _leaves(self):
        out = []

        def walk(level, parent_children):
            for key, node in level.items():
                if node.children:
                    walk(node.children, node.children)
                else:
                    out.append((node.last_use, key, level, node))
        walk(self.root, self.root)
        return out

    def evict(self, n_free_target: int = 1) -> bool:
        """Drop LRU leaves until the pool has ``n_free_target`` free
        blocks or the trie is empty.  Dropping a leaf releases the
        trie's reference; the block is only truly freed once no slot
        holds it.  Returns whether the target was met."""
        while self.pool.n_free < n_free_target:
            leaves = self._leaves()
            if not leaves:
                return False
            leaves.sort(key=lambda t: t[0])
            progressed = False
            for _, key, level, node in leaves:
                level.pop(key)
                self.n_nodes -= 1
                if self.pool.decref(node.block):
                    progressed = True
                if self.pool.n_free >= n_free_target:
                    return True
            if not progressed and not self._leaves():
                return False
        return True

    def clear(self) -> None:
        def walk(level):
            for node in level.values():
                walk(node.children)
                self.pool.decref(node.block)
        walk(self.root)
        self.root = {}
        self.n_nodes = 0
