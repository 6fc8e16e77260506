"""The dense decoder LM (counterpart of ``repro.models.model.LM``, dense
branch): init, forward, loss, the linear slot cache and the paged block
pool, decode, chunked prefill and the speculative re-score.

Params are plain dicts of tensors with the same keys and shapes as repro's
param tree: per-layer weights stacked on a leading ``[L]`` axis, ``ln*``
in f32, the rest in ``cfg.dtype``, weights ``[in, out]`` used as
``x @ w``.  Layers run as a Python loop over per-layer views.  ``forward``
(training) takes the views with ``torch.unbind`` on every call, so the
backward stacks each weight's L gradients in one node, and under autograd
it runs each layer under ``torch.utils.checkpoint`` (repro's per-layer
``jax.checkpoint``): only the layer inputs are kept, and the layer is
recomputed in the backward.  Decode and prefill never differentiate and
reuse views cached across steps.

Unlike repro's pure functions, the cache is updated in place: the decode
and prefill steps write K/V and advance ``pos`` inside the tensors they
are given and return the same dict.  The writes repro drops with
``mode="drop"`` (inactive slots, a prefill chunk's tail past max_len) are
masked here without ever indexing out of range or wrapping a negative
index; in the paged pool they go to block 0, the null sink that the host
allocator (runtime/paged.py) never hands out."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from .attention import attend_cache, attend_paged, attention
from .common import (dense_init, embed_init, resolve_device, rms_norm, rope,
                     softmax_cross_entropy)

Params = Dict[str, Any]
Cache = Dict[str, Any]

PREFILL_IMPLS = ("auto", "scan", "parallel")


def prefill_parallel_ok(cfg: ArchConfig) -> bool:
    """Whether prefill_chunk can run a chunk in parallel (offset flash
    attention against a linear KV cache); same rule as repro."""
    return (not (cfg.family == "hybrid" and cfg.attn_every)
            and cfg.xlstm is None and cfg.family != "ssm"
            and cfg.swa_window is None)


def paged_ok(cfg: ArchConfig) -> bool:
    """Whether the paged block-pool KV layout applies (same precondition
    as parallel prefill, as in repro)."""
    return prefill_parallel_ok(cfg)


def _unsupported_family(cfg: ArchConfig) -> Optional[str]:
    if cfg.moe is not None:
        return "moe"
    if cfg.family == "hybrid" or cfg.attn_every:
        return "hybrid"
    if cfg.family == "ssm" or cfg.ssm is not None:
        return "ssm"
    if cfg.xlstm is not None:
        return "xlstm"
    if cfg.embed_stub:
        return "embed-stub"
    return None


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _index(tree: Params, i: int) -> Params:
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unbind(tree: Params) -> List[Params]:
    """Per-layer views of stacked ``[L, ...]`` leaves, one unbind per leaf
    (its backward is one stack of the L gradients, not L scatters into
    full-size zeros)."""
    flat = {k: _unbind(v) if isinstance(v, dict) else torch.unbind(v)
            for k, v in tree.items()}
    n = len(next(iter(flat.values())))
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


def _mlp_forward(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = F.silu((x @ p["wg"]).float()).to(x.dtype)
    return (g * (x @ p["wu"])) @ p["wd"]


@dataclasses.dataclass
class LM:
    cfg: ArchConfig
    # per-layer views of the last params["layers"] seen (built once, not
    # on every step); holds the dict itself so identity stays meaningful
    _views: Tuple[Any, List[Params]] = dataclasses.field(
        default=(None, []), init=False, repr=False, compare=False)

    def __post_init__(self):
        fam = _unsupported_family(self.cfg)
        if fam is not None:
            raise NotImplementedError(
                f"{self.cfg.name}: the {fam} family is not ported yet; the "
                "port serves the dense family")

    # -- params ------------------------------------------------------------
    def param_shapes(self) -> Params:
        """Tree of (shape, dtype) with repro's keys, for init and for the
        JAX weight converter's checks."""
        cfg = self.cfg
        d, hd, L = cfg.d_model, cfg.hd, cfg.n_layers
        h, kv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
        dt, f32 = torch_dtype(cfg), torch.float32
        attn = {"wq": ((L, d, h * hd), dt), "wk": ((L, d, kv * hd), dt),
                "wv": ((L, d, kv * hd), dt), "wo": ((L, h * hd, d), dt)}
        if cfg.qkv_bias:
            attn.update(bq=((L, h * hd), dt), bk=((L, kv * hd), dt),
                        bv=((L, kv * hd), dt))
        tree: Params = {
            "embed": ((cfg.vocab, d), dt),
            "ln_f": ((d,), f32),
            "layers": {"ln1": ((L, d), f32), "ln2": ((L, d), f32),
                       "attn": attn,
                       "mlp": {"wg": ((L, d, f), dt), "wu": ((L, d, f), dt),
                               "wd": ((L, f, d), dt)}},
        }
        if not cfg.tie_embeddings:
            tree["lm_head"] = ((d, cfg.vocab), dt)
        return tree

    def init(self, seed: int = 0, device="cuda") -> Params:
        """Random params from ``torch.Generator(seed)`` on ``device``:
        normal/sqrt(fan_in) weights, 0.02-normal embedding, zero biases,
        unit norms (repro's init rules; the values differ, the PRNGs do)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)

        def make(name, spec):
            if isinstance(spec, dict):
                return {k: make(k, v) for k, v in spec.items()}
            shape, dt = spec
            if name.startswith("ln"):
                return torch.ones(shape, dtype=dt, device=dev)
            if name in ("bq", "bk", "bv"):
                return torch.zeros(shape, dtype=dt, device=dev)
            if name == "embed":
                return embed_init(shape, gen, dtype=dt, device=dev)
            # stacked [L, in, out] (or [in, out] for lm_head): fan_in = in
            return dense_init(shape, gen, in_axis=len(shape) - 2, dtype=dt,
                              device=dev)

        return {k: make(k, v) for k, v in self.param_shapes().items()}

    def _layers(self, params: Params) -> List[Params]:
        src, views = self._views
        if src is not params["layers"]:
            views = [_index(params["layers"], i)
                     for i in range(self.cfg.n_layers)]
            self._views = (params["layers"], views)
        return views

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        w = (params["embed"].T if self.cfg.tie_embeddings
             else params["lm_head"])
        return x @ w

    def _qkv(self, p: Params, x: torch.Tensor):
        q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
        if self.cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        return q, k, v

    # -- forward (train) -----------------------------------------------------
    def _layer(self, p: Params, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        b, s, _ = x.shape
        xn = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = self._qkv(p["attn"], xn)
        q = rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta)
        k = rope(k.reshape(b, s, kvh, hd), positions, cfg.rope_theta)
        v = v.reshape(b, s, kvh, hd)
        o = attention(q, k, v, causal=True, window=cfg.swa_window)
        x = x + o.reshape(b, s, h * hd) @ p["attn"]["wo"]
        return x + _mlp_forward(p["mlp"], rms_norm(x, p["ln2"],
                                                   cfg.norm_eps))

    def forward(self, params: Params,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, S] -> (logits [B, S, V], aux_loss 0).  Under autograd
        each layer is rematerialised in the backward."""
        x = params["embed"][tokens]
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        remat = torch.is_grad_enabled()
        for p in _unbind(params["layers"]):
            if remat:
                x = checkpoint(self._layer, p, x, positions,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = self._layer(p, x, positions)
        x = rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        return self._head(params, x), torch.zeros((), device=x.device)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """Token-mean CE (f32) of ``batch["tokens"]`` against
        ``batch["labels"]``, plus 0.01 x the aux loss, as repro."""
        logits, aux = self.forward(params, batch["tokens"])
        ce = softmax_cross_entropy(logits, batch["labels"], self.cfg.vocab)
        return ce + 0.01 * aux

    # -- the linear slot cache --------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device="cuda") -> Cache:
        """{"pos": [B] int32, "kv": {"k", "v": [L, B, S, KV, hd] bf16}}.
        The cache is bf16 whatever the model dtype, as in repro."""
        cfg = self.cfg
        dev = resolve_device(device)
        s = min(max_len, cfg.swa_window) if cfg.swa_window else max_len
        shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.hd)
        return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
                "kv": {"k": torch.zeros(shape, dtype=torch.bfloat16,
                                        device=dev),
                       "v": torch.zeros(shape, dtype=torch.bfloat16,
                                        device=dev)}}

    def init_cache_paged(self, batch: int, max_len: int, n_blocks: int,
                         block_len: int, device="cuda") -> Cache:
        """Paged serving cache: one block pool per layer, no per-slot
        max_len reservation, plus a per-slot block table mapping logical
        block index -> pool block id: {"pos": [B] int32, "block_table":
        [B, max_len // block_len] int32, "pages": {"k", "v": [L, NB, BL,
        KV, hd] bf16}}.  Block 0 is the host allocator's reserved null
        sink (zeroed table rows point at it).  Dense full-attention
        configurations only (``paged_ok``)."""
        cfg = self.cfg
        if not paged_ok(cfg):
            raise ValueError(
                f"paged KV cache unsupported for {cfg.name} (recurrent "
                "state or ring-buffer SWA cache)")
        if max_len % block_len:
            raise ValueError(
                f"block_len={block_len} must divide max_len={max_len} "
                "(keeps the gathered per-slot view the same length as "
                "the linear cache: the bit-equality invariant)")
        dev = resolve_device(device)
        shape = (cfg.n_layers, n_blocks, block_len, cfg.n_kv_heads, cfg.hd)
        return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
                "block_table": torch.zeros((batch, max_len // block_len),
                                           dtype=torch.int32, device=dev),
                "pages": {"k": torch.zeros(shape, dtype=torch.bfloat16,
                                           device=dev),
                          "v": torch.zeros(shape, dtype=torch.bfloat16,
                                           device=dev)}}

    def reset_slot(self, cache: Cache, slot: int) -> Cache:
        """Zero one slot's K/V and position, in place.  For a paged cache
        only the slot's position and table row are cleared: the pool
        blocks are recycled by the host allocator, and a zeroed table row
        points at the null block."""
        if "pages" in cache:
            cache["pos"][slot] = 0
            cache["block_table"][slot].zero_()
            return cache
        cache["kv"]["k"][:, slot].zero_()
        cache["kv"]["v"][:, slot].zero_()
        cache["pos"][slot] = 0
        return cache

    @staticmethod
    def _slot_view(cache: Cache, slot: int) -> Cache:
        """Batch-1 view of one slot's row: writes through it land in the
        pool cache (repro copies with slot_slice / slot_merge instead)."""
        return {"pos": cache["pos"][slot:slot + 1],
                "kv": {"k": cache["kv"]["k"][:, slot:slot + 1],
                       "v": cache["kv"]["v"][:, slot:slot + 1]}}

    # -- decode ----------------------------------------------------------------
    def decode_step(self, params: Params, cache: Cache, tokens: torch.Tensor,
                    active: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens [B] -> (logits [B, V], cache updated in place).  The
        cache is linear (``init_cache``) or paged (``init_cache_paged``).

        ``active`` [B] bool: inactive rows keep their cache row and
        position (repro drops their write with an out-of-range index)."""
        cfg = self.cfg
        hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        pos = cache["pos"]
        x = params["embed"][tokens]
        b = x.shape[0]
        if "pages" in cache:
            attend = self._paged_writer(cache, pos, active, b)
        else:
            attend = self._linear_writer(cache, pos, active, b)
        rpos = pos[:, None]
        for li, p in enumerate(self._layers(params)):
            pa = p["attn"]
            xn = rms_norm(x, p["ln1"], cfg.norm_eps)
            q, k, v = self._qkv(pa, xn)
            q = rope(q.reshape(b, 1, h, hd), rpos, cfg.rope_theta)[:, 0]
            k = rope(k.reshape(b, 1, kvh, hd), rpos, cfg.rope_theta)[:, 0]
            v = v.reshape(b, kvh, hd)
            o = attend(li, q, k, v)
            x = x + o.reshape(b, h * hd) @ pa["wo"]
            x = x + _mlp_forward(p["mlp"], rms_norm(x, p["ln2"],
                                                    cfg.norm_eps))
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        if active is None:
            pos += 1
        else:
            pos += active.to(pos.dtype)
        return self._head(params, x), cache

    def _linear_writer(self, cache: Cache, pos: torch.Tensor,
                       active: Optional[torch.Tensor], b: int):
        """attend(layer, q, k, v) for a decode step on the linear cache:
        write the new K/V at each row's position, then attend."""
        kc_all, vc_all = cache["kv"]["k"], cache["kv"]["v"]
        S = kc_all.shape[2]
        slot = pos % S if self.cfg.swa_window is not None else pos
        ok = slot < S
        if active is not None:
            ok = ok & active
        # a dropped row rewrites its own position 0 with the value already
        # there, so every index stays in range and no two rows collide
        idx = torch.where(ok, slot, torch.zeros_like(slot)).long()
        rows = torch.arange(b, device=pos.device)
        keep = ok[:, None, None]
        length = torch.clamp(pos + 1, max=S).to(torch.int32)

        def attend(li, q, k, v):
            kc, vc = kc_all[li], vc_all[li]
            kc[rows, idx] = torch.where(keep, k.to(torch.bfloat16),
                                        kc[rows, idx])
            vc[rows, idx] = torch.where(keep, v.to(torch.bfloat16),
                                        vc[rows, idx])
            return attend_cache(q, kc, vc, length)
        return attend

    def _paged_writer(self, cache: Cache, pos: torch.Tensor,
                      active: Optional[torch.Tensor], b: int):
        """attend(layer, q, k, v) for a decode step on the paged pool
        (repro's ``_attn_decode_paged``): write the new K/V through each
        row's table at block pos // BL, offset pos % BL, then attend
        through the table.  A row that is inactive or whose position lies
        past its table writes into the null block 0 instead of being
        dropped, so no index is out of range and no such write can land
        in a live or trie-shared block."""
        kp_all, vp_all = cache["pages"]["k"], cache["pages"]["v"]
        table = cache["block_table"]
        bl, mb = kp_all.shape[2], table.shape[1]
        p64 = pos.long()
        bidx = p64 // bl
        ok = bidx < mb
        if active is not None:
            ok = ok & active
        rows = torch.arange(b, device=pos.device)
        blk = table[rows, bidx.clamp(max=mb - 1)].long()
        wblk = torch.where(ok, blk, torch.zeros_like(blk))
        woff = p64 % bl
        length = torch.clamp(pos + 1, max=mb * bl).to(torch.int32)

        def attend(li, q, k, v):
            kp, vp = kp_all[li], vp_all[li]
            kp[wblk, woff] = k.to(torch.bfloat16)
            vp[wblk, woff] = v.to(torch.bfloat16)
            return attend_paged(q, kp, vp, table, length)
        return attend

    # -- chunked prefill -----------------------------------------------------
    def prefill_chunk(self, params: Params, cache: Cache,
                      tokens: torch.Tensor, slot: int, n_valid: int,
                      impl: str = "auto") -> Tuple[torch.Tensor, Cache]:
        """Consume ``tokens`` [C] (first ``n_valid`` real, rest padding)
        into one slot at its current position.  Returns (f32 logits [V]
        of the last valid token, cache updated in place).  The cache is
        linear or paged.

        ``impl``: "auto" runs the chunk in parallel (offset flash attention
        against the slot's cache) where prefill_parallel_ok allows, else
        steps decode_step over it; "scan" forces the stepwise path;
        "parallel" forces the parallel one."""
        if impl not in PREFILL_IMPLS:
            raise ValueError(f"prefill impl must be one of {PREFILL_IMPLS}, "
                             f"got {impl!r}")
        if not 1 <= n_valid <= tokens.shape[0]:
            raise ValueError(f"n_valid={n_valid} outside [1, "
                             f"{tokens.shape[0]}]")
        if "pages" in cache:
            # the pool has no slot axis: writes go through the slot's
            # table row instead of a batch-1 view
            if impl == "scan":
                logits = self._prefill_chunk_paged_scan(params, cache,
                                                        tokens, slot, n_valid)
            else:
                logits = self._prefill_chunk_attn_paged(params, cache,
                                                        tokens, slot, n_valid)
            return logits, cache
        parallel_ok = prefill_parallel_ok(self.cfg)
        if impl == "parallel" and not parallel_ok:
            raise ValueError(
                f"parallel prefill unsupported for {self.cfg.name} "
                "(ring-buffer SWA cache)")
        sub = self._slot_view(cache, slot)
        if parallel_ok and impl != "scan":
            logits = self._prefill_chunk_attn(params, sub, tokens, n_valid)
        else:
            logits = self._prefill_chunk_scan(params, sub, tokens, n_valid)
        return logits, cache

    def _prefill_chunk_scan(self, params: Params, sub: Cache,
                            tokens: torch.Tensor, n_valid: int):
        """Step decode_step over the chunk's valid tokens on the slot's
        batch-1 view (the padded tail is never fed)."""
        logits = None
        for i in range(n_valid):
            logits, _ = self.decode_step(params, sub, tokens[i:i + 1])
        return logits[0].float()

    def _prefill_chunk_attn(self, params: Params, sub: Cache,
                            tokens: torch.Tensor, n_valid: int):
        """Parallel chunk prefill: write the chunk's K/V at its absolute
        positions and attend its queries against the slot's whole cache
        with the causal offset ``pos``, read on the device."""
        cfg = self.cfg
        hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        pos0 = sub["pos"]                                   # [1] int32
        kc_all, vc_all = sub["kv"]["k"], sub["kv"]["v"]     # [L,1,S,KV,hd]
        S = kc_all.shape[2]
        c = tokens.shape[0]
        x = params["embed"][tokens][None]                   # [1, C, D]
        positions = (pos0.long() + torch.arange(c, device=x.device))[None]
        # rows at or past S are dropped, as repro's mode="drop".  Only the
        # first min(C, S) rows can land; each dropped one rewrites, with
        # its own old value, position idx - S, which lies below pos0 and
        # so collides with no kept row.
        cw = min(c, S)
        idx = positions[0, :cw]
        ok = idx < S
        widx = torch.where(ok, idx, idx - S)
        keep = ok[:, None, None]
        for li, p in enumerate(self._layers(params)):
            pa = p["attn"]
            xn = rms_norm(x, p["ln1"], cfg.norm_eps)
            q, k, v = self._qkv(pa, xn)
            q = rope(q.reshape(1, c, h, hd), positions, cfg.rope_theta)
            k = rope(k.reshape(1, c, kvh, hd), positions, cfg.rope_theta)
            v = v.reshape(1, c, kvh, hd)
            kc, vc = kc_all[li], vc_all[li]                 # [1,S,KV,hd]
            kc[0, widx] = torch.where(keep, k[0, :cw].to(torch.bfloat16),
                                      kc[0, widx])
            vc[0, widx] = torch.where(keep, v[0, :cw].to(torch.bfloat16),
                                      vc[0, widx])
            o = attention(q, kc, vc, causal=True, q_offset=pos0)
            x = x + o.reshape(1, c, h * hd) @ pa["wo"]
            x = x + _mlp_forward(p["mlp"], rms_norm(x, p["ln2"],
                                                    cfg.norm_eps))
        # only the last valid row's logits are returned, so only that row
        # goes through the final norm and the head
        last = rms_norm(x[0, n_valid - 1], params["ln_f"], cfg.norm_eps)
        pos0 += n_valid
        return self._head(params, last).float()

    # -- paged serving: block-pool prefill and the speculative re-score ----
    def _prefill_chunk_attn_paged(self, params: Params, cache: Cache,
                                  tokens: torch.Tensor, slot: int,
                                  n_valid: int) -> torch.Tensor:
        """Parallel chunk prefill through the paged pool (repro's
        ``_prefill_chunk_attn_paged``): the chunk's K/V is written through
        the slot's table row at its absolute positions (padded rows and
        rows past the table into the null block 0), then the chunk's
        queries attend the slot's gathered view [1, MB*BL, KV, hd] with
        the causal offset ``pos``, as the reference does."""
        cfg = self.cfg
        hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        kp_all, vp_all = cache["pages"]["k"], cache["pages"]["v"]
        bl, mb = kp_all.shape[2], cache["block_table"].shape[1]
        pos0 = cache["pos"][slot:slot + 1]                  # [1] int32
        row = cache["block_table"][slot].long()             # [MB]
        c = tokens.shape[0]
        x = params["embed"][tokens][None]                   # [1, C, D]
        ar = torch.arange(c, device=x.device)
        positions = (pos0.long() + ar)[None]
        abs_pos = positions[0]
        bidx = abs_pos // bl
        ok = (ar < n_valid) & (bidx < mb)
        blk = row[bidx.clamp(max=mb - 1)]
        wblk = torch.where(ok, blk, torch.zeros_like(blk))
        woff = abs_pos % bl
        for li, p in enumerate(self._layers(params)):
            pa = p["attn"]
            xn = rms_norm(x, p["ln1"], cfg.norm_eps)
            q, k, v = self._qkv(pa, xn)
            q = rope(q.reshape(1, c, h, hd), positions, cfg.rope_theta)
            k = rope(k.reshape(1, c, kvh, hd), positions, cfg.rope_theta)
            v = v.reshape(1, c, kvh, hd)
            kp, vp = kp_all[li], vp_all[li]                 # [NB,BL,KV,hd]
            kp[wblk, woff] = k[0].to(torch.bfloat16)
            vp[wblk, woff] = v[0].to(torch.bfloat16)
            kview = kp[row].reshape(1, mb * bl, kvh, hd)
            vview = vp[row].reshape(1, mb * bl, kvh, hd)
            o = attention(q, kview, vview, causal=True, q_offset=pos0)
            x = x + o.reshape(1, c, h * hd) @ pa["wo"]
            x = x + _mlp_forward(p["mlp"], rms_norm(x, p["ln2"],
                                                    cfg.norm_eps))
        last = rms_norm(x[0, n_valid - 1], params["ln_f"], cfg.norm_eps)
        pos0 += n_valid
        return self._head(params, last).float()

    def _prefill_chunk_paged_scan(self, params: Params, cache: Cache,
                                  tokens: torch.Tensor, slot: int,
                                  n_valid: int) -> torch.Tensor:
        """Sequential prefill for the paged pool: step the pool-wide
        decode_step over the chunk's valid tokens with a one-hot active
        mask, so only ``slot`` writes and advances.  Pool-wide and not on
        a batch-1 view: this is the preemption resume, and it recomputes
        decode-written K/V bit-exactly only at the batch width that first
        wrote them."""
        b = cache["pos"].shape[0]
        onehot = torch.arange(b, device=tokens.device) == slot
        zero = torch.zeros((), dtype=tokens.dtype, device=tokens.device)
        logits = None
        for i in range(n_valid):
            feed = torch.where(onehot, tokens[i], zero)
            logits, _ = self.decode_step(params, cache, feed, active=onehot)
        return logits[slot].float()

    def decode_rescore(self, params: Params, cache: Cache,
                       tokens: torch.Tensor, rows: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
        """Read-only batched re-score for speculative verification: logits
        [N, V] for feeding ``tokens`` [N] at cache ``positions`` [N] of
        pool rows ``rows`` [N].  The cache already holds the drafted K/V,
        each token's own position included, so nothing is written.  On a
        paged cache the kernel reads through ``table[rows]`` with lengths
        ``positions + 1`` (the reference's gather, then attend_cache, with
        no [N, MB*BL, KV, hd] view built); on a linear cache the rows'
        caches are gathered and attended, as the reference does."""
        cfg = self.cfg
        hd, h = cfg.hd, cfg.n_heads
        n = tokens.shape[0]
        paged = "pages" in cache
        length = (positions + 1).to(torch.int32)
        if paged:
            kv_all = cache["pages"]
            table = cache["block_table"][rows]              # [N, MB]
        else:
            kv_all = cache["kv"]
        x = params["embed"][tokens]                         # [N, D]
        rpos = positions[:, None]
        for li, p in enumerate(self._layers(params)):
            pa = p["attn"]
            xn = rms_norm(x, p["ln1"], cfg.norm_eps)
            q = xn @ pa["wq"]
            if cfg.qkv_bias:
                q = q + pa["bq"]
            q = rope(q.reshape(n, 1, h, hd), rpos, cfg.rope_theta)[:, 0]
            kc, vc = kv_all["k"][li], kv_all["v"][li]
            if paged:
                o = attend_paged(q, kc, vc, table, length)
            else:
                o = attend_cache(q, kc[rows], vc[rows], length)
            x = x + o.reshape(n, h * hd) @ pa["wo"]
            x = x + _mlp_forward(p["mlp"], rms_norm(x, p["ln2"],
                                                    cfg.norm_eps))
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return self._head(params, x)
