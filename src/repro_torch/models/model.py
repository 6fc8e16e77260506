"""The dense decoder LM (counterpart of ``repro.models.model.LM``, dense
branch): init, forward, loss, the linear slot cache, decode and chunked
prefill.

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
index."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from .attention import attend_cache, attention
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
    as parallel prefill, as in repro).  The paged tier itself is not in
    the port yet."""
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

    def reset_slot(self, cache: Cache, slot: int) -> Cache:
        """Zero one slot's K/V and position, in place."""
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
        """tokens [B] -> (logits [B, V], cache updated in place).

        ``active`` [B] bool: inactive rows keep their cache row and
        position (repro drops their write with an out-of-range index)."""
        cfg = self.cfg
        hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        pos = cache["pos"]
        kc_all, vc_all = cache["kv"]["k"], cache["kv"]["v"]
        S = kc_all.shape[2]
        x = params["embed"][tokens]
        b = x.shape[0]
        slot = pos % S if cfg.swa_window is not None else pos
        ok = slot < S
        if active is not None:
            ok = ok & active
        # a dropped row rewrites its own position 0 with the value already
        # there, so every index stays in range and no two rows collide
        idx = torch.where(ok, slot, torch.zeros_like(slot)).long()
        rows = torch.arange(b, device=x.device)
        keep = ok[:, None, None]
        length = torch.clamp(pos + 1, max=S).to(torch.int32)
        rpos = pos[:, None]
        for li, p in enumerate(self._layers(params)):
            pa = p["attn"]
            xn = rms_norm(x, p["ln1"], cfg.norm_eps)
            q, k, v = self._qkv(pa, xn)
            q = rope(q.reshape(b, 1, h, hd), rpos, cfg.rope_theta)[:, 0]
            k = rope(k.reshape(b, 1, kvh, hd), rpos, cfg.rope_theta)[:, 0]
            v = v.reshape(b, kvh, hd)
            kc, vc = kc_all[li], vc_all[li]
            kc[rows, idx] = torch.where(keep, k.to(torch.bfloat16),
                                        kc[rows, idx])
            vc[rows, idx] = torch.where(keep, v.to(torch.bfloat16),
                                        vc[rows, idx])
            o = attend_cache(q, kc, vc, length)
            x = x + o.reshape(b, h * hd) @ pa["wo"]
            x = x + _mlp_forward(p["mlp"], rms_norm(x, p["ln2"],
                                                    cfg.norm_eps))
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        if active is None:
            pos += 1
        else:
            pos += active.to(pos.dtype)
        return self._head(params, x), cache

    # -- chunked prefill -----------------------------------------------------
    def prefill_chunk(self, params: Params, cache: Cache,
                      tokens: torch.Tensor, slot: int, n_valid: int,
                      impl: str = "auto") -> Tuple[torch.Tensor, Cache]:
        """Consume ``tokens`` [C] (first ``n_valid`` real, rest padding)
        into one slot at its current position.  Returns (f32 logits [V]
        of the last valid token, cache updated in place).

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
