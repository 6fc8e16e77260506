"""The decoder LM (counterpart of ``repro.models.model.LM``, its dense
and hybrid branches): for the dense family init, forward, loss, the
linear slot cache and the paged block pool, decode, chunked prefill and
the speculative re-score; for the hybrid family (zamba2: Mamba2 layers
with one shared attention+MLP block applied after every ``attn_every``
of them) init, forward and loss.  The hybrid family's cache and decode
wait for the hybrid serving slice and raise ``NotImplementedError``.

Params are plain dicts of tensors with the same keys and shapes as repro's
param tree: per-layer weights stacked on a leading ``[L]`` axis (the
hybrid family's ``mamba``; its ``shared`` layer is one unstacked dense
layer), ``ln*`` and the Mamba scalars and norm in f32, the rest in
``cfg.dtype``, weights ``[in, out]`` used as ``x @ w``.  Layers run as
a Python loop over per-layer views.  ``forward``
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
allocator (runtime/paged.py) never hands out.

Under a sharding plan (``LM.plan`` with ``LM.mesh``: the training
forward and loss and every serving entry point of the dense family, on
both tiers) params, cache and activations are DTensors: ``shard``
redistributes the activations where repro constrains them, and the
attention runs on the local shards (``attention.attention_sharded``
around the training kernels; when serving, the ``*_sharded`` routes of
``models/attention.py`` with each layer's K/V write: the linear cache,
the scan prefill's row, the paged pool and its table, the re-score).
Plain tensors (lengths, write indices, the rotary tables) join the
DTensor ops as replicated (``dist_scope``).  The hybrid family refuses a
plan.  Without a plan every path runs as before."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from .attention import (attend_cache, attend_cache_sharded, attend_paged,
                        attend_paged_sharded, attend_slot_sharded,
                        attention, attention_sharded,
                        prefill_attention_paged_sharded,
                        prefill_attention_sharded, rescore_sharded)
from .common import (dense_init, embed_init, local, resolve_device, rms_norm,
                     rope, shard, softmax_cross_entropy, whole)
from .sharding import global_offset
from .mamba import SSD_IMPLS, mamba_forward, mamba_shapes

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


def is_hybrid(cfg: ArchConfig) -> bool:
    """The zamba2 layout: Mamba2 layers and one shared dense block applied
    after every ``attn_every`` of them (repro's hybrid branch)."""
    return (cfg.family == "hybrid" and bool(cfg.attn_every)
            and cfg.ssm is not None)


def _unsupported_family(cfg: ArchConfig) -> Optional[str]:
    if cfg.moe is not None:
        return "moe"
    if cfg.xlstm is not None:
        return "xlstm"
    if cfg.embed_stub:
        return "embed-stub"
    if is_hybrid(cfg):
        return None
    if cfg.family == "hybrid" or cfg.attn_every:
        return "hybrid"
    if cfg.family == "ssm" or cfg.ssm is not None:
        return "ssm"
    return None


def refuse_plan(cfg: ArchConfig) -> None:
    """Raise for a config whose family does not run under a sharding plan
    yet: the hybrid family (repro shards its SSD scan through
    ``shard_map``)."""
    if is_hybrid(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the hybrid family under a sharding plan is not "
            "ported yet (ROADMAP A.1: hybrid training and serving under a "
            "plan; repro shards its SSD scan through shard_map)")


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


def _whole_along(t, dim: int):
    """DTensor ``t`` with no mesh dim cutting tensor dim ``dim`` (the
    loss's vocab: DTensor's masked gather of a label from vocab-cut
    logits fails in its reduction, so a vocab cut is gathered first)."""
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in t.placements]
    if pl == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, pl)


@contextlib.contextmanager
def _replicating():
    from torch.distributed.tensor import DTensor
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def _zeros(shapes: Cache, dev: torch.device) -> Cache:
    """A tree of (shape, dtype) leaves as zeroed tensors on ``dev``."""
    return {k: _zeros(v, dev) if isinstance(v, dict)
            else torch.zeros(v[0], dtype=v[1], device=dev)
            for k, v in shapes.items()}


def _mlp_forward(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = F.silu((x @ p["wg"]).float()).to(x.dtype)
    return (g * (x @ p["wu"])) @ p["wd"]


@dataclasses.dataclass
class LM:
    cfg: ArchConfig
    # the SSD scan of the hybrid family's Mamba layers: "kernel" (repro's
    # "pallas": the CUDA kernel on the card, its plain version on the
    # CPU), "chunked" (repro's "xla"), or "auto" (the kernel on a CUDA
    # tensor, the chunked scan elsewhere)
    ssd_impl: str = "auto"
    # a solved ShardingPlan and the DeviceMesh its axes name (repro's
    # LM.plan / LM.mesh): the trainer (train/engine.py) and the Server
    # place the params (and cache) under it
    plan: Any = None
    mesh: Any = None
    # per-layer views of the last params["layers"] seen (built once, not
    # on every step); holds the dict itself so identity stays meaningful
    _views: Tuple[Any, List[Params]] = dataclasses.field(
        default=(None, []), init=False, repr=False, compare=False)

    def __post_init__(self):
        fam = _unsupported_family(self.cfg)
        if fam is not None:
            raise NotImplementedError(
                f"{self.cfg.name}: the {fam} family is not ported yet; the "
                "port runs the dense family and trains the hybrid one")
        if self.ssd_impl not in SSD_IMPLS:
            raise ValueError(f"ssd_impl must be one of {SSD_IMPLS}, got "
                             f"{self.ssd_impl!r}")
        if self.plan is not None:
            refuse_plan(self.cfg)
        if is_hybrid(self.cfg) and self.cfg.n_layers % self.cfg.attn_every:
            raise ValueError(
                f"{self.cfg.name}: {self.cfg.n_layers} layers are not a "
                f"multiple of attn_every={self.cfg.attn_every}")

    def _dense_only(self, what: str) -> None:
        if is_hybrid(self.cfg):
            raise NotImplementedError(
                f"{self.cfg.name}: {what} of the hybrid family waits for the "
                "hybrid serving slice (mamba_step, the shared ring cache)")

    def _shard(self, x, role: str, dims: Sequence[str]):
        return shard(x, self.plan, role, dims)

    def dist_scope(self):
        """What a planned step runs in: plain tensors join DTensor ops as
        replicated (``implicit_replication``, restoring the setting it
        found on exit, so scopes nest: a layer's own scope inside the
        forward's).  Nothing without a plan."""
        if self.plan is None:
            return contextlib.nullcontext()
        return _replicating()

    # -- params ------------------------------------------------------------
    def param_shapes(self) -> Params:
        """Tree of (shape, dtype) with repro's keys, for init and for the
        JAX weight converter's checks."""
        cfg = self.cfg
        d, L = cfg.d_model, cfg.n_layers
        dt, f32 = torch_dtype(cfg), torch.float32
        tree: Params = {"embed": ((cfg.vocab, d), dt), "ln_f": ((d,), f32)}
        if is_hybrid(cfg):
            mamba = {k: ((L,) + shape, t)
                     for k, (shape, t) in mamba_shapes(cfg, dt).items()}
            mamba["ln"] = ((L, d), f32)
            tree["mamba"] = mamba
            tree["shared"] = self._dense_layer_shapes(())
        else:
            tree["layers"] = self._dense_layer_shapes((L,))
        if not cfg.tie_embeddings:
            tree["lm_head"] = ((d, cfg.vocab), dt)
        return tree

    def _dense_layer_shapes(self, lead: Tuple[int, ...]) -> Params:
        """One dense layer's (shape, dtype) tree, each shape prefixed with
        ``lead`` (``(L,)`` when stacked)."""
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.hd
        h, kv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
        dt, f32 = torch_dtype(cfg), torch.float32
        attn = {"wq": (lead + (d, h * hd), dt), "wk": (lead + (d, kv * hd), dt),
                "wv": (lead + (d, kv * hd), dt),
                "wo": (lead + (h * hd, d), dt)}
        if cfg.qkv_bias:
            attn.update(bq=(lead + (h * hd,), dt), bk=(lead + (kv * hd,), dt),
                        bv=(lead + (kv * hd,), dt))
        return {"ln1": (lead + (d,), f32), "ln2": (lead + (d,), f32),
                "attn": attn,
                "mlp": {"wg": (lead + (d, f), dt), "wu": (lead + (d, f), dt),
                        "wd": (lead + (f, d), dt)}}

    def init(self, seed: int = 0, device="cuda") -> Params:
        """Random params from ``torch.Generator(seed)`` on ``device``:
        normal/sqrt(fan_in) weights, 0.02-normal embedding, zero biases,
        unit norms; for the Mamba layers a conv of zeros with its last tap
        1, ``A_log`` and ``dt_bias`` 0, ``D`` and ``norm`` 1 (repro's init
        rules; the values differ, the PRNGs do)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)

        def make(name, spec):
            if isinstance(spec, dict):
                return {k: make(k, v) for k, v in spec.items()}
            shape, dt = spec
            if name.startswith("ln") or name in ("D", "norm"):
                return torch.ones(shape, dtype=dt, device=dev)
            if name in ("bq", "bk", "bv", "A_log", "dt_bias"):
                return torch.zeros(shape, dtype=dt, device=dev)
            if name == "conv_w":                 # identity-ish: last tap 1
                w = torch.zeros(shape, dtype=dt, device=dev)
                w[..., -1, :] = 1
                return w
            if name == "embed":
                return embed_init(shape, gen, dtype=dt, device=dev)
            # stacked [L, in, out] (or [in, out] for lm_head): fan_in = in
            return dense_init(shape, gen, in_axis=len(shape) - 2, dtype=dt,
                              device=dev)

        return {k: make(k, v) for k, v in self.param_shapes().items()}

    def _layers(self, params: Params) -> List[Params]:
        self._dense_only("decoding")
        src, views = self._views
        if src is not params["layers"]:
            views = [_index(params["layers"], i)
                     for i in range(self.cfg.n_layers)]
            self._views = (params["layers"], views)
        return views

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        w = (params["embed"].T if self.cfg.tie_embeddings
             else params["lm_head"])
        dims = {1: ("vocab",), 2: ("batch", "vocab"),
                3: ("batch", "seq", "vocab")}[x.ndim]
        return self._shard(x @ w, "logits", dims)

    def _qkv(self, p: Params, x: torch.Tensor):
        q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
        if self.cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        return q, k, v

    # -- forward (train) -----------------------------------------------------
    def _layer(self, p: Params, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        """One dense layer of the training forward.  Under a plan it runs
        in ``dist_scope()`` itself (the remat calls it again in the backward)
        and constrains the activations at repro's sites: the post-norm
        activations, q on ``wq.out`` and ``x`` after each residual add."""
        with self.dist_scope():
            return self._layer_body(p, x, positions)

    def _layer_body(self, p: Params, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        b, s, _ = x.shape
        bsd = ("batch", "seq", "d_model")
        xn = self._shard(rms_norm(x, p["ln1"], cfg.norm_eps), "x", bsd)
        q, k, v = self._qkv(p["attn"], xn)
        q = self._shard(q, "wq.out", ("batch", "seq", "heads"))
        q = rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta)
        k = rope(k.reshape(b, s, kvh, hd), positions, cfg.rope_theta)
        v = v.reshape(b, s, kvh, hd)
        attend = attention if self.plan is None else attention_sharded
        o = attend(q, k, v, causal=True, window=cfg.swa_window)
        x = self._shard(x + o.reshape(b, s, h * hd) @ p["attn"]["wo"], "x",
                        bsd)
        xn = self._shard(rms_norm(x, p["ln2"], cfg.norm_eps), "x", bsd)
        return self._shard(x + _mlp_forward(p["mlp"], xn), "x", bsd)

    def _mamba_layer(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        return x + mamba_forward(p, rms_norm(x, p["ln"], self.cfg.norm_eps),
                                 self.cfg, impl=self.ssd_impl)

    def forward(self, params: Params,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, S] -> (logits [B, S, V], aux_loss 0).  Under autograd
        each layer (each Mamba layer and each application of the hybrid
        family's shared block) is rematerialised in the backward.  Under
        a plan (dense family) params and tokens are DTensors and so are
        the logits."""
        with self.dist_scope():
            return self._forward(params, tokens)

    def _forward(self, params: Params, tokens: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self._shard(params["embed"][tokens], "x",
                        ("batch", "seq", "d_model"))
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        if self.plan is not None:
            # a DTensor, so the rotary tables saved for the backward are
            # DTensors too and the backward mixes no plain tensor in
            from torch.distributed.tensor import DTensor, Replicate
            positions = DTensor.from_local(
                positions, self.mesh, [Replicate()] * self.mesh.ndim,
                run_check=False)
        remat = torch.is_grad_enabled()

        def run(fn, *args):
            if remat:
                return checkpoint(fn, *args, use_reentrant=False,
                                  preserve_rng_state=False)
            return fn(*args)

        if is_hybrid(self.cfg):
            # groups of attn_every Mamba layers, each followed by the shared
            # block; autograd sums the shared weights' grads over the groups
            period = self.cfg.attn_every
            mamba = _unbind(params["mamba"])
            for g0 in range(0, len(mamba), period):
                for p in mamba[g0:g0 + period]:
                    x = run(self._mamba_layer, p, x)
                x = run(self._layer, params["shared"], x, positions)
        else:
            for p in _unbind(params["layers"]):
                x = run(self._layer, p, x, positions)
        x = rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        return self._head(params, x), torch.zeros((), device=x.device)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """Token-mean CE (f32) of ``batch["tokens"]`` against
        ``batch["labels"]``, plus 0.01 x the aux loss, as repro."""
        logits, aux = self.forward(params, batch["tokens"])
        with self.dist_scope():
            if self.plan is not None:
                logits = _whole_along(logits, logits.ndim - 1)
            ce = softmax_cross_entropy(logits, batch["labels"],
                                       self.cfg.vocab)
            return ce + 0.01 * aux

    # -- the linear slot cache --------------------------------------------------
    def cache_shapes(self, batch: int, max_len: int) -> Cache:
        """The linear cache's tree of (shape, dtype): {"pos": [B] int32,
        "kv": {"k", "v": [L, B, S, KV, hd] bf16}}.  The cache is bf16
        whatever the model dtype, as in repro."""
        self._dense_only("init_cache")
        cfg = self.cfg
        s = min(max_len, cfg.swa_window) if cfg.swa_window else max_len
        shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.hd)
        return {"pos": ((batch,), torch.int32),
                "kv": {"k": (shape, torch.bfloat16),
                       "v": (shape, torch.bfloat16)}}

    def init_cache(self, batch: int, max_len: int, device="cuda") -> Cache:
        """The linear cache of ``cache_shapes``, zeroed."""
        return _zeros(self.cache_shapes(batch, max_len),
                      resolve_device(device))

    def cache_shapes_paged(self, batch: int, max_len: int, n_blocks: int,
                           block_len: int) -> Cache:
        """The paged serving cache's tree of (shape, dtype): one block
        pool per layer, no per-slot max_len reservation, plus a per-slot
        block table mapping logical block index -> pool block id:
        {"pos": [B] int32, "block_table": [B, max_len // block_len] int32,
        "pages": {"k", "v": [L, NB, BL, KV, hd] bf16}}.  Block 0 is the
        host allocator's reserved null sink (zeroed table rows point at
        it).  Dense full-attention configurations only (``paged_ok``)."""
        self._dense_only("init_cache_paged")
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
        shape = (cfg.n_layers, n_blocks, block_len, cfg.n_kv_heads, cfg.hd)
        return {"pos": ((batch,), torch.int32),
                "block_table": ((batch, max_len // block_len), torch.int32),
                "pages": {"k": (shape, torch.bfloat16),
                          "v": (shape, torch.bfloat16)}}

    def init_cache_paged(self, batch: int, max_len: int, n_blocks: int,
                         block_len: int, device="cuda") -> Cache:
        """The paged cache of ``cache_shapes_paged``, zeroed."""
        return _zeros(self.cache_shapes_paged(batch, max_len, n_blocks,
                                              block_len),
                      resolve_device(device))

    def reset_slot(self, cache: Cache, slot: int) -> Cache:
        """Zero one slot's K/V and position, in place.  For a paged cache
        only the slot's position and table row are cleared: the pool
        blocks are recycled by the host allocator, and a zeroed table row
        points at the null block."""
        self._dense_only("reset_slot")
        if self.plan is not None:
            # each rank zeroes the slot's row where its shard holds it
            dim, rows = ((0, [cache["block_table"]]) if "pages" in cache
                         else (1, [cache["kv"]["k"], cache["kv"]["v"]]))
            for t in rows:
                lt, b0 = local(t), global_offset(t)[dim]
                if lt.numel() and b0 <= slot < b0 + lt.shape[dim]:
                    lt.select(dim, slot - b0).zero_()
            local(cache["pos"])[slot] = 0
            return cache
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
        self._dense_only("decode_step")
        with self.dist_scope():
            return self._decode_step(params, cache, tokens, active)

    def _decode_step(self, params: Params, cache: Cache,
                     tokens: torch.Tensor, active: Optional[torch.Tensor],
                     slot: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Cache]:
        """``slot``: a batch-1 step of that row of a planned linear cache
        (the scan prefill; ``tokens`` [1]), which advances its position
        alone."""
        cfg = self.cfg
        hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        bd = ("batch", "d_model")
        pos = local(cache["pos"])
        if slot is not None:
            pos = pos[slot:slot + 1]                    # a view: += lands
        x = self._shard(params["embed"][tokens], "x", bd)
        b = x.shape[0]
        if "pages" in cache:
            attend = self._paged_writer(cache, pos, active, b)
        else:
            attend = self._linear_writer(cache, pos, active, b, slot)
        rpos = pos[:, None]
        for li, p in enumerate(self._layers(params)):
            pa = p["attn"]
            xn = self._shard(rms_norm(x, p["ln1"], cfg.norm_eps), "x", bd)
            q, k, v = self._qkv(pa, xn)
            q = self._shard(q, "wq.out", ("batch", "heads"))
            q = rope(q.reshape(b, 1, h, hd), rpos, cfg.rope_theta)[:, 0]
            k = rope(k.reshape(b, 1, kvh, hd), rpos, cfg.rope_theta)[:, 0]
            v = v.reshape(b, kvh, hd)
            o = attend(li, q, k, v)
            x = self._shard(x + o.reshape(b, h * hd) @ pa["wo"], "x", bd)
            xn = self._shard(rms_norm(x, p["ln2"], cfg.norm_eps), "x", bd)
            x = self._shard(x + _mlp_forward(p["mlp"], xn), "x", bd)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        if active is None:
            pos += 1
        else:
            pos += active.to(pos.dtype)
        return self._head(params, x), cache

    def _linear_writer(self, cache: Cache, pos: torch.Tensor,
                       active: Optional[torch.Tensor], b: int,
                       slot: Optional[int] = None):
        """attend(layer, q, k, v) for a decode step on the linear cache:
        write the new K/V at each row's position, then attend.  ``slot``:
        the batch-1 step of that row of a planned cache (``pos`` is its
        [1] view)."""
        kc_all, vc_all = cache["kv"]["k"], cache["kv"]["v"]
        S = kc_all.shape[2]
        at = pos % S if self.cfg.swa_window is not None else pos
        ok = at < S
        if active is not None:
            ok = ok & active
        # a dropped row rewrites its own position 0 with the value already
        # there, so every index stays in range and no two rows collide
        length = torch.clamp(pos + 1, max=S).to(torch.int32)
        if self.plan is not None:
            # the write's drop rule (at < S) is applied shard by shard
            keep = (torch.ones_like(ok) if active is None else active)
            if slot is not None:
                return lambda li, q, k, v: attend_slot_sharded(
                    q, k, v, kc_all, vc_all, li, slot, at, keep, length)
            return lambda li, q, k, v: attend_cache_sharded(
                q, k, v, kc_all, vc_all, li, at, keep, length)
        idx = torch.where(ok, at, torch.zeros_like(at)).long()
        rows = torch.arange(b, device=pos.device)
        keep = ok[:, None, None]

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
        in a live or trie-shared block.  Under a plan the write indices
        come from the whole table (every rank writes every row into its
        pool replica) and ``attend_paged_sharded`` writes and attends."""
        kp_all, vp_all = cache["pages"]["k"], cache["pages"]["v"]
        table = cache["block_table"]
        bl, mb = kp_all.shape[2], table.shape[1]
        p64 = pos.long()
        bidx = p64 // bl
        ok = bidx < mb
        if active is not None:
            ok = ok & active
        rows = torch.arange(b, device=pos.device)
        blk = whole(table)[rows, bidx.clamp(max=mb - 1)].long()
        wblk = torch.where(ok, blk, torch.zeros_like(blk))
        woff = p64 % bl
        length = torch.clamp(pos + 1, max=mb * bl).to(torch.int32)
        if self.plan is not None:
            return lambda li, q, k, v: attend_paged_sharded(
                q, k, v, kp_all, vp_all, table, li, wblk, woff, length)

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
        self._dense_only("prefill_chunk")
        with self.dist_scope():
            return self._prefill_chunk(params, cache, tokens, slot, n_valid,
                                       impl)

    def _prefill_chunk(self, params: Params, cache: Cache,
                       tokens: torch.Tensor, slot: int, n_valid: int,
                       impl: str) -> Tuple[torch.Tensor, Cache]:
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
        if parallel_ok and impl != "scan":
            logits = self._prefill_chunk_attn(params, cache, tokens, slot,
                                              n_valid)
        else:
            logits = self._prefill_chunk_scan(params, cache, tokens, slot,
                                              n_valid)
        return logits, cache

    def _prefill_chunk_scan(self, params: Params, cache: Cache,
                            tokens: torch.Tensor, slot: int, n_valid: int):
        """Step the decode step over the chunk's valid tokens on the
        slot's row (the padded tail is never fed): on its batch-1 view,
        or, under a plan, on the placed cache's row through
        ``attend_slot_sharded`` (a view of a batch-cut DTensor would slice
        across shards; every rank joins the step's weight collectives)."""
        if self.plan is None:
            sub = self._slot_view(cache, slot)

            def step(tok):
                return self.decode_step(params, sub, tok)
        else:
            def step(tok):
                return self._decode_step(params, cache, tok, None, slot)
        logits = None
        for i in range(n_valid):
            logits, _ = step(tokens[i:i + 1])
        return logits[0].float()

    def _prefill_chunk_attn(self, params: Params, cache: Cache,
                            tokens: torch.Tensor, slot: int, n_valid: int):
        """Parallel chunk prefill: write the chunk's K/V at its absolute
        positions and attend its queries against the slot's whole cache
        with the causal offset ``pos``, read on the device."""
        c = tokens.shape[0]
        pos0 = local(cache["pos"])[slot:slot + 1]           # [1] int32
        positions = (pos0.long() + torch.arange(c, device=tokens.device)
                     )[None]
        if self.plan is not None:
            def attend(li, q, k, v):
                return prefill_attention_sharded(
                    q, k, v, cache["kv"]["k"], cache["kv"]["v"], li, slot,
                    pos0)
        else:
            sub = self._slot_view(cache, slot)
            kc_all, vc_all = sub["kv"]["k"], sub["kv"]["v"]  # [L,1,S,KV,hd]
            S = kc_all.shape[2]
            # rows at or past S are dropped, as repro's mode="drop".  Only
            # the first min(C, S) rows can land; each dropped one rewrites,
            # with its own old value, position idx - S, which lies below
            # pos0 and so collides with no kept row.
            cw = min(c, S)
            idx = positions[0, :cw]
            ok = idx < S
            widx = torch.where(ok, idx, idx - S)
            keep = ok[:, None, None]

            def attend(li, q, k, v):
                kc, vc = kc_all[li], vc_all[li]             # [1,S,KV,hd]
                kc[0, widx] = torch.where(
                    keep, k[0, :cw].to(torch.bfloat16), kc[0, widx])
                vc[0, widx] = torch.where(
                    keep, v[0, :cw].to(torch.bfloat16), vc[0, widx])
                return attention(q, kc, vc, causal=True, q_offset=pos0)
        return self._chunk_layers(params, tokens, positions, attend, n_valid,
                                  pos0)

    def _chunk_layers(self, params: Params, tokens: torch.Tensor,
                      positions: torch.Tensor, attend, n_valid: int,
                      pos0: torch.Tensor) -> torch.Tensor:
        """The layers of a parallel prefill chunk ``tokens`` [C] at
        ``positions`` [1, C], each layer's K/V write and attention done by
        ``attend(layer, q, k, v)``; advances the slot's position ``pos0``
        [1] by ``n_valid`` and returns the f32 logits [V] of the last
        valid token."""
        cfg = self.cfg
        hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        bsd = ("batch", "seq", "d_model")
        c = tokens.shape[0]
        x = self._shard(params["embed"][tokens][None], "x", bsd)  # [1,C,D]
        for li, p in enumerate(self._layers(params)):
            pa = p["attn"]
            xn = self._shard(rms_norm(x, p["ln1"], cfg.norm_eps), "x", bsd)
            q, k, v = self._qkv(pa, xn)
            q = self._shard(q, "wq.out", ("batch", "seq", "heads"))
            q = rope(q.reshape(1, c, h, hd), positions, cfg.rope_theta)
            k = rope(k.reshape(1, c, kvh, hd), positions, cfg.rope_theta)
            v = v.reshape(1, c, kvh, hd)
            o = attend(li, q, k, v)
            x = self._shard(x + o.reshape(1, c, h * hd) @ pa["wo"], "x", bsd)
            xn = self._shard(rms_norm(x, p["ln2"], cfg.norm_eps), "x", bsd)
            x = self._shard(x + _mlp_forward(p["mlp"], xn), "x", bsd)
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
        the causal offset ``pos``, as the reference does.  Under a plan
        ``prefill_attention_paged_sharded`` writes every rank's pool
        replica and attends on the row's owner."""
        cfg = self.cfg
        hd, kvh = cfg.hd, cfg.n_kv_heads
        kp_all, vp_all = cache["pages"]["k"], cache["pages"]["v"]
        table = cache["block_table"]
        bl, mb = kp_all.shape[2], table.shape[1]
        pos0 = local(cache["pos"])[slot:slot + 1]           # [1] int32
        row = whole(table)[slot].long()                     # [MB]
        c = tokens.shape[0]
        ar = torch.arange(c, device=tokens.device)
        positions = (pos0.long() + ar)[None]
        abs_pos = positions[0]
        bidx = abs_pos // bl
        ok = (ar < n_valid) & (bidx < mb)
        blk = row[bidx.clamp(max=mb - 1)]
        wblk = torch.where(ok, blk, torch.zeros_like(blk))
        woff = abs_pos % bl
        if self.plan is not None:
            def attend(li, q, k, v):
                return prefill_attention_paged_sharded(
                    q, k, v, kp_all, vp_all, table, li, slot, row, wblk,
                    woff, pos0)
        else:
            def attend(li, q, k, v):
                kp, vp = kp_all[li], vp_all[li]             # [NB,BL,KV,hd]
                kp[wblk, woff] = k[0].to(torch.bfloat16)
                vp[wblk, woff] = v[0].to(torch.bfloat16)
                kview = kp[row].reshape(1, mb * bl, kvh, hd)
                vview = vp[row].reshape(1, mb * bl, kvh, hd)
                return attention(q, kview, vview, causal=True,
                                 q_offset=pos0)
        return self._chunk_layers(params, tokens, positions, attend, n_valid,
                                  pos0)

    def _prefill_chunk_paged_scan(self, params: Params, cache: Cache,
                                  tokens: torch.Tensor, slot: int,
                                  n_valid: int) -> torch.Tensor:
        """Sequential prefill for the paged pool: step the pool-wide
        decode_step over the chunk's valid tokens with a one-hot active
        mask, so only ``slot`` writes and advances.  Pool-wide and not on
        a batch-1 view: this is the preemption resume, and it recomputes
        decode-written K/V bit-exactly only at the batch width that first
        wrote them (under a plan too: every rank steps the whole pool)."""
        b = cache["pos"].shape[0]
        onehot = torch.arange(b, device=tokens.device) == slot
        zero = torch.zeros((), dtype=tokens.dtype, device=tokens.device)
        logits = None
        for i in range(n_valid):
            feed = torch.where(onehot, tokens[i], zero)
            logits, _ = self.decode_step(params, cache, feed, active=onehot)
        return whole(logits)[slot].float()

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
        caches are gathered and attended, as the reference does.  Under a
        plan each rank attends the rows it owns (``rescore_sharded``)."""
        self._dense_only("decode_rescore")
        with self.dist_scope():
            return self._decode_rescore(params, cache, tokens, rows,
                                        positions)

    def _decode_rescore(self, params: Params, cache: Cache,
                        tokens: torch.Tensor, rows: torch.Tensor,
                        positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        hd, h = cfg.hd, cfg.n_heads
        bd = ("batch", "d_model")
        n = tokens.shape[0]
        paged = "pages" in cache
        length = (positions + 1).to(torch.int32)
        kv_all = cache["pages"] if paged else cache["kv"]
        if self.plan is not None:
            table = cache["block_table"] if paged else None

            def attend(li, q):
                return rescore_sharded(q, kv_all["k"], kv_all["v"], li, rows,
                                       length, table)
        elif paged:
            table = cache["block_table"][rows]              # [N, MB]

            def attend(li, q):
                return attend_paged(q, kv_all["k"][li], kv_all["v"][li],
                                    table, length)
        else:
            def attend(li, q):
                return attend_cache(q, kv_all["k"][li][rows],
                                    kv_all["v"][li][rows], length)
        x = self._shard(params["embed"][tokens], "x", bd)   # [N, D]
        rpos = positions[:, None]
        for li, p in enumerate(self._layers(params)):
            pa = p["attn"]
            xn = self._shard(rms_norm(x, p["ln1"], cfg.norm_eps), "x", bd)
            q = xn @ pa["wq"]
            if cfg.qkv_bias:
                q = q + pa["bq"]
            q = self._shard(q, "wq.out", ("batch", "heads"))
            q = rope(q.reshape(n, 1, h, hd), rpos, cfg.rope_theta)[:, 0]
            o = attend(li, q)
            x = self._shard(x + o.reshape(n, h * hd) @ pa["wo"], "x", bd)
            xn = self._shard(rms_norm(x, p["ln2"], cfg.norm_eps), "x", bd)
            x = self._shard(x + _mlp_forward(p["mlp"], xn), "x", bd)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return self._head(params, x)
