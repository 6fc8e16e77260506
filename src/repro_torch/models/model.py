"""The decoder LM (counterpart of ``repro.models.model.LM``, its dense,
MoE, hybrid, xLSTM and pure-SSM branches): for the dense family init,
forward, loss, the linear slot cache and the paged block pool, decode,
chunked prefill and the speculative re-score; the MoE family is the dense one with each
layer's MLP replaced by ``models/moe.py``'s layer (its aux summed over
the layers into the loss, as repro); for the hybrid family (zamba2:
Mamba2 layers with one shared attention+MLP block applied after every
``attn_every`` of them) init, forward, loss, the linear cache (each
layer's Mamba state, and the shared block's ring of K/V per
application), decode and the scan prefill; for the SSM family either
xLSTM (``models/xlstm.py``: L / 2 pairs of an sLSTM and an mLSTM block,
each block after its own norm ``ln``, the cache each layer's sLSTM state
h, c, n and mLSTM state C) or, with no ``xlstm`` and no shared block,
the pure-Mamba branch (the hybrid family's Mamba layers alone, the cache
their states), each with init, forward, loss, the linear cache, decode
and the scan prefill.  As in repro the recurrent families have no paged
pool (``paged_ok``) and no speculative re-score.  The embedding-stub
backbones (``cfg.embed_stub``: internvl2-76b, musicgen-large) are dense
decoders whose frontend hands them precomputed embeddings: ``forward``
and ``loss`` take ``embeds`` [B, S, D] in place of token ids and
``decode_step`` takes [B, D] embeds in place of [B] ids (the embed table
is then unused), as repro's; serving feeds them token ids through the
embed table, as repro's ``Server`` does.

Params are plain dicts of tensors with the same keys and shapes as repro's
param tree: per-layer weights stacked on a leading ``[L]`` axis (the
hybrid and pure-SSM families' ``mamba``, xLSTM's ``slstm`` and ``mlstm``
of L / 2 each; the hybrid family's ``shared`` layer is one unstacked
dense layer), ``ln*``, the norms and the Mamba scalars in f32, the rest in
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
forward and loss and every serving entry point, on both tiers) params,
cache and activations are DTensors: ``shard`` redistributes the
activations where repro constrains them, and the attention runs on the
local shards (``attention.attention_sharded`` around the training
kernels; when serving, the ``*_sharded`` routes of
``models/attention.py`` with each layer's K/V write: the linear cache or
the hybrid family's ring, the scan prefill's row, the paged pool and its
table, the re-score).  The MoE layer routes each rank's tokens and
trades the experts' rows by all-to-all in training
(``moe.moe_ffn_sharded``) and runs the global formula on each rank's
own experts when serving (``moe.moe_ffn_placed``), as repro's two
routes do.  The hybrid family's SSD scan and its decode step's state
update run on local batch rows (``models/mamba.py``), and so do the
xLSTM blocks' recurrences and state updates (``models/xlstm.py``).
Plain tensors (lengths, write indices, the rotary tables) join the
DTensor ops as replicated (``dist_scope``).  Without a plan every path
runs as before."""
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
                        attention,
                        prefill_attention_paged_sharded,
                        prefill_attention_sharded, rescore_sharded)
from .common import (dense_init, embed_init, local, resolve_device, rms_norm,
                     rope, shard, softmax_cross_entropy, whole)
from .sharding import global_offset, lookup, matmul
from .mamba import (SSD_IMPLS, mamba_forward, mamba_shapes,
                    mamba_state_shapes, mamba_step)
from .xlstm import (mlstm_forward, mlstm_shapes, mlstm_state_shapes,
                    mlstm_step, slstm_forward, slstm_shapes,
                    slstm_state_shapes, slstm_step)
from .moe import (check_plan, moe_ffn, moe_ffn_placed, moe_ffn_sharded,
                  moe_shapes)

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


def is_xlstm(cfg: ArchConfig) -> bool:
    """The xLSTM layout (xlstm-125m): sLSTM / mLSTM pairs."""
    return cfg.xlstm is not None


def is_pure_ssm(cfg: ArchConfig) -> bool:
    """repro's pure-``ssm`` branch: Mamba2 layers, no shared block, no
    xLSTM (no config has it; tests build one)."""
    return (cfg.family == "ssm" and cfg.ssm is not None
            and cfg.xlstm is None and not cfg.attn_every)


def is_recurrent(cfg: ArchConfig) -> bool:
    """A family whose state replaces (or joins) the KV cache."""
    return is_hybrid(cfg) or is_xlstm(cfg) or is_pure_ssm(cfg)


def _unsupported_family(cfg: ArchConfig) -> Optional[str]:
    hybrid = cfg.family == "hybrid" or bool(cfg.attn_every)
    if cfg.xlstm is not None:
        # repro takes its hybrid branch first for such a config; no config
        # has one, and it is not held to repro
        return "hybrid-xlstm" if hybrid else None
    if is_hybrid(cfg):
        # no config puts experts in the shared block; not held to repro
        return "hybrid-moe" if cfg.moe is not None else None
    if hybrid:
        return "hybrid"
    if cfg.family == "ssm" or cfg.ssm is not None:
        return None if is_pure_ssm(cfg) else "ssm"
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


def _unstacked(t):
    """DTensor ``t`` with every tensor dim that more than one mesh dim
    cuts replicated (a plain tensor as it is): torch 2.11's DTensor index
    refuses such an index ("hybrid sharding strategies"), and 2.13 gathers
    it the same way to look the rows up."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        return t
    dims = [p.dim for p in t.placements if isinstance(p, Shard)]
    stacked = {d for d in dims if dims.count(d) > 1}
    if not stacked:
        return t
    pl = [Replicate() if isinstance(p, Shard) and p.dim in stacked else p
          for p in t.placements]
    return t.redistribute(t.device_mesh, pl)


def _sharded_cross_entropy(logits, labels) -> torch.Tensor:
    """Token-mean CE (f32) of vocab-whole DTensor ``logits`` [B, S, V]:
    the labels placed as the logits' batch and sequence, each rank's
    tokens' CE on its local shard (``softmax_cross_entropy``'s formula),
    then the mean over the DTensor.  DTensor's own gather of the labels
    ran on replicated operands, and its backward wrote a zero tensor of
    the global logits' shape on every rank (538 GB a card for llama3.2-3b
    at 256 x 4096 on a (16, 16) mesh, ``launch/dryrun``)."""
    from torch.distributed.tensor import DTensor

    from .sharding import from_local, place
    mesh = logits.device_mesh
    pl = list(logits.placements)
    if not isinstance(labels, DTensor):
        labels = place(labels, mesh, pl)
    elif list(labels.placements) != pl:
        labels = labels.redistribute(mesh, pl)
    lg = logits.to_local().float()
    gold = torch.gather(lg, -1, labels.to_local().long()[..., None])[..., 0]
    tok = torch.logsumexp(lg, dim=-1) - gold
    return from_local(tok, mesh, pl, labels.shape).mean()


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
    g = F.silu(matmul(x, p["wg"]).float()).to(x.dtype)
    return matmul(g * matmul(x, p["wu"]), p["wd"])


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
                "port runs the dense, MoE, hybrid, SSM (xLSTM, pure Mamba2) "
                "and embedding-stub families")
        if self.ssd_impl not in SSD_IMPLS:
            raise ValueError(f"ssd_impl must be one of {SSD_IMPLS}, got "
                             f"{self.ssd_impl!r}")
        if is_hybrid(self.cfg) and self.cfg.n_layers % self.cfg.attn_every:
            raise ValueError(
                f"{self.cfg.name}: {self.cfg.n_layers} layers are not a "
                f"multiple of attn_every={self.cfg.attn_every}")
        if is_xlstm(self.cfg) and self.cfg.n_layers % 2:
            raise ValueError(f"{self.cfg.name}: xLSTM pairs an sLSTM and an "
                             f"mLSTM block, {self.cfg.n_layers} layers is odd")
        if self.cfg.moe is not None:
            check_plan(self.plan)

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

        def stacked(shapes, n):
            out = {k: ((n,) + shape, t) for k, (shape, t) in shapes.items()}
            out["ln"] = ((n, d), f32)
            return out
        if is_xlstm(cfg):
            tree["slstm"] = stacked(slstm_shapes(cfg, dt), L // 2)
            tree["mlstm"] = stacked(mlstm_shapes(cfg, dt), L // 2)
        elif is_hybrid(cfg) or is_pure_ssm(cfg):
            tree["mamba"] = stacked(mamba_shapes(cfg, dt), L)
            if is_hybrid(cfg):
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
        tree = {"ln1": (lead + (d,), f32), "ln2": (lead + (d,), f32),
                "attn": attn}
        if cfg.moe is not None:
            tree["moe"] = {k: (lead + shape, t)
                           for k, (shape, t) in moe_shapes(cfg, dt).items()}
        else:
            tree["mlp"] = {"wg": (lead + (d, f), dt),
                           "wu": (lead + (d, f), dt),
                           "wd": (lead + (f, d), dt)}
        return tree

    def init(self, seed: int = 0, device="cuda") -> Params:
        """Random params from ``torch.Generator(seed)`` on ``device``:
        normal/sqrt(fan_in) weights (fan-in: the axis before the last, hd
        for sLSTM's ``r_gates``), 0.02-normal embedding, zero biases,
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
        """Per-layer views of the stacked layers (the Mamba layers of the
        hybrid and pure-SSM families; xLSTM's pairs, each {"slstm",
        "mlstm"}), built once for a params tree."""
        cfg = self.cfg
        if is_xlstm(cfg):
            stack = params["slstm"]
        else:
            stack = params["mamba" if is_recurrent(cfg) else "layers"]
        src, views = self._views
        if src is not stack:
            if is_xlstm(cfg):
                views = [{k: _index(params[k], i) for k in ("slstm", "mlstm")}
                         for i in range(cfg.n_layers // 2)]
            else:
                views = [_index(stack, i) for i in range(cfg.n_layers)]
            self._views = (stack, views)
        return views

    def _embed(self, params: Params, tokens: Optional[torch.Tensor] = None,
               embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The decoder's input (repro's ``_embed``): ``embeds`` [B, S, D]
        or [B, D] cast to the embed table's dtype, else the table's rows
        for ``tokens`` [B, S] or [B]; constrained on "x".  Under a plan,
        embeds that come as a plain tensor (the same on every rank) are
        placed under the batch placements first, d_model whole."""
        if embeds is None:
            x = lookup(params["embed"], _unstacked(tokens))
        else:
            if self.plan is not None:
                from torch.distributed.tensor import DTensor
                if not isinstance(embeds, DTensor):
                    from .sharding import batch_placements, place
                    kind = "prefill" if embeds.ndim == 3 else "decode"
                    embeds = place(embeds, self.mesh, batch_placements(
                        self.plan, self.mesh.mesh_dim_names, kind))
            x = embeds.to(params["embed"].dtype)
        dims = ("batch", "seq", "d_model")[:x.ndim - 1] + ("d_model",)
        return self._shard(x, "x", dims)

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        w = (params["embed"].T if self.cfg.tie_embeddings
             else params["lm_head"])
        dims = {1: ("vocab",), 2: ("batch", "vocab"),
                3: ("batch", "seq", "vocab")}[x.ndim]
        return self._shard(matmul(x, w), "logits", dims)

    def _qkv(self, p: Params, x: torch.Tensor):
        q, k, v = (matmul(x, p[w]) for w in ("wq", "wk", "wv"))
        if self.cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        return q, k, v

    # -- forward (train) -----------------------------------------------------
    def _ffn(self, p: Params, xn: torch.Tensor, train: bool = False
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The layer's feed-forward on the normed activations ``xn`` [B, S,
        d] or [B, d] (a decode step, a re-score: routed as [B, 1, d], as
        repro): the MLP, or the MoE layer and its aux (None for the MLP).
        Under a plan the MoE's route is repro's: local routing (and
        expert parallelism) in the training forward (``train``), the
        global formula when serving."""
        if "moe" not in p:
            return _mlp_forward(p["mlp"], xn), None
        x3 = xn.unsqueeze(1) if xn.ndim == 2 else xn
        if self.plan is None:
            y, aux = moe_ffn(p["moe"], x3, self.cfg)
        elif train:
            y, aux = moe_ffn_sharded(p["moe"], x3, self.cfg, self.mesh)
        else:
            y, aux = moe_ffn_placed(p["moe"], x3, self.cfg)
        return (y.squeeze(1) if xn.ndim == 2 else y), aux

    def _layer(self, p: Params, x: torch.Tensor, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One dense layer of the training forward -> (x, the MoE aux or
        None).  Under a plan it runs in ``dist_scope()`` itself (the remat
        calls it again in the backward) and constrains the activations at
        repro's sites: the post-norm activations, q on ``wq.out`` and
        ``x`` after each residual add."""
        with self.dist_scope():
            return self._layer_body(p, x, positions)

    def _layer_body(self, p: Params, x: torch.Tensor,
                    positions: torch.Tensor
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
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
        # DTensor queries (a plan) go to attention_sharded there
        o = attention(q, k, v, causal=True, window=cfg.swa_window)
        x = self._shard(x + matmul(o.reshape(b, s, h * hd), p["attn"]["wo"]),
                        "x", bsd)
        xn = self._shard(rms_norm(x, p["ln2"], cfg.norm_eps), "x", bsd)
        y, aux = self._ffn(p, xn, train=True)
        return self._shard(x + y, "x", bsd), aux

    def _mamba_layer(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        """One Mamba layer of the training forward, constrained at repro's
        sites under a plan (the normed input and the residual sum), in
        ``dist_scope()`` itself as ``_layer``."""
        bsd = ("batch", "seq", "d_model")
        with self.dist_scope():
            xn = self._shard(rms_norm(x, p["ln"], self.cfg.norm_eps), "x",
                             bsd)
            y = mamba_forward(p, xn, self.cfg, self.plan, impl=self.ssd_impl,
                              mesh=self.mesh)
            return self._shard(x + y, "x", bsd)

    def _xlstm_pair(self, ps: Params, pm: Params,
                    x: torch.Tensor) -> torch.Tensor:
        """One sLSTM / mLSTM pair of the training forward (repro's
        ``pair_body``), constrained at repro's one site under a plan (the
        pair's output), in ``dist_scope()`` itself as ``_layer``."""
        cfg = self.cfg
        with self.dist_scope():
            x = x + slstm_forward(ps, rms_norm(x, ps["ln"], cfg.norm_eps),
                                  cfg, self.plan, self.mesh)
            x = x + mlstm_forward(pm, rms_norm(x, pm["ln"], cfg.norm_eps),
                                  cfg, self.plan, self.mesh)
            return self._shard(x, "x", ("batch", "seq", "d_model"))

    def forward(self, params: Params, tokens: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, S] (or, for an embedding-stub frontend, embeds [B, S,
        D]) -> (logits [B, S, V], aux_loss: the sum of the MoE layers' aux,
        0 without experts).  Under autograd each layer (each Mamba layer
        and each application of the hybrid family's shared block, each
        xLSTM pair) is rematerialised in the backward, its aux carried out
        of it.  Under a plan params and inputs are DTensors (embeds given
        as a plain tensor are placed, ``_embed``) and so are the logits and
        the aux."""
        with self.dist_scope():
            return self._forward(params, tokens, embeds)

    def _forward(self, params: Params, tokens: Optional[torch.Tensor],
                 embeds: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self._embed(params, tokens, embeds)
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

        auxs = []
        if is_hybrid(self.cfg):
            # groups of attn_every Mamba layers, each followed by the shared
            # block; autograd sums the shared weights' grads over the groups
            period = self.cfg.attn_every
            mamba = _unbind(params["mamba"])
            for g0 in range(0, len(mamba), period):
                for p in mamba[g0:g0 + period]:
                    x = run(self._mamba_layer, p, x)
                x, _ = run(self._layer, params["shared"], x, positions)
        elif is_xlstm(self.cfg):
            for ps, pm in zip(_unbind(params["slstm"]),
                              _unbind(params["mlstm"])):
                x = run(self._xlstm_pair, ps, pm, x)
        elif is_pure_ssm(self.cfg):
            for p in _unbind(params["mamba"]):
                x = run(self._mamba_layer, p, x)
        else:
            for p in _unbind(params["layers"]):
                x, aux = run(self._layer, p, x, positions)
                auxs.append(aux)
        x = rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        # summed after the loop from the layers' stacked values, as repro
        # sums its scan's ys
        aux_total = (torch.stack(auxs).sum() if self.cfg.moe is not None
                     else torch.zeros((), device=x.device))
        return self._head(params, x), aux_total

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """Token-mean CE (f32) of ``batch["tokens"]`` (or ``["embeds"]``)
        against ``batch["labels"]``, plus 0.01 x the aux loss, as repro."""
        logits, aux = self.forward(params, batch.get("tokens"),
                                   batch.get("embeds"))
        with self.dist_scope():
            if self.plan is not None:
                ce = _sharded_cross_entropy(
                    _whole_along(logits, logits.ndim - 1), batch["labels"])
            else:
                ce = softmax_cross_entropy(logits, batch["labels"],
                                           self.cfg.vocab)
            return ce + 0.01 * aux

    # -- the linear slot cache --------------------------------------------------
    def cache_shapes(self, batch: int, max_len: int) -> Cache:
        """The linear cache's tree of (shape, dtype): {"pos": [B] int32,
        "kv": {"k", "v": [L, B, S, KV, hd] bf16}}; for the hybrid family
        (repro's tree) {"pos", "mamba": {"ssm" [L, B, H, P, N] f32, "conv"
        [L, B, K-1, d_inner + 2N] bf16}, "shared": {"k", "v": [L /
        attn_every, B, win, KV, hd] bf16}}, the shared block's ring one
        per application, ``win = min(max_len, swa_window or 4096)`` past
        65,536 positions and ``max_len`` below; for xLSTM {"pos", "slstm":
        {"h", "c", "n" [L/2, B, H, d/H] f32}, "mlstm": {"C" [L/2, B, H, hd,
        hd] f32}}, and for the pure-SSM branch {"pos", "mamba"}, neither
        with K/V.  K/V are bf16 whatever the model dtype, as in repro."""
        cfg = self.cfg
        tree: Cache = {"pos": ((batch,), torch.int32)}

        def stacked(shapes, n):
            return {k: ((n,) + shape, dt) for k, (shape, dt) in shapes.items()}
        if is_xlstm(cfg):
            tree["slstm"] = stacked(slstm_state_shapes(cfg, batch),
                                    cfg.n_layers // 2)
            tree["mlstm"] = stacked(mlstm_state_shapes(cfg, batch),
                                    cfg.n_layers // 2)
            return tree
        if is_pure_ssm(cfg):
            tree["mamba"] = stacked(mamba_state_shapes(cfg, batch),
                                    cfg.n_layers)
            return tree
        if is_hybrid(cfg):
            tree["mamba"] = {k: ((cfg.n_layers,) + shape, dt)
                             for k, (shape, dt)
                             in mamba_state_shapes(cfg, batch).items()}
            s = (min(max_len, cfg.swa_window or 4096) if max_len > 65536
                 else max_len)
            n, key = cfg.n_layers // cfg.attn_every, "shared"
        else:
            s = min(max_len, cfg.swa_window) if cfg.swa_window else max_len
            n, key = cfg.n_layers, "kv"
        shape = (n, batch, s, cfg.n_kv_heads, cfg.hd)
        tree[key] = {"k": (shape, torch.bfloat16),
                     "v": (shape, torch.bfloat16)}
        return tree

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
        """Zero one slot's rows (K/V, the Mamba state, xLSTM's C, h, c and
        n) and position, in place.  For a paged cache only the slot's position
        and table row are cleared: the pool blocks are recycled by the
        host allocator, and a zeroed table row points at the null
        block."""
        if "pages" in cache:
            dim, rows = 0, [cache["block_table"]]
        else:
            dim = 1                     # every leaf but pos: [L, B, ...]
            rows = [t for k, sub in cache.items() if k != "pos"
                    for t in sub.values()]
        for t in rows:
            # under a plan each rank zeroes the row where its shard holds it
            lt, b0 = local(t), global_offset(t)[dim]
            if lt.numel() and b0 <= slot < b0 + lt.shape[dim]:
                lt.select(dim, slot - b0).zero_()
        local(cache["pos"])[slot] = 0
        return cache

    @staticmethod
    def _slot_view(cache: Cache, slot: int) -> Cache:
        """Batch-1 view of one slot's rows (every leaf but ``pos`` is [L,
        B, ...]): writes through it land in the pool cache (repro copies
        with slot_slice / slot_merge instead)."""
        return {k: (v[slot:slot + 1] if k == "pos" else
                    {n: t[:, slot:slot + 1] for n, t in v.items()})
                for k, v in cache.items()}

    # -- decode ----------------------------------------------------------------
    def decode_step(self, params: Params, cache: Cache, tokens: torch.Tensor,
                    active: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens [B] (or [B, D] embeds for an embedding-stub frontend) ->
        (logits [B, V], cache updated in place).  The cache is linear
        (``init_cache``) or paged (``init_cache_paged``).

        ``active`` [B] bool: inactive rows keep their cache row and
        position (repro drops their write with an out-of-range index); a
        recurrent row's state (Mamba, xLSTM) still churns, as in repro,
        and ``reset_slot`` clears it at the next admission."""
        with self.dist_scope():
            return self._decode_step(params, cache, tokens, active)

    def _decode_step(self, params: Params, cache: Cache,
                     tokens: torch.Tensor, active: Optional[torch.Tensor],
                     slot: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Cache]:
        """``slot``: a batch-1 step of that row of a planned linear cache
        (the scan prefill; ``tokens`` [1]), which advances its position
        and steps its recurrent state alone."""
        cfg = self.cfg
        pos = local(cache["pos"])
        if slot is not None:
            pos = pos[slot:slot + 1]                    # a view: += lands
        if tokens.ndim == 2:                    # [B, D] embeds
            x = self._embed(params, embeds=tokens)
        else:
            x = self._embed(params, tokens)
        b = x.shape[0]
        rpos = pos[:, None]
        if is_xlstm(cfg):
            x = self._xlstm_decode(params, cache, x, slot)
        elif is_recurrent(cfg):
            attend = (self._linear_writer(cache["shared"], pos, active, b,
                                          slot) if is_hybrid(cfg) else None)
            x = self._mamba_layers_decode(params, cache["mamba"], x, attend,
                                          rpos, slot)
        else:
            if "pages" in cache:
                attend = self._paged_writer(cache, pos, active, b)
            else:
                attend = self._linear_writer(cache["kv"], pos, active, b,
                                             slot)
            for li, p in enumerate(self._layers(params)):
                x = self._block_decode(p, x, attend, li, rpos)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        if active is None:
            pos += 1
        else:
            pos += active.to(pos.dtype)
        return self._head(params, x), cache

    def _block_decode(self, p: Params, x: torch.Tensor, attend, li: int,
                      rpos: torch.Tensor) -> torch.Tensor:
        """One dense block of a decode step (the hybrid family's shared
        block at application ``li``): attention through ``attend(li, q, k,
        v)``, which writes the new K/V, then the MLP."""
        cfg = self.cfg
        hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        bd = ("batch", "d_model")
        b = x.shape[0]
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
        return self._shard(x + self._ffn(p, xn)[0], "x", bd)

    def _mamba_layers_decode(self, params: Params, state: Cache,
                             x: torch.Tensor, attend, rpos: torch.Tensor,
                             slot: Optional[int]) -> torch.Tensor:
        """The Mamba decode layers, each a step of its layer of the stacked
        ``state``: repro's pure-SSM branch, or its hybrid branch, where
        each group of ``attn_every`` steps is followed by the shared block,
        whose application g writes and attends ring g (``pos % S``, up to
        ``min(pos + 1, S)``)."""
        cfg = self.cfg
        period = cfg.attn_every
        for li, p in enumerate(self._layers(params)):
            y = mamba_step(p, rms_norm(x, p["ln"], cfg.norm_eps), state, cfg,
                           self.plan, self.mesh, layer=li, slot=slot)
            x = self._shard(x + y, "x", ("batch", "d_model"))
            if attend is not None and (li + 1) % period == 0:
                x = self._block_decode(params["shared"], x, attend,
                                       li // period, rpos)
        return x

    def _xlstm_decode(self, params: Params, cache: Cache, x: torch.Tensor,
                      slot: Optional[int]) -> torch.Tensor:
        """xLSTM's decode layers (repro's xLSTM branch): each pair an sLSTM
        step on its layer of ``cache["slstm"]``, then an mLSTM step on its
        layer of ``cache["mlstm"]``, each after its own norm."""
        cfg = self.cfg
        for li, pair in enumerate(self._layers(params)):
            ps, pm = pair["slstm"], pair["mlstm"]
            x = x + slstm_step(ps, rms_norm(x, ps["ln"], cfg.norm_eps),
                               cache["slstm"], cfg, self.plan, self.mesh,
                               layer=li, slot=slot)
            x = x + mlstm_step(pm, rms_norm(x, pm["ln"], cfg.norm_eps),
                               cache["mlstm"], cfg, self.plan, self.mesh,
                               layer=li, slot=slot)
            x = self._shard(x, "x", ("batch", "d_model"))
        return x

    def _linear_writer(self, kv: Cache, pos: torch.Tensor,
                       active: Optional[torch.Tensor], b: int,
                       slot: Optional[int] = None):
        """attend(layer, q, k, v) for a decode step on the linear cache
        ``kv`` ({"k", "v"} [L, B, S, KV, hd]; the hybrid family's shared
        rings): write the new K/V at each row's position (``pos % S`` on a
        ring: a window, or the hybrid family's shared block), then
        attend.  ``slot``: the batch-1 step of that row of a planned cache
        (``pos`` is its [1] view)."""
        kc_all, vc_all = kv["k"], kv["v"]
        S = kc_all.shape[2]
        ring = self.cfg.swa_window is not None or is_hybrid(self.cfg)
        at = pos % S if ring else pos
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
        (the recurrent families, a ring-buffer window) steps decode_step
        over it; "scan" forces the stepwise path; "parallel" forces the
        parallel one, and raises where it does not apply."""
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
                "(recurrent state or ring-buffer SWA cache)")
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
            x = self._shard(x + matmul(o.reshape(1, c, h * hd), pa["wo"]),
                            "x", bsd)
            xn = self._shard(rms_norm(x, p["ln2"], cfg.norm_eps), "x", bsd)
            x = self._shard(x + self._ffn(p, xn)[0], "x", bsd)
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
        plan each rank attends the rows it owns (``rescore_sharded``).
        Dense families only: a recurrent state cannot be re-scored read
        only (repro's ``Server`` never verifies a recurrent family)."""
        if is_recurrent(self.cfg):
            raise ValueError(
                f"speculative re-score unsupported for {self.cfg.name} "
                "(recurrent state): drafts are accepted as they are")
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
            x = self._shard(x + self._ffn(p, xn)[0], "x", bd)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return self._head(params, x)
