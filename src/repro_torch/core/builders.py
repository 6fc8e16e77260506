"""Semantic-graph builders (paper §3: the "semantic dataflow graph").

Builders emit *forward* ops; ``add_backward`` mechanically mirrors them
into backward + gradient + update ops (the paper's Fig. 8b structure), so
the solver sees forward/backward/update ops that share weights *together*
(§4.2.2).

Graphs are coarse on purpose: one tensor per logical quantity per
(representative) layer, with ``repeat`` factors for the L-layer stack.
Two explicit chained layer instances are built so that the inter-layer
tiling-conversion cost is represented (see DESIGN.md).

Dim-name conventions (plan.py maps them back to physical axes):
  batch, seq        activation leading dims
  d_model           residual width
  heads / kv_heads  merged head*head_dim projections (units=head_dim so an
                    even cut never splits a head)
  d_ff              MLP hidden
  vocab             embedding rows / logits
  expert, tok_e     MoE expert id / dispatched-token capacity
  inner             SSM / xLSTM inner channels (units=ssm head_dim)
  seq_kv            KV-cache length (decode graphs)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..configs.base import ArchConfig, ShapeConfig
from .graph import Graph
from .tiling import Part, REDUCED, REPLICATE
from .cost import Assignment

BF16 = 2.0
FP32 = 4.0


# --------------------------------------------------------------------------
# mechanical backward pass over recorded forward einsum/ewise/custom ops
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _FwdOp:
    kind: str                  # einsum | ewise | custom
    name: str
    inputs: Tuple[str, ...]
    output: str
    repeat: float
    grad_inputs: Tuple[bool, ...]   # which inputs need gradients
    align_dims: Optional[Tuple[str, ...]] = None
    bwd_forms: Optional[Dict[str, list]] = None  # custom: input -> forms
    group: int = 0


class GraphBuilder:
    def __init__(self, name: str, allow_uneven: bool = False):
        self.g = Graph(name, allow_uneven)
        self.fwd: List[_FwdOp] = []
        self.weights: List[str] = []
        self._n = 0
        self.group = 0                      # current layer group (DP order)
        self._weight_group: Dict[str, int] = {}

    def new_group(self) -> int:
        self.group += 1
        return self.group

    def _tag(self, group: Optional[int] = None) -> None:
        self.g.ops[-1].attrs["group"] = self.group if group is None else group

    # -- tensors ------------------------------------------------------
    def act(self, name: str, dims, shape, role=None, units=None,
            bytes_per_elem=BF16) -> str:
        return self.g.tensor(name, dims, shape, bytes_per_elem,
                             "activation", role, units)

    def weight(self, name: str, dims, shape, role=None, units=None,
               bytes_per_elem=BF16) -> str:
        self.weights.append(name)
        self._weight_group[name] = self.group
        return self.g.tensor(name, dims, shape, bytes_per_elem,
                             "weight", role, units)

    def inp(self, name: str, dims, shape, units=None,
            bytes_per_elem=BF16, role=None) -> str:
        return self.g.tensor(name, dims, shape, bytes_per_elem,
                             "input", role, units)

    # -- forward ops ----------------------------------------------------
    def einsum(self, lhs: str, rhs: str, out: str, repeat: float = 1.0,
               grads=(True, True)) -> str:
        nm = f"mm{self._n}:{out}"
        self._n += 1
        self.g.einsum(nm, lhs, rhs, out, repeat)
        self._tag()
        self.fwd.append(_FwdOp("einsum", nm, (lhs, rhs), out, repeat,
                               tuple(grads), group=self.group))
        return out

    def ewise(self, inputs, out: str, repeat: float = 1.0,
              align_dims=None, grads=None) -> str:
        nm = f"ew{self._n}:{out}"
        self._n += 1
        self.g.ewise(nm, inputs, out, repeat, align_dims=align_dims)
        self._tag()
        if grads is None:
            grads = tuple(True for _ in inputs)
        self.fwd.append(_FwdOp("ewise", nm, tuple(inputs), out, repeat,
                               tuple(grads),
                               tuple(align_dims) if align_dims else None,
                               group=self.group))
        return out

    def custom(self, inputs, out: str, forms, repeat: float = 1.0,
               bwd_forms: Optional[Dict[str, list]] = None) -> str:
        nm = f"cu{self._n}:{out}"
        self._n += 1
        self.g.custom(nm, inputs, out, forms, repeat)
        self._tag()
        self.fwd.append(_FwdOp("custom", nm, tuple(inputs), out, repeat,
                               tuple(bwd_forms is not None and (i in bwd_forms)
                                     for i in inputs),
                               bwd_forms=bwd_forms, group=self.group))
        return out

    # -- backward -------------------------------------------------------
    def grad_name(self, t: str) -> str:
        return f"d_{t}"

    def _ensure_grad(self, t: str, accum: Dict[str, int]) -> str:
        """Gradient tensor of t; multiple contributions accumulate via an
        ewise add (cheap — same tiling) handled by suffixing."""
        ts = self.g.tensors[t]
        base = self.grad_name(t)
        k = accum.get(t, 0)
        accum[t] = k + 1
        nm = base if k == 0 else f"{base}#{k}"
        kind = "grad"
        self.g.tensor(nm, ts.dims, ts.shape, ts.bytes_per_elem, kind,
                      (ts.role + ".grad") if ts.role else None,
                      dict(ts.units))
        return nm

    def add_backward(self, seed: str, *, master_fp32: bool = False,
                     error_feedback: bool = False) -> None:
        """Mirror all recorded forward ops (reverse order) into backward +
        gradient ops; add parameter-update ops.  ``seed``: activation whose
        gradient starts the chain (created as an input-like tensor tied to
        the forward value by a zero-cost ewise).

        ``master_fp32``: add fp32 master-weight tensors (mixed-precision
        training keeps an fp32 copy next to the bf16 compute weight; the
        update op reads+writes the master, and the write-back into the
        bf16 weight is what the all-gather after a ZeRO-sharded update
        moves — 2 bytes/elem, not 4).  ``error_feedback``: add the fp32
        error-feedback residual of int8 compressed gradient sync
        (optim/compression.py) as persistent per-weight state.  Both ride
        the update op, so the solver prices their tilings jointly with the
        weight / gradient / moment tilings (DESIGN.md §12)."""
        accum: Dict[str, int] = {}
        # seed gradient (loss backward), tied to fwd value
        seed_g = self._ensure_grad(seed, accum)
        seed_group = max((f.group for f in self.fwd if f.output == seed),
                         default=self.group)
        self.g.ewise(f"seed:{seed_g}", (seed,), seed_g)
        self._tag(seed_group)

        def grad_of(t: str, group: int) -> Optional[str]:
            base = self.grad_name(t)
            if t not in accum:
                return None
            n = accum[t]
            parts = [base] + [f"{base}#{k}" for k in range(1, n)]
            if n == 1:
                return base
            # accumulate: ewise add into a fresh tensor
            ts = self.g.tensors[t]
            tot = f"{base}.sum{n}"
            if tot not in self.g.tensors:
                self.g.tensor(tot, ts.dims, ts.shape, ts.bytes_per_elem,
                              "grad", None, dict(ts.units))
                self.g.ewise(f"acc:{tot}", tuple(parts), tot)
                self._tag(group)
            return tot

        for op in reversed(self.fwd):
            dy = grad_of(op.output, op.group)
            if dy is None:
                continue
            if op.kind == "einsum":
                lhs, rhs = op.inputs
                if op.grad_inputs[0]:
                    dl = self._ensure_grad(lhs, accum)
                    self.g.einsum(f"bwd:{dl}", dy, rhs, dl, op.repeat)
                    self._tag(op.group)
                if op.grad_inputs[1]:
                    dr = self._ensure_grad(rhs, accum)
                    self.g.einsum(f"bwd:{dr}", lhs, dy, dr, op.repeat)
                    self._tag(op.group)
            elif op.kind == "ewise":
                for i, t in enumerate(op.inputs):
                    if not op.grad_inputs[i]:
                        continue
                    dt = self._ensure_grad(t, accum)
                    self.g.ewise(f"bwd:{dt}", (dy,) + op.inputs, dt,
                                 op.repeat, align_dims=op.align_dims)
                    self._tag(op.group)
            elif op.kind == "custom":
                for i, t in enumerate(op.inputs):
                    if not op.grad_inputs[i]:
                        continue
                    dt = self._ensure_grad(t, accum)
                    forms = []
                    for form, pen in op.bwd_forms[t]:
                        f = dict(form)
                        # rename placeholders IN/OUT
                        f2 = {}
                        for k, v in f.items():
                            if k == "__dy__":
                                f2[dy] = v
                            elif k == "__dx__":
                                f2[dt] = v
                            else:
                                f2[k] = v
                        forms.append((f2, pen))
                    self.g.custom(f"bwd:{dt}", (dy,), dt, forms, op.repeat)
                    self._tag(op.group)
        # parameter updates: the op writes back into W itself, so the
        # solver cannot pick a next-iteration weight tiling that differs
        # from this iteration's (the update ties them).  The Adam moments
        # participate as fp32 'opt' tensors (2 x 4 bytes) — and, when
        # requested, the fp32 master weight and the compression error-
        # feedback residual: the aligned-form machinery then prices
        # ZeRO-style sharded updates exactly (dW red->P reduce-scatter,
        # m/v/master/err: P local, W': P->r all-gather of the *bf16*
        # compute weight).  Each state tensor gets a derived role
        # (<role>.opt / .master / .err) so ShardingPlan carries its
        # solved tiling out to the training engine (repro.train).
        for w in self.weights:
            grp = self._weight_group.get(w, 0)
            dw = grad_of(w, grp)
            if dw is None:
                continue
            ts = self.g.tensors[w]
            upd = [w, dw]
            for tag, bpe, on in (("opt", 8.0, True),
                                 ("master", 4.0, master_fp32),
                                 ("err", 4.0, error_feedback)):
                if not on:
                    continue
                upd.append(self.g.tensor(
                    f"{tag}:{w}", ts.dims, ts.shape, bpe, "opt",
                    (ts.role + f".{tag}") if ts.role else None,
                    dict(ts.units)))
            self.g.ewise(f"upd:{w}", tuple(upd), w, update=True)
            self._tag(grp)


# --------------------------------------------------------------------------
# Paper models: MLP (§2.2 / Fig.8), CNN (Fig.9), AlexNet / VGG (Fig.10)
# --------------------------------------------------------------------------

def mlp_graph(batch: int, hidden: List[int], bytes_per_elem: float = FP32,
              with_backward: bool = True, seed_free: bool = False,
              master_fp32: bool = False,
              error_feedback: bool = False) -> Graph:
    """The paper's MLP: L fully-connected layers.  ``hidden`` holds L+1
    widths.  ``seed_free``: don't charge for the loss-seed conversion
    (the paper's §2.2 accounting *includes* it in the activation total,
    so the default is False)."""
    b = GraphBuilder("mlp", allow_uneven=True)
    x = b.inp("x0", ("batch", "h0"), (batch, hidden[0]),
              bytes_per_elem=bytes_per_elem)
    for l in range(1, len(hidden)):
        b.new_group()
        w = b.weight(f"W{l}", (f"h{l-1}", f"h{l}"),
                     (hidden[l - 1], hidden[l]), role=f"W{l}",
                     bytes_per_elem=bytes_per_elem)
        x = b.act(f"x{l}", ("batch", f"h{l}"), (batch, hidden[l]),
                  role=f"x{l}", bytes_per_elem=bytes_per_elem)
        b.einsum(f"x{l-1}" if l > 1 else "x0", w, x,
                 grads=(l > 1, True))
    if with_backward:
        b.add_backward(x, master_fp32=master_fp32,
                       error_feedback=error_feedback)
        if seed_free:
            for op in b.g.ops:
                if op.name.startswith("seed:"):
                    op.repeat = 0.0
    return b.g


def cnn_graph(batch: int, image: int, channels: List[int], fc: List[int],
              kernel: int = 3, bytes_per_elem: float = FP32,
              pool_every: int = 2, with_backward: bool = True) -> Graph:
    """Convolutional network in im2col form (paper §4.5: tilings on batch
    and channel dims; image/kernel dims strictly dominated).  Each conv is
    an einsum  x[batch, pix_l, cink_l] × w[cink_l, cout_l] -> y[batch,
    pix_l, cout_l]  where cink = k²·c_in (units=c_in granularity)."""
    b = GraphBuilder("cnn", allow_uneven=True)
    pix = image * image
    x = b.inp("x0", ("batch", "pix0", "c0"), (batch, pix, channels[0]),
              bytes_per_elem=bytes_per_elem)
    for l in range(1, len(channels)):
        b.new_group()
        cin, cout = channels[l - 1], channels[l]
        cink = kernel * kernel * cin
        if l > 1 and (l - 1) % pool_every == 0:
            pix = max(1, pix // 4)
        # im2col expansion: zero-cost logical tensor tied elementwise
        xc = b.act(f"x{l-1}c", ("batch", f"pix{l-1}", f"cink{l}"),
                   (batch, pix, cink), units={f"cink{l}": kernel * kernel},
                   bytes_per_elem=bytes_per_elem)
        b.ewise((f"x{l-1}" if l > 1 else "x0",), xc,
                align_dims=("batch", f"pix{l-1}"))
        w = b.weight(f"W{l}", (f"cink{l}", f"c{l}"), (cink, cout),
                     role=f"conv{l}", units={f"cink{l}": kernel * kernel},
                     bytes_per_elem=bytes_per_elem)
        x = b.act(f"x{l}", ("batch", f"pix{l-1}", f"c{l}"),
                  (batch, pix, cout), bytes_per_elem=bytes_per_elem)
        b.einsum(xc, w, x, grads=(l > 1, True))
    # flatten + FC stack
    feat = pix * channels[-1]
    xf = b.act("xflat", ("batch", "hf0"), (batch, feat),
               bytes_per_elem=bytes_per_elem)
    b.ewise((x,), xf, align_dims=("batch",))
    prev = xf
    widths = [feat] + fc
    for l in range(1, len(widths)):
        b.new_group()
        w = b.weight(f"F{l}", (f"hf{l-1}", f"hf{l}"),
                     (widths[l - 1], widths[l]), role=f"fc{l}",
                     bytes_per_elem=bytes_per_elem)
        nxt = b.act(f"xf{l}", ("batch", f"hf{l}"), (batch, widths[l]),
                    bytes_per_elem=bytes_per_elem)
        b.einsum(prev, w, nxt)
        prev = nxt
    if with_backward:
        b.add_backward(prev)
    return b.g


def alexnet_graph(batch: int, with_backward: bool = True) -> Graph:
    """AlexNet (Fig. 10a): 5 convs + 3 FC (im2col coarse model)."""
    return cnn_graph(batch, image=55, channels=[3, 96, 256, 384, 384, 256],
                     fc=[4096, 4096, 1000], kernel=3,
                     with_backward=with_backward)


def vgg_graph(batch: int, with_backward: bool = True) -> Graph:
    """VGG-16 (Fig. 10b)."""
    return cnn_graph(batch, image=224,
                     channels=[3, 64, 64, 128, 128, 256, 256, 256,
                               512, 512, 512, 512, 512, 512],
                     fc=[4096, 4096, 1000], kernel=3, pool_every=2,
                     with_backward=with_backward)


# --------------------------------------------------------------------------
# Transformer-family graphs from ArchConfig × ShapeConfig
# --------------------------------------------------------------------------

def _attn_block(b: GraphBuilder, cfg: ArchConfig, x: str, tag: str,
                rep: float, B: int, S: int) -> str:
    b.new_group()
    d, hd = cfg.d_model, cfg.hd
    H, KV = cfg.n_heads, cfg.n_kv_heads
    wq = b.weight(f"wq{tag}", ("d_model", "heads"), (d, H * hd),
                  role="wq", units={"heads": hd})
    wk = b.weight(f"wk{tag}", ("d_model", "kv_heads"), (d, KV * hd),
                  role="wk", units={"kv_heads": hd})
    wv = b.weight(f"wv{tag}", ("d_model", "kv_heads"), (d, KV * hd),
                  role="wv", units={"kv_heads": hd})
    wo = b.weight(f"wo{tag}", ("heads", "d_model"), (H * hd, d),
                  role="wo", units={"heads": hd})
    q = b.act(f"q{tag}", ("batch", "seq", "heads"), (B, S, H * hd),
              units={"heads": hd})
    k = b.act(f"k{tag}", ("batch", "seq", "kv_heads"), (B, S, KV * hd),
              units={"kv_heads": hd})
    v = b.act(f"v{tag}", ("batch", "seq", "kv_heads"), (B, S, KV * hd),
              units={"kv_heads": hd})
    b.einsum(x, wq, q, rep)
    b.einsum(x, wk, k, rep)
    b.einsum(x, wv, v, rep)
    ao = b.act(f"ao{tag}", ("batch", "seq", "heads"), (B, S, H * hd),
               units={"heads": hd})
    # attention is parallel over batch and (q-)heads; kv tensors lacking
    # "heads" are replicated in the head-parallel form (GQA TP)
    b.ewise((q, k, v), ao, rep, align_dims=("batch", "heads"))
    xo = b.act(f"xattn{tag}", ("batch", "seq", "d_model"), (B, S, d),
               role="x")
    b.einsum(ao, wo, xo, rep)
    res = b.act(f"xattn_res{tag}", ("batch", "seq", "d_model"), (B, S, d))
    b.ewise((x, xo), res, rep)
    return res


def _mlp_block(b: GraphBuilder, cfg: ArchConfig, x: str, tag: str,
               rep: float, B: int, S: int) -> str:
    b.new_group()
    d, f = cfg.d_model, cfg.d_ff
    wg = b.weight(f"wg{tag}", ("d_model", "d_ff"), (d, f), role="w_gate")
    wu = b.weight(f"wu{tag}", ("d_model", "d_ff"), (d, f), role="w_up")
    wd = b.weight(f"wd{tag}", ("d_ff", "d_model"), (f, d), role="w_down")
    hg = b.act(f"hg{tag}", ("batch", "seq", "d_ff"), (B, S, f))
    hu = b.act(f"hu{tag}", ("batch", "seq", "d_ff"), (B, S, f))
    b.einsum(x, wg, hg, rep)
    b.einsum(x, wu, hu, rep)
    h = b.act(f"h{tag}", ("batch", "seq", "d_ff"), (B, S, f))
    b.ewise((hg, hu), h, rep)
    y = b.act(f"xmlp{tag}", ("batch", "seq", "d_model"), (B, S, d))
    b.einsum(h, wd, y, rep)
    res = b.act(f"xmlp_res{tag}", ("batch", "seq", "d_model"), (B, S, d))
    b.ewise((x, y), res, rep)
    return res


def _moe_block(b: GraphBuilder, cfg: ArchConfig, x: str, tag: str,
               rep: float, B: int, S: int) -> str:
    b.new_group()
    d = cfg.d_model
    m = cfg.moe
    E, K, f = m.n_experts, m.top_k, m.d_ff_expert
    cap = max(1, (B * S * K) // E)
    wr = b.weight(f"wr{tag}", ("d_model", "expert"), (d, E),
                  role="moe_gate")
    scores = b.act(f"router{tag}", ("batch", "seq", "expert"), (B, S, E))
    b.einsum(x, wr, scores, rep)
    xd = b.act(f"xdisp{tag}", ("tok_e", "expert", "d_model"), (cap, E, d))
    # routing: under batch/seq partitioning the dispatch is local (tokens
    # stay put); converting xdisp to an expert partition afterwards *is*
    # the all-to-all — it falls out of the conversion cost.
    route_forms = [
        ({x: Part("batch"), xd: Part("tok_e")}, 0.0),
        ({x: Part("seq"), xd: Part("tok_e")}, 0.0),
        ({x: Part("d_model"), xd: Part("d_model")}, 0.0),
        ({x: REPLICATE, xd: REPLICATE}, b.g.tensors[x].nbytes),
    ]
    bwd_route = {x: [
        ({"__dy__": Part("tok_e"), "__dx__": Part("batch")}, 0.0),
        ({"__dy__": Part("tok_e"), "__dx__": Part("seq")}, 0.0),
        ({"__dy__": Part("d_model"), "__dx__": Part("d_model")}, 0.0),
        ({"__dy__": REPLICATE, "__dx__": REPLICATE},
         b.g.tensors[x].nbytes),
    ]}
    b.custom((x,), xd, route_forms, rep, bwd_forms=bwd_route)
    w1 = b.weight(f"we_up{tag}", ("expert", "d_model", "e_ff"),
                  (E, d, f), role="moe_up")
    w2 = b.weight(f"we_dn{tag}", ("expert", "e_ff", "d_model"),
                  (E, f, d), role="moe_down")
    h = b.act(f"he{tag}", ("tok_e", "expert", "e_ff"), (cap, E, f))
    b.einsum(xd, w1, h, rep)
    ha = b.act(f"hea{tag}", ("tok_e", "expert", "e_ff"), (cap, E, f))
    b.ewise((h,), ha, rep)
    yd = b.act(f"ydisp{tag}", ("tok_e", "expert", "d_model"), (cap, E, d))
    b.einsum(ha, w2, yd, rep)
    y = b.act(f"xmoe{tag}", ("batch", "seq", "d_model"), (B, S, d))
    comb_forms = [
        ({yd: Part("tok_e"), y: Part("batch")}, 0.0),
        ({yd: Part("tok_e"), y: Part("seq")}, 0.0),
        ({yd: Part("d_model"), y: Part("d_model")}, 0.0),
        ({yd: REPLICATE, y: REPLICATE}, b.g.tensors[y].nbytes),
    ]
    bwd_comb = {yd: [
        ({"__dy__": Part("batch"), "__dx__": Part("tok_e")}, 0.0),
        ({"__dy__": Part("seq"), "__dx__": Part("tok_e")}, 0.0),
        ({"__dy__": Part("d_model"), "__dx__": Part("d_model")}, 0.0),
        ({"__dy__": REPLICATE, "__dx__": REPLICATE},
         b.g.tensors[yd].nbytes),
    ]}
    b.custom((yd,), y, comb_forms, rep, bwd_forms=bwd_comb)
    res = b.act(f"xmoe_res{tag}", ("batch", "seq", "d_model"), (B, S, d))
    b.ewise((scores, x, y), res, rep)
    return res


def _ssm_block(b: GraphBuilder, cfg: ArchConfig, x: str, tag: str,
               rep: float, B: int, S: int) -> str:
    """Mamba2 block, coarse: in-proj, chunked-scan (ewise over batch/inner
    channels), out-proj."""
    b.new_group()
    d = cfg.d_model
    di = cfg.d_inner
    p = cfg.ssm.head_dim
    wi = b.weight(f"wi{tag}", ("d_model", "inner"), (d, 2 * di),
                  role="ssm_in", units={"inner": p})
    wo = b.weight(f"wssmo{tag}", ("inner", "d_model"), (di, d),
                  role="ssm_out", units={"inner": p})
    zi = b.act(f"zi{tag}", ("batch", "seq", "inner"), (B, S, 2 * di),
               units={"inner": p})
    b.einsum(x, wi, zi, rep)
    ys = b.act(f"yscan{tag}", ("batch", "seq", "inner"), (B, S, di),
               units={"inner": p})
    # SSD scan: sequential over seq; parallel over batch and channel heads
    b.ewise((zi,), ys, rep, align_dims=("batch", "inner"))
    y = b.act(f"xssm{tag}", ("batch", "seq", "d_model"), (B, S, d))
    b.einsum(ys, wo, y, rep)
    res = b.act(f"xssm_res{tag}", ("batch", "seq", "d_model"), (B, S, d))
    b.ewise((x, y), res, rep)
    return res


def _xlstm_block(b: GraphBuilder, cfg: ArchConfig, x: str, tag: str,
                 rep: float, B: int, S: int) -> str:
    b.new_group()
    d = cfg.d_model
    dm = int(d * cfg.xlstm.proj_factor_mlstm)
    wi = b.weight(f"wxi{tag}", ("d_model", "inner"), (d, 3 * dm),
                  role="ssm_in", units={"inner": dm // cfg.n_heads})
    wo = b.weight(f"wxo{tag}", ("inner", "d_model"), (dm, d),
                  role="ssm_out", units={"inner": dm // cfg.n_heads})
    zi = b.act(f"zxi{tag}", ("batch", "seq", "inner"), (B, S, 3 * dm),
               units={"inner": dm // cfg.n_heads})
    b.einsum(x, wi, zi, rep)
    ys = b.act(f"yxscan{tag}", ("batch", "seq", "inner"), (B, S, dm),
               units={"inner": dm // cfg.n_heads})
    b.ewise((zi,), ys, rep, align_dims=("batch", "inner"))
    y = b.act(f"xx{tag}", ("batch", "seq", "d_model"), (B, S, d))
    b.einsum(ys, wo, y, rep)
    res = b.act(f"xx_res{tag}", ("batch", "seq", "d_model"), (B, S, d))
    b.ewise((x, y), res, rep)
    return res


def _layer(b: GraphBuilder, cfg: ArchConfig, x: str, tag: str, rep: float,
           B: int, S: int) -> str:
    if cfg.xlstm is not None:
        return _xlstm_block(b, cfg, x, tag, rep, B, S)
    if cfg.family in ("ssm", "hybrid") and cfg.ssm is not None:
        return _ssm_block(b, cfg, x, tag, rep, B, S)
    x = _attn_block(b, cfg, x, tag, rep, B, S)
    if cfg.moe is not None:
        return _moe_block(b, cfg, x, tag, rep, B, S)
    if cfg.d_ff:
        return _mlp_block(b, cfg, x, tag, rep, B, S)
    return x


def transformer_graph(cfg: ArchConfig, shape: ShapeConfig,
                      n_rep: int = 2, master_fp32: bool = False,
                      error_feedback: bool = False) -> Graph:
    """Training (or prefill) semantic graph: embed -> n_rep chained
    representative layers carrying repeat=L/n_rep -> head -> loss (+ full
    backward & updates for training shapes).  ``master_fp32`` /
    ``error_feedback`` add the corresponding optimizer-state tensors to
    the update ops (see GraphBuilder.add_backward) — the training engine
    solves with the flags matching its runtime policy."""
    B, S, d, V = shape.global_batch, shape.seq_len, cfg.d_model, cfg.vocab
    b = GraphBuilder(f"{cfg.name}:{shape.name}")
    # embedding: one-hot trick (zero-byte lhs) models gather comm correctly
    oh = b.inp("onehot", ("batch", "seq", "vocab"), (B, S, V),
               bytes_per_elem=0.0)
    we = b.weight("embed", ("vocab", "d_model"), (V, d), role="embed")
    x = b.act("x_emb", ("batch", "seq", "d_model"), (B, S, d), role="x")
    b.einsum(oh, we, x, grads=(False, not cfg.embed_stub))

    L = cfg.n_layers
    if cfg.family == "hybrid" and cfg.attn_every:
        n_shared = max(1, L // cfg.attn_every)
        x = _ssm_block(b, cfg, x, "A", L / 2, B, S)
        x = _attn_block(b, cfg, x, "S", n_shared, B, S)
        x = _mlp_block(b, cfg, x, "S", n_shared, B, S)
        x = _ssm_block(b, cfg, x, "B", L / 2, B, S)
    elif cfg.xlstm is not None:
        x = _xlstm_block(b, cfg, x, "A", L / 2, B, S)
        x = _xlstm_block(b, cfg, x, "B", L / 2, B, S)
    else:
        for i in range(n_rep):
            x = _layer(b, cfg, x, chr(ord("A") + i), L / n_rep, B, S)

    b.new_group()
    wh = b.weight("lm_head", ("d_model", "vocab"), (d, V), role="lm_head")
    logits = b.act("logits", ("batch", "seq", "vocab"), (B, S, V),
                   role="logits")
    b.einsum(x, wh, logits)
    if shape.kind == "train":
        # loss: logsumexp reduce over vocab + elementwise seed
        lse = b.act("lse", ("batch", "seq"), (B, S))
        b.g.reduce("loss:lse", logits, lse, axis="vocab")
        b._tag()
        b.add_backward(logits, master_fp32=master_fp32,
                       error_feedback=error_feedback)
    return b.g


def decode_graph(cfg: ArchConfig, shape: ShapeConfig,
                 paged: bool = False, block_len: int = 16) -> Graph:
    """Serving decode step: 1 new token per sequence against a KV cache /
    SSM state of length shape.seq_len.

    ``paged``: model the paged serving tier — the per-slot block table
    becomes a solver tensor (role "block_table") feeding the cache
    append+gather op, so the solve places it with the cache view it
    indexes (batch-cut together or replicated together), and the
    flash-decoding seq_kv form is dropped (the table-gather kernel has
    no partial-softmax combine across seq shards)."""
    B, S, d, V = shape.global_batch, shape.seq_len, cfg.d_model, cfg.vocab
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    b = GraphBuilder(f"{cfg.name}:{shape.name}")
    oh = b.inp("onehot", ("batch", "vocab"), (B, V), bytes_per_elem=0.0)
    we = b.weight("embed", ("vocab", "d_model"), (V, d), role="embed")
    x = b.act("x_emb", ("batch", "d_model"), (B, d), role="x")
    b.einsum(oh, we, x, grads=(False, False))
    L = cfg.n_layers

    def attn_decode(x: str, tag: str, rep: float, window: Optional[int]) -> str:
        b.new_group()
        Sk = min(S, window) if window else S
        wq = b.weight(f"wq{tag}", ("d_model", "heads"), (d, H * hd),
                      role="wq", units={"heads": hd})
        wk = b.weight(f"wk{tag}", ("d_model", "kv_heads"), (d, KV * hd),
                      role="wk", units={"kv_heads": hd})
        wv = b.weight(f"wv{tag}", ("d_model", "kv_heads"), (d, KV * hd),
                      role="wv", units={"kv_heads": hd})
        wo = b.weight(f"wo{tag}", ("heads", "d_model"), (H * hd, d),
                      role="wo", units={"heads": hd})
        q = b.act(f"q{tag}", ("batch", "heads"), (B, H * hd),
                  units={"heads": hd})
        b.einsum(x, wq, q, rep, grads=(False, False))
        kn = b.act(f"knew{tag}", ("batch", "kv_heads"), (B, KV * hd),
                   units={"kv_heads": hd})
        vn = b.act(f"vnew{tag}", ("batch", "kv_heads"), (B, KV * hd),
                   units={"kv_heads": hd})
        b.einsum(x, wk, kn, rep, grads=(False, False))
        b.einsum(x, wv, vn, rep, grads=(False, False))
        kc = b.inp(f"kcache{tag}", ("batch", "seq_kv", "kv_heads"),
                   (B, Sk, KV * hd), units={"kv_heads": hd},
                   role="kv_cache")
        vc = b.inp(f"vcache{tag}", ("batch", "seq_kv", "kv_heads"),
                   (B, Sk, KV * hd), units={"kv_heads": hd},
                   role="kv_cache")
        kc2 = b.act(f"kcache2{tag}", ("batch", "seq_kv", "kv_heads"),
                    (B, Sk, KV * hd), units={"kv_heads": hd},
                    role="kv_cache")
        if paged:
            # append+gather through the block table: the table must be
            # split exactly like the per-slot cache view's batch (each
            # shard gathers its own rows from the replicated pool), or
            # replicated with it under head parallelism
            mbk = -(-Sk // block_len)
            bt = b.inp(f"btable{tag}", ("batch", "blocks"), (B, mbk),
                       role="block_table", bytes_per_elem=4.0)
            forms_g = [
                ({kc: Part("batch"), kn: Part("batch"),
                  vc: Part("batch"), vn: Part("batch"),
                  bt: Part("batch"), kc2: Part("batch")}, 0.0),
                ({kc: Part("kv_heads"), kn: Part("kv_heads"),
                  vc: Part("kv_heads"), vn: Part("kv_heads"),
                  bt: REPLICATE, kc2: Part("kv_heads")}, 0.0),
                ({kc: REPLICATE, kn: REPLICATE, vc: REPLICATE,
                  vn: REPLICATE, bt: REPLICATE, kc2: REPLICATE}, 0.0),
            ]
            b.custom((kc, kn, vc, vn, bt), kc2, forms_g, rep)
        else:
            b.ewise((kc, kn, vc, vn), kc2, rep,
                    align_dims=("batch", "kv_heads", "seq_kv"),
                    grads=(False,) * 4)
        ao = b.act(f"ao{tag}", ("batch", "heads"), (B, H * hd),
                   units={"heads": hd})
        forms = [
            ({q: Part("batch"), kc2: Part("batch"), ao: Part("batch")}, 0.0),
            # head-parallel with replicated KV (GQA tensor parallelism)
            ({q: Part("heads"), kc2: REPLICATE, ao: Part("heads")}, 0.0),
            # flash-decoding: split the cache along seq_kv, combine partials
            ({q: REPLICATE, kc2: Part("seq_kv"), ao: REDUCED}, 0.0),
            # joint q/kv head parallelism (feasible when KV % arity == 0)
            ({q: Part("heads"), kc2: Part("kv_heads"), ao: Part("heads")},
             0.0),
        ]
        if paged:
            # no flash-decoding form: the paged gather kernel cannot
            # combine partial softmaxes across seq_kv shards
            forms = [f for f in forms
                     if f[0][kc2] != Part("seq_kv")]
        b.custom((q, kc2), ao, forms, rep)
        xo = b.act(f"xattn{tag}", ("batch", "d_model"), (B, d), role="x")
        b.einsum(ao, wo, xo, rep, grads=(False, False))
        res = b.act(f"xares{tag}", ("batch", "d_model"), (B, d))
        b.ewise((x, xo), res, rep, grads=(False, False))
        return res

    def mlp_decode(x: str, tag: str, rep: float) -> str:
        b.new_group()
        # MoE decode: coarse active-expert FFN (top_k experts per token)
        f = (cfg.moe.top_k * cfg.moe.d_ff_expert) if cfg.moe else cfg.d_ff
        wg = b.weight(f"wg{tag}", ("d_model", "d_ff"), (d, f), role="w_gate")
        wd = b.weight(f"wd{tag}", ("d_ff", "d_model"), (f, d), role="w_down")
        h = b.act(f"h{tag}", ("batch", "d_ff"), (B, f))
        b.einsum(x, wg, h, rep, grads=(False, False))
        y = b.act(f"xmlp{tag}", ("batch", "d_model"), (B, d))
        b.einsum(h, wd, y, rep, grads=(False, False))
        res = b.act(f"xmres{tag}", ("batch", "d_model"), (B, d))
        b.ewise((x, y), res, rep, grads=(False, False))
        return res

    def ssm_decode(x: str, tag: str, rep: float) -> str:
        b.new_group()
        di = cfg.d_inner or int(d * (cfg.xlstm.proj_factor_mlstm
                                     if cfg.xlstm else 2))
        p = cfg.ssm.head_dim if cfg.ssm else max(1, di // cfg.n_heads)
        N = cfg.ssm.state_dim if cfg.ssm else cfg.hd
        wi = b.weight(f"wi{tag}", ("d_model", "inner"), (d, 2 * di),
                      role="ssm_in", units={"inner": p})
        wo = b.weight(f"wssmo{tag}", ("inner", "d_model"), (di, d),
                      role="ssm_out", units={"inner": p})
        st = b.inp(f"state{tag}", ("batch", "inner", "sdim"), (B, di, N),
                   units={"inner": p}, role="ssm_state")
        zi = b.act(f"zi{tag}", ("batch", "inner"), (B, 2 * di),
                   units={"inner": p})
        b.einsum(x, wi, zi, rep, grads=(False, False))
        st2 = b.act(f"state2{tag}", ("batch", "inner", "sdim"), (B, di, N),
                    units={"inner": p}, role="ssm_state")
        ys = b.act(f"ys{tag}", ("batch", "inner"), (B, di),
                   units={"inner": p})
        b.ewise((zi, st), st2, rep, align_dims=("batch", "inner"),
                grads=(False, False))
        b.ewise((st2, zi), ys, rep, align_dims=("batch", "inner"),
                grads=(False, False))
        y = b.act(f"xssm{tag}", ("batch", "d_model"), (B, d))
        b.einsum(ys, wo, y, rep, grads=(False, False))
        res = b.act(f"xsres{tag}", ("batch", "d_model"), (B, d))
        b.ewise((x, y), res, rep, grads=(False, False))
        return res

    L = cfg.n_layers
    if cfg.family == "hybrid" and cfg.attn_every:
        # long-context serving: the shared attention block is windowed so
        # the hybrid arch stays O(1)-state (DESIGN.md long_500k policy)
        win = (cfg.swa_window or 4096) if S > 65536 else None
        x = ssm_decode(x, "A", L / 2)
        x = attn_decode(x, "S", max(1, L // cfg.attn_every), window=win)
        x = mlp_decode(x, "S", max(1, L // cfg.attn_every))
        x = ssm_decode(x, "B", L / 2)
    elif cfg.xlstm is not None or cfg.family == "ssm":
        x = ssm_decode(x, "A", L / 2)
        x = ssm_decode(x, "B", L / 2)
    else:
        x = attn_decode(x, "A", L / 2, window=cfg.swa_window)
        if cfg.moe is not None:
            x = mlp_decode(x, "A", L / 2)  # coarse: active-expert FFN
        elif cfg.d_ff:
            x = mlp_decode(x, "A", L / 2)
        x = attn_decode(x, "B", L / 2, window=cfg.swa_window)
        if cfg.d_ff or cfg.moe:
            x = mlp_decode(x, "B", L / 2)

    b.new_group()
    wh = b.weight("lm_head", ("d_model", "vocab"), (d, V), role="lm_head")
    logits = b.act("logits", ("batch", "vocab"), (B, V), role="logits")
    b.einsum(x, wh, logits, grads=(False, False))
    return b.g


def build_graph(cfg: ArchConfig, shape: ShapeConfig,
                master_fp32: bool = False,
                error_feedback: bool = False) -> Graph:
    if shape.kind == "decode":
        return decode_graph(cfg, shape)
    if shape.kind == "decode-paged":
        return decode_graph(cfg, shape, paged=True)
    return transformer_graph(cfg, shape, master_fp32=master_fp32,
                             error_feedback=error_feedback)
