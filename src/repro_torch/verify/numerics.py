"""Differential numerics (the port's ``repro.verify.numerics``): a solved
plan's sharded step must compute the same numbers as the one-device
serial program.

For each conformance cell the *same parameter values* (``LM.init(0)``)
run through:
  serial    LM(cfg) with no plan, on this rank's device
  sharded   LM(cfg, plan=..., mesh=...) with params, batch and cache as
            DTensors placed by the plan on the verification mesh

train cells compare the scalar loss; prefill cells the full logits;
decode cells the per-step logits over several steps (KV, SSM and xLSTM
state placed by the plan).  bf16 models on different layouts
re-associate reductions, so tolerances are bands, not equality: repro's
declared values.  torch is imported inside the functions.
"""
from __future__ import annotations

from typing import Dict

# declared numerics tolerance bands (repro's)
LOSS_ATOL = 0.05          # scalar loss, bf16 model
LOGITS_ATOL = 0.25        # max-abs over logits, bf16 model

DECODE_STEPS = 4


def mesh_device(mesh):
    """The torch device of this rank's part of ``mesh``: its card, or the
    CPU."""
    import torch
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _batch(cfg, shape, device, seed: int = 0):
    """The cell's batch, drawn by a seeded CPU ``torch.Generator`` (the
    same values on every rank and device) and moved to ``device``:
    tokens [B, S] and their next-token labels, or embeds [B, S, D] and
    random labels for an embedding-stub config."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    b, s = shape.global_batch, shape.seq_len
    if cfg.embed_stub:
        emb = torch.randn((b, s, cfg.d_model), generator=g)
        labels = torch.randint(0, cfg.vocab, (b, s), generator=g)
        return {"embeds": emb.to(device), "labels": labels.to(device)}
    toks = torch.randint(0, cfg.vocab, (b, s), generator=g)
    return {"tokens": toks.to(device),
            "labels": torch.roll(toks, -1, 1).to(device)}


def _f32(t):
    from ..models.common import whole
    return whole(t).detach().float()


def run_numerics(cfg, shape, plan, mesh, params=None) -> Dict[str, object]:
    """Returns a record with serial/sharded values, the observed error
    and the pass verdict for this cell's kind.  ``plan``'s MoE roles are
    pinned as the MoE layer runs them (``normalize_moe_plan``).
    ``params``: the serial model's parameters on this rank's device
    (``LM(cfg).init(0)`` when omitted)."""
    import torch

    from ..launch.compile import normalize_moe_plan
    from ..models.model import LM
    from ..models.sharding import (CACHE_RULES, batch_placements, place,
                                   place_tree, zeros_tree)

    dev = mesh_device(mesh)
    names = mesh.mesh_dim_names
    plan = normalize_moe_plan(plan, cfg)
    serial = LM(cfg)
    if params is None:
        params = serial.init(0, device=dev)
    batch = _batch(cfg, shape, dev)
    rec: Dict[str, object] = {"kind": shape.kind}

    with torch.no_grad():
        if shape.kind == "decode":
            sizes = dict(zip(names, mesh.mesh.shape))
            plan = plan.for_pool(shape.global_batch, sizes)
        sharded = LM(cfg, plan=plan, mesh=mesh)
        p1 = place_tree(params, mesh, plan)

        if shape.kind == "train":
            l0 = float(serial.loss(params, batch))
            bpl = batch_placements(plan, names, "train")
            bpl["embeds"] = batch_placements(plan, names, "prefill")
            b1 = {k: place(v, mesh, bpl[k]) for k, v in batch.items()}
            l1 = float(_f32(sharded.loss(p1, b1)))
            err = abs(l0 - l1)
            rec.update(serial_loss=l0, sharded_loss=l1, abs_err=err,
                       tol=LOSS_ATOL, ok=bool(err < LOSS_ATOL))
            return rec

        if shape.kind == "prefill":
            logits0 = serial.forward(params, batch.get("tokens"),
                                     batch.get("embeds"))[0].float()
            bpl = batch_placements(plan, names, "prefill")
            toks = {k: place(v, mesh, bpl) for k, v in batch.items()
                    if k != "labels"}
            logits1 = _f32(sharded.forward(p1, toks.get("tokens"),
                                           toks.get("embeds"))[0])
            err = float((logits0 - logits1).abs().max())
            rec.update(max_abs_err=err, tol=LOGITS_ATOL,
                       logit_scale=float(logits0.abs().max()),
                       ok=bool(err < LOGITS_ATOL))
            return rec

        # decode: step by step against the serial stepper, the sharded
        # cache placed by the plan (each rank allocating its shard)
        b, s = shape.global_batch, shape.seq_len
        cache0 = serial.init_cache(b, s, device=dev)
        cache1 = zeros_tree(sharded.cache_shapes(b, s), mesh, plan,
                            CACHE_RULES, dev)
        g = torch.Generator(device="cpu").manual_seed(0)
        if cfg.embed_stub:
            toks = torch.randn((DECODE_STEPS, b, cfg.d_model), generator=g)
        else:
            toks = torch.randint(0, cfg.vocab, (DECODE_STEPS, b),
                                 generator=g)
        toks = toks.to(dev)
        max_err, scale = 0.0, 0.0
        for i in range(DECODE_STEPS):
            lg0, cache0 = serial.decode_step(params, cache0, toks[i])
            lg1, cache1 = sharded.decode_step(p1, cache1, toks[i])
            a, bb = lg0.float(), _f32(lg1)
            max_err = max(max_err, float((a - bb).abs().max()))
            scale = max(scale, float(a.abs().max()))
        rec.update(steps=DECODE_STEPS, max_abs_err=max_err,
                   logit_scale=scale, tol=LOGITS_ATOL,
                   ok=bool(max_err < LOGITS_ATOL))
        return rec
