"""The port's attention kernels (src/repro_torch/kernels) against repro's
Pallas kernels.

On the CPU the port runs the plain versions (kernels/ref.py); they are
held to repro's ``flash_attention_fwd`` / ``flash_attention_decode`` run
in Pallas interpret mode, as tests/test_kernels.py runs them, on the same
seeded numpy inputs.  Tolerance 2e-5 (atol and rtol): both sides compute
in f32 and differ only in summation order, the band tests/test_kernels.py
uses for the same kernels in f32.

The CUDA kernels themselves are held to the plain versions on the card
by tests/test_torch_gpu.py and chip_smoke.py.
"""
import ast
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")     # the card's machine has no JAX
jnp = jax.numpy

from repro.kernels.flash_attention import (flash_attention_decode,
                                           flash_attention_fwd)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import attend_cache, attention

TOL = 2e-5
ROOT = Path(__file__).resolve().parents[1]


def _inputs(seed, b, sq, sk, h, kv, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    return q, k, v


def _visible_rows(sq, sk, off, causal, window):
    """Rows that see at least one key.  A row that sees none has no
    defined output (the TPU kernel averages over its tile padding); no
    caller produces one."""
    qpos = off + np.arange(sq)
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, int)
    return hi > lo


FWD_GRID = list(itertools.product(
    [(4, 4), (4, 2), (4, 1)],       # (q heads, kv heads)
    [True, False],                  # causal
    [None, 5],                      # window
    [0, 3, 7],                      # q_offset
))


@pytest.mark.parametrize("heads,causal,window,q_offset", FWD_GRID)
def test_fwd_ref_matches_pallas(heads, causal, window, q_offset):
    h, kv = heads
    b, sq, sk, hd = 2, 7, 13, 16          # ragged against 4 x 8 tiles
    q, k, v = _inputs(17, b, sq, sk, h, kv, hd)
    o_j, lse_j = flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_offset=q_offset, block_q=4, block_k=8,
        interpret=True)
    o_t, lse_t = ref.flash_attention_fwd_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, q_offset=q_offset)
    rows = _visible_rows(sq, sk, q_offset, causal, window)
    np.testing.assert_allclose(o_t.numpy()[:, rows],
                               np.asarray(o_j)[:, rows], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse_t.numpy()[:, :, rows],
                               np.asarray(lse_j)[:, :, rows],
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("hd,q_offset,window,causal", [
    (80, 0, None, True), (80, 80, 33, True), (128, 0, 33, True),
    (128, 80, None, True), (128, 80, 33, False), (80, 0, None, False)])
def test_fwd_ref_matches_pallas_at_the_kernel_tiles(hd, q_offset, window,
                                                    causal):
    """The CUDA forward's shapes: 64-row q tiles and 64-key tiles (Pallas
    blocks of 64) cut sq 70 against sk 150 raggedly, 12 q heads on 2 KV
    heads (g 6), hd 80 and 128, an offset, a window that starts inside a
    tile."""
    b, sq, sk, h, kv = 1, 70, 150, 12, 2
    q, k, v = _inputs(hd + q_offset, b, sq, sk, h, kv, hd)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o_j, lse_j = flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=64,
        block_k=64, interpret=True, **kw)
    o_t, lse_t = ref.flash_attention_fwd_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    rows = _visible_rows(sq, sk, q_offset, causal, window)
    assert rows.all()
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_fwd_ref_without_offset_matches_pallas(causal):
    """q_offset=None: repro's row-1 pallas_call (_fwd_kernel)."""
    q, k, v = _inputs(3, 1, 9, 9, 4, 2, 16)
    o_j, lse_j = flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=4, block_k=4, interpret=True)
    o_t, lse_t = ref.flash_attention_fwd_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("heads,window", [((4, 2), None), ((4, 1), 3),
                                          ((4, 4), None), ((8, 2), 6)])
def test_decode_ref_matches_pallas(heads, window):
    h, kv = heads
    b, s, hd = 4, 20, 16
    rng = np.random.default_rng(5)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    # the serving cache is bf16: hand both sides the same bf16 values
    kc = torch.randn(b, s, kv, hd, generator=torch.Generator().manual_seed(1)
                     ).to(torch.bfloat16)
    vc = torch.randn(b, s, kv, hd, generator=torch.Generator().manual_seed(2)
                     ).to(torch.bfloat16)
    lengths = np.array([1, 7, 13, s], np.int32)
    o_j = flash_attention_decode(
        jnp.asarray(q), jnp.asarray(kc.float().numpy(), jnp.bfloat16),
        jnp.asarray(vc.float().numpy(), jnp.bfloat16), jnp.asarray(lengths),
        window=window, block_k=8, interpret=True)
    o_t = ref.flash_attention_decode_ref(
        torch.from_numpy(q), kc, vc, torch.from_numpy(lengths),
        window=window)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_ref_empty_slot_matches_pallas(window):
    """A slot of length 0 among live ones: repro's Pallas decode zeroes the
    dead V rows (``_clean``) and returns exact zeros for it; so does the
    plain version, and the live slots keep the 2e-5 band."""
    b, s, h, kv, hd = 4, 20, 4, 2, 16
    rng = np.random.default_rng(6)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    kc, vc = (torch.from_numpy(rng.standard_normal((b, s, kv, hd)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    lengths = np.array([0, 7, 13, s], np.int32)
    o_j = flash_attention_decode(
        jnp.asarray(q), jnp.asarray(kc.float().numpy(), jnp.bfloat16),
        jnp.asarray(vc.float().numpy(), jnp.bfloat16), jnp.asarray(lengths),
        window=window, block_k=8, interpret=True)
    o_t = ref.flash_attention_decode_ref(
        torch.from_numpy(q), kc, vc, torch.from_numpy(lengths),
        window=window)
    assert not o_t[0].any()
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=TOL,
                               rtol=TOL)


# (b, s, h, kv, hd), window, lengths, split: lengths at a split edge, one
# past it, 1 and the whole cache; a window that starts inside split 1 and
# spans two; g 6 at hd 128
SPLIT_CASES = [((4, 48, 4, 2, 16), None, [16, 17, 1, 48], 16),
               ((4, 48, 4, 1, 16), 20, [40, 30, 45, 20], 16),
               ((3, 64, 12, 2, 128), None, [64, 33, 16], 16)]


@pytest.mark.parametrize("shape,window,lengths,split", SPLIT_CASES)
def test_decode_split_ref_matches_pallas(shape, window, lengths, split):
    """The decode kernels' split-and-merge arithmetic (per-split partials
    merged in split order, ref.flash_attention_decode_split_ref) against
    repro's Pallas decode."""
    b, s, h, kv, hd = shape
    rng = np.random.default_rng(8)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    kc, vc = (torch.from_numpy(rng.standard_normal((b, s, kv, hd)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    ln = np.array(lengths, np.int32)
    o_j = flash_attention_decode(
        jnp.asarray(q), jnp.asarray(kc.float().numpy(), jnp.bfloat16),
        jnp.asarray(vc.float().numpy(), jnp.bfloat16), jnp.asarray(ln),
        window=window, block_k=16, interpret=True)
    o_t = ref.flash_attention_decode_split_ref(
        torch.from_numpy(q), kc, vc, torch.from_numpy(ln), split=split,
        window=window)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=TOL,
                               rtol=TOL)


def test_offset_chunk_matches_full_sequence():
    """A prefill chunk at q_offset equals the matching rows of the whole
    sequence (the counterpart of test_offset_chunk_matches_full)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(9, 1, 24, 24, 4, 2, 16))
    full, lse_full = ref.flash_attention_fwd_ref(q, k, v)
    part, lse_part = ref.flash_attention_fwd_ref(
        q[:, 10:18], k, v, q_offset=torch.tensor([10], dtype=torch.int32))
    torch.testing.assert_close(part, full[:, 10:18], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse_part, lse_full[:, :, 10:18], atol=1e-6,
                               rtol=1e-6)


class TestChecks:
    def test_indivisible_heads_raise(self):
        q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 4, 4, 4, 3, 16))
        with pytest.raises(ValueError, match="divisible"):
            ref.flash_attention_fwd_ref(q, k, v)
        with pytest.raises(ValueError, match="divisible"):
            ops.flash_attention_fwd(q, k, v)
        with pytest.raises(ValueError, match="divisible"):
            ops.flash_attention_decode(q[:, 0], k, v,
                                       torch.ones(1, dtype=torch.int32))

    def test_attention_unknown_kwarg_raises(self):
        q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 4, 4, 4, 2, 16))
        with pytest.raises(TypeError, match="unsupported"):
            attention(q, k, v, bogus=1)

    def test_attention_drops_k_chunk_and_forwards_offset(self):
        q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 4, 9, 4, 2, 16))
        o = attention(q, k, v, k_chunk=2, q_offset=5)
        o_ref, _ = ref.flash_attention_fwd_ref(q, k, v, q_offset=5)
        torch.testing.assert_close(o, o_ref, atol=0, rtol=0)

    def test_attention_rejects_other_impls(self):
        q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 4, 4, 4, 2, 16))
        with pytest.raises(ValueError, match="impl"):
            attention(q, k, v, impl="pallas")

    def test_wrappers_take_cuda_tensors_only(self):
        """The kernel wrappers never fall back: a CPU tensor is an error
        there, and ops.py is what routes CPU tensors to the plain path."""
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(0, 1, 4, 4, 4, 2, 16))
        with pytest.raises(ValueError, match="CUDA"):
            fa.flash_attention_fwd(q, k, v)
        with pytest.raises(ValueError, match="CUDA"):
            fa.flash_attention_decode(q[:, 0], k, v,
                                      torch.ones(1, dtype=torch.int32))


@pytest.mark.parametrize("b,sk,kv,g,want", [
    (4, 1024, 2, 6, 3),     # qwen2's training shape: 128 key-tile blocks
    (2, 1024, 32, 1, 1),    # zamba2's shared block: g 1
    (1, 40, 1, 4, 4),       # a tiny grid takes the whole group
    (8, 4096, 2, 6, 1)])    # the key tiles alone fill 132 SMs twice
def test_dkv_split_fills_the_card(b, sk, kv, g, want):
    """The dk/dv kernel's group split: the least divisor of g whose grid
    gives each of 132 SMs its two resident blocks, else all of g."""
    got = fa.dkv_split(b, sk, kv, g, 132)
    assert got == want and g % got == 0
    assert -(-sk // fa.TILE) * kv * b * got >= 2 * 132 or got == g


@pytest.mark.parametrize("positions,want", [
    (2048, 128),        # the serving decode step: the sweep's best
    (64, 128),          # one tile, one split
    (8192, 128),        # 64 splits
    (8193, 256),        # no row cut into more than 64 splits
    (65536, 1024)])
def test_decode_split_follows_the_positions_alone(positions, want):
    """The decode kernels' positions per block: DEC_SPLIT, doubled until a
    row has at most 64 splits; nothing else (not the batch: a row keeps
    its bits in a 16-row draft step and a 64-row verify re-score)."""
    got = fa.decode_split(positions)
    assert got == want and got % fa.TILE == 0
    assert -(-positions // got) <= fa.DEC_MAX_SPLITS
    assert got == fa.DEC_SPLIT or -(-positions // (got // 2)) > \
        fa.DEC_MAX_SPLITS


@pytest.mark.parametrize("b,kv,bl,mb", [(16, 2, 16, 128), (64, 2, 16, 128),
                                        (4, 2, 48, 43), (3, 1, 8, 5)])
def test_decode_split_is_the_same_for_pools_and_their_view(b, kv, bl, mb):
    """The paged kernel splits its MB x BL positions as flash_decode splits
    the gathered view [B, MB x BL, KV, hd] (chip_smoke.py's bit-equality
    check needs the same split on both): both wrappers take their position
    count from decode_positions, here given their own arguments."""
    pools = torch.zeros(b * mb + 1, bl, kv, 16, dtype=torch.bfloat16)
    table = torch.arange(1, b * mb + 1, dtype=torch.int32).reshape(b, mb)
    view = pools[table.long()].reshape(b, -1, kv, 16)
    paged = fa.decode_positions(pools, table)
    assert paged == fa.decode_positions(view) == mb * bl
    assert fa.decode_split(paged) == fa.decode_split(view.shape[1])


def test_cpu_tensors_take_the_plain_path():
    fa.reset_launches()
    ops.reset_plain_calls()
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 2, 5, 8, 4, 2, 16))
    ops.flash_attention_fwd(q, k, v, q_offset=3)
    attend_cache(q[:, 0], k, v, torch.tensor([3, 8], dtype=torch.int32))
    assert fa.launches == {"flash_fwd": 0, "flash_fwd_f32": 0,
                           "flash_decode": 0, "flash_paged_decode": 0,
                           "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                           "flash_bwd_dq_f32": 0, "flash_bwd_dkv_f32": 0}
    assert fa.offset_launches == {"flash_fwd": 0, "flash_fwd_f32": 0}
    assert ops.plain_calls == {"flash_attention_fwd_ref": 1,
                               "flash_attention_bwd_ref": 0,
                               "flash_attention_decode_ref": 1,
                               "flash_attention_paged_decode_ref": 0,
                               "ssd_ref": 0}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_ssd_ablation_edits_apply():
    """ssd_ablation.py times the SSD kernel with parts of its source edited
    out; every edit must still match the source it edits."""
    import sys
    sys.path.insert(0, str(ROOT))
    import ssd_ablation

    text = (ROOT / "src/repro_torch/kernels/csrc/ssd_scan.cu").read_text()
    missing = [(name, old[:60])
               for name, edits in ssd_ablation.VARIANTS.items()
               for old, _ in edits if old not in text]
    assert not missing, missing


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "ssd_ablation.py"]
    assert len(files) > 10
    verify = {f.name for f in files if f.parent.name == "verify"}
    assert {"__init__.py", "__main__.py", "calibration.py", "cells.py",
            "compute_cell.py", "executor.py", "fuzz.py", "numerics.py",
            "pipeline_cell.py", "serve_cell.py", "serve_paged_cell.py",
            "train_cell.py", "trace_cell.py"} <= verify
    trace = {f.name for f in files if f.parent.name == "trace"}
    assert {"__init__.py", "__main__.py", "autoshard.py", "capture.py",
            "demo.py"} <= trace
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
