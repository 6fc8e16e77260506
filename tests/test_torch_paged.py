"""The port's paged-tier pieces below the server: the host allocator
(src/repro_torch/runtime/paged.py) against repro's, and the paged decode
attention's plain version (kernels/ref.py) against repro's Pallas kernel
and its XLA gather path.

Tolerances: the plain version and repro compute the same f32 attention
and differ only in summation order; 2e-5 (atol and rtol) is the band of
repro's tests/test_kernels.py::TestPagedDecodeKernel for the same
kernel.  The CUDA kernel is held to the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")     # the card's machine has no JAX
jnp = jax.numpy

from repro.kernels import ops as jax_ops
from repro.models.attention import attend_paged as jax_attend_paged
from repro.runtime import paged as jax_paged
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import attend_paged
from repro_torch.runtime import paged

TOL = 2e-5


# -- the allocator and the trie ---------------------------------------------

def _trie_state(trie):
    """Every node as (path of token tuples, block, last_use), sorted."""
    out = []

    def walk(level, path):
        for key, node in level.items():
            out.append((path + (key,), node.block, node.last_use))
            walk(node.children, path + (key,))
    walk(trie.root, ())
    return sorted(out)


def _state(pool, trie):
    return (list(pool.ref), list(pool._free), pool.n_free, trie.n_nodes,
            _trie_state(trie))


@pytest.mark.parametrize("seed", range(4))
def test_allocator_and_trie_match_repro_step_for_step(seed):
    """One seeded random sequence of alloc / incref / decref / match /
    insert / insert_partial / evict through repro's BlockPool and
    PrefixTrie and through the port's copies: every result, refcount,
    free list and trie node equal after every step."""
    rng = np.random.default_rng(seed)
    bl, nb = 4, 24
    sides = []
    for mod in (jax_paged, paged):
        pool = mod.BlockPool(nb)
        sides.append((mod, pool, mod.PrefixTrie(pool, bl)))
    held = []                    # blocks the "slots" hold a reference to
    # a small alphabet so that prompts share prefixes and partial blocks
    vocab = 3

    def toks(n):
        return rng.integers(0, vocab, size=n).tolist()

    for step in range(300):
        op = rng.choice(["alloc", "incref", "decref", "match", "insert",
                         "insert_partial", "evict"])
        args = {"alloc": (), "incref": (), "decref": (),
                "match": (toks(int(rng.integers(1, 14))),),
                "evict": (int(rng.integers(1, 6)),)}.get(op)
        if op in ("incref", "decref"):
            if not held:
                continue
            args = (held[int(rng.integers(len(held)))],)
        if op in ("insert", "insert_partial"):
            if not held:
                continue
            n = int(rng.integers(1, 4))
            seq = toks(n * bl + (int(rng.integers(1, bl))
                                 if op == "insert_partial" else 0))
            blocks = [held[int(rng.integers(len(held)))] for _ in range(n)]
            args = (seq, blocks) if op == "insert" else (seq, blocks[0])
        results = []
        for mod, pool, trie in sides:
            target = pool if op in ("alloc", "incref", "decref") else trie
            try:
                results.append(("ok", getattr(target, op)(*args)))
            except mod.NoFreeBlocks:
                results.append(("NoFreeBlocks", None))
        assert results[0] == results[1], (step, op)
        assert _state(*sides[0][1:]) == _state(*sides[1][1:]), (step, op)
        kind, val = results[0]
        if op == "alloc" and kind == "ok":
            held.append(val)
        elif op == "incref":
            held.append(val)
        elif op == "decref":
            held.remove(args[0])
        elif op == "match":
            full, part = val
            held += full + ([part[0]] if part else [])
    sides[1][2].clear()
    sides[0][2].clear()
    assert _state(*sides[0][1:]) == _state(*sides[1][1:])


def test_block_zero_is_never_handed_out():
    pool = paged.BlockPool(4)
    assert {pool.alloc() for _ in range(3)} == {1, 2, 3}
    with pytest.raises(paged.NoFreeBlocks):
        pool.alloc()


# -- paged decode attention ---------------------------------------------------

def _paged_inputs(seed, b, h, kv, hd, bl, mb, lengths):
    """q, pools and a table where each row owns a random disjoint slice of
    the pool; table entries past a row's blocks point at block 0."""
    rng = np.random.default_rng(seed)
    nb = mb * b + 1
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    # the serving pool is bf16: hand both sides the same bf16 values
    k_pool = torch.from_numpy(rng.standard_normal(
        (nb, bl, kv, hd)).astype(np.float32)).to(torch.bfloat16)
    v_pool = torch.from_numpy(rng.standard_normal(
        (nb, bl, kv, hd)).astype(np.float32)).to(torch.bfloat16)
    perm = rng.permutation(nb - 1) + 1
    table = np.zeros((b, mb), np.int32)
    for s in range(b):
        n_owned = -(-int(lengths[s]) // bl)
        table[s, :n_owned] = perm[s * mb:s * mb + n_owned]
    return q, k_pool, v_pool, table, np.asarray(lengths, np.int32)


def _jax(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("h,kv,bl,mb", [(4, 2, 16, 4), (4, 4, 8, 6),
                                        (2, 1, 32, 2)])
def test_paged_ref_matches_pallas_and_xla_gather(h, kv, bl, mb):
    b, hd = 4, 32
    lengths = [1, bl, bl + 3, mb * bl]
    q, kp, vp, table, ln = _paged_inputs(21, b, h, kv, hd, bl, mb, lengths)
    o_t = ref.flash_attention_paged_decode_ref(
        torch.from_numpy(q), kp, vp, torch.from_numpy(table),
        torch.from_numpy(ln))
    args = (jnp.asarray(q), _jax(kp), _jax(vp), jnp.asarray(table),
            jnp.asarray(ln))
    o_p = jax_ops.flash_attention_paged_decode(*args)
    o_x = jax_attend_paged(*args, impl="xla")
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_p), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_x), atol=TOL,
                               rtol=TOL)


def test_paged_ref_equals_decode_ref_on_the_gathered_view():
    """Bit-equal to the linear decode on the view the table spells: the
    property that makes the paged engine's streams those of the linear
    one."""
    b, h, kv, hd, bl, mb = 3, 6, 2, 16, 8, 5
    q, kp, vp, table, ln = _paged_inputs(3, b, h, kv, hd, bl, mb,
                                         [5, 17, mb * bl])
    qt, tt, lt = (torch.from_numpy(a) for a in (q, table, ln))
    got = ref.flash_attention_paged_decode_ref(qt, kp, vp, tt, lt)
    view_k = kp[tt.long()].reshape(b, mb * bl, kv, hd)
    view_v = vp[tt.long()].reshape(b, mb * bl, kv, hd)
    want = ref.flash_attention_decode_ref(qt, view_k, view_v, lt)
    assert torch.equal(got, want)


@pytest.mark.parametrize("poison", [1e9, float("nan")])
def test_null_block_garbage_cannot_leak(poison):
    """Entries past a row's length route to block 0; poisoning it and
    every other unowned block (with huge values, and with NaN, which the
    reference's gather would carry into its P.V) must not move the
    output (repro's test_null_block_garbage_cannot_leak)."""
    b, h, kv, hd, bl, mb, nb = 2, 4, 2, 32, 8, 4, 9
    rng = np.random.default_rng(22)
    q = torch.from_numpy(rng.standard_normal((b, h, hd)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (nb, bl, kv, hd)).astype(np.float32)).to(torch.bfloat16)
        for _ in range(2))
    table = torch.tensor([[1, 2, 0, 0], [3, 0, 0, 0]], dtype=torch.int32)
    lengths = torch.tensor([11, 8], dtype=torch.int32)
    clean = ops.flash_attention_paged_decode(q, kp, vp, table, lengths)
    dirty_k, dirty_v = kp.clone(), vp.clone()
    owned = {1, 2, 3}
    for blk in range(nb):
        if blk not in owned:
            dirty_k[blk] = poison
            dirty_v[blk] = poison
    # the partly live block 2 (positions 8-10 of row 0) is poisoned past
    # its live rows too
    dirty_k[2, 3:] = poison
    dirty_v[2, 3:] = poison
    dirty = ops.flash_attention_paged_decode(q, dirty_k, dirty_v, table,
                                             lengths)
    assert torch.equal(dirty, clean)
    if poison == poison:          # repro's gather multiplies NaN by 0
        want = jax_attend_paged(jnp.asarray(q.numpy()), _jax(dirty_k),
                                _jax(dirty_v), jnp.asarray(table.numpy()),
                                jnp.asarray(lengths.numpy()), impl="xla")
        np.testing.assert_allclose(dirty.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)


def test_paged_cpu_tensors_take_the_plain_path():
    fa.reset_launches()
    ops.reset_plain_calls()
    q, kp, vp, table, ln = _paged_inputs(5, 2, 4, 2, 16, 8, 3, [4, 20])
    attend_paged(torch.from_numpy(q), kp, vp, torch.from_numpy(table),
                 torch.from_numpy(ln))
    assert not any(fa.launches.values())
    assert ops.plain_calls["flash_attention_paged_decode_ref"] == 1


def test_paged_wrapper_takes_cuda_tensors_only():
    q, kp, vp, table, ln = _paged_inputs(5, 2, 4, 2, 16, 8, 3, [4, 20])
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_paged_decode(
            torch.from_numpy(q).bfloat16(), kp, vp, torch.from_numpy(table),
            torch.from_numpy(ln))


def test_attend_paged_rejects_other_impls():
    q, kp, vp, table, ln = _paged_inputs(5, 2, 4, 2, 16, 8, 3, [4, 20])
    with pytest.raises(ValueError, match="impl"):
        attend_paged(torch.from_numpy(q), kp, vp, torch.from_numpy(table),
                     torch.from_numpy(ln), impl="xla")
