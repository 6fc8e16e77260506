"""The port's attention backward (src/repro_torch/kernels) against repro's
Pallas backward, and the differentiable op against repro's custom_vjp.

On the CPU the port runs its plain versions (kernels/ref.py); repro's
``flash_attention_bwd`` runs in Pallas interpret mode, as
tests/test_kernels.py runs it, on the same seeded numpy inputs (o and lse
from repro's forward).  Tolerance, f32: atol = rtol = 5e-4, the band
tests/test_kernels.py:68 holds the same backward to.

repro's dk/dv kernel reads the padded rows of lse and delta when S is not
a multiple of its q block, and in interpret mode those hold NaN, which
0 * NaN carries into every dk (ROADMAP C).  The ragged case therefore
holds dq and dv to repro at a ragged tiling and dk to repro at a block
that covers S.  The CUDA kernels are held to the plain versions on the
card by tests/test_torch_gpu.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")     # the card's machine has no JAX
jnp = jax.numpy

from repro.kernels import ops as jax_ops
from repro.kernels.flash_attention import (flash_attention_bwd,
                                           flash_attention_fwd)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

TOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread avoids oversubscribing the cores
    that the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, s, h, kv, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    do = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    return q, k, v, do


def _jax_bwd(q, k, v, do, causal, window, block):
    kw = dict(causal=causal, window=window, block_q=block, block_k=block,
              interpret=True)
    qj, kj, vj = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    o, lse = flash_attention_fwd(qj, kj, vj, **kw)
    grads = flash_attention_bwd(qj, kj, vj, o, lse, jnp.asarray(do), **kw)
    return np.asarray(o), np.asarray(lse), [np.asarray(g) for g in grads]


def _port_bwd(q, k, v, o, lse, do, causal, window):
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, do)]
    return [g.numpy() for g in ref.flash_attention_bwd_ref(
        *t, causal=causal, window=window)]


# (q heads, kv heads[, head dim, 16 if absent]), causal, window: g in
# {1, 2, 4}; zamba2's shared block (hd 80, g 1), causal and under a window;
# windows whose edge falls inside an 8-row block (5, 11)
BWD_GRID = [((4, 4), True, None), ((4, 2), True, 5), ((4, 1), False, None),
            ((4, 4), False, 5), ((2, 2, 80), True, None),
            ((2, 2, 80), True, 11), ((4, 2, 16), False, 11)]


@pytest.mark.parametrize("heads,causal,window", BWD_GRID)
def test_bwd_ref_matches_pallas(heads, causal, window):
    h, kv, hd = (*heads, 16)[:3]
    q, k, v, do = _inputs(11, 2, 16, h, kv, hd)
    o, lse, want = _jax_bwd(q, k, v, do, causal, window, block=8)
    got = _port_bwd(q, k, v, o, lse, do, causal, window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("causal,window", [(True, 4)])
def test_bwd_ref_matches_pallas_ragged(causal, window):
    """S = 13 against 8-row tiles: dq and dv at the ragged tiling; dk at a
    block covering S (repro's ragged dk is NaN in interpret mode)."""
    q, k, v, do = _inputs(12, 2, 13, 4, 2, 16)
    o, lse, ragged = _jax_bwd(q, k, v, do, causal, window, block=8)
    _, _, whole = _jax_bwd(q, k, v, do, causal, window, block=16)
    got = _port_bwd(q, k, v, o, lse, do, causal, window)
    np.testing.assert_allclose(got[0], ragged[0], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[2], ragged[2], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[1], whole[1], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("heads,causal,window", [((4, 2), True, None),
                                                 ((4, 1), False, 3),
                                                 ((4, 4), True, 5)])
def test_bwd_ref_matches_autograd(heads, causal, window):
    """The formulas of the Pallas backward equal autograd through the plain
    forward (f32, summation order only: 1e-5)."""
    h, kv = heads
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(3, 2, 11, h, kv, 16))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = ref.flash_attention_fwd_ref(*leaves, causal=causal,
                                         window=window)
    want = torch.autograd.grad(o, leaves, do)
    got = ref.flash_attention_bwd_ref(q, k, v, o.detach(), lse.detach(), do,
                                      causal=causal, window=window)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 4)])
def test_op_grads_match_repro_custom_vjp(causal, window):
    """grads of ops.flash_attention vs jax.grad of repro's
    ops.flash_attention (Pallas, interpret mode on the CPU)."""
    q, k, v, w = _inputs(5, 1, 16, 4, 2, 16)

    def jax_loss(q, k, v):
        o = jax_ops.flash_attention(q, k, v, causal, window, None)
        return jnp.sum(o * w)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    ops.reset_plain_calls()
    o = ops.flash_attention(*leaves, causal, window, None)
    got = torch.autograd.grad((o * torch.from_numpy(w)).sum(), leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=TOL)
    assert ops.plain_calls["flash_attention_fwd_ref"] == 1
    assert ops.plain_calls["flash_attention_bwd_ref"] == 1


def test_cpu_backward_takes_the_plain_path():
    fa.reset_launches()
    ops.reset_plain_calls()
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 1, 6, 4, 2, 16))
    o, lse = ops.flash_attention_fwd(q, k, v)
    ops.flash_attention_bwd(q, k, v, o, lse, do)
    assert not any(fa.launches.values())
    assert ops.plain_calls == {"flash_attention_fwd_ref": 1,
                               "flash_attention_bwd_ref": 1,
                               "flash_attention_decode_ref": 0,
                               "flash_attention_paged_decode_ref": 0,
                               "ssd_ref": 0}


def test_bwd_wrapper_takes_cuda_tensors_only():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(0, 1, 4, 4, 2, 16))
    lse = torch.zeros(1, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(q, k, v, q, lse, do)


def test_static_offset_builds_no_tensor(monkeypatch):
    """q_offset None or an int goes to the kernel by value: no tensor is
    made, so no host-to-device copy stalls the stream."""
    def refuse(*a, **kw):
        raise AssertionError("a tensor was built for a static offset")

    for name in ("tensor", "as_tensor", "full", "zeros", "empty", "ones"):
        monkeypatch.setattr(torch, name, refuse)
    dev = torch.device("cpu")
    assert fa.offset_arg(None, dev) == (None, 0)
    assert fa.offset_arg(0, dev) == (None, 0)
    assert fa.offset_arg(7, dev) == (None, 7)
    monkeypatch.undo()
    off = torch.tensor([5], dtype=torch.int32)
    t, val = fa.offset_arg(off, dev)
    assert t is not None and int(t) == 5 and val == 0
    with pytest.raises(ValueError, match="int32"):
        fa.offset_arg(off.long(), dev)
