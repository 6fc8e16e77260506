"""The port's SSD scan (src/repro_torch: kernels/ref.ssd_ref, the chunked
kernels/ssd.ssd_scan, the ops.ssd_chunk_scan dispatch and its autograd
Function, models/mamba) against repro's on the CPU, on the same numpy
inputs.

Bands, each with its reason:
  ssd_ref vs repro's Pallas kernel (interpret mode), and the chunked scans
      of the two packages: atol = rtol = 2e-5, repro's own band
      (tests/test_kernels.py TestSSDKernel): f32 sums in another order;
  the differentiable dispatch against repro's _ssd_dispatch("pallas"):
      5e-5 on values and grads, repro's TestSSDVjp band;
  one Mamba layer in f32: atol = rtol = 1e-5, the same f32 arithmetic up
      to summation order;
  ref.ssd_chunk_scan_split_ref (the CUDA scan's passes, every product on
      operands split into bf16 hi + lo as the kernel splits them) against
      repro's Pallas kernel and against ssd_ref: |err| <= 2e-4 x max(1,
      max|y|), the band the card holds the kernel to (SSD_TOL in
      chip_smoke.py and tests/test_torch_gpu.py), because the emulated
      rounding is the kernel's.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")     # the card's machine has no JAX
jnp = jax.numpy

from repro.configs import get_arch as jax_arch
from repro.kernels.ssd import ssd_chunk_scan as jax_ssd_chunk_scan
from repro.models import mamba as jax_mamba
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref, ssd
from repro_torch.models import mamba

SSD_SHAPES = [(1, 64, 2, 8, 16, 16), (2, 128, 3, 8, 16, 32),
              (1, 128, 1, 16, 8, 64), (2, 64, 4, 4, 4, 64)]
SSD_VJP_SHAPES = [(1, 64, 2, 8, 16, 32), (2, 96, 1, 8, 8, 64)]
SSD_TOL = 2e-4
# (b, s, h, p, n, chunk, a): SSD_SHAPES, a long-memory head (a = 0.01:
# the carried states weigh in y), 8 chunks carried, P = N = 8 at chunk 8
SPLIT_SHAPES = ([shape + (1.0,) for shape in SSD_SHAPES]
                + [(2, 128, 3, 8, 16, 32, 0.01), (1, 256, 2, 8, 8, 32, 0.01),
                   (2, 64, 3, 8, 8, 8, 0.01)])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread avoids oversubscribing the cores
    that the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, s, h, p, n, seed=0, a=1.0):
    """repro's test distribution: x 0.5-normal, a_log = -a
    softplus(normal), B and C 0.3-normal; f32 numpy."""
    rng = np.random.default_rng(seed)
    xh = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    al = (-a * np.logaddexp(rng.standard_normal((b, s, h)), 0)
          ).astype(np.float32)
    bb = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    cc = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    return xh, al, bb, cc


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_ref_matches_pallas(b, s, h, p, n, chunk):
    ins = _inputs(b, s, h, p, n, seed=s + h)
    want = jax_ssd_chunk_scan(*map(jnp.asarray, ins), chunk=chunk,
                              interpret=True)
    got, _ = ref.ssd_ref(*map(torch.from_numpy, ins))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("b,s,h,p,n,chunk",
                         SSD_SHAPES + [(2, 96, 1, 8, 8, 64)])
def test_chunked_scan_matches_repro(b, s, h, p, n, chunk):
    ins = _inputs(b, s, h, p, n, seed=7 * s + h)
    yj, sj = jax.jit(jax_mamba.ssd_scan, static_argnums=4)(
        *map(jnp.asarray, ins), chunk)
    yt, st = ssd.ssd_scan(*map(torch.from_numpy, ins), chunk)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-5,
                               rtol=2e-5)


def test_long_memory_head_scans_match_repro():
    """a = 0.01 (a head with A = 0.01): cum stays ~ -0.3 over a chunk of
    32, so the state carried across chunks and every in-chunk term weigh
    in y.  ssd_ref against repro's Pallas kernel, and the chunked scans of
    the two packages, y and final state, in the bands above."""
    ins = _inputs(2, 128, 3, 8, 16, seed=11, a=0.01)
    jins = tuple(map(jnp.asarray, ins))
    tins = tuple(map(torch.from_numpy, ins))
    want = jax_ssd_chunk_scan(*jins, chunk=32, interpret=True)
    got, _ = ref.ssd_ref(*tins)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    yj, sj = jax.jit(jax_mamba.ssd_scan, static_argnums=4)(*jins, 32)
    yt, st = ssd.ssd_scan(*tins, 32)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("b,s,h,p,n,chunk,a", SPLIT_SHAPES)
def test_split_ref_matches_pallas_and_recurrence(b, s, h, p, n, chunk, a):
    """The CUDA scan's arithmetic (chunk-local states, the carry as
    products of per-chunk clipped decays, C.B^T shared by the heads, hi +
    lo operands) against repro's Pallas kernel in interpret mode and the
    sequential recurrence."""
    ins = _inputs(b, s, h, p, n, seed=3 * s + h, a=a)
    want = np.asarray(jax_ssd_chunk_scan(*map(jnp.asarray, ins), chunk=chunk,
                                         interpret=True))
    tins = tuple(map(torch.from_numpy, ins))
    got = ref.ssd_chunk_scan_split_ref(*tins, chunk).numpy()
    seq = ref.ssd_ref(*tins)[0].numpy()
    for other in (want, seq):
        band = SSD_TOL * max(1.0, float(np.abs(other).max()))
        assert float(np.abs(got - other).max()) <= band


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_VJP_SHAPES)
def test_kernel_route_values_and_grads_match_repro(b, s, h, p, n, chunk):
    """The "kernel" route (on the CPU: the plain forward, the chunked
    scan's backward) against repro's Pallas route with its XLA-scan VJP,
    including the pad of S = 96 to a multiple of 64."""
    ins = _inputs(b, s, h, p, n, seed=15)

    def jloss(*t):
        return jnp.sum(jax_mamba._ssd_dispatch(*t, chunk, "pallas") * 0.01)

    jins = tuple(map(jnp.asarray, ins))
    yj = jax.jit(lambda *t: jax_mamba._ssd_dispatch(*t, chunk, "pallas"))(
        *jins)
    gj = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(*jins)
    ops.reset_plain_calls()
    tins = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    yt = mamba.ssd_dispatch(*tins, chunk, "kernel")
    gt = torch.autograd.grad((yt * 0.01).sum(), tins)
    assert ops.plain_calls["ssd_ref"] == 1
    assert ops.bwd_recomputes["ssd_chunk_scan"] == 1
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               atol=5e-5, rtol=5e-5)
    for a, w, name in zip(gt, gj, ("xh", "a_log", "bb", "cc")):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=5e-5,
                                   rtol=5e-5, err_msg=f"d{name}")


def test_dispatch_routes_and_checks():
    ins = [torch.from_numpy(a) for a in _inputs(1, 24, 2, 4, 4)]
    ops.reset_plain_calls()
    y = mamba.ssd_dispatch(*ins, 16, "auto")      # CPU: the chunked scan
    assert ops.plain_calls["ssd_ref"] == 0
    torch.testing.assert_close(y, ssd.ssd_scan(*ins, 16)[0])
    with pytest.raises(ValueError, match="ssd impl"):
        mamba.ssd_dispatch(*ins, 16, "pallas")
    with pytest.raises(ValueError, match="multiple"):
        ops.ssd_chunk_scan(*ins, chunk=16)        # 24 % 16: pad first
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_chunk_scan(*ins, chunk=8)         # the wrapper: cards only


def test_mamba_layer_matches_repro():
    """One Mamba layer of the reduced zamba2 in f32, its init constants
    perturbed so that A_log, dt_bias, D, norm and the conv taps all
    matter.  The port's kernel route (the plain scan on the CPU) against
    repro's XLA route: the layer around the scan is what is held here,
    the two scans are held to each other above."""
    cfg = dataclasses.replace(get_arch("zamba2-2.7b").reduced(),
                              dtype="float32")
    jcfg = dataclasses.replace(jax_arch("zamba2-2.7b").reduced(),
                               dtype="float32")
    rng = np.random.default_rng(3)
    layer = {}
    for k, (shape, _) in mamba.mamba_shapes(cfg, torch.float32).items():
        scale = 0.3 if k in ("A_log", "dt_bias") else 1.0
        base = 1.0 if k in ("D", "norm") else 0.0
        w = base + scale * rng.standard_normal(shape)
        if k.startswith("w_"):
            w = w / np.sqrt(shape[0])
        layer[k] = w.astype(np.float32)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x_: jax_mamba.mamba_forward(p, x_, jcfg))(
        {k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(x))
    got = mamba.mamba_forward({k: torch.from_numpy(v)
                               for k, v in layer.items()},
                              torch.from_numpy(x), cfg, impl="kernel")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
