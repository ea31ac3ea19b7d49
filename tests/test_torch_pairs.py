"""The pair-indexed flow warp (K4) and the flow warp's other TPU entry point
(K5) of the port against the JAX package on the CPU, on the same numpy
inputs: the plain versions against the JAX CPU path, against the Pallas
kernels in TPU interpret mode (|flow| < 16 px, inside their +-max_shift
window), the backward against the JAX VJPs, and gradcheck in float64."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from depthinspace_tpu.ops.pallas.warp2d_pairs import warp2d_pairs
from depthinspace_tpu.ops.pallas.warp_kernel import warp2d as jax_warp2d_v1
from depthinspace_tpu.ops.resample import flow_warp_pairs as jax_pairs
from depthinspace_tpu.ops.sampling import resize_flow as jax_resize_flow
from depthinspace_tpu_torch.ops import (flow_warp_pairs, resize_flow,
                                        warp2d_bwd_plain,
                                        warp2d_pairs_bwd_plain,
                                        warp2d_pairs_plain, warp2d_plain,
                                        warp2d_v1)

# all-pairs track layout (tl = 4, N = 1): target-major (i, j != i), every
# source three times
S, H, W, C = 4, 16, 12, 4
PAIRS = [(i, j) for i in range(S) for j in range(S) if j != i]
SRC = tuple(j for _, j in PAIRS)
M = len(PAIRS)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(11)
    return (rng.rand(S, H, W, C).astype(np.float32),
            rng.uniform(-5, 5, (M, H, W, 2)).astype(np.float32),
            rng.rand(M, H, W, C).astype(np.float32))


# interpret mode runs the Pallas grid step by step: a smaller track (tl = 3,
# every source in two pairs), one band of 8 rows and two channels keep it
# short
S3, H8 = 3, 8
SRC3 = tuple(j for i in range(S3) for j in range(S3) if j != i)


@pytest.fixture(scope="module")
def small():
    rng = np.random.RandomState(12)
    m = len(SRC3)
    return (rng.rand(S3, H8, W, 2).astype(np.float32),
            rng.uniform(-5, 5, (m, H8, W, 2)).astype(np.float32),
            rng.rand(m, H8, W, 2).astype(np.float32))


def test_pairs_plain_matches_jax_cpu_path(data):
    """warp2d_pairs_plain and flow_warp_pairs on CPU tensors against JAX's
    off-TPU flow_warp_pairs (stack + ops/sampling.warp): within 1e-6, and
    the JAX VJP against warp2d_pairs_bwd_plain within 1e-6."""
    feat, flow, g = data
    ref, vjp = jax.vjp(lambda x: jax_pairs(x, jnp.asarray(flow), SRC),
                       jnp.asarray(feat))
    tf, tfl, tg = map(torch.from_numpy, (feat, flow, g))
    np.testing.assert_allclose(warp2d_pairs_plain(tf, tfl, SRC).numpy(),
                               np.asarray(ref), rtol=0, atol=1e-6)
    x = tf.clone().requires_grad_()
    out = flow_warp_pairs(x, tfl, SRC)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-6)
    out.backward(tg)
    g_ref = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(x.grad.numpy(), g_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        warp2d_pairs_bwd_plain(tfl, SRC, tg, S).numpy(), g_ref, rtol=0,
        atol=1e-6)


def test_pairs_plain_matches_the_pallas_kernel_in_interpret_mode(small):
    """Against warp2d_pairs (_pairs_fwd, _pairs_bwd) run in TPU interpret
    mode: float32 within 1e-5 (the kernel sums its taps in another order),
    the feat gradient within 1e-5; bfloat16 (both accumulate in float32 and
    round once) within one bf16 ulp, 2^-7 relative."""
    feat, flow, g = small
    with pltpu.force_tpu_interpret_mode():
        fn = jax.jit(lambda x, f: warp2d_pairs(x, f, SRC3, 16))
        ref = np.asarray(fn(jnp.asarray(feat), jnp.asarray(flow)))
        _, vjp = jax.vjp(lambda x: warp2d_pairs(x, jnp.asarray(flow), SRC3,
                                                16), jnp.asarray(feat))
        g_ref = np.asarray(vjp(jnp.asarray(g))[0])
        ref16 = np.asarray(fn(jnp.asarray(feat, jnp.bfloat16),
                              jnp.asarray(flow)).astype(jnp.float32))
    tf, tfl, tg = map(torch.from_numpy, (feat, flow, g))
    np.testing.assert_allclose(warp2d_pairs_plain(tf, tfl, SRC3).numpy(),
                               ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(warp2d_pairs_bwd_plain(tfl, SRC3, tg, S3)
                               .numpy(), g_ref, rtol=0, atol=1e-5)
    out16 = warp2d_pairs_plain(tf.to(torch.bfloat16), tfl, SRC3)
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(out16.float().numpy(), ref16, rtol=2 ** -7,
                               atol=1e-6)


def test_pairs_bwd_plain_in_bfloat16_rounds_the_float32_sum():
    """The bf16 backward is the float32 per-source sum, rounded once."""
    rng = np.random.RandomState(3)
    flow = torch.from_numpy(rng.uniform(-3, 3, (M, H, W, 2)).astype(
        np.float32))
    g = torch.from_numpy(rng.randn(M, H, W, C).astype(np.float32))
    g16 = g.to(torch.bfloat16)
    ref = warp2d_pairs_bwd_plain(flow, SRC, g16.float(), S)
    out = warp2d_pairs_bwd_plain(flow, SRC, g16, S)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ref.to(torch.bfloat16))


def test_pairs_gradcheck_float64():
    """torch.autograd.gradcheck of flow_warp_pairs (CPU: the plain forward
    and backward) in float64, a table that repeats and skips planes."""
    rng = np.random.RandomState(5)
    feat = torch.from_numpy(rng.rand(3, 6, 5, 2)).requires_grad_()
    flow = torch.from_numpy(rng.uniform(-3, 3, (4, 6, 5, 2)))
    assert torch.autograd.gradcheck(
        lambda x: flow_warp_pairs(x, flow, (2, 0, 2, 2)), (feat,))


def test_warp2d_v1_plain_matches_the_pallas_kernel_in_interpret_mode(small):
    """K5 (warp_kernel.warp2d, the DIS_WARP_V1 route) in TPU interpret mode
    at |flow| < 16 px against warp2d_v1 on CPU tensors (K3's plain versions):
    forward and VJP within 1e-5 (the kernel sums its taps in another
    order)."""
    _, flow, g = small
    flow, g = flow[:1], g[:1]
    img = np.random.RandomState(9).rand(*g.shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(lambda x: jax_warp2d_v1(x, jnp.asarray(flow), 16),
                           jnp.asarray(img))
        ref = np.asarray(ref)
        g_ref = np.asarray(vjp(jnp.asarray(g))[0])
    ti, tfl, tg = map(torch.from_numpy, (img, flow, g))
    x = ti.clone().requires_grad_()
    out = warp2d_v1(x, tfl)
    out.backward(tg)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), g_ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(warp2d_plain(ti, tfl).numpy(), ref, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(warp2d_bwd_plain(tfl, tg).numpy(), g_ref,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [(32, 28), (16, 14), (7, 9)])
def test_resize_flow_matches_jax(size):
    """resize_flow (bilinear, align_corners, values rescaled): bit-exact to
    the JAX version, whose interpolation-matrix products have two nonzero
    terms per row."""
    rng = np.random.RandomState(7)
    flow = rng.uniform(-20, 20, (3, 64, 56, 2)).astype(np.float32)
    ref = np.asarray(jax_resize_flow(jnp.asarray(flow), *size))
    out = resize_flow(torch.from_numpy(flow), *size).numpy()
    np.testing.assert_array_equal(out, ref)
