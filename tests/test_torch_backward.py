"""The backward passes of K1 (census-SAD), K2 (pattern warp) and K3 (flow
warp): the port's plain versions, reached through its autograd Functions on
the CPU, against the JAX CPU VJPs and against the Pallas backward kernels
in interpret mode, on the same numpy inputs; finite differences in float64;
and the dispatch rules. The CUDA kernels are tested in
test_torch_kernels.py."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from depthinspace_tpu.losses.photometric import _xwarp_border
from depthinspace_tpu.ops.census import census_sad as jax_census_sad
from depthinspace_tpu.ops.sampling import warp as jax_warp
from depthinspace_tpu_torch.ops import kernels
from depthinspace_tpu_torch.ops.census import (census_sad,
                                               census_sad_bwd_plain)
from depthinspace_tpu_torch.ops.resample import (flow_warp, warp2d_bwd_plain,
                                                 warp_pattern,
                                                 xwarp_bwd_plain)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test processes on the machine's cores at once;
    two intra-op threads per process keep torch from oversubscribing them
    (with all cores each, this file's steps ran ~10x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _randn(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _torch_grad(fn, x, g):
    x = torch.from_numpy(x).requires_grad_()
    fn(x).backward(torch.from_numpy(g))
    return x.grad.numpy()


@pytest.mark.parametrize("shape", [(2, 16, 20), (1, 5, 3), (1, 1, 7)])
def test_census_bwd_plain_matches_jax_vjp(shape):
    """Gradient to es within 1e-6 (the same scan, summed in another
    order); ta gets none (JAX: zeros)."""
    es, ta, g = _randn(shape, 0), _randn(shape, 1), _randn(shape, 2)
    _, vjp = jax.vjp(lambda e, t: jax_census_sad(e, t, 9, 0.5),
                     jnp.asarray(es), jnp.asarray(ta))
    ref_es, ref_ta = map(np.asarray, vjp(jnp.asarray(g)))
    t_ta = torch.from_numpy(ta).requires_grad_()
    out = _torch_grad(lambda e: census_sad(e, t_ta), es, g)
    np.testing.assert_allclose(out, ref_es, rtol=0, atol=1e-6)
    assert t_ta.grad is None and not ref_ta.any()


def _disp_with_edges(N, H, W, seed, lo, hi):
    d = np.random.RandomState(seed).uniform(lo, hi, (N, H, W)).astype(
        np.float32)
    # x = u - disp hits 0, 1, W-1 and fractions at u = 0..W-1
    d[0, 0, :] = np.arange(W, dtype=np.float32)                  # x = 0
    d[0, 1, :] = np.arange(W, dtype=np.float32) - 1.0            # x = 1
    d[0, 2, :] = np.arange(W, dtype=np.float32) - (W - 1.0)      # x = W-1
    d[0, 3, :] = np.arange(W, dtype=np.float32) - 2.5            # x = 2.5
    return d


def test_xwarp_bwd_plain_matches_jax_vjp():
    """Exact, including the strict inside mask at x = 0 and x = W-1 (where
    autograd of the clamp would pass a gradient)."""
    N, H, W = 3, 10, 24
    pat = _randn((H, W), 3)
    disp = _disp_with_edges(N, H, W, 4, -3.0, W + 3.0)
    g = _randn((N, H, W), 5)
    pat_n = jnp.broadcast_to(jnp.asarray(pat), (N, H, W))
    _, vjp = jax.vjp(lambda d: _xwarp_border(pat_n, d), jnp.asarray(disp))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    out = _torch_grad(lambda d: warp_pattern(torch.from_numpy(pat), d),
                      disp, g)
    np.testing.assert_array_equal(out, ref)
    assert not out[0, 0].any() and not out[0, 2].any()
    np.testing.assert_array_equal(
        xwarp_bwd_plain(torch.from_numpy(pat), torch.from_numpy(disp),
                        torch.from_numpy(g)).numpy(), ref)


@pytest.mark.parametrize("C,max_flow", [(1, 40.0), (3, 6.0)])
def test_warp2d_bwd_plain_matches_jax_vjp(C, max_flow):
    """Gradient to the image within 1e-6 of JAX's autodiff of
    ops/sampling.warp (the same scatter-add); the flow gets none."""
    rng = np.random.RandomState(6)
    img = rng.rand(2, 14, 18, C).astype(np.float32)
    flow = rng.uniform(-max_flow, max_flow, (2, 14, 18, 2)).astype(np.float32)
    flow[0, 0, :4] = [[0.0, 0.0], [-1.0, 0.0], [17.0, 0.0], [0.5, -0.5]]
    g = _randn(img.shape, 7)
    _, vjp = jax.vjp(lambda i: jax_warp(i, jnp.asarray(flow),
                                        padding="zeros"), jnp.asarray(img))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    t_flow = torch.from_numpy(flow).requires_grad_()
    out = _torch_grad(lambda i: flow_warp(i, t_flow), img, g)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert t_flow.grad is None


def test_census_bwd_plain_matches_pallas_interpret():
    from depthinspace_tpu.ops.pallas.census_kernel import census_sad_pallas
    shape = (2, 16, 12)
    es, ta, g = _randn(shape, 8), _randn(shape, 9), _randn(shape, 10)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda e: census_sad_pallas(e, jnp.asarray(ta),
                                                     9, 0.5), jnp.asarray(es))
        ref = np.asarray(vjp(jnp.asarray(g))[0])
    out = census_sad_bwd_plain(*map(torch.from_numpy, (es, ta, g))).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_xwarp_bwd_plain_matches_pallas_interpret():
    """The Pallas kernel clips its shift index to [0, max_disp], so the
    disparities stay inside that range here."""
    from depthinspace_tpu.ops.pallas.warp_kernel import xwarp_disparity
    N, H, W = 2, 8, 24
    pat = _randn((H, W), 11)
    disp = _disp_with_edges(N, H, W, 12, 0.0, 16.0)
    disp = np.clip(disp, 0.0, 16.0)
    g = _randn((N, H, W), 13)
    pat_n = jnp.broadcast_to(jnp.asarray(pat), (N, H, W))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda d: xwarp_disparity(pat_n, d, 16),
                         jnp.asarray(disp))
        ref = np.asarray(vjp(jnp.asarray(g))[0])
    out = xwarp_bwd_plain(*map(torch.from_numpy, (pat, disp, g))).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_warp2d_bwd_plain_matches_pallas_interpret():
    from depthinspace_tpu.ops.pallas.warp2d_v2 import warp2d_v2
    rng = np.random.RandomState(14)
    img = rng.rand(2, 16, 12, 1).astype(np.float32)
    flow = rng.uniform(-5.0, 5.0, (2, 16, 12, 2)).astype(np.float32)
    g = _randn(img.shape, 15)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda i: warp2d_v2(i, jnp.asarray(flow), 16),
                         jnp.asarray(img))
        ref = np.asarray(vjp(jnp.asarray(g))[0])
    out = warp2d_bwd_plain(torch.from_numpy(flow), torch.from_numpy(g))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_functions_pass_gradcheck_in_float64():
    """torch.autograd.gradcheck (finite differences in float64) through the
    three Functions on the CPU, away from the kinks of sign and clamp."""
    rng = np.random.RandomState(16)
    es = torch.from_numpy(rng.randn(1, 7, 6)).requires_grad_()
    ta = torch.from_numpy(rng.randn(1, 7, 6))
    assert torch.autograd.gradcheck(lambda e: census_sad(e, ta), (es,),
                                    eps=1e-6, atol=1e-5)
    pat = torch.from_numpy(rng.randn(5, 9))
    disp = torch.from_numpy(rng.uniform(0.2, 7.8, (2, 5, 9)) + 0.01)
    disp.requires_grad_()
    assert torch.autograd.gradcheck(lambda d: warp_pattern(pat, d), (disp,),
                                    eps=1e-6, atol=1e-5)
    img = torch.from_numpy(rng.rand(2, 5, 6, 2)).requires_grad_()
    flow = torch.from_numpy(rng.uniform(-3.0, 3.0, (2, 5, 6, 2)))
    assert torch.autograd.gradcheck(lambda x: flow_warp(x, flow), (img,),
                                    eps=1e-6, atol=1e-5)


def test_backward_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the Functions run the plain versions; the kernel
    wrappers themselves take CUDA tensors only (no fallback)."""
    x = torch.zeros(1, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.census_sad_bwd(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.xwarp_bwd(x[0], x, x)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.warp2d_bwd(torch.zeros(1, 8, 8, 2), torch.zeros(1, 8, 8, 1))
    assert all(v == 0 for k, v in kernels.launches.items())
