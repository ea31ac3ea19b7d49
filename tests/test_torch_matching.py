"""The port's matching utilities (ops/matching.py) against
depthinspace_tpu/ops/matching.py on the same numpy inputs; neither carries
a gradient."""
import numpy as np

import jax.numpy as jnp
import torch

from depthinspace_tpu.ops import matching as jax_matching
from depthinspace_tpu_torch.ops import matching

N, H, W = 2, 16, 20


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_nn_search_matches_jax():
    """The same indices (random points: no near ties at this seed)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((N, 50, 3)).astype(np.float32)
    b = rng.standard_normal((N, 70, 3)).astype(np.float32)
    got = matching.nn_search(_t(a), _t(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jax_matching.nn_search(
        jnp.asarray(a), jnp.asarray(b))))


def test_crosscheck_matches_jax():
    rng = np.random.default_rng(1)
    d0 = rng.uniform(0, 8, (N, H, W)).astype(np.float32)
    d1 = (d0 + rng.standard_normal((N, H, W)) * 1.5).astype(np.float32)
    for th in (0.5, 1.0):
        got = matching.crosscheck(_t(d0), _t(d1), th).numpy()
        want = np.asarray(jax_matching.crosscheck(jnp.asarray(d0),
                                                  jnp.asarray(d1), th))
        assert np.array_equal(got, want) and 0 < got.mean() < 1


def test_proj_nn_matches_jax():
    """Equal, with non-finite points in xyz1 (skipped) and none in a
    pixel's whole patch (0)."""
    rng = np.random.default_rng(2)
    x0 = rng.standard_normal((N, H, W, 3)).astype(np.float32)
    x1 = rng.standard_normal((N, H, W, 3)).astype(np.float32)
    x1[0, 3:8, 4:9] = np.inf
    K = np.eye(3, dtype=np.float32)
    got = matching.proj_nn(_t(x0), _t(x1), _t(K)).numpy()
    want = np.asarray(jax_matching.proj_nn(jnp.asarray(x0), jnp.asarray(x1),
                                           jnp.asarray(K)))
    assert np.array_equal(got, want) and (got[0, 5, 6] == 0).all()


def test_xcorrvol_matches_jax():
    """Within 2e-4 (box sums in another order, divided by the local
    standard deviations); the zero shift of an image with itself is 1."""
    rng = np.random.default_rng(3)
    a = rng.random((N, H, W), dtype=np.float32)
    b = np.roll(a, -3, axis=-1) + rng.random((N, H, W),
                                             dtype=np.float32) * 0.1
    got = matching.xcorrvol(_t(a), _t(b), n_disps=8, block_size=5).numpy()
    want = np.asarray(jax_matching.xcorrvol(jnp.asarray(a), jnp.asarray(b),
                                            n_disps=8, block_size=5))
    assert got.shape == (N, H, W, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    same = matching.xcorrvol(_t(a), _t(a), n_disps=2, block_size=5)
    np.testing.assert_allclose(same[..., 0].numpy(), 1.0, atol=1e-4)


def test_no_gradient():
    x = torch.rand(1, 4, 5, requires_grad=True)
    assert not matching.xcorrvol(x, x, n_disps=2, block_size=3).requires_grad
    assert not matching.crosscheck(x, x).requires_grad
