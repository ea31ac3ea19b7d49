"""Census-SAD (K1): the port's plain version against the JAX scan path and
the JAX oracle on the CPU (atol 1e-5), and the dispatch rules of the
wrapper. The CUDA kernel itself is tested in test_torch_kernels.py."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from depthinspace_tpu.ops.census import census_sad as jax_census_sad
from depthinspace_tpu.ops.census import census_sad_oracle
from depthinspace_tpu_torch.ops import kernels
from depthinspace_tpu_torch.ops.census import census_sad, census_sad_plain


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 16, 20), (1, 11, 9)])
def test_census_plain_matches_jax(shape):
    es, ta = _inputs(shape, 0)
    out = census_sad_plain(torch.from_numpy(es), torch.from_numpy(ta)).numpy()
    scan = np.asarray(jax_census_sad(jnp.asarray(es), jnp.asarray(ta), 9, 0.5))
    oracle = np.asarray(census_sad_oracle(jnp.asarray(es), jnp.asarray(ta),
                                          9, 0.5))
    np.testing.assert_allclose(out, scan, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out, oracle, rtol=0, atol=1e-5)


def test_census_dispatch_cpu_is_plain():
    es, ta = map(torch.from_numpy, _inputs((2, 12, 14), 1))
    assert torch.equal(census_sad(es, ta), census_sad_plain(es, ta))


def test_census_kernel_wrapper_refuses_cpu_and_grad():
    """The kernel wrappers take CUDA tensors only, forward and backward; a
    CPU tensor that requires grad goes through the plain versions, and the
    gradient reaches es only."""
    es, ta = map(torch.from_numpy, _inputs((1, 8, 8), 2))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.census_sad_fwd(es, ta)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.census_sad_bwd(es, ta, es)
    es.requires_grad_()
    ta.requires_grad_()
    census_sad(es, ta).sum().backward()
    assert es.grad is not None and bool(torch.isfinite(es.grad).all())
    assert ta.grad is None
