"""The port's output heads (models/heads.py) against the flax heads of
depthinspace_tpu/models/heads.py: each kind from make_output_head, its
flax weights mapped by models/convert.py::head_state_dict_from_flax, on
the same NHWC input (NCHW in the port), and pos_to_depth."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from depthinspace_tpu.models import heads as jax_heads
from depthinspace_tpu_torch.models import (head_state_dict_from_flax,
                                           make_output_head, pos_to_depth)

H, W, C = 12, 10, 6
PARAMS = {"linear": {}, "disp": {"alpha": 64.0},
          "disp_row": {"alpha": 64.0, "beta": 1.0},
          "pos": {"alpha": 10.0, "offset": 1.0},
          "pos_row": {"alpha": 10.0, "gamma": 2.0}}


@pytest.mark.parametrize("kind", list(PARAMS))
def test_head_matches_flax(kind):
    """Outputs within rtol 1e-5, atol 1e-5 (3x3 convolutions and the
    per-row contraction summed in another order)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, H, W, C)).astype(np.float32)
    jm = jax_heads.make_output_head(kind, height=H, **PARAMS[kind])
    variables = jm.init(jax.random.key(1), jnp.asarray(x))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    head = make_output_head(kind, C, height=H, **PARAMS[kind])
    head.load_state_dict(head_state_dict_from_flax(
        jax.tree.map(np.asarray, variables), kind))
    with torch.no_grad():
        got = head(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, H, W, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pos_to_depth_matches_jax():
    rng = np.random.default_rng(2)
    pos = rng.uniform(-20, 5, (2, H, W, 1)).astype(np.float32)
    want = np.asarray(jax_heads.pos_to_depth(jnp.asarray(pos), 400.0, 0.025))
    got = pos_to_depth(torch.from_numpy(pos).permute(0, 3, 1, 2), 400.0,
                       0.025).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_unknown_head_raises():
    with pytest.raises(ValueError):
        make_output_head("depth", C)
