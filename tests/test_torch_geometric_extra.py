"""The geometric losses' mask statistics (``with_stats=True``) and the
per-pair ``flow_consistency_sf`` / ``flow_consistency_mf`` of the port
against the JAX package on the CPU (K3's plain path against the Pallas
kernel in interpret mode), on a synthetic track at 24x20 with rotations:
the losses and every accept fraction at rtol 1e-5."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from depthinspace_tpu import losses as jl
from depthinspace_tpu_torch import losses as tl_
from depthinspace_tpu_torch.data import make_settings, make_track_batch

H, W = 24, 20
RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def track():
    """A track of 4 frames, bs 2, its depth from the GT disparity with 0.3
    px of noise (so the masks and losses are neither empty nor zero), the
    stand-in primary depth and both cameras."""
    s = make_settings(H, W)
    b = make_track_batch(s, tl=4, bs=2, seed=5, disp_range=(2.0, 12.0),
                         primary_noise=0.5)
    rng = np.random.RandomState(6)
    disp = b.disp_gt + rng.normal(0, 0.3, b.disp_gt.shape).astype(np.float32)
    f = s.focal_length * s.baseline
    depth = (f / np.maximum(disp, 0.1)).astype(np.float32)
    pdepth = (f / b.primary_disp).astype(np.float32)
    return (b, depth, pdepth, jl.CameraGeometry.create(s.K, H, W),
            tl_.CameraGeometry.create(s.K, H, W))


def _close(out, ref):
    np.testing.assert_allclose(float(out), float(ref), rtol=RTOL, atol=1e-8)


@pytest.mark.parametrize("arch", ["sf", "mf"])
def test_geometric_loss_with_stats_matches_jax(track, arch):
    b, depth, pdepth, jcam, tcam = track
    jargs = [jnp.asarray(a) for a in (depth, b.R, b.t, b.flow, b.ambient)]
    targs = [_t(a) for a in (depth, b.R, b.t, b.flow, b.ambient)]
    if arch == "sf":
        ref, jst = jl.geometric_loss_sf(jcam, *jargs, clamp=0.1,
                                        with_stats=True)
        out, tst = tl_.geometric_loss_sf(tcam, *targs, clamp=0.1,
                                         with_stats=True)
        keys = {"fb", "vc", "accept"}
        plain = tl_.geometric_loss_sf(tcam, *targs, clamp=0.1)
    else:
        ref, jst = jl.geometric_loss_mf(jcam, *jargs, jnp.asarray(pdepth),
                                        with_stats=True)
        out, tst = tl_.geometric_loss_mf(tcam, *targs, _t(pdepth),
                                         with_stats=True)
        keys = {"fb", "vc", "rf", "accept"}
        plain = tl_.geometric_loss_mf(tcam, *targs, _t(pdepth))
    assert set(tst) == set(jst) == keys
    _close(out, ref)
    assert float(plain) == float(out)
    for k in keys:
        assert tst[k].dtype == torch.float32 and tst[k].ndim == 0
        _close(tst[k], jst[k])
        assert 0.0 < float(tst[k]) <= 1.0, (k, float(tst[k]))
    # the accepted share is at most each mask's
    assert float(tst["accept"]) <= min(float(tst[k]) for k in keys)


@pytest.mark.parametrize("pair", [(0, 1), (1, 3), (2, 0)])
@pytest.mark.parametrize("arch", ["sf", "mf"])
def test_flow_consistency_matches_jax(track, arch, pair):
    """One view pair (i, j): the masked mean of i -> j plus that of j -> i,
    with the batch's flow i -> j and j -> i."""
    b, depth, pdepth, jcam, tcam = track
    i, j = pair
    arrays = (depth[i], depth[j], b.R[i], b.t[i], b.R[j], b.t[j],
              b.flow[i, j], b.flow[j, i], b.ambient[i], b.ambient[j])
    if arch == "sf":
        ref = jl.flow_consistency_sf(jcam, *map(jnp.asarray, arrays),
                                     clamp=0.1)
        out = tl_.flow_consistency_sf(tcam, *map(_t, arrays), clamp=0.1)
    else:
        ref = jl.flow_consistency_mf(jcam, *map(jnp.asarray, arrays),
                                     jnp.asarray(pdepth[i]),
                                     jnp.asarray(pdepth[j]))
        out = tl_.flow_consistency_mf(tcam, *map(_t, arrays),
                                      _t(pdepth[i]), _t(pdepth[j]))
    assert float(out) > 0.0
    _close(out, ref)
