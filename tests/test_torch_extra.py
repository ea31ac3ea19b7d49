"""The port's dormant functions against their JAX counterparts on the same
numpy inputs: losses/extra.py (ssim, occlusion_mask,
projection_depth_similarity_loss), ops/sampling.py::resize_mask,
ops/census.py::photometric_dissimilarity (its four types),
losses/photometric.py::warp_pattern_by_disparity, utils/metric.py's mse,
rmse, mae and outlier_fraction, data/dataset.py::MultiDataset and
utils/misc.py::git_hash."""
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from depthinspace_tpu.data.dataset import MultiDataset as JaxMultiDataset
from depthinspace_tpu.losses import extra as jax_extra
from depthinspace_tpu.losses.geometric import CameraGeometry as JaxCam
from depthinspace_tpu.losses.photometric import \
    warp_pattern_by_disparity as jax_warp_pattern
from depthinspace_tpu.ops.census import \
    photometric_dissimilarity as jax_dissimilarity
from depthinspace_tpu.ops.sampling import resize_mask as jax_resize_mask
from depthinspace_tpu.utils import metric as jax_metric
from depthinspace_tpu.utils.misc import git_hash as jax_git_hash
from depthinspace_tpu_torch.data import MultiDataset, make_settings
from depthinspace_tpu_torch.losses import extra
from depthinspace_tpu_torch.losses.geometric import CameraGeometry
from depthinspace_tpu_torch.losses.photometric import \
    warp_pattern_by_disparity
from depthinspace_tpu_torch.ops.census import photometric_dissimilarity
from depthinspace_tpu_torch.ops.sampling import resize_mask
from depthinspace_tpu_torch.utils import metric
from depthinspace_tpu_torch.utils.misc import git_hash

H, W = 24, 20


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_ssim_matches_jax():
    """rtol 1e-5, atol 1e-6 (the 3x3 sums in another order)."""
    rng = np.random.default_rng(0)
    x, y = (rng.random((2, H, W, 3), dtype=np.float32) for _ in range(2))
    _close(extra.ssim(_t(x), _t(y)), jax_extra.ssim(x, y), 1e-5, 1e-6)


def _poses(rng, n):
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy()
    t = (rng.standard_normal((n, 3)) * 0.01).astype(np.float32)
    return R, t


def test_projection_depth_similarity_loss_and_masks_match_jax():
    """The loss within rtol 1e-5, the rigid flows within 1e-4 px, and the
    occlusion masks equal but for pixels whose test is within 1e-4 of its
    threshold (none at this seed)."""
    rng = np.random.default_rng(1)
    s = make_settings(H, W)
    K = np.asarray(s.K, np.float64)
    d0, d1 = (rng.uniform(0.8, 1.2, (2, H, W)).astype(np.float32)
              for _ in range(2))
    (R0, t0), (R1, t1) = _poses(rng, 2), _poses(rng, 2)
    want = jax_extra.projection_depth_similarity_loss(
        JaxCam.create(K, H, W), d0, d1, R0, t0, R1, t1, clamp=0.05)
    got = extra.projection_depth_similarity_loss(
        CameraGeometry.create(K, H, W), _t(d0), _t(d1), _t(R0), _t(t0),
        _t(R1), _t(t1), clamp=0.05)
    _close(got[0], want[0], 1e-5, 0)
    for i in (1, 2):
        _close(got[i], want[i], 0, 1e-4)
    for i in (3, 4):
        assert np.array_equal(got[i].numpy(), np.asarray(want[i]))
        assert 0 < float(got[i].mean()) <= 1


def test_resize_mask_matches_jax():
    rng = np.random.default_rng(2)
    m = (rng.random((2, H, W, 1)) > 0.5).astype(np.float32)
    for h, w in ((12, 10), (48, 40), (17, 9)):
        assert np.array_equal(resize_mask(_t(m), h, w).numpy(),
                              np.asarray(jax_resize_mask(m, h, w)))


@pytest.mark.parametrize("loss_type", ["census_sad", "census_mse", "mse",
                                       "sad"])
def test_photometric_dissimilarity_matches_jax(loss_type):
    """Each type within rtol 1e-5, atol 1e-6; census_sad is the port's K1
    entry point (its plain version on the CPU)."""
    rng = np.random.default_rng(3)
    es, ta = (rng.standard_normal((2, H, W)).astype(np.float32)
              for _ in range(2))
    _close(photometric_dissimilarity(_t(es), _t(ta), 5, loss_type),
           jax_dissimilarity(es, ta, 5, loss_type), 1e-5, 1e-6)
    with pytest.raises(ValueError):
        photometric_dissimilarity(_t(es), _t(ta), 5, "ssd")


def test_warp_pattern_by_disparity_matches_jax():
    """Within 1e-5 (the interpolation's rounding)."""
    rng = np.random.default_rng(4)
    pattern = rng.random((H, W), dtype=np.float32)
    disp = rng.uniform(0, 6, (2, H, W)).astype(np.float32)
    _close(warp_pattern_by_disparity(_t(pattern), _t(disp)),
           jax_warp_pattern(jnp.asarray(pattern), jnp.asarray(disp)), 0,
           1e-5)


def test_metric_functions_match_jax():
    rng = np.random.default_rng(5)
    es, gt = rng.random((2, 3, H, W))
    mask = rng.random((3, H, W)) > 0.3
    for name in ("mse", "rmse", "mae"):
        for m in (None, mask):
            assert getattr(metric, name)(es, gt, m) == getattr(
                jax_metric, name)(es, gt, m)
    for th in (0.1, 0.5):
        assert metric.outlier_fraction(es, gt, mask, th) == \
            jax_metric.outlier_fraction(es, gt, mask, th)
    with pytest.raises(ValueError):
        metric.mse(es, gt[:2])


def test_multi_dataset_matches_jax():
    parts = [list(range(3)), list(range(10, 15)), [], list(range(20, 22))]
    port, ref = MultiDataset(*parts[:2]), JaxMultiDataset(*parts[:2])
    for d in parts[2:]:
        port.append(d)
        ref.append(d)
    assert len(port) == len(ref) == 10
    assert [port[i] for i in range(10)] == [ref[i] for i in range(10)]
    parts[1].append(15)
    port.dataset_updated()
    ref.dataset_updated()
    assert [port[i] for i in range(11)] == [ref[i] for i in range(11)]


def test_git_hash_matches_jax(tmp_path):
    repo = Path(__file__).resolve().parents[1]
    assert git_hash(repo) == jax_git_hash(repo)
    assert git_hash(tmp_path) is None
