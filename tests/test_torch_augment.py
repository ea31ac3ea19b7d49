"""The port's host augmentation (``data/augment.py``, numpy alone) against
the JAX package's (cv2) on the CPU, the same ``RandomState`` seed on both
sides: ``augment_frame`` with the shear off (max_shift 0) and on (64), and
the ``data_aug`` branch of ``TrackDataset`` with every map it shifts
(primary_disp, sgm_disp, grad); and the two cv2 calls it replaces.

What the tests hold: the same branches taken and the same noise drawn;
the disparity maps (float64 after the shear, as cv2 returns them) and grad
bit for bit; the images within 1e-6 (the 5x5 Gaussian blur's row pass
rounds otherwise than cv2's on some pixels, by one float32 ulp).
``warp_affine`` is cv2.warpAffine bit for bit on float32 (OpenCV 5's float
coordinates) and float64 (its 1/32 px fixed-point path) images."""
import cv2
import numpy as np
import pytest

from depthinspace_tpu.data.augment import augment_frame as jax_augment
from depthinspace_tpu.data.dataset import TrackDataset as JaxTrackDataset
from depthinspace_tpu.data.fixture import generate_dataset
from depthinspace_tpu_torch.data import (TrackDataset, augment_frame, hdf5,
                                         imgproc, load_settings)

IMAGES = ("im", "ambient")
TOL_IMAGES = 1e-6


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A real-type fixture (GT disparity and SGM), 4 samples at 64x56, with
    a stand-in single_frame_disp.hdf5 (the GT less 0.25 px)."""
    d = tmp_path_factory.mktemp("aug") / "ds"
    generate_dataset(d, n_samples=4, imsize=(64, 56), seed=2, focal=300.0,
                     baseline=0.35, write_sgm=True)
    for s in sorted(d.glob("0*")):
        with hdf5.File(s / "frames.hdf5") as f:
            disp = np.asarray(f["disp"])
        hdf5.write_hdf5(s / "single_frame_disp.hdf5", {"disp": disp - 0.25})
    return d


def _frame(data, i=1, frame=2):
    with hdf5.File(data / f"{i:08d}" / "frames.hdf5") as f:
        return {k: np.array(f[k][frame, 0]) for k in
                ("im", "ambient", "disp", "sgm_disp", "grad")}


def _check(out, ref, names):
    for name, o, r in zip(names, out, ref):
        if r is None:
            assert o is None, name
            continue
        assert o.dtype == r.dtype and o.shape == r.shape, name
        if name in IMAGES:
            np.testing.assert_allclose(o, r, rtol=0, atol=TOL_IMAGES,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(o, r, err_msg=name)


@pytest.mark.parametrize("max_shift", [0.0, 64.0])
@pytest.mark.parametrize("seed", range(4))
def test_augment_frame_matches_jax(data, seed, max_shift):
    """Seeds 0-3 take both sides of each coin (shear or shift, blur, salt
    and pepper); the knobs are the function's defaults."""
    f = _frame(data)
    kw = dict(amb=f["ambient"], disp=f["disp"], primary_disp=f["disp"] - 1,
              sgm_disp=f["sgm_disp"], grad=f["grad"], max_shift=max_shift)
    out = augment_frame(f["im"], np.random.RandomState(seed), **kw)
    ref = jax_augment(f["im"], np.random.RandomState(seed), **kw)
    _check(out, ref, ("im", "ambient", "disp", "primary_disp", "sgm_disp",
                      "grad"))
    if max_shift:
        assert not np.array_equal(out[2], f["disp"])
    out = augment_frame(f["im"], np.random.RandomState(seed),
                        max_shift=max_shift)
    ref = jax_augment(f["im"], np.random.RandomState(seed),
                      max_shift=max_shift)
    _check(out, ref, ("im", "ambient", "disp", "primary_disp", "sgm_disp",
                      "grad"))


@pytest.mark.parametrize("max_shift", [0.0, 64.0])
def test_track_dataset_host_augmentation_matches_jax(data, max_shift):
    """Training samples of epoch 2 with data_aug: the frame permutation and
    then each frame's augmentation from the sample's RNG, on im, ambient,
    disp, primary_disp, sgm_disp and grad."""
    paths = sorted(str(p) for p in data.glob("0*"))
    kw = dict(train=True, data_aug=True, load_primary=True, load_grad=True,
              data_type="real")
    port = TrackDataset(load_settings(data / "settings.pkl"), paths, **kw)
    ref = JaxTrackDataset(data / "settings.pkl", paths, **kw)
    port.current_epoch = ref.current_epoch = 2
    port.max_shift = ref.max_shift = max_shift
    plain = TrackDataset(load_settings(data / "settings.pkl"), paths,
                         **dict(kw, data_aug=False))
    plain.current_epoch = 2
    for i in range(len(paths)):
        o, r, p = port[i], ref[i], plain[i]
        assert sorted(o) == sorted(r)
        for k in ("R", "t"):
            np.testing.assert_array_equal(o[k], r[k])
            np.testing.assert_array_equal(o[k], p[k])
        for k in ("im", "ambient", "disp", "primary_disp", "sgm_disp",
                  "grad"):
            assert o[k].dtype == r[k].dtype == np.float32, k
            tol = TOL_IMAGES if k in IMAGES else 0.0
            np.testing.assert_allclose(o[k], r[k], rtol=0, atol=tol,
                                       err_msg=k)
        assert not np.array_equal(o["im"], p["im"])
        assert np.array_equal(o["disp"], p["disp"]) == (max_shift == 0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(64, 56), (45, 70)])
def test_warp_affine_and_blur_match_cv2(shape, dtype):
    rng = np.random.RandomState(7)
    H, W = shape
    src = (rng.rand(H, W) * 80).astype(dtype)
    for shear, shift in ((0.0, 23.7), (0.0, -11.2), (37.3, 0.0),
                         (-52.9, 0.0)):
        T = np.float32([[1, shear / H, shift - min(shear, 0.0)], [0, 1, 0]])
        ref = cv2.warpAffine(src, T, (W, H))
        out = imgproc.warp_affine(src, T)
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)
    src = src.astype(np.float32) / 80
    for sigma in (0.2, 0.77, 1.5):
        np.testing.assert_allclose(imgproc.gaussian_blur5(src, sigma),
                                   cv2.GaussianBlur(src, (5, 5), sigma),
                                   rtol=0, atol=2 ** -23)
