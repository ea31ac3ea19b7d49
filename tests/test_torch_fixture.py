"""The port's plane-scene generator (``data/fixture.py``, numpy alone)
against the JAX package's (``depthinspace_tpu/data/fixture.py``, cv2 and
h5py) on the CPU, and the cv2 filters it replaces (``data/imgproc.py``)
against cv2.

What the tests hold, field by field (the same seed, the same draws):
settings.pkl's imsize, baseline and K, and R, t, disp, ambient, sgm_disp
and every flow_{i}{j} bit for bit; the pattern and im within 1e-6 (the
pattern's 3x3 Gaussian blur rounds otherwise than cv2's on some pixels,
by one float32 ulp); grad within 1e-4 (cv2's symmetric row pass of the 5x5
Sobel rounds otherwise on 10-25 % of pixels, by one ulp, and the LCN's
division by a local deviation of at least 0.1 magnifies it; measured up
to 4e-5). The remap, the box blur and the Sobel's antisymmetric pass are
cv2's bit for bit."""
import pickle

import cv2
import h5py
import numpy as np
import pytest

from depthinspace_tpu.data.fixture import generate_dataset as jax_generate
from depthinspace_tpu.tools import make_fixture as jax_make_fixture
from depthinspace_tpu_torch.data import generate_dataset, hdf5, imgproc
from depthinspace_tpu_torch.tools import make_fixture

TOL = {"im": 1e-6, "grad": 1e-4}          # every other field: bit for bit


def _compare_dirs(port_dir, jax_dir, n_samples):
    sp = pickle.load(open(port_dir / "settings.pkl", "rb"))
    sj = pickle.load(open(jax_dir / "settings.pkl", "rb"))
    assert tuple(sp["imsize"]) == tuple(sj["imsize"])
    assert sp["baseline"] == sj["baseline"]
    np.testing.assert_array_equal(sp["K"], sj["K"])
    np.testing.assert_allclose(sp["pattern"], sj["pattern"], rtol=0,
                               atol=1e-6)
    names = sorted(p.name for p in jax_dir.glob("0*"))
    assert names == sorted(p.name for p in port_dir.glob("0*"))
    assert len(names) == n_samples
    for name in names:
        for fname in ("frames.hdf5", "flow.hdf5"):
            with h5py.File(jax_dir / name / fname, "r") as fj, \
                    hdf5.File(port_dir / name / fname) as fp:
                assert sorted(fj.keys()) == sorted(fp.keys())
                for k in fj.keys():
                    ref, out = fj[k][()], np.asarray(fp[k])
                    assert out.shape == ref.shape and out.dtype == ref.dtype
                    if k in TOL:
                        np.testing.assert_allclose(out, ref, rtol=0,
                                                   atol=TOL[k], err_msg=k)
                    else:
                        np.testing.assert_array_equal(out, ref, err_msg=k)


@pytest.mark.parametrize("write_sgm", [False, True])
@pytest.mark.parametrize("imsize", [(64, 56), (64, 112)])
def test_generate_dataset_matches_jax(tmp_path, imsize, write_sgm):
    # the real-data test's camera (GT disparity around 30 px) with SGM
    kw = dict(focal=300.0, baseline=0.35) if write_sgm else {}
    generate_dataset(tmp_path / "port", n_samples=2, imsize=imsize, seed=11,
                     write_sgm=write_sgm, **kw)
    jax_generate(tmp_path / "jax", n_samples=2, imsize=imsize, seed=11,
                 write_sgm=write_sgm, **kw)
    _compare_dirs(tmp_path / "port", tmp_path / "jax", 2)
    with hdf5.File(tmp_path / "port" / "00000000" / "frames.hdf5") as f:
        assert ("sgm_disp" in f.keys()) == write_sgm
        disp = np.asarray(f["disp"])
        assert disp.shape == (4, 1) + imsize and (disp > 0).all()


def test_make_fixture_cli_matches_jax(tmp_path, capsys):
    argv = ["--n", "3", "--imsize", "32", "24", "--seed", "5"]
    make_fixture.main([str(tmp_path / "port")] + argv)
    assert "wrote 3 samples" in capsys.readouterr().out
    jax_make_fixture.main([str(tmp_path / "jax")] + argv)
    _compare_dirs(tmp_path / "port", tmp_path / "jax", 3)


@pytest.mark.parametrize("shape", [(37, 29), (64, 56)])
def test_remap_box_blur_and_sobel_match_cv2(shape):
    rng = np.random.RandomState(0)
    H, W = shape
    src = rng.rand(H, W).astype(np.float32)
    # coordinates inside, across the border and far outside
    mx = rng.uniform(-3, W + 2, (H, W)).astype(np.float32)
    my = rng.uniform(-3, H + 2, (H, W)).astype(np.float32)
    ref = cv2.remap(src, mx, my, cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_CONSTANT, borderValue=0.0)
    np.testing.assert_array_equal(imgproc.remap(src, mx, my), ref)
    np.testing.assert_array_equal(
        imgproc.box_blur_reflect(src, 11),
        cv2.blur(src, (11, 11), borderType=cv2.BORDER_REFLECT))
    np.testing.assert_array_equal(imgproc.sobel5(src, 1, 0),
                                  cv2.Sobel(src, cv2.CV_32F, 1, 0, ksize=5))
    # the symmetric row pass: ulps of its sums, at most 4 of the largest
    # value's
    ref = cv2.Sobel(src, cv2.CV_32F, 0, 1, ksize=5)
    np.testing.assert_allclose(imgproc.sobel5(src, 0, 1), ref, rtol=0,
                               atol=4 * np.spacing(np.abs(ref).max()))
