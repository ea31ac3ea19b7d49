"""The worker's debug images without matplotlib: ``utils/cmap.py`` bit for
bit against the JAX package's, the PNG writer through ``imgproc.read_png``,
and a worker epoch's train_EEE_BBBB.png, test_EEE_BBBB.png and errs.png."""
import numpy as np
import pytest
import torch

from depthinspace_tpu.utils import cmap as jax_cmap
from depthinspace_tpu_torch.config import RunConfig
from depthinspace_tpu_torch.data import SyntheticSource, make_settings
from depthinspace_tpu_torch.data.imgproc import read_png, write_png
from depthinspace_tpu_torch.train.single_frame import SingleFrameWorker
from depthinspace_tpu_torch.utils import cmap, plots

H, W = 32, 24


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test processes on the machine's cores at once;
    two intra-op threads per process keep torch from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("scale", [None, 16.0, 40.0])
def test_color_depth_map_matches_jax(scale):
    d = np.random.RandomState(0).uniform(0, 30, (H, W)).astype(np.float32)
    d[0, :4] = [0.0, 30.0, 1e-3, 16.0]
    got = cmap.color_depth_map(d, scale=scale)
    want = jax_cmap.color_depth_map(d, scale=scale)
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)


@pytest.mark.parametrize("bgr", [True, False])
def test_color_error_image_matches_jax(bgr):
    rng = np.random.RandomState(1)
    e = np.abs(rng.normal(0, 2, (H, W))).astype(np.float32)
    e[0, :3] = [0.0, 1e-6, 1e3]
    mask = rng.rand(H, W) > 0.2
    for m in (None, mask):
        got = cmap.color_error_image(e, mask=m, BGR=bgr)
        want = jax_cmap.color_error_image(e, mask=m, BGR=bgr)
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)


def test_png_writer_round_trips(tmp_path):
    """Gray and RGB uint8 back through read_png (cv2.imread's BGR order,
    gray repeated to 3 channels); other inputs raise."""
    rng = np.random.RandomState(2)
    rgb = rng.randint(0, 256, (7, 5, 3)).astype(np.uint8)
    gray = rng.randint(0, 256, (4, 9)).astype(np.uint8)
    write_png(tmp_path / "rgb.png", rgb)
    write_png(tmp_path / "gray.png", gray)
    assert np.array_equal(read_png(tmp_path / "rgb.png"), rgb[..., ::-1])
    assert np.array_equal(read_png(tmp_path / "gray.png"),
                          np.repeat(gray[..., None], 3, axis=2))
    with pytest.raises(ValueError):
        write_png(tmp_path / "f.png", rgb.astype(np.float32))


def test_loss_curves_draw_each_series_in_its_colour():
    canvas, legend = plots.loss_curves({"train": ([0, 1, 2], [3.0, 2.0, 1.5]),
                                        "test0": ([0, 1, 2], [3.2, 2.4, 2.0])})
    assert canvas.shape == (600, 800, 3) and canvas.dtype == np.uint8
    for label, color in zip(("test0", "train"), plots.SERIES_COLORS):
        assert f"{label} rgb{color}" in legend
        assert (canvas == np.array(color, np.uint8)).all(axis=2).sum() > 100


def _worker(tmp_path, write_debug_images):
    settings = make_settings(H, W, focal=20.0)
    cfg = RunConfig(data_dir=tmp_path, output_dir=tmp_path / "out", epochs=1,
                    train_batch_size=2, test_batch_size=2, max_train_iter=1,
                    num_workers=1, write_debug_images=write_debug_images,
                    save_frequency=100)        # no checkpoints
    SingleFrameWorker(cfg, device="cpu",
                      source=SyntheticSource(settings, 8)).do("retrain")
    return tmp_path / "out" / "single_frame"


def test_worker_writes_debug_images_and_errs_png(tmp_path):
    """One epoch: the 2x3 grid of the first training batch and of the first
    test batch, (2H, 3W) RGB, and errs.png (600x800) after the test epoch,
    each named in train.log with its titles or legend. With
    write_debug_images=False the grids are not written; errs.png is, as in
    the JAX worker."""
    exp = _worker(tmp_path / "on", True)
    for name in ("train_000_0000.png", "test_000_0000.png"):
        img = read_png(exp / name)
        assert img.shape == (2 * H, 3 * W, 3), name
        assert img.std() > 0, name
    assert read_png(exp / "errs.png").shape == (600, 800, 3)
    log = (exp / "train.log").read_text()
    assert "test_000_0000.png: IR input | Ambient | Disp GT | Disp est" in log
    assert "errs.png: x: epoch" in log and "train rgb" in log
    exp = _worker(tmp_path / "off", False)
    assert sorted(p.name for p in exp.glob("*.png")) == ["errs.png"]
