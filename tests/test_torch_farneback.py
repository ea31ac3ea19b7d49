"""ops/farneback.py (OpenCV's Farnebäck flow in PyTorch) against cv2 on the
same numpy inputs made from seeds: the JAX package's
``presave_flow.farneback_flow`` (cv2.calcOpticalFlowFarneback with the
tool's parameters) and cv2 at each stage's parameters.

Inputs: analytic textures (sums of random sinusoids) moved by known
affine motions, quantized to uint8 with a ramp of their own; the port's
plane-scene fixture's ambient pairs; and at 512x432, where 3 pyramid levels
run, a sample rendered by the port's create_syn_data.

Tolerances: the stages and the filters within 1e-4 px (measured equal bit
for bit: the filters round as OpenCV's vector code does, the sums in the
order of its loops, float64 where it sums in double); at 512x432 the mean
|d| <= 1e-3 px and the 99.9th percentile <= 5e-2 px (a 2x2 system near
singular, in flat regions, turns an ulp into a large step, so the tail is
the bound that matters; measured equal but for values within 1e-11 px
of zero), and the mean EPE to the rigid flow within 0.1 % of cv2's
(measured equal)."""
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from depthinspace_tpu.tools import presave_flow as jax_presave_flow
from depthinspace_tpu_torch.data import hdf5, load_settings
from depthinspace_tpu_torch.data.fixture import generate_dataset
from depthinspace_tpu_torch.ops import farneback as fb
from depthinspace_tpu_torch.tools import create_syn_data, presave_flow

STAGE_ATOL = 1e-4
FULL_MEAN, FULL_P999, EPE_RTOL = 1e-3, 5e-2, 1e-3
PARAMS = dict(pyr_scale=0.5, levels=4, winsize=21, iterations=5, poly_n=7,
              poly_sigma=1.5)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def texture_pair(H, W, seed, shift, angle_deg=0.0, ramp=(0.0, 1.0)):
    """Frame 0 and frame 1 = frame 0 moved by (rotation about the centre,
    then ``shift``), both quantized as the JAX tool quantizes, after the
    intensity ramp lo + (hi - lo) * x."""
    rs = np.random.RandomState(seed)
    k = 12
    freq = rs.uniform(0.05, 0.6, k) * np.exp(2j * np.pi * rs.rand(k))
    amp, phase = rs.uniform(0.5, 1.0, k), rs.uniform(0, 2 * np.pi, k)

    def image(x, y):
        v = sum(a * np.sin(f.real * x + f.imag * y + p)
                for a, f, p in zip(amp, freq, phase))
        return 0.5 + 0.5 * v / amp.sum()

    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    c = np.array([(W - 1) / 2, (H - 1) / 2])
    t = np.deg2rad(angle_deg)
    # frame 1 at x shows what frame 0 showed at R^-1 (x - c - shift) + c
    u, v = x - c[0] - shift[0], y - c[1] - shift[1]
    x0 = np.cos(t) * u + np.sin(t) * v + c[0]
    y0 = -np.sin(t) * u + np.cos(t) * v + c[1]
    lo, hi = ramp
    q = lambda im: (np.clip(lo + (hi - lo) * im, 0, 1) * 255).astype(np.uint8)
    return q(image(x, y)), q(image(x0, y0))


def plane_pair(tmp_path_factory, H, W):
    d = tmp_path_factory.mktemp("plane")
    generate_dataset(d, n_samples=1, imsize=(H, W), seed=3, write_flow=False)
    with hdf5.File(d / "00000000" / "frames.hdf5") as f:
        amb = np.array(f["ambient"][:, 0])
    return tuple((np.clip(amb[i], 0, 1) * 255).astype(np.uint8)
                 for i in (0, 2))


def port(a, b, **kw):
    frames = torch.from_numpy(np.stack([a, b]))
    return fb.farneback(frames, [0], [1], **kw)[0].numpy()


def cv(a, b, **kw):
    p = dict(PARAMS, **kw)
    flow = cv2.calcOpticalFlowFarneback(
        a, b, None, p["pyr_scale"], p["levels"], p["winsize"],
        p["iterations"], p["poly_n"], p["poly_sigma"],
        cv2.OPTFLOW_FARNEBACK_GAUSSIAN)
    return np.moveaxis(flow, -1, 0)


STAGES = {
    "levels0-iter1": dict(levels=0, iterations=1),
    "levels0-iter5": dict(levels=0, iterations=5),
    "pyramid": dict(),
    "poly_n5": dict(poly_n=5, poly_sigma=1.1),
    "winsize15": dict(winsize=15),
}


@pytest.mark.parametrize("source", ["shift", "affine", "plane"])
@pytest.mark.parametrize("stage", list(STAGES))
def test_stage_matches_cv2(tmp_path_factory, source, stage):
    """Each stage's parameters at 160x144 (2 coarser levels run where
    levels = 4) on a textured pair moved by (2.3, -1.6) px, one moved by
    (4.1, 2.7) px and 3 degrees, and a plane-scene ambient pair (frames 0
    and 2): within 1e-4 px of cv2 (measured equal); on the textures the
    flow also finds the motion (median within 0.25 px away from the
    border)."""
    H, W = 160, 144
    if source == "plane":
        a, b = plane_pair(tmp_path_factory, H, W)
        motion = None
    else:
        shift, angle = ((2.3, -1.6), 0.0) if source == "shift" else \
            ((4.1, 2.7), 3.0)
        a, b = texture_pair(H, W, 11, shift, angle, ramp=(0.1, 0.85))
        motion = shift, angle
    got, ref = port(a, b, **STAGES[stage]), cv(a, b, **STAGES[stage])
    assert got.shape == (2, H, W) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=STAGE_ATOL)
    if motion is not None and stage != "levels0-iter1":
        (sx, sy), angle = motion
        y, x = np.mgrid[0:H, 0:W].astype(np.float64)
        c = np.array([(W - 1) / 2, (H - 1) / 2])
        t = np.deg2rad(angle)
        want_x = np.cos(t) * (x - c[0]) - np.sin(t) * (y - c[1]) + c[0] + sx
        want_y = np.sin(t) * (x - c[0]) + np.cos(t) * (y - c[1]) + c[1] + sy
        err = np.hypot(got[0] - (want_x - x), got[1] - (want_y - y))
        assert np.median(err[20:-20, 20:-20]) < 0.25


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """One create_syn_data sample at 512x432 (default pattern, procedural
    objects) and its settings."""
    d = tmp_path_factory.mktemp("rendered")
    create_syn_data.main(["default", "--objects", "procedural",
                          "--n_samples", "1", "--data_dir", str(d)])
    with hdf5.File(d / "00000000" / "frames.hdf5") as f:
        frames = {k: np.array(f[k]) for k in ("ambient", "disp", "R", "t")}
    return frames, load_settings(d / "settings.pkl")


def test_full_size_matches_cv2(rendered):
    """presave_flow.farneback_flow against the JAX tool's (cv2) at 512x432,
    where levels = 4 runs 3 coarser levels (64x54, 128x108, 256x216), on
    three ordered pairs of a rendered sample, each after its own intensity
    ramp (gain and offset before the uint8 quantization: uint8 ranges
    28-255, 68-204 and 0-255). Measured: mean |d| 2.2e-35 px, 99.9th
    percentile 0, max 1.3e-29 (0.012 % of the values differ, all within
    1.3e-29 of zero); mean EPE to the rigid flow 10.3452 px, cv2's 10.3452
    (zero flow 10.6875)."""
    frames, st = rendered
    amb = frames["ambient"][:, 0].astype(np.float32)
    depth = st.baseline * st.focal_length / np.maximum(
        frames["disp"][:, 0], 1e-6)
    assert amb.shape[1:] == (512, 432)
    assert fb.pyramid_levels(512, 432, 0.5, 4) == 3
    d, epe_port, epe_cv = [], [], []
    for (i, j), (gain, offset) in zip([(0, 1), (1, 2), (3, 0)],
                                      [(1.0, 0.0), (0.6, 0.2), (1.5, -0.2)]):
        a, b = (np.float32(gain) * amb[k] + np.float32(offset) for k in (i, j))
        got = presave_flow.farneback_flow(a, b, device="cpu")
        ref = jax_presave_flow.farneback_flow(a, b)
        gt = jax_presave_flow.rigid_flow(depth[i], st.K, frames["R"][i],
                                         frames["t"][i], frames["R"][j],
                                         frames["t"][j])
        assert got.shape == ref.shape == (2, 512, 432)
        d.append(np.abs(got - ref).ravel())
        epe_port.append(np.linalg.norm(got - gt, axis=0).mean())
        epe_cv.append(np.linalg.norm(ref - gt, axis=0).mean())
    d = np.concatenate(d)
    assert d.mean() <= FULL_MEAN and np.quantile(d, 0.999) <= FULL_P999
    assert abs(np.mean(epe_port) - np.mean(epe_cv)) <= EPE_RTOL * np.mean(
        epe_cv)


def test_batched_pairs_equal_single_calls():
    """The 12 ordered pairs of 4 frames in one call (each frame expanded
    once a level) equal 12 single-pair calls bit for bit on the CPU (96x80:
    one coarser level)."""
    a, b = texture_pair(96, 80, 5, (1.5, 0.5))
    c, d = texture_pair(96, 80, 6, (-2.0, 1.0), 2.0)
    frames = np.stack([a, b, c, d])
    src = [i for i in range(4) for j in range(4) if i != j]
    dst = [j for i in range(4) for j in range(4) if i != j]
    batched = fb.farneback(torch.from_numpy(frames), src, dst, **PARAMS)
    assert batched.shape == (12, 2, 96, 80)
    for p, (i, j) in enumerate(zip(src, dst)):
        assert torch.equal(batched[p], torch.from_numpy(
            port(frames[i], frames[j], **PARAMS)))


@pytest.mark.parametrize("H,W,levels,want", [
    (512, 432, 4, 3), (512, 432, 5, 3), (432, 512, 4, 3), (128, 112, 4, 1),
    (64, 56, 4, 0), (160, 144, 1, 1)])
def test_pyramid_stops_at_32_pixels(H, W, levels, want):
    """cv2 runs a coarser level only while both sides stay >= 32 px: the
    port's count, and at the small sizes cv2's flow equal with ``levels``
    and with that count."""
    assert fb.pyramid_levels(H, W, 0.5, levels) == want
    if H * W < 512 * 432:
        a, b = texture_pair(H, W, 2, (1.0, 2.0))
        np.testing.assert_array_equal(cv(a, b, levels=levels),
                                      cv(a, b, levels=want))


@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (3, 0.5), (9, 1.5),
                                         (19, 3.5)])
def test_gaussian_blur_matches_cv2(ksize, sigma):
    """The pyramid's blurs (level 0: cv2's fixed 3-tap kernel; levels 1-3
    of pyr_scale 0.5) equal cv2.GaussianBlur bit for bit."""
    img = np.random.RandomState(ksize).randint(0, 256, (96, 80)).astype(
        np.float32)
    got = fb.gaussian_blur(torch.from_numpy(img), ksize, sigma).numpy()
    np.testing.assert_array_equal(got, cv2.GaussianBlur(img, (ksize, ksize),
                                                        sigma, sigma))


@pytest.mark.parametrize("kind,size", [("frames", (48, 40)),
                                       ("frames", (24, 20)),
                                       ("flow", (192, 160))])
def test_resizes_match_cv2(kind, size):
    """cv2.resize INTER_LINEAR bit for bit: a frame down to 1/2 and 1/4, and
    a two-channel flow up 2x (cv2 weights its channels as p0 (1 - a) + p1
    a, not as the one-channel lerp)."""
    rs = np.random.RandomState(1)
    h, w = size
    if kind == "frames":
        img = rs.randint(0, 256, (96, 80)).astype(np.float32)
        got = fb.resize_frames(torch.from_numpy(img)[None], h, w)[0].numpy()
        ref = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    else:
        flow = rs.randn(96, 80, 2).astype(np.float32)
        got = fb.resize_flow(torch.from_numpy(flow).permute(2, 0, 1)[None],
                             h, w)[0].permute(1, 2, 0).numpy()
        ref = cv2.resize(flow, (w, h), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("frames,kw,error", [
    (torch.zeros(2, 32, 32, dtype=torch.float64), {}, TypeError),
    (torch.zeros(32, 32), {}, ValueError),
    (torch.zeros(2, 8, 32), {}, ValueError),
    (torch.zeros(2, 32, 32), dict(pyr_scale=1.0), ValueError),
], ids=["float64", "2-d", "8-rows", "pyr_scale-1"])
def test_unhandled_inputs_raise(frames, kw, error):
    with pytest.raises(error):
        fb.farneback(frames, [0], [1], **kw)
