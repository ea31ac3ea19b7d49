"""Seeded synthetic inputs, numpy only.

Ports the pieces of ``depthinspace_tpu/data/fixture.py`` and ``bench.py``
that the forward path needs, without cv2 or h5py:

- ``make_dot_pattern``: the random-dot projector pattern (fixture.py:30-42),
  with cv2's 3x3 Gaussian blur written as a separable numpy filter with the
  same reflect-101 border;
- ``smooth_disparity``: a scene-like low-frequency disparity field, by
  default in [10, 80] px (bench.py::_smooth_disp), upsampled bilinearly
  instead of cv2's bicubic;
- ``random_poses`` and ``rigid_flow``: small camera motions and the exact
  rigid optical flow of a static scene (fixture.py:154-168);
- ``make_track_batch``: one track-major :class:`Batch` whose IR image is the
  pattern shifted by the disparity over a smooth ambient, with all-pairs
  rigid flow and, on request, a stand-in for the DIS-SF primary disparity
  (the GT plus seeded Gaussian noise, clipped at 0.1, as the JAX package's
  tests stand in for a presaved SF prediction).
"""

from __future__ import annotations

import numpy as np

from .batch import Batch
from .imgproc import _fma
from .settings import Settings


def _blur3_reflect101(x: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(x, (3, 3), sigma) for a 2-D float32 image of dots
    (0 and 1): the column pass is cv2's, ``fma(u + d, k1, m * k0)``, and
    on such an image the row pass rounds as cv2's does, so the result is
    cv2's bit for bit."""
    k = np.exp(-np.arange(-1.0, 2.0) ** 2 / (2.0 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    xp = np.pad(x, 1, mode="reflect")           # numpy reflect == reflect-101
    rows = k[0] * xp[:, :-2] + k[1] * xp[:, 1:-1] + k[2] * xp[:, 2:]
    return _fma(rows[:-2] + rows[2:], k[0], rows[1:-1] * k[1])


def make_dot_pattern(height: int, width: int, n_dots: int = None,
                     seed: int = 7) -> np.ndarray:
    """Random dot projector pattern, (H, W, 3) float32 in [0, 1]."""
    rng = np.random.RandomState(seed)
    if n_dots is None:
        n_dots = height * width // 24
    pat = np.zeros((height, width), np.float32)
    ys = rng.randint(0, height, n_dots)
    xs = rng.randint(0, width, n_dots)
    pat[ys, xs] = 1.0
    pat = _blur3_reflect101(pat, 0.6)
    pat = np.clip(pat / max(pat.max(), 1e-6), 0, 1)
    return np.stack([pat] * 3, axis=-1)


def make_settings(height: int = 512, width: int = 432, focal: float = 435.2,
                  baseline: float = 0.025, seed: int = 7) -> Settings:
    """The camera and pattern of bench.py::_settings at any image size."""
    K = np.array([[focal, 0, width / 2.0], [0, focal, height / 2.0],
                  [0, 0, 1]], np.float32)
    return Settings(imsize=(height, width),
                             pattern=make_dot_pattern(height, width, seed=seed),
                             baseline=baseline, K=K)


def _upsample_bilinear(coarse: np.ndarray, height: int,
                       width: int) -> np.ndarray:
    """(..., h, w) -> (..., height, width), corners aligned."""
    h, w = coarse.shape[-2:]
    ys = np.linspace(0.0, h - 1.0, height)
    xs = np.linspace(0.0, w - 1.0, width)
    y0 = np.minimum(np.floor(ys).astype(int), h - 2)
    x0 = np.minimum(np.floor(xs).astype(int), w - 2)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    c = coarse
    top = c[..., y0, :][..., :, x0] * (1 - fx) + c[..., y0, :][..., :, x0 + 1] * fx
    bot = (c[..., y0 + 1, :][..., :, x0] * (1 - fx)
           + c[..., y0 + 1, :][..., :, x0 + 1] * fx)
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def smooth_disparity(rng: np.random.RandomState, shape,
                     lo: float = 10.0, hi: float = 80.0) -> np.ndarray:
    """Smooth disparity field of ``shape`` (..., H, W) in [lo, hi] px (the
    bilinear upsampling of an 8x8 grid stays inside its range)."""
    coarse = rng.uniform(lo, hi, tuple(shape[:-2]) + (8, 8))
    return _upsample_bilinear(coarse, shape[-2], shape[-1])


def _rotation(axis_angle: np.ndarray) -> np.ndarray:
    """Rodrigues' formula."""
    theta = float(np.linalg.norm(axis_angle))
    if theta < 1e-12:
        return np.eye(3, dtype=np.float32)
    k = axis_angle / theta
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(theta) * Kx + (1 - np.cos(theta)) * Kx @ Kx
    return R.astype(np.float32)


def random_poses(rng: np.random.RandomState, tl: int, bs: int,
                 max_angle: float = 0.004, max_shift: float = 0.003):
    """Small camera motions: R (tl, bs, 3, 3), t (tl, bs, 3). At the default
    camera and disparities in [10, 80] px the rigid flow is a few px."""
    R = np.stack([np.stack([_rotation(rng.uniform(-max_angle, max_angle, 3))
                            for _ in range(bs)]) for _ in range(tl)])
    t = rng.uniform(-max_shift, max_shift, (tl, bs, 3)).astype(np.float32)
    return R.astype(np.float32), t


def rigid_flow(depth_i, K, R_i, t_i, R_j, t_j) -> np.ndarray:
    """Exact flow (H, W, 2) from frame i to frame j of a static scene
    (fixture.py::_rigid_flow, in the row convention X_w = (X_c - t) R)."""
    H, W = depth_i.shape
    Ki = np.linalg.inv(K)
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    pix = np.stack([u, v, np.ones_like(u)], axis=-1).reshape(-1, 3)
    Xc = (pix @ Ki.T) * depth_i.reshape(-1, 1)
    Xw = (Xc - t_i[None, :]) @ R_i
    Xj = Xw @ R_j.T + t_j[None, :]
    uvj = Xj @ K.T
    uj = uvj[:, 0] / np.maximum(uvj[:, 2], 1e-9)
    vj = uvj[:, 1] / np.maximum(uvj[:, 2], 1e-9)
    return np.stack([uj.reshape(H, W) - u, vj.reshape(H, W) - v],
                    axis=-1).astype(np.float32)


def _shift_rows(pattern: np.ndarray, disp: np.ndarray) -> np.ndarray:
    """pattern (H, W) sampled at u - disp, linear, border clamp."""
    H, W = pattern.shape
    x = np.clip(np.arange(W, dtype=np.float32)[None] - disp, 0, W - 1)
    x0 = np.floor(x).astype(int)
    f = x - x0
    x1 = np.minimum(x0 + 1, W - 1)
    rows = np.arange(H)[:, None]
    return pattern[rows, x0] * (1 - f) + pattern[rows, x1] * f


def make_track_batch(settings, tl: int = 4, bs: int = 1, seed: int = 0,
                     disp_range=(10.0, 80.0), blend: float = 0.6,
                     max_angle: float = 0.004,
                     primary_noise: float | None = None) -> Batch:
    """One synthetic track batch (numpy, float32) with exact rigid flow.
    ``max_angle=0`` gives translation-only poses (R = I). With
    ``primary_noise`` (px) the batch carries a stand-in primary disparity,
    max(GT + primary_noise * N(0, 1), 0.1), drawn after everything else
    from the same seed."""
    H, W = settings.imsize
    rng = np.random.RandomState(seed)
    disp = smooth_disparity(rng, (tl, bs, H, W), *disp_range)
    amb = np.clip(_upsample_bilinear(rng.uniform(0.2, 0.9, (tl, bs, 6, 6)),
                                     H, W), 0.0, 1.0)
    R, t = random_poses(rng, tl, bs, max_angle=max_angle)
    pat = settings.pattern_gray()
    im = np.empty((tl, bs, H, W), np.float32)
    for i in range(tl):
        for b in range(bs):
            im[i, b] = (blend * _shift_rows(pat, disp[i, b])
                        + (1 - blend) * amb[i, b])
    depth = settings.baseline * settings.focal_length / disp
    K = np.asarray(settings.K, np.float64)
    flow = np.zeros((tl, tl, bs, H, W, 2), np.float32)
    for i in range(tl):
        for j in range(tl):
            if i != j:
                for b in range(bs):
                    flow[i, j, b] = rigid_flow(depth[i, b], K, R[i, b],
                                               t[i, b], R[j, b], t[j, b])
    primary = None
    if primary_noise is not None:
        primary = np.maximum(disp + primary_noise * rng.randn(*disp.shape),
                             0.1).astype(np.float32)
    return Batch(im=np.clip(im, 0.0, 1.0), ambient=amb.astype(np.float32),
                 disp_gt=disp, R=R, t=t, flow=flow, primary_disp=primary)
