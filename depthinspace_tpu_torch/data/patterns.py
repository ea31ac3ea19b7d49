"""Projector pattern files and real-capture post-processing, port of
``depthinspace_tpu/data/patterns.py`` without cv2: PNG patterns are read
by ``imgproc.read_png``, resized by ``imgproc.resize_linear`` and mapped
onto the camera by ``imgproc.remap``, each cv2's function in numpy.
"""

from __future__ import annotations

import numpy as np

from .imgproc import read_png, remap, resize_linear


def read_pattern_file(pattern_path: str, pattern_type: str = "default",
                      pattern_size=None) -> np.ndarray:
    """Load a projector pattern PNG -> (H, W, 3) float32 in [0, 1], BGR as
    cv2 reads it: ``default`` patterns are mirrored and turned a quarter,
    ``kinect`` ones cropped to their centre square and resized to
    ``pattern_size`` (width, height)."""
    pattern = read_png(pattern_path).astype(np.float32) / 255.0
    if pattern_type == "default":
        pattern = np.rot90(np.flip(pattern, axis=1))
    elif pattern_type == "kinect":
        m = min(pattern.shape[:2])
        sh = (pattern.shape[0] - m) // 2
        sw = (pattern.shape[1] - m) // 2
        pattern = pattern[sh:sh + m, sw:sw + m]
        if pattern_size is not None:
            pattern = resize_linear(pattern, pattern_size)
    return np.ascontiguousarray(pattern)


def post_process(pattern_type: str, im: np.ndarray, K=None):
    """Real-capture processing: crop (128, 108) margins then 2x downscale to
    432x512, with intrinsics adjusted accordingly; identity for synthetic."""
    if pattern_type == "real":
        out = im[128:-128, 108:-108, ...].copy()
        out = resize_linear(out, (432, 512))
        if K is not None:
            Kp = K.copy()
            Kp[0, 0] /= 2
            Kp[1, 1] /= 2
            Kp[0, 2] = (Kp[0, 2] - 108) / 2
            Kp[1, 2] = (Kp[1, 2] - 128) / 2
            return out, Kp
        return out
    if K is not None:
        return im, K
    return im


def map_pattern_to_camera(pattern: np.ndarray, K_proj: np.ndarray,
                          K: np.ndarray, imsize) -> np.ndarray:
    """Reproject the projector-space pattern onto the camera pixel grid
    (the fronto-parallel approximation of the loss pattern)."""
    H, W = imsize
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    grid = np.stack([u.ravel(), v.ravel(), np.ones(u.size)], axis=0)
    mapped = K_proj @ (np.linalg.inv(K) @ grid)
    mapped = mapped / mapped[2]
    x_map = mapped[0].reshape(H, W).astype(np.float32)
    y_map = mapped[1].reshape(H, W).astype(np.float32)
    return remap(pattern, x_map, y_map)
