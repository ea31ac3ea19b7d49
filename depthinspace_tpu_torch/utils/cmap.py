"""Debug-image colormaps, port of ``depthinspace_tpu/utils/cmap.py`` (the
JAX module is numpy alone; this package keeps its own copy): the
log-scaled error map and the piecewise-linear depth map of the reference's
debug grids, bit for bit."""

from __future__ import annotations

import numpy as np

_ERROR_COLORS = np.array([
    [149, 54, 49], [180, 117, 69], [209, 173, 116], [233, 217, 171],
    [248, 243, 224], [144, 224, 254], [97, 174, 253], [67, 109, 244],
    [39, 48, 215], [38, 0, 165], [38, 0, 165]], dtype=np.float64)

_DEPTH_COLORS = np.array([
    [0, 0, 0], [0, 0, 255], [255, 0, 0], [255, 0, 255], [0, 255, 0],
    [0, 255, 255], [255, 255, 0], [255, 255, 255], [255, 255, 255]],
    dtype=np.float64)

_DEPTH_CENTERS = np.array(
    [0.0, 0.114, 0.299, 0.413, 0.587, 0.701, 0.886, 1.000, 2.000])


def color_error_image(errors: np.ndarray, scale: float = 1.2,
                      log_scale: float = 0.25, mask=None,
                      BGR: bool = True) -> np.ndarray:
    """HxW error map -> HxWx3 colors (int), a color step per log2 of the
    error; ``mask`` == 0 is white."""
    flat = errors.flatten()
    idx = np.clip(np.log2(flat / scale + 1e-5) / log_scale + 5, 0, 9)
    i0 = np.floor(idx).astype(int)
    frac = (idx - i0).reshape(-1, 1)
    colors = _ERROR_COLORS[i0] * (1 - frac) + _ERROR_COLORS[i0 + 1] * frac
    if mask is not None:
        colors[mask.flatten() == 0] = 255
    if not BGR:
        colors = colors[:, [2, 1, 0]]
    return colors.reshape(*errors.shape, 3).astype(int)


def color_depth_map(depths: np.ndarray, scale=None) -> np.ndarray:
    """HxW depth map -> HxWx3 uint8 colors (BGR) by piecewise-linear
    bins of ``depths / scale`` (``scale`` None: the maximum)."""
    if scale is None:
        scale = depths.max()
    vals = np.clip(depths.flatten() / scale, 0, 1)
    lower = ((vals.reshape(-1, 1) >= _DEPTH_CENTERS.reshape(1, -1))
             * np.arange(9)).max(axis=1)
    lo, hi = _DEPTH_CENTERS[lower], _DEPTH_CENTERS[lower + 1]
    alpha = ((vals - lo) / (hi - lo)).reshape(-1, 1)
    colors = _DEPTH_COLORS[lower] * (1 - alpha) + _DEPTH_COLORS[lower + 1] * alpha
    return colors.reshape(*depths.shape, 3).astype(np.uint8)
