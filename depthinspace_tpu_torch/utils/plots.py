"""The workers' debug images without matplotlib, which the card machine
does not have: the 2x3 panel grid of ``Worker.write_debug_image`` and the
loss curves of ``errs.png`` (``depthinspace_tpu/train/worker.py``), as
uint8 RGB arrays for ``data/imgproc.py::write_png``. The titles and the
legend that matplotlib draws go to the caller's log line instead."""

from __future__ import annotations

import numpy as np

from . import cmap

# matplotlib's first default line colours (tab10), RGB
SERIES_COLORS = ((31, 119, 180), (255, 127, 14), (44, 160, 44),
                 (214, 39, 40), (148, 103, 189), (140, 86, 75),
                 (227, 119, 194), (127, 127, 127))


def gray(x: np.ndarray) -> np.ndarray:
    """(H, W) values -> (H, W, 3) uint8 gray, scaled from the values' min
    to their max (what imshow does with a gray colormap)."""
    lo, hi = float(np.min(x)), float(np.max(x))
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    g = np.clip((x.astype(np.float64) - lo) * scale + 0.5, 0, 255)
    return np.repeat(g.astype(np.uint8)[..., None], 3, axis=2)


def debug_grid(im, amb, gt, es) -> tuple[np.ndarray, list[str]]:
    """The 2x3 grid of one frame, (2H, 3W, 3) uint8 RGB, and its panel
    titles: IR and ambient in gray; GT and estimate through
    ``color_depth_map`` at vmax = max(1.2 max(GT), 16); the error through
    ``color_error_image``; the absolute error in gray (the JAX worker's
    last panel is matplotlib's viridis)."""
    diff = np.abs(es - gt)
    vmax = max(float(np.nanmax(gt)) * 1.2, 16.0)
    panels = [gray(im), gray(amb),
              cmap.color_depth_map(gt, scale=vmax)[..., ::-1],
              cmap.color_depth_map(es, scale=vmax)[..., ::-1],
              cmap.color_error_image(diff, BGR=False).astype(np.uint8),
              gray(diff)]
    titles = ["IR input", "Ambient", "Disp GT",
              f"Disp est {es.min():.2f}/{es.max():.2f}",
              f"err {diff.mean():.4f}", "abs err"]
    grid = np.concatenate([np.concatenate(panels[:3], axis=1),
                           np.concatenate(panels[3:], axis=1)], axis=0)
    return grid, titles


def _line(canvas, x0, y0, x1, y1, color) -> None:
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.rint(np.linspace(x0, x1, n + 1)).astype(int)
    ys = np.rint(np.linspace(y0, y1, n + 1)).astype(int)
    ok = ((xs >= 0) & (xs < canvas.shape[1]) & (ys >= 0)
          & (ys < canvas.shape[0]))
    canvas[ys[ok], xs[ok]] = color


def loss_curves(series: dict, width: int = 800, height: int = 600,
                margin: int = 40) -> tuple[np.ndarray, str]:
    """``series``: label -> (epochs, total losses). Returns the (height,
    width, 3) uint8 RGB plot, a polyline with a 3x3 marker at each point
    per series in its own colour inside a black frame, and its legend and
    axis ranges as text."""
    canvas = np.full((height, width, 3), 255, np.uint8)
    xs = np.concatenate([np.asarray(v[0], np.float64)
                         for v in series.values()])
    ys = np.concatenate([np.asarray(v[1], np.float64)
                         for v in series.values()])
    x0, x1 = float(xs.min()), float(xs.max())
    y0, y1 = float(ys.min()), float(ys.max())
    if x1 == x0:
        x0, x1 = x0 - 1, x1 + 1
    pad = 0.05 * (y1 - y0) if y1 > y0 else max(abs(y0), 1.0) * 0.05
    y0, y1 = y0 - pad, y1 + pad
    left, right, top, bottom = margin, width - margin, margin, height - margin
    for a, b, c, d in ((left, top, right, top), (left, bottom, right, bottom),
                       (left, top, left, bottom), (right, top, right, bottom)):
        _line(canvas, a, b, c, d, (0, 0, 0))

    def px(x, y):
        return (left + (x - x0) / (x1 - x0) * (right - left),
                bottom - (y - y0) / (y1 - y0) * (bottom - top))

    legend = []
    for i, (label, (ex, ey)) in enumerate(sorted(series.items())):
        color = SERIES_COLORS[i % len(SERIES_COLORS)]
        pts = [px(float(x), float(y)) for x, y in zip(ex, ey)]
        for (a, b), (c, d) in zip(pts, pts[1:]):
            _line(canvas, a, b, c, d, color)
        for a, b in pts:
            r, c = int(round(b)), int(round(a))
            canvas[max(r - 1, 0):r + 2, max(c - 1, 0):c + 2] = color
        legend.append(f"{label} rgb{color}")
    text = (f"x: epoch {x0:g}..{x1:g}, y: total loss {y0:.5g}..{y1:.5g}; "
            + ", ".join(legend))
    return canvas, text
