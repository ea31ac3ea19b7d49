"""OpenCV's dense Farnebäck optical flow, ``cv2.calcOpticalFlowFarneback``
with ``OPTFLOW_FARNEBACK_GAUSSIAN``, in PyTorch on tensors of any device.

G. Farnebäck, "Two-Frame Motion Estimation Based on Polynomial
Expansion" (SCIA 2003). Each frame is expanded into the quadratic
polynomial ``x^T A x + b^T x + c`` about every pixel (a Gaussian-weighted
least-squares fit over a ``(2 poly_n + 1)^2`` neighbourhood); the
displacement ``d`` of a pixel solves ``A d = Δb/2`` averaged over a Gaussian
window, refined ``iterations`` times and coarse to fine over a pyramid.
OpenCV's choices, each held to cv2 by ``tests/test_torch_farneback.py``:

- **pyramid.** Levels run while both sides of ``size * pyr_scale^k`` stay
  at or above 32 pixels: at 512x432 and ``pyr_scale`` 0.5, ``levels`` 4
  runs 3 coarser levels (64x54 to 256x216) and the full size, and at 64x56
  none. Level ``k`` blurs the **full-resolution** frame with a Gaussian of
  sigma ``(1/scale - 1)/2`` and ``max(round(5 sigma) | 1, 3)`` taps
  (BORDER_REFLECT_101; at level 0 sigma 0 gives cv2's fixed 3-tap kernel
  1/4, 1/2, 1/4), then resizes it to ``round(size * scale)`` with
  INTER_LINEAR. The coarser flow is resized with INTER_LINEAR and
  multiplied by ``1/pyr_scale``; the coarsest level starts from zero flow.
- **polynomial expansion.** Separable, edge rows and columns repeated: a
  vertical pass of the weights g, x g and x^2 g in float32, a horizontal
  pass into float64 sums (as cv2's), then the five coefficients
  ``(b_y, b_x, a_yy, a_xx, a_xy)`` from the inverse of the 6x6 moment
  matrix of the applicability g.
- **matrix update.** R1 is sampled bilinearly at ``x + d``, and only where
  all four corners lie inside the image (else its b is 0 and A is R0's
  alone). ``A = (A0 + A1)/2``, ``Δb = (b0 - b1)/2 + A d``; the outer
  five-pixel frame is weighted by 0.14, 0.14, 0.4472, 0.4472, 0.4472
  (product of the x and y factors); then ``A^T A`` and ``A^T Δb``.
- **flow update.** ``A^T A`` and ``A^T Δb`` are blurred by a Gaussian of
  ``winsize // 2`` taps a side and sigma ``0.3 * (winsize // 2)``, edges
  repeated; the 2x2 system is solved in float64 with ``1e-3`` added to its
  determinant. Between iterations the matrices are rebuilt from the new
  flow (cv2 interleaves this by row stripes; every row it rebuilds lies
  outside the window of the rows still to solve, so this is the same).

The filters are sums of shifted slices in cv2's order, not convolutions,
so no cuDNN algorithm choice enters and one input gives one flow on a
device (the card's equals the CPU's bit for bit). Values are float32, and
each step rounds where cv2 rounds: float64 where cv2 sums in double (the
expansion's horizontal pass; the solve, which keeps near-singular 2x2
systems, where ``a_11 a_22 ~ a_12^2``, from cancelling), and a float64
product and sum rounded once where OpenCV's vector code fuses a
multiply-add (the pyramid's blurs, the one-channel resize). So on the CPU
the flow equals cv2's at ``presave_flow``'s parameters, bit for bit but
for values within 1e-28 px of zero.

Frames are expanded once a level and indexed by a pair table, as
``models/flownet.py::flow_all_pairs`` encodes each frame once: a 4-frame
track has 12 ordered pairs but 4 expansions.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..data.imgproc import _gaussian_kernel, _linear_taps

_F32 = np.float32
_MIN_SIZE = 32          # cv2 stops the pyramid where a side falls below it
_BORDER = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], _F32)


def _cv_round(x: float) -> int:
    """cvRound: to the nearest integer, halves to even."""
    return int(np.rint(x))


def pyramid_levels(height: int, width: int, pyr_scale: float,
                   levels: int) -> int:
    """The number of coarser levels cv2 runs for a (height, width) frame."""
    scale = 1.0
    for k in range(levels):
        scale *= pyr_scale
        if width * scale < _MIN_SIZE or height * scale < _MIN_SIZE:
            return k
    return levels


def _poly_weights(n: int, sigma: float):
    """The expansion's float32 weights g, x g, x^2 g at x = 0..n, and the
    entries (1,1), (0,3), (3,3), (5,5) of the inverse moment matrix (cv2's
    FarnebackPrepareGaussian: float32 products, float64 sums)."""
    if sigma < np.finfo(_F32).eps:
        sigma = n * 0.3
    g = np.array([math.exp(-x * x / (2 * sigma * sigma))
                  for x in range(-n, n + 1)], _F32)
    s = 0.0
    for v in g:
        s += float(v)
    g = (g.astype(np.float64) * (1.0 / s)).astype(_F32)
    xs = np.arange(-n, n + 1)
    xg = xs.astype(_F32) * g
    xxg = (xs * xs).astype(_F32) * g
    G = np.zeros((6, 6))
    for y in range(2 * n + 1):
        for x in range(2 * n + 1):
            gg = g[y] * g[x]
            fx, fy = _F32(xs[x]), _F32(xs[y])
            G[0, 0] += float(gg)
            G[1, 1] += float(gg * fx * fx)
            G[3, 3] += float(gg * fx * fx * fx * fx)
            G[5, 5] += float(gg * fx * fx * fy * fy)
    G[2, 2] = G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[3, 4] = G[4, 3] = G[5, 5]
    ig = np.linalg.inv(G)
    return (g[n:], xg[n:], xxg[n:],
            (ig[1, 1], ig[0, 3], ig[3, 3], ig[5, 5]))


def _window_kernel(m: int) -> np.ndarray:
    """The flow update's float32 Gaussian, taps 0..m, sigma 0.3 m."""
    sigma = m * 0.3
    k = [1.0]
    s = 1.0
    for i in range(1, m + 1):
        t = _F32(math.exp(-i * i / (2 * sigma * sigma)))
        k.append(t)
        s += float(t * _F32(2))
    return (np.array(k, np.float64) * (1.0 / s)).astype(_F32)


def _blur_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma, CV_32F), half of it (taps 0..r);
    sigma 0 with 3 taps is cv2's fixed kernel."""
    if sigma <= 0:
        if ksize != 3:
            raise ValueError(f"no fixed Gaussian kernel of {ksize} taps")
        return np.array([0.5, 0.25], _F32)
    return _gaussian_kernel(ksize, sigma)[ksize // 2:]


def _pad(x: torch.Tensor, r: int, axis: int, mode: str) -> torch.Tensor:
    """x (..., H, W) padded by r along axis -2 or -1."""
    if r == 0:
        return x
    pads = (0, 0, r, r) if axis == -2 else (r, r, 0, 0)
    shape = x.shape
    x4 = x.reshape(-1, 1, shape[-2], shape[-1])
    return F.pad(x4, pads, mode=mode).reshape(
        *shape[:-2], x4.shape[-2] + (2 * r if axis == -2 else 0),
        x4.shape[-1] + (2 * r if axis == -1 else 0))


def _shift(xp: torch.Tensor, r: int, i: int, n: int, axis: int):
    """The slice of the r-padded xp at offset i (-r..r) along axis, length
    n."""
    return xp.narrow(axis, r + i, n)


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as OpenCV's vector filters and
    resize compute it (the float64 product of two float32 values is
    exact)."""
    return (a.double() * b + c.double()).float()


def _symmetric_pass(x: torch.Tensor, k, axis: int, mode: str, fused=False):
    """sum_i k[i] (x[-i] + x[+i]) along axis, x * k[0] first, i = 1.. in
    turn (cv2's order); ``fused`` adds each term with one rounding."""
    r = len(k) - 1
    n = x.shape[axis]
    xp = _pad(x, r, axis, mode)
    out = x * float(k[0])
    for i in range(1, r + 1):
        pair = _shift(xp, r, i, n, axis) + _shift(xp, r, -i, n, axis)
        out = (_fma(pair, float(k[i]), out) if fused
               else out + pair * float(k[i]))
    return out


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float):
    """cv2.GaussianBlur(img, (ksize, ksize), sigma, sigma) of (..., H, W)
    float32 images, BORDER_REFLECT_101, rounded as OpenCV's vector filters:
    the row pass of 3 taps is ``fma(x0, k0, (x-1 + x1) k1)``, of 7 or more
    a fused sum of the taps from the left; the column pass a fused sum of
    the symmetric pairs after ``x0 k0``. Bit for bit with cv2 at 3, 9 and
    19 taps (the sizes of ``pyr_scale`` 0.5); at 5 taps cv2's row pass
    sums in another order, and a fifth of the values differ in the last
    bit."""
    k = _blur_kernel(ksize, sigma)
    r = len(k) - 1
    W = img.shape[-1]
    xp = _pad(img, r, -1, "reflect")
    if r == 1:
        rows = _fma(img, float(k[0]),
                    (_shift(xp, 1, -1, W, -1) + _shift(xp, 1, 1, W, -1))
                    * float(k[1]))
    else:
        taps = np.concatenate([k[::-1], k[1:]])
        rows = _shift(xp, r, -r, W, -1) * float(taps[0])
        for j in range(1, 2 * r + 1):
            rows = _fma(_shift(xp, r, j - r, W, -1), float(taps[j]), rows)
    return _symmetric_pass(rows, k, -2, "reflect", fused=True)


def _taps(n_out: int, n_in: int, device):
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                 for t in _linear_taps(n_out, n_in))


def resize_frames(x: torch.Tensor, height: int, width: int):
    """cv2.resize(x, (width, height), interpolation=INTER_LINEAR) of (F, H,
    W) one-channel float32 frames: ``fma(a, p1 - p0, p0)`` along x, then
    along y, at ``data/imgproc.py``'s taps (its ``resize_linear``)."""
    if x.shape[-2:] == (height, width):
        return x
    x0, x1, ax = _taps(width, x.shape[-1], x.device)
    y0, y1, ay = _taps(height, x.shape[-2], x.device)
    p0, p1 = x.index_select(-1, x0), x.index_select(-1, x1)
    rows = _fma(ax, p1 - p0, p0)
    q0, q1 = rows.index_select(-2, y0), rows.index_select(-2, y1)
    return _fma(ay[:, None], q1 - q0, q0)


def resize_flow(flow: torch.Tensor, height: int, width: int):
    """cv2.resize of a two-channel (dx, dy) map, (P, 2, H, W), with
    INTER_LINEAR: ``p0 (1 - a) + p1 a`` along x, then along y (cv2 resizes
    a two-channel float32 map with these weights, not the one-channel
    lerp)."""
    x0, x1, ax = _taps(width, flow.shape[-1], flow.device)
    y0, y1, ay = _taps(height, flow.shape[-2], flow.device)
    rows = flow.index_select(-1, x0) * (1 - ax) + flow.index_select(-1, x1) * ax
    ay = ay[:, None]
    return rows.index_select(-2, y0) * (1 - ay) + rows.index_select(-2, y1) * ay


def poly_exp(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """cv2's FarnebackPolyExp of (F, H, W) float32 frames: (F, 5, H, W),
    the coefficients (b_y, b_x, a_yy, a_xx, a_xy)."""
    g, xg, xxg, (ig11, ig03, ig33, ig55) = _poly_weights(n, sigma)
    H, W = img.shape[-2:]
    # vertical pass, float32: rows of g, x g (odd), x^2 g
    xp = _pad(img, n, -2, "replicate")
    r0 = img * float(g[0])
    r1 = r2 = None
    for k in range(1, n + 1):
        up, dn = _shift(xp, n, -k, H, -2), _shift(xp, n, k, H, -2)
        p = up + dn
        r0 = r0 + p * float(g[k])
        t1 = (dn - up) * float(xg[k])
        t2 = p * float(xxg[k])
        r1 = t1 if r1 is None else r1 + t1
        r2 = t2 if r2 is None else r2 + t2
    # horizontal pass: float32 pair sums and products, float64 sums
    f64 = torch.float64
    q0, q1, q2 = (_pad(r, n, -1, "replicate") for r in (r0, r1, r2))
    b1 = (r0 * float(g[0])).to(f64)
    b3 = (r1 * float(g[0])).to(f64)
    b5 = (r2 * float(g[0])).to(f64)
    b2 = b4 = b6 = 0.0
    for k in range(1, n + 1):
        lo0, hi0 = _shift(q0, n, -k, W, -1), _shift(q0, n, k, W, -1)
        lo1, hi1 = _shift(q1, n, -k, W, -1), _shift(q1, n, k, W, -1)
        lo2, hi2 = _shift(q2, n, -k, W, -1), _shift(q2, n, k, W, -1)
        tg = (hi0 + lo0).to(f64)
        b1 = b1 + tg * float(g[k])
        b4 = b4 + tg * float(xxg[k])
        b2 = b2 + ((hi0 - lo0) * float(xg[k])).to(f64)
        b3 = b3 + ((hi1 + lo1) * float(g[k])).to(f64)
        b6 = b6 + ((hi1 - lo1) * float(xg[k])).to(f64)
        b5 = b5 + ((hi2 + lo2) * float(g[k])).to(f64)
    return torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                        b1 * ig03 + b4 * ig33, b6 * ig55], 1).float()


def _border_weight(H: int, W: int, device) -> torch.Tensor:
    """(H, W): the weight of the outer five-pixel frame, x factor times y
    factor (cv2's order of products: ((x_lo x_hi) y_lo) y_hi)."""
    wx_lo, wy_lo = np.ones(W, _F32), np.ones(H, _F32)
    wx_hi, wy_hi = np.ones(W, _F32), np.ones(H, _F32)
    b = len(_BORDER)
    wx_lo[:b], wy_lo[:b] = _BORDER, _BORDER
    wx_hi[W - b:], wy_hi[H - b:] = _BORDER[::-1], _BORDER[::-1]
    wx = wx_lo * wx_hi
    w = ((wx[None, :] * wy_lo[:, None]) * wy_hi[:, None]).astype(_F32)
    return torch.from_numpy(w).to(device)


def update_matrices(R0: torch.Tensor, R1: torch.Tensor,
                    flow: torch.Tensor, border: torch.Tensor):
    """cv2's FarnebackUpdateMatrices for (P, 5, H, W) expansions and (P, 2,
    H, W) flow (dx, dy): (P, 5, H, W), the entries (1,1), (1,2), (2,2) of
    A^T A and A^T Δb."""
    P, _, H, W = R0.shape
    dev = flow.device
    xs = torch.arange(W, device=dev, dtype=torch.float32)
    ys = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    dx, dy = flow[:, 0], flow[:, 1]
    fx, fy = xs + dx, ys + dy
    x1, y1 = torch.floor(fx), torch.floor(fy)
    fx, fy = fx - x1, fy - y1
    inside = (x1 >= 0) & (x1 < W - 1) & (y1 >= 0) & (y1 < H - 1)
    zero = torch.zeros((), device=dev)
    base = torch.where(inside, y1 * W + x1, zero).long().reshape(P, 1, -1)
    base = base.expand(P, 5, H * W)
    flat = R1.reshape(P, 5, H * W)

    def corner(off):
        return flat.gather(2, base + off).reshape(P, 5, H, W)

    a00 = ((1 - fx) * (1 - fy))[:, None]
    a01 = (fx * (1 - fy))[:, None]
    a10 = ((1 - fx) * fy)[:, None]
    a11 = (fx * fy)[:, None]
    s = (a00 * corner(0) + a01 * corner(1)) + a10 * corner(W)
    s = s + a11 * corner(W + 1)
    r0 = [R0[:, c] for c in range(5)]
    r2 = torch.where(inside, s[:, 0], zero)
    r3 = torch.where(inside, s[:, 1], zero)
    r4 = torch.where(inside, (r0[2] + s[:, 2]) * 0.5, r0[2])
    r5 = torch.where(inside, (r0[3] + s[:, 3]) * 0.5, r0[3])
    r6 = torch.where(inside, (r0[4] + s[:, 4]) * 0.25, r0[4] * 0.5)
    r2 = (r0[0] - r2) * 0.5
    r3 = (r0[1] - r3) * 0.5
    r2 = r2 + (r4 * dy + r6 * dx)
    r3 = r3 + (r6 * dy + r5 * dx)
    r2, r3, r4, r5, r6 = (r * border for r in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3, r6 * r2 + r5 * r3], 1)


def update_flow(M: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """cv2's FarnebackUpdateFlow_GaussianBlur without the matrix update:
    (P, 5, H, W) matrices blurred (columns, then rows; edges repeated) and
    solved, (P, 2, H, W) flow (dx, dy)."""
    h = _symmetric_pass(_symmetric_pass(M, kernel, -2, "replicate"), kernel,
                        -1, "replicate").double()
    g11, g12, g22, h1, h2 = h.unbind(1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet,
                        (g22 * h1 - g12 * h2) * idet], 1).float()


def farneback(frames: torch.Tensor, src, dst, *, pyr_scale: float = 0.5,
              levels: int = 4, winsize: int = 21, iterations: int = 5,
              poly_n: int = 7, poly_sigma: float = 1.5) -> torch.Tensor:
    """Dense Farnebäck flow from ``frames[src[p]]`` to ``frames[dst[p]]``.

    frames: (F, H, W), uint8 or float32 grey values (cv2's 0..255 scale);
    src, dst: P frame indices each. Returns (P, 2, H, W) float32 flow,
    channel 0 along x, on frames' device; pixel ``x`` of the first frame
    moves to ``x + flow``. The defaults are the JAX ``presave_flow``'s
    cv2 call (pyr_scale 0.5, levels 4, winsize 21, iterations 5, poly_n 7,
    poly_sigma 1.5).
    """
    if frames.dim() != 3:
        raise ValueError(f"frames must be (F, H, W), got {tuple(frames.shape)}")
    if frames.dtype == torch.uint8:
        frames = frames.float()
    elif frames.dtype != torch.float32:
        raise TypeError(f"frames must be uint8 or float32, got {frames.dtype}")
    if not 0 < pyr_scale < 1 or winsize < 1 or iterations < 1 or poly_n < 1:
        raise ValueError("needs 0 < pyr_scale < 1 and winsize, iterations, "
                         "poly_n >= 1")
    _, H, W = frames.shape
    if min(H, W) < 2 * len(_BORDER):
        raise ValueError(f"frames of {H}x{W} are below 10 pixels a side")
    dev = frames.device
    src = torch.as_tensor(src, dtype=torch.long, device=dev).reshape(-1)
    dst = torch.as_tensor(dst, dtype=torch.long, device=dev).reshape(-1)
    kernel = _window_kernel(winsize // 2)
    flow = None
    for k in range(pyramid_levels(H, W, pyr_scale, levels), -1, -1):
        scale = 1.0
        for _ in range(k):
            scale *= pyr_scale
        sigma = (1.0 / scale - 1) * 0.5
        ksize = max(_cv_round(sigma * 5) | 1, 3)
        h, w = _cv_round(H * scale), _cv_round(W * scale)
        if flow is None:
            flow = torch.zeros(src.numel(), 2, h, w, device=dev)
        else:
            flow = resize_flow(flow, h, w) * (1.0 / pyr_scale)
        img = resize_frames(gaussian_blur(frames, ksize, sigma), h, w)
        R = poly_exp(img, poly_n, poly_sigma)
        R0, R1 = R.index_select(0, src), R.index_select(0, dst)
        border = _border_weight(h, w, dev)
        M = update_matrices(R0, R1, flow, border)
        for it in range(iterations):
            flow = update_flow(M, kernel)
            if it < iterations - 1:
                M = update_matrices(R0, R1, flow, border)
    return flow
