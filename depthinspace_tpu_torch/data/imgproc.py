"""The cv2 image functions of the dataset tools, in numpy: the bilinear
resampling of ``cv2.remap`` and ``cv2.warpAffine`` (INTER_LINEAR,
BORDER_CONSTANT 0) and of ``cv2.resize`` (INTER_LINEAR),
``cv2.GaussianBlur`` (BORDER_REFLECT_101), ``cv2.blur`` (BORDER_REFLECT)
and ``cv2.Sobel`` with ksize 5 (CV_32F, BORDER_REFLECT_101), on 2-D images
(``remap`` and ``resize_linear`` also on channels); and ``read_png``,
``cv2.imread`` of a PNG file in numpy and ``zlib``.

Each follows OpenCV 5's code where it decides the last bit:

- on float32 images the bilinear paths take float coordinates, not the
  1/32 px grid of OpenCV 4 (INTER_BITS = 5): with ``ix = floor(x)`` and
  ``a = x - ix`` the value is ``fma(b, w - v, v)`` of the row lerps ``v =
  fma(a, p01 - p00, p00)``, ``w = fma(a, p11 - p10, p10)``, corners
  outside the image 0. ``warpAffine`` inverts the matrix in double, rounds
  it to float32 and computes a source column as ``x + (y*M1 + M2)`` in its
  vector loop of 16 columns and ``(x + y*M1) + M2`` in the scalar tail.
  These match cv2 bit for bit;
- on float64 images ``warpAffine`` keeps the fixed-point path: source
  coordinates on the 1/32 px grid, weights of that grid, sums in double
  (bit for bit);
- the separable filters sum a 5-tap symmetric row or column as
  ``fma(s2 + s-2, k2, fma(s1 + s-1, k1, s0 * k0))`` and an antisymmetric
  one as ``fma(s2 - s-2, k2, (s1 - s-1) * k1)``. This is cv2's column pass
  and antisymmetric row pass bit for bit; its symmetric row pass rounds
  otherwise on 10-25 % of pixels, by one float32 ulp;
- the box filter sums in double, as cv2 does for float32 (bit for bit);
- ``resize`` of float32 takes the same lerps, along x and then along y,
  at the source coordinate ``(d + 0.5) * in / out - 0.5`` in double, edge
  pixels repeated: bit for bit at the 2x downscale of real captures, and
  within one float32 ulp on a few pixels in 10^4 elsewhere.

``fma`` is float32's fused multiply-add, computed in float64 and rounded
once.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_F32 = np.float32
# columns of OpenCV's vector loop in warpAffine (2 x 8 float32 lanes); the
# rest of a row takes the scalar formula
_WARP_VECTOR_COLS = 16


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c with one rounding (the float64 product of two
    float32 values is exact)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def remap(src: np.ndarray, map_x: np.ndarray,
          map_y: np.ndarray) -> np.ndarray:
    """cv2.remap(src, map_x, map_y, INTER_LINEAR, BORDER_CONSTANT, 0):
    ``src`` (H, W) or (H, W, C) float32 sampled at float32 coordinates
    (any shape), corners outside the image 0, each channel alike.
    Non-finite coordinates sample 0."""
    src = np.asarray(src, _F32)
    if src.ndim == 3:
        return np.stack([remap(src[..., c], map_x, map_y)
                         for c in range(src.shape[2])], axis=-1)
    H, W = src.shape
    x = np.asarray(map_x, _F32)
    y = np.asarray(map_y, _F32)
    # any coordinate beyond the 1-pixel rim has all four corners outside
    x = np.where(np.isfinite(x), np.clip(x, -2, W + 1), -2).astype(_F32)
    y = np.where(np.isfinite(y), np.clip(y, -2, H + 1), -2).astype(_F32)
    fx, fy = np.floor(x), np.floor(y)
    a, b = x - fx, y - fy
    ix, iy = fx.astype(np.int64) + 2, fy.astype(np.int64) + 2
    pad = np.zeros((H + 5, W + 5), _F32)
    pad[2:H + 2, 2:W + 2] = src
    p00, p01 = pad[iy, ix], pad[iy, ix + 1]
    p10, p11 = pad[iy + 1, ix], pad[iy + 1, ix + 1]
    v = _fma(a, p01 - p00, p00)
    w = _fma(a, p11 - p10, p10)
    return _fma(b, w - v, v)


def warp_affine(src: np.ndarray, T: np.ndarray) -> np.ndarray:
    """cv2.warpAffine(src, T, (W, H)) for a 2x3 ``T`` whose rows are (1, a,
    b) and (0, 1, 0) (a shear and shift along x): INTER_LINEAR,
    BORDER_CONSTANT 0. The output pixel (x, y) samples ``src`` at x - a y -
    b. A float32 ``src`` takes OpenCV 5's float path, a float64 one the
    fixed-point path that OpenCV keeps for it: the source column on a grid
    of 1/32 px, ``(round(1024 (-a y - b)) + 16 + 1024 x) >> 5`` in 1/32
    units, and the bilinear weights of that grid, summed in double."""
    src = np.asarray(src)
    H, W = src.shape
    T = np.asarray(T, np.float64)
    if (T[0, 0] != 1 or T[1, 0] != 0 or T[1, 1] != 1 or T[1, 2] != 0):
        raise ValueError("warp_affine takes shears and shifts along x only")
    # cv2.invertAffineTransform, in double
    M1, M2 = -T[0, 1], -T[0, 2]
    if src.dtype == np.float64:
        return _warp_shear_fixed(src, M1, M2)
    src = src.astype(_F32, copy=False)
    M1, M2 = _F32(M1), _F32(M2)
    X = np.arange(W, dtype=_F32)[None, :]
    Y = np.arange(H, dtype=_F32)[:, None]
    yM1 = Y * M1
    sx = np.empty((H, W), _F32)
    nv = W - W % _WARP_VECTOR_COLS
    sx[:, :nv] = X[:, :nv] + (yM1 + M2)
    sx[:, nv:] = (X[:, nv:] + yM1) + M2
    return remap(src, sx, np.broadcast_to(Y, (H, W)))


def _warp_shear_fixed(src: np.ndarray, M1: float, M2: float) -> np.ndarray:
    """OpenCV's fixed-point warpAffine of a float64 image for the inverse
    map x' = x + M1 y + M2, y' = y."""
    H, W = src.shape
    y = np.arange(H, dtype=np.float64)
    X0 = np.rint((M1 * y + M2) * 1024).astype(np.int64) + 16
    X = (X0[:, None] + 1024 * np.arange(W, dtype=np.int64)[None, :]) >> 5
    ix, fx = X >> 5, X & 31
    w1 = fx.astype(np.float64) / 32
    w0 = 1.0 - w1
    pad = np.zeros((H, W + 3), np.float64)
    pad[:, 1:W + 1] = src
    j = np.clip(ix, -1, W) + 1
    far = (ix < -1) | (ix >= W)                 # both corners outside
    rows = np.arange(H)[:, None]
    out = pad[rows, j] * w0 + pad[rows, j + 1] * w1
    return np.where(far, 0.0, out)


def _pad_reflect101(x: np.ndarray, r: int) -> np.ndarray:
    return np.pad(x, r, mode="reflect")          # numpy reflect = cv2 101


def _symm5(x: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    """The symmetric 5-tap filter ``k`` (k[2] the centre) along ``axis`` of
    an array padded by 2 on it."""
    n = x.shape[axis] - 4
    s = [np.take(x, range(i, i + n), axis=axis) for i in range(5)]
    k = k.astype(_F32)
    return _fma(s[4] + s[0], k[0], _fma(s[3] + s[1], k[1], s[2] * k[2]))


def _anti5(x: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    """The antisymmetric 5-tap filter ``k`` (k[2] = 0) along ``axis``."""
    n = x.shape[axis] - 4
    s = [np.take(x, range(i, i + n), axis=axis) for i in range(5)]
    k = k.astype(_F32)
    return _fma(s[4] - s[0], k[4], (s[3] - s[1]) * k[3])


def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma, CV_32F) for sigma > 0."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-x * x / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(_F32)


def gaussian_blur5(x: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(x, (5, 5), sigma) for a 2-D float32 image."""
    k = _gaussian_kernel(5, sigma)
    xp = _pad_reflect101(np.asarray(x, _F32), 2)
    return _symm5(_symm5(xp, k, 1), k, 0)


def box_blur_reflect(x: np.ndarray, k: int) -> np.ndarray:
    """cv2.blur(x, (k, k), borderType=BORDER_REFLECT), k odd: the mean over
    a k x k window, summed in double, edge pixels repeated at the border."""
    r = k // 2
    xp = np.pad(np.asarray(x, np.float64), r, mode="symmetric")
    c = np.cumsum(np.pad(xp, ((1, 0), (1, 0))), axis=0).cumsum(axis=1)
    H, W = np.shape(x)
    s = c[k:k + H, k:k + W] - c[:H, k:k + W] - c[k:k + H, :W] + c[:H, :W]
    return (s * (1.0 / (k * k))).astype(_F32)


_SOBEL5_D = np.array([-1, -2, 0, 2, 1], np.float32)
_SOBEL5_S = np.array([1, 4, 6, 4, 1], np.float32)


def sobel5(x: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """cv2.Sobel(x, CV_32F, dx, dy, ksize=5) with (dx, dy) = (1, 0) or
    (0, 1), BORDER_REFLECT_101."""
    xp = _pad_reflect101(np.asarray(x, _F32), 2)
    if (dx, dy) == (1, 0):
        return _symm5(_anti5(xp, _SOBEL5_D, 1), _SOBEL5_S, 0)
    if (dx, dy) == (0, 1):
        return _anti5(_symm5(xp, _SOBEL5_S, 1), _SOBEL5_D, 0)
    raise ValueError("sobel5 takes (dx, dy) = (1, 0) or (0, 1)")


def _linear_taps(n_out: int, n_in: int):
    """Source index pairs and float32 weights of cv2.resize's INTER_LINEAR
    along one axis: the edge pixel repeated beyond either end."""
    f = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(f).astype(np.int64)
    a = (f - i0).astype(_F32)
    a[i0 < 0] = 0
    i0[i0 < 0] = 0
    a[i0 >= n_in - 1] = 0
    i0[i0 >= n_in - 1] = n_in - 1
    return i0, np.minimum(i0 + 1, n_in - 1), a


def resize_linear(src: np.ndarray, dsize) -> np.ndarray:
    """cv2.resize(src, dsize, interpolation=INTER_LINEAR) for a float32
    ``src`` of shape (H, W) or (H, W, C); ``dsize`` is (width, height), as
    cv2 takes it. Each output is ``fma(a, p1 - p0, p0)`` along x, then the
    same along y (module docstring)."""
    src = np.asarray(src, _F32)
    w, h = dsize
    x0, x1, ax = _linear_taps(w, src.shape[1])
    y0, y1, ay = _linear_taps(h, src.shape[0])
    chan = (None,) * (src.ndim - 2)
    p0, p1 = src[:, x0], src[:, x1]
    rows = _fma(ax[(None, slice(None)) + chan], p1 - p0, p0)
    q0, q1 = rows[y0], rows[y1]
    return _fma(ay[(slice(None), None) + chan], q1 - q0, q0)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples a pixel per PNG colour type: gray, RGB, palette, gray + alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_unfilter(raw: bytes, height: int, stride: int,
                  bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters (None, Sub, Up, Average, Paeth) of
    ``height`` rows of ``stride`` bytes, ``bpp`` bytes a filter unit.

    A byte depends on the one ``bpp`` to its left and the two above, so the
    rows are reconstructed together along anti-diagonals of filter units:
    H + W steps, each over every row's unit on the diagonal."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size < height * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = rows[:height * (stride + 1)].reshape(height, stride + 1)
    types = rows[:, 0].astype(np.int64)
    if types.max(initial=0) > 4:
        raise ValueError(f"PNG filter type {types.max()} is not defined")
    n = stride // bpp
    filt = rows[:, 1:].reshape(height, n, bpp).astype(np.int32)
    # one zero row above and one zero unit to the left of the image
    out = np.zeros((height + 1, n + 1, bpp), np.int32)
    for t in range(height + n - 1):
        y = np.arange(max(0, t - n + 1), min(height, t + 1))
        x = t - y
        a = out[y + 1, x]                        # left
        b = out[y, x + 1]                        # above
        c = out[y, x]                            # above left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        kind = types[y][:, None]
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (filt[y, x] + pred) & 255
    return out[1:, 1:].reshape(height, stride).astype(np.uint8)


def read_png(path) -> np.ndarray:
    """cv2.imread(path) (IMREAD_COLOR) of a PNG file: (H, W, 3) uint8 in
    BGR order. Gray is repeated to 3 channels, alpha dropped, a palette
    looked up, 16-bit samples cut to their high byte and 1-, 2- and 4-bit
    gray scaled to 0..255, as cv2 does. Raises FileNotFoundError for a
    missing file and ValueError for a file that is not a PNG this reader
    takes (Adam7-interlaced files among them)."""
    try:
        data = Path(path).read_bytes()
    except (FileNotFoundError, IsADirectoryError):
        raise FileNotFoundError(path) from None
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header, palette = 8, [], None, None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: Adam7-interlaced PNG files are not read")
    if ctype not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"{path}: PNG colour type {ctype}, bit depth "
                         f"{depth} are not read")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    channels = _PNG_CHANNELS[ctype]
    bits = channels * depth
    stride = (width * bits + 7) // 8
    rows = _png_unfilter(zlib.decompress(b"".join(idat)), height, stride,
                         max(1, bits // 8))
    if depth == 16:
        samples = rows[:, 0::2].reshape(height, width, channels)
    elif depth == 8:
        samples = rows.reshape(height, width, channels)
    else:                                        # one channel, packed bits
        per_byte = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        unpacked = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        samples = unpacked.reshape(height, stride * per_byte)[:, :width, None]
        if ctype == 0:
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        if samples.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: palette index beyond PLTE")
        rgb = palette[samples[..., 0]]
    elif ctype in (0, 4):
        rgb = np.repeat(samples[..., :1], 3, axis=2)
    else:
        rgb = samples[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])
