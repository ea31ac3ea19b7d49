"""data/patterns.py and the cv2 stand-ins it rests on (data/imgproc.py's
read_png, resize_linear and the channel remap) against cv2 and the JAX
package's data/patterns.py, on seeded numpy inputs and on PNG files the
test writes with zlib.

Tolerances: read_png, the remap and resize_linear's 2x downscale (the
real-capture post-processing) are bit for bit; resize_linear's other
scales within 1e-6 on [0, 1] images (one float32 ulp on a few pixels in
10^4, where cv2's weights round otherwise)."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from depthinspace_tpu.data import patterns as ref
from depthinspace_tpu_torch.data import imgproc, patterns as port

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered(rows, bpp, types):
    """Scanlines of raw bytes filtered with types[y % len(types)]."""
    out, prev = [], bytes(len(rows[0]))
    for y, row in enumerate(rows):
        t = types[y % len(types)]
        f = bytearray(len(row))
        for i in range(len(row)):
            a = row[i - bpp] if i >= bpp else 0
            c = prev[i - bpp] if i >= bpp else 0
            b = prev[i]
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[t]
            f[i] = (row[i] - pred) & 255
        out.append(bytes([t]) + bytes(f))
        prev = row
    return b"".join(out)


def write_png(path, rows, width, height, depth, ctype, types, palette=None,
              interlace=0):
    bits = CHANNELS[ctype] * depth
    data = _filtered(rows, max(1, bits // 8), types)
    png = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, height, depth, ctype, 0, 0, interlace))
    if palette is not None:
        png += _chunk(b"PLTE", palette)
    # two IDAT chunks: the reader must join them
    z = zlib.compress(data)
    png += _chunk(b"IDAT", z[:len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:])
    png += _chunk(b"IEND", b"")
    path.write_bytes(png)


def _rows(rng, width, height, depth, ctype):
    """Random scanlines (bytes) of an image of this colour type and depth."""
    if depth < 8:
        hi = min(1 << depth, 5) if ctype == 3 else 1 << depth
        v = rng.randint(0, hi, (height, width))
        per = 8 // depth
        v = np.pad(v, ((0, 0), (0, -width % per)))
        packed = sum(v[:, k::per] << (8 - depth * (k + 1)) for k in range(per))
        return [r.astype(np.uint8).tobytes() for r in packed]
    if ctype == 3:
        return [r.tobytes() for r in rng.randint(0, 5, (height, width))
                .astype(np.uint8)]
    dt = np.uint8 if depth == 8 else np.dtype(">u2")
    v = rng.randint(0, 1 << depth, (height, width * CHANNELS[ctype]))
    return [r.astype(dt).tobytes() for r in v]


PNG_KINDS = ([(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16)]
             + [(3, d) for d in (1, 2, 4, 8)] + [(4, 8), (4, 16), (6, 8),
                                                 (6, 16)])


@pytest.mark.parametrize("ctype,depth", PNG_KINDS)
def test_read_png_matches_cv2_imread(tmp_path, ctype, depth):
    """Every colour type and bit depth, each with every filter type alone
    and all five mixed: BGR uint8 as cv2.imread gives it."""
    rng = np.random.RandomState(ctype * 100 + depth)
    width, height = 13, 7
    rows = _rows(rng, width, height, depth, ctype)
    palette = (rng.randint(0, 256, 15).astype(np.uint8).tobytes()
               if ctype == 3 else None)
    for types in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
        p = tmp_path / f"t{''.join(map(str, types))}.png"
        write_png(p, rows, width, height, depth, ctype, types, palette)
        want = cv2.imread(str(p))
        got = imgproc.read_png(p)
        assert want is not None
        assert got.dtype == np.uint8 and got.shape == (height, width, 3)
        np.testing.assert_array_equal(got, want, err_msg=f"filters {types}")


def test_read_png_refuses_what_it_does_not_read(tmp_path):
    rng = np.random.RandomState(0)
    p = tmp_path / "i.png"
    write_png(p, _rows(rng, 8, 4, 8, 2), 8, 4, 8, 2, [0], interlace=1)
    with pytest.raises(ValueError, match="Adam7"):
        imgproc.read_png(p)
    (tmp_path / "x.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        imgproc.read_png(tmp_path / "x.png")
    with pytest.raises(FileNotFoundError):
        port.read_pattern_file(tmp_path / "missing.png")


@pytest.mark.parametrize("shape", [(1024, 864), (1024, 864, 3), (40, 30)])
def test_resize_linear_halving_is_cv2_bit_for_bit(shape):
    rng = np.random.RandomState(len(shape))
    x = (rng.rand(*shape) * rng.choice([1e-3, 1, 100], size=shape)).astype(
        np.float32)
    dsize = (shape[1] // 2, shape[0] // 2)
    want = cv2.resize(x, dsize, interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(imgproc.resize_linear(x, dsize), want)


@pytest.mark.parametrize("src,dst", [((97, 61), (40, 33)),
                                     ((50, 70), (113, 151)),
                                     ((300, 300), (1024, 1024)),
                                     ((256, 256), (4096, 4096))])
@pytest.mark.parametrize("channels", [None, 3])
def test_resize_linear_matches_cv2(src, dst, channels):
    rng = np.random.RandomState(src[0])
    shape = src if channels is None else src + (channels,)
    x = rng.rand(*shape).astype(np.float32)
    dsize = (dst[1], dst[0])
    want = cv2.resize(x, dsize, interpolation=cv2.INTER_LINEAR)
    got = imgproc.resize_linear(x, dsize)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_remap_of_channels_is_cv2_bit_for_bit():
    rng = np.random.RandomState(4)
    pat = rng.rand(300, 280, 3).astype(np.float32)
    mx = (rng.rand(64, 56) * 320 - 10).astype(np.float32)
    my = (rng.rand(64, 56) * 320 - 10).astype(np.float32)
    want = cv2.remap(pat, mx, my, cv2.INTER_LINEAR)
    np.testing.assert_array_equal(imgproc.remap(pat, mx, my), want)


@pytest.mark.parametrize("pattern_type", ["default", "kinect", "real"])
def test_read_pattern_file_matches_jax_package(tmp_path, pattern_type):
    """An RGB pattern PNG of 40 x 52 (rows x columns): default flips and
    turns it, kinect crops the centre square and resizes it to 96 x 96,
    real keeps it."""
    rng = np.random.RandomState(5)
    p = tmp_path / "pattern.png"
    write_png(p, _rows(rng, 52, 40, 8, 2), 52, 40, 8, 2, [0, 1, 2, 3, 4])
    got = port.read_pattern_file(p, pattern_type, (96, 96))
    want = ref.read_pattern_file(p, pattern_type, (96, 96))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.flags["C_CONTIGUOUS"]
    if pattern_type == "kinect":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_post_process_matches_jax_package():
    rng = np.random.RandomState(6)
    K = np.array([[1112.18, 0, 517.09], [0, 1112.18, 649.63], [0, 0, 1]],
                 np.float32)
    for shape in ((1280, 1080), (1280, 1080, 3)):
        im = rng.rand(*shape).astype(np.float32)
        got, got_K = port.post_process("real", im, K)
        want, want_K = ref.post_process("real", im, K)
        assert got.shape == want.shape == (512, 432) + shape[2:]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_K, want_K)
        np.testing.assert_array_equal(port.post_process("real", im),
                                      ref.post_process("real", im))
        assert port.post_process("default", im) is im
        assert port.post_process("default", im, K)[1] is K


def test_map_pattern_to_camera_matches_jax_package():
    """A 3-channel projector pattern reprojected onto a smaller camera, as
    the generator's settings.pkl pattern is made."""
    from depthinspace_tpu_torch.data.synthetic import make_dot_pattern
    pattern = make_dot_pattern(256, 256, n_dots=256 * 256 // 48)
    K_proj = np.array([[98.9, 0, 127.5], [0, 98.9, 127.5], [0, 0, 1]],
                      np.float32)
    K = np.array([[54.4, 0, 28], [0, 54.4, 32], [0, 0, 1]], np.float32)
    got = port.map_pattern_to_camera(pattern, K_proj, K, (64, 56))
    want = ref.map_pattern_to_camera(pattern, K_proj, K, (64, 56))
    assert got.shape == (64, 56, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
