"""Zstandard decompression for the checkpoint reader: a ctypes binding of
``native/zstd_decode.cpp``, a decoder of zstd frames (RFC 8878) written for
this package, since Python has no zstd module and the machine with the card
has no ``zstandard`` package.

The library is built from the source with ``g++`` at first use, into
``build/zstd/<hash>/libdis_zstd.so`` at the repository root
(``utils/cbuild.py``, as the renderer is built). A failed build raises with
the compiler's output; there is no Python fallback.

``decompress(data)`` decodes every frame of ``data`` (concatenated and
skippable frames included) straight into one numpy ``uint8`` array: the
input is passed to the decoder without a copy, and the output is allocated
once, at the size the frames' headers state (or at a bound from their block
headers when a frame states none, then sliced). A frame's checksum, when it
has one, is verified. A frame that names a dictionary, and a corrupt or
truncated input, raise :class:`ZstdError` with the byte offset at which
decoding failed.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from . import cbuild

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = Path(__file__).resolve().parents[1] / "native" / "zstd_decode.cpp"
BUILD_ROOT = _ROOT / "build" / "zstd"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIB_NAME = "libdis_zstd.so"

_lib = None


class ZstdError(ValueError):
    """A corrupt, truncated or unsupported zstd input."""


def library_path() -> Path:
    return cbuild.library_path(SOURCE, BUILD_ROOT, LIB_NAME, CXX_FLAGS)


def build() -> tuple[Path, float]:
    """Compile the library unless it is already built. Returns (path,
    seconds spent compiling; 0.0 when it was built before)."""
    return cbuild.build_library(SOURCE, BUILD_ROOT, LIB_NAME, CXX_FLAGS)


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    u8p, u64p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)
    lib.dis_zstd_bound.argtypes = [u8p, ctypes.c_size_t, u64p,
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.c_char_p, ctypes.c_size_t]
    lib.dis_zstd_bound.restype = ctypes.c_int
    lib.dis_zstd_decompress.argtypes = [u8p, ctypes.c_size_t, u8p,
                                        ctypes.c_size_t, u64p,
                                        ctypes.c_char_p, ctypes.c_size_t]
    lib.dis_zstd_decompress.restype = ctypes.c_int
    lib.dis_crc32c.argtypes = [u8p, ctypes.c_size_t]
    lib.dis_crc32c.restype = ctypes.c_uint32
    _lib = lib
    return lib


def _view(data) -> np.ndarray:
    """``data`` (bytes, bytearray, memoryview or a uint8 array) as a uint8
    array over the same memory."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data.reshape(-1).view(np.uint8))
    return np.frombuffer(data, np.uint8)


def _ptr(a: np.ndarray) -> int | None:
    return a.ctypes.data if a.size else None


def decompress(data) -> np.ndarray:
    """All frames of ``data`` decoded into one uint8 array."""
    lib = _load_lib()
    src = _view(data)
    err = ctypes.create_string_buffer(256)
    bound, exact = ctypes.c_uint64(), ctypes.c_int()
    if lib.dis_zstd_bound(_ptr(src), src.size, ctypes.byref(bound),
                          ctypes.byref(exact), err, len(err)):
        raise ZstdError(err.value.decode())
    out = np.empty(bound.value, np.uint8)
    written = ctypes.c_uint64()
    if lib.dis_zstd_decompress(_ptr(src), src.size, _ptr(out), out.size,
                               ctypes.byref(written), err, len(err)):
        raise ZstdError(err.value.decode())
    if exact.value and written.value != out.size:
        raise ZstdError(f"decoded {written.value} bytes, the frames state "
                        f"{out.size}")
    return out if written.value == out.size else out[:written.value]


def crc32c(data) -> int:
    """The CRC-32C (Castagnoli) of ``data``."""
    src = _view(data)
    return int(_load_lib().dis_crc32c(_ptr(src), src.size))
