"""The flax msgpack file format, in pure Python (no msgpack, no flax).

``flax.serialization.to_bytes`` writes a tree of dicts of arrays as
msgpack: maps with str keys, and each numpy array as msgpack ext type 1
whose payload is itself msgpack of (shape, dtype name, C-order bytes).
``to_bytes`` here writes that format with msgpack's smallest encodings (as
msgpack-python does), so a tree of numpy arrays gives the same bytes as
flax; ``from_bytes`` reads it back into nested dicts of numpy arrays. Only
what such a file holds is covered (maps, strings, bytes, int arrays for the
shapes, ext type 1); bfloat16 arrays are not supported.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1


def _pack_len(out: bytearray, n: int, fix_base: int, fix_max: int,
              codes: tuple) -> None:
    """A length header: fix form below fix_max, else 8/16/32-bit forms
    (codes[0] may be None where msgpack has no 8-bit form)."""
    if n < fix_max:
        out.append(fix_base | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v >= 0:
        for code, fmt, lim in ((0xcc, ">BB", 1 << 8), (0xcd, ">BH", 1 << 16),
                               (0xce, ">BI", 1 << 32), (0xcf, ">BQ", 1 << 64)):
            if v < lim:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, lim in ((0xd0, ">Bb", 1 << 7), (0xd1, ">Bh", 1 << 15),
                               (0xd2, ">Bi", 1 << 31), (0xd3, ">Bq", 1 << 63)):
            if v >= -lim:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(v)


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(fixed[n])
    elif n < 1 << 8:
        out += struct.pack(">BB", 0xc7, n)
    elif n < 1 << 16:
        out += struct.pack(">BH", 0xc8, n)
    else:
        out += struct.pack(">BI", 0xc9, n)
    out += struct.pack(">b", code) + data


def _array_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.names is not None:
        raise TypeError(f"cannot serialize dtype {a.dtype}")
    return packb((tuple(a.shape), a.dtype.name, a.tobytes("C")))


def _pack(out: bytearray, x) -> None:
    if isinstance(x, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _array_payload(x))
    elif isinstance(x, int) and not isinstance(x, bool):
        _pack_int(out, x)
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _pack_len(out, len(b), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out += b
    elif isinstance(x, (bytes, bytearray)):
        n = len(x)
        if n < 1 << 8:
            out += struct.pack(">BB", 0xc4, n)
        elif n < 1 << 16:
            out += struct.pack(">BH", 0xc5, n)
        else:
            out += struct.pack(">BI", 0xc6, n)
        out += x
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), 0x90, 16, (None, 0xdc, 0xdd))
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 16, (None, 0xde, 0xdf))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def packb(x) -> bytes:
    out = bytearray()
    _pack(out, x)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return bytes(b)

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        c = self.unpack(">B")
        if c < 0x80:
            return c
        if c >= 0xe0:
            return c - 0x100
        if c < 0x90:
            return self._map(c & 0x0f)
        if c < 0xa0:
            return self._array(c & 0x0f)
        if c < 0xc0:
            return self.take(c & 0x1f).decode("utf-8")
        sized = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
        if c in sized:
            return self.take(self.unpack(sized[c]))
        ext = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
        if c in ext:
            n = self.unpack(ext[c])
            return self._ext(self.unpack(">b"), self.take(n))
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if c in fixext:
            code = self.unpack(">b")
            return self._ext(code, self.take(fixext[c]))
        numbers = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                   0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if c in numbers:
            return self.unpack(numbers[c])
        strs = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
        if c in strs:
            return self.take(self.unpack(strs[c])).decode("utf-8")
        if c in (0xdc, 0xdd):
            return self._array(self.unpack(">H" if c == 0xdc else ">I"))
        if c in (0xde, 0xdf):
            return self._map(self.unpack(">H" if c == 0xde else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    @staticmethod
    def _ext(code: int, payload: bytes):
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, buf = unpackb(payload)
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        if dtype == "bfloat16":
            raise TypeError("bfloat16 arrays are not supported")
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def unpackb(data: bytes):
    reader = _Reader(data)
    value = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack data")
    return value


def to_bytes(tree: dict) -> bytes:
    """A nested dict of numpy arrays as flax.serialization.to_bytes writes
    it."""
    return packb(tree)


def from_bytes(data: bytes) -> dict:
    """The nested dict of numpy arrays in a file flax.serialization wrote."""
    tree = unpackb(data)
    if not isinstance(tree, dict):
        raise ValueError("expected a msgpack map at the top level")
    return tree
