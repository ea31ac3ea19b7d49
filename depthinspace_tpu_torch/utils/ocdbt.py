"""A read-only OCDBT key-value store (tensorstore's "optionally-cooperative
distributed B+tree"), the format in which orbax writes a checkpoint's
arrays, in numpy and ``struct``.

A store is a directory with a manifest, ``manifest.ocdbt``, and data files
whose paths the manifest and the b-tree nodes name relative to the store's
directory (``d/<32 hex>``, or ``ocdbt.process_0/d/<32 hex>`` for the merged
store orbax writes above its per-process stores). Manifests and b-tree nodes
are files (or parts of data files) of one layout:

  magic (uint32 big-endian: 0x0cdb3a2a manifest, 0x0cdb20de b-tree node)
  length (uint64 little-endian, the whole file including the checksum)
  format version (varint, 0) and compression (varint: 0 none, 1 zstd)
  the body, compressed as stated
  CRC-32C of everything before it (uint32 little-endian)

Varints are unsigned LEB128. The manifest's body is the configuration
(uuid[16], manifest kind, max inline value bytes, max decoded node bytes,
version tree arity log2 as a byte, compression method and, for zstd, an
int32 level), then a data-file table and the newest versions of the tree
as columns: generation numbers, root heights (bytes), the roots' file ids,
offsets and lengths, key counts, tree bytes, indirect value bytes, and
commit times (uint64). Older versions sit in version-tree nodes listed
after them, which a reader of the newest version does not need. Only the
"single" manifest kind is read; a store whose versions live in numbered
manifests raises.

A data-file table: the count, then for files 1.. the length of the path
prefix each shares with the one before, for every file its suffix length
and the length of its base path, then the suffixes; a file's path is its
base path followed by its relative path.

A b-tree node's body is its height (a byte), a data-file table and its
entries as columns. Keys are prefix-coded: for entries 1.. the length of
the prefix shared with the key before, for every entry its suffix length,
then (interior nodes only) the length of the prefix that every key of the
entry's subtree shares, then the suffixes. A leaf follows with value
lengths, value kinds (0 inline, 1 in a data file), the data-file ids and
offsets of the values kept in data files, then the inline values. An
interior node follows with its children's file ids, offsets, lengths, key
counts, tree bytes and indirect value bytes. A child's keys leave out the
prefix its subtree shares; the reader puts it back.

This layout was worked out from the bytes that orbax 0.11 and tensorstore
write; ``tests/test_torch_orbax.py`` holds it to both (interior nodes and
version-tree nodes included).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE


class OcdbtError(ValueError):
    """A store this reader cannot read, or a damaged one."""


class _Reader:
    def __init__(self, buf: bytes, what: str):
        self.b, self.p, self.what = buf, 0, what

    def varint(self) -> int:
        r = s = 0
        b = self.b
        while True:
            if self.p >= len(b):
                raise OcdbtError(f"{self.what}: truncated at byte {self.p}")
            c = b[self.p]
            self.p += 1
            r |= (c & 0x7F) << s
            s += 7
            if c < 0x80:
                return r

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.p + n > len(self.b):
            raise OcdbtError(f"{self.what}: truncated at byte {self.p}")
        out = self.b[self.p:self.p + n]
        self.p += n
        return out

    def byte(self) -> int:
        return self.raw(1)[0]


def _body(blob: bytes, magic: int, what: str) -> bytes:
    """The decoded body of a manifest or b-tree node, its frame checked."""
    if len(blob) < 18:
        raise OcdbtError(f"{what}: {len(blob)} bytes is too short")
    got_magic, length = struct.unpack_from(">I", blob)[0], struct.unpack_from(
        "<Q", blob, 4)[0]
    if got_magic != magic:
        raise OcdbtError(f"{what}: magic {got_magic:#010x}, want {magic:#010x}")
    if length != len(blob):
        raise OcdbtError(f"{what}: length field {length}, file holds "
                         f"{len(blob)} bytes")
    crc = struct.unpack_from("<I", blob, len(blob) - 4)[0]
    if zstd.crc32c(memoryview(blob)[:-4]) != crc:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    r = _Reader(blob, what)
    r.p = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}")
    payload = memoryview(blob)[r.p:len(blob) - 4]
    if compression == 0:
        return bytes(payload)
    if compression == 1:
        return zstd.decompress(payload).tobytes()
    raise OcdbtError(f"{what}: compression {compression}")


def _data_files(r: _Reader) -> list[str]:
    n = r.varint()
    shared = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base_len = r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        full = prev[:shared[i]] + r.raw(suffix[i])
        if base_len[i] > len(full):
            raise OcdbtError(f"{r.what}: base path longer than its path")
        paths.append(full.decode())
        prev = full
    return paths


def _keys(r: _Reader, n: int, interior: bool):
    shared = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    common = r.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            raise OcdbtError(f"{r.what}: key prefix longer than the key "
                             "before")
        k = prev[:shared[i]] + r.raw(suffix[i])
        keys.append(k)
        prev = k
    return keys, common


@dataclass(frozen=True)
class _Ref:
    """Where a value or a node lives: bytes [offset, offset + length) of
    the data file ``path`` (relative to the store's directory)."""
    path: str
    offset: int
    length: int


class OcdbtStore:
    """The newest version of the store at ``path``: ``keys()`` and
    ``read(key) -> bytes``. The whole b-tree is read when the store is
    opened (``height`` and ``node_count`` say what it held); values are read
    when asked for."""

    def __init__(self, path):
        self.base = Path(path)
        blob = (self.base / "manifest.ocdbt").read_bytes()
        r = _Reader(_body(blob, MANIFEST_MAGIC, str(self.base /
                                                      "manifest.ocdbt")),
                    "manifest")
        r.raw(16)                           # uuid
        kind = r.varint()
        r.varints(2)                        # max inline value, node bytes
        r.byte()                            # version tree arity log2
        if r.varint() == 1:                 # zstd, then its level
            r.raw(4)
        if kind != 0:
            raise OcdbtError(f"{self.base}: manifest kind {kind} (numbered "
                             "manifests) is not supported")
        files = _data_files(r)
        n = r.varint()
        if n == 0:
            raise OcdbtError(f"{self.base}: manifest lists no version")
        r.varints(n)                        # generation numbers
        height = r.raw(n)[-1]
        fid, off, ln, nkeys = (r.varints(n)[-1] for _ in range(4))
        self._values: dict[bytes, bytes | _Ref] = {}
        self.node_count = 0
        self.height = height
        if nkeys:
            self._walk(_Ref(files[fid], off, ln), height, b"")
        if len(self._values) != nkeys:
            raise OcdbtError(f"{self.base}: the tree holds "
                             f"{len(self._values)} keys, its manifest says "
                             f"{nkeys}")

    def _file_bytes(self, ref: _Ref) -> bytes:
        path = self.base / ref.path
        with open(path, "rb") as f:
            f.seek(ref.offset)
            data = f.read(ref.length)
        if len(data) != ref.length:
            raise OcdbtError(f"{path}: [{ref.offset}, "
                             f"{ref.offset + ref.length}) is past its end")
        return data

    def _walk(self, ref: _Ref, height: int, prefix: bytes) -> None:
        what = f"{self.base / ref.path}@{ref.offset}"
        r = _Reader(_body(self._file_bytes(ref), NODE_MAGIC, what), what)
        self.node_count += 1
        if r.byte() != height:
            raise OcdbtError(f"{what}: node height does not match its "
                             f"parent's ({height})")
        files = _data_files(r)
        n = r.varint()
        keys, common = _keys(r, n, interior=height > 0)
        if height > 0:
            fid, off, ln = r.varints(n), r.varints(n), r.varints(n)
            for _ in range(3):      # key counts, tree and indirect bytes
                r.varints(n)
            if r.p != len(r.b):
                raise OcdbtError(f"{what}: {len(r.b) - r.p} bytes after the "
                                 "last child")
            for i in range(n):
                self._walk(_Ref(files[fid[i]], off[i], ln[i]), height - 1,
                           prefix + keys[i][:common[i]])
            return
        lengths, kinds = r.varints(n), r.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            raise OcdbtError(f"{what}: value kind not 0 or 1")
        fid, off = r.varints(len(indirect)), r.varints(len(indirect))
        for j, i in enumerate(indirect):
            self._values[prefix + keys[i]] = _Ref(files[fid[j]], off[j],
                                                  lengths[i])
        for i in range(n):
            if kinds[i] == 0:
                self._values[prefix + keys[i]] = r.raw(lengths[i])
        if r.p != len(r.b):
            raise OcdbtError(f"{what}: {len(r.b) - r.p} bytes after the "
                             "last value")

    def keys(self) -> list[str]:
        return sorted(k.decode() for k in self._values)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._values

    def read(self, key: str) -> bytes:
        v = self._values.get(key.encode())
        if v is None:
            raise KeyError(key)
        return v if isinstance(v, bytes) else self._file_bytes(v)

