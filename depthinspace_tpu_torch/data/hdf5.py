"""HDF5 reader and writer in numpy alone, for the files of the datasets.

The reference and the JAX package write every file of a dataset directory
(``frames.hdf5``, ``flow.hdf5``, ``{arch}_disp.hdf5``) with plain
``h5py`` ``create_dataset(name, data=array)`` calls into the root group. The
library writes those files in its oldest format: a version 0 superblock, a
root group kept as a symbol table (a version 1 B-tree over ``SNOD`` nodes,
the names in a local heap), a version 1 object header per dataset, and
contiguous storage with no chunks and no filters. This module reads and
writes exactly that subset:

    with File(path) as f:
        disp = f["disp"]            # read-only np.memmap, nothing read yet
    write_hdf5(path, {"disp": disp})

A file outside the subset raises :class:`HDF5FormatError`, naming what it
met (a newer superblock, a version 2 object header, a nested group, a
chunked or compressed layout, big-endian or non-numeric data). Nothing falls
back to ``h5py``; the tests hold both directions to ``h5py`` bit for bit.

Layout (HDF5 file format specification, version 2.0; sizes of offsets and
lengths 8 bytes, little-endian throughout).
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Mapping

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF          # the undefined address
_HEAP_FREE_NULL = 1                 # the end of a local heap's free list

# object header message types
_NIL, _DATASPACE, _DATATYPE, _FILL = 0x0, 0x1, 0x3, 0x5
_LINK, _LAYOUT, _FILTERS, _CONTINUATION, _SYMBOL_TABLE = \
    0x6, 0x8, 0xB, 0x10, 0x11


class HDF5FormatError(ValueError):
    """The file uses a feature of HDF5 that this module does not read."""


def _dtype_of(cls: int, bits: bytes, size: int, name: str) -> np.dtype:
    """numpy dtype of a datatype message: class 0 (fixed point) or 1
    (IEEE float), little-endian."""
    if cls not in (0, 1):
        kind = {2: "time", 3: "string", 4: "bit field", 5: "opaque",
                6: "compound", 7: "reference", 8: "enumerated",
                9: "variable-length", 10: "array"}.get(cls, f"class {cls}")
        raise HDF5FormatError(f"dataset {name!r}: {kind} datatype is not "
                              "supported (integers and floats only)")
    if bits[0] & 0x01:
        raise HDF5FormatError(f"dataset {name!r}: big-endian data is not "
                              "supported")
    if cls == 0:
        if size not in (1, 2, 4, 8):
            raise HDF5FormatError(f"dataset {name!r}: {size}-byte integer")
        return np.dtype(f"<{'i' if bits[0] & 0x08 else 'u'}{size}")
    if size not in (2, 4, 8):
        raise HDF5FormatError(f"dataset {name!r}: {size}-byte float")
    return np.dtype(f"<f{size}")


class File:
    """The root group of an HDF5 file, read-only: ``f[name]`` is the
    dataset as a read-only ``np.memmap`` (``h5py`` too reads only what is
    indexed); ``keys()`` and ``len`` as on a dict. The metadata is read
    when the file is opened; the file is not kept open."""

    def __init__(self, path):
        self.path = str(path)
        self._fh = open(self.path, "rb")
        try:
            self._datasets = self._parse()
        finally:
            self._fh.close()

    # ------------------------------------------------------------ context
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        """Nothing stays open: each memmap holds its own mapping."""

    def keys(self):
        return list(self._datasets)

    def __len__(self) -> int:
        return len(self._datasets)

    def __getitem__(self, name: str) -> np.ndarray:
        try:
            dtype, shape, addr, size = self._datasets[name]
        except KeyError:
            raise KeyError(f"no dataset {name!r} in {self.path}") from None
        n = int(np.prod(shape, dtype=np.int64))
        if addr == UNDEF or n == 0:
            raise HDF5FormatError(f"dataset {name!r} of shape {shape} has no "
                                  "data stored (empty or never written)")
        if size != n * dtype.itemsize:
            raise HDF5FormatError(f"dataset {name!r}: {size} bytes stored "
                                  f"for shape {shape} of {dtype}")
        return np.memmap(self.path, dtype=dtype, mode="r", offset=addr,
                         shape=shape)

    # ------------------------------------------------------------- parsing
    def _read(self, addr: int, n: int) -> bytes:
        self._fh.seek(addr)
        b = self._fh.read(n)
        if len(b) != n:
            raise HDF5FormatError(f"truncated file: {n} bytes at {addr}")
        return b

    def _parse(self) -> dict:
        sb = self._read(0, 96)
        if sb[:8] != SIGNATURE:
            raise HDF5FormatError(f"{self.path} is not an HDF5 file (the "
                                  "superblock must be at offset 0)")
        if sb[8] != 0:
            raise HDF5FormatError(f"superblock version {sb[8]} is not "
                                  "supported (version 0 only)")
        if sb[13] != 8 or sb[14] != 8:
            raise HDF5FormatError(f"sizes of offsets and lengths {sb[13]}, "
                                  f"{sb[14]} (8 only)")
        base = struct.unpack_from("<Q", sb, 24)[0]
        if base != 0:
            raise HDF5FormatError(f"base address {base} (0 only)")
        # the root group's symbol table entry; its scratch pad caches the
        # B-tree and heap addresses, which the object header also holds
        root_header = struct.unpack_from("<Q", sb, 64)[0]
        btree, heap = self._root_symbol_table(root_header)
        names = self._heap(heap)
        out = {}
        for name_off, header in self._group_entries(btree):
            name = _cstr(names, name_off)
            out[name] = self._dataset(header, name)
        return out

    def _messages(self, addr: int):
        """(type, data) of every message of the version 1 object header at
        ``addr``, continuation blocks followed."""
        pre = self._read(addr, 16)
        if pre[:4] == b"OHDR":
            raise HDF5FormatError("version 2 object headers are not "
                                  "supported (files written with "
                                  "libver='latest')")
        if pre[0] != 1:
            raise HDF5FormatError(f"object header version {pre[0]}")
        size = struct.unpack_from("<I", pre, 8)[0]
        blocks = [(addr + 16, size)]
        msgs = []
        while blocks:
            start, length = blocks.pop(0)
            buf = self._read(start, length)
            p = 0
            while p + 8 <= length:
                mtype, msize = struct.unpack_from("<HH", buf, p)
                data = buf[p + 8:p + 8 + msize]
                p += 8 + msize
                if mtype == _CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", data))
                elif mtype != _NIL:
                    msgs.append((mtype, data))
        return msgs

    def _root_symbol_table(self, header: int):
        for mtype, data in self._messages(header):
            if mtype == _SYMBOL_TABLE:
                return struct.unpack_from("<QQ", data)
            if mtype == _LINK:
                break
        raise HDF5FormatError("the root group is not a symbol table "
                              "(new-style groups with link messages are "
                              "not supported)")

    def _heap(self, addr: int) -> bytes:
        hdr = self._read(addr, 32)
        if hdr[:4] != b"HEAP":
            raise HDF5FormatError(f"no local heap at {addr}")
        size, _, data_addr = struct.unpack_from("<QQQ", hdr, 8)
        return self._read(data_addr, size)

    def _group_entries(self, addr: int):
        """(name offset, object header address) of every link under the
        group B-tree node at ``addr``, in name order."""
        node = self._read(addr, 24)
        if node[:4] != b"TREE" or node[4] != 0:
            raise HDF5FormatError(f"no group B-tree node at {addr}")
        level, used = node[5], struct.unpack_from("<H", node, 6)[0]
        # keys and children interleave: key0, child0, key1, ..., key_used
        body = self._read(addr + 24, (2 * used + 1) * 8)
        children = [struct.unpack_from("<Q", body, 8 + 16 * i)[0]
                    for i in range(used)]
        for child in children:
            if level > 0:
                yield from self._group_entries(child)
                continue
            snod = self._read(child, 8)
            if snod[:4] != b"SNOD":
                raise HDF5FormatError(f"no symbol table node at {child}")
            count = struct.unpack_from("<H", snod, 6)[0]
            entries = self._read(child + 8, 40 * count)
            for i in range(count):
                yield struct.unpack_from("<QQ", entries, 40 * i)

    def _dataset(self, header: int, name: str):
        shape = dtype = layout = None
        for mtype, data in self._messages(header):
            if mtype == _SYMBOL_TABLE or mtype == _LINK:
                raise HDF5FormatError(f"{name!r} is a group: nested groups "
                                      "are not supported")
            if mtype == _FILTERS:
                raise HDF5FormatError(f"dataset {name!r} is compressed or "
                                      "filtered (filter pipeline): not "
                                      "supported")
            if mtype == _DATASPACE:
                shape = _dataspace(data, name)
            elif mtype == _DATATYPE:
                dtype = _dtype_of(data[0] & 0x0F, data[1:4],
                                  struct.unpack_from("<I", data, 4)[0], name)
            elif mtype == _LAYOUT:
                layout = _layout(data, name)
        if shape is None or dtype is None or layout is None:
            raise HDF5FormatError(f"{name!r} is not a dataset (no "
                                  "dataspace, datatype or layout message)")
        return (dtype, shape) + layout


def _cstr(heap: bytes, off: int) -> str:
    return heap[off:heap.index(b"\0", off)].decode("utf-8")


def _dataspace(data: bytes, name: str) -> tuple:
    version, rank, flags = data[0], data[1], data[2]
    if version == 1:
        off = 8
    elif version == 2:
        if data[3] == 2:
            raise HDF5FormatError(f"dataset {name!r} has a null dataspace")
        off = 4
    else:
        raise HDF5FormatError(f"dataspace message version {version}")
    return tuple(struct.unpack_from(f"<{rank}Q", data, off))


def _layout(data: bytes, name: str) -> tuple:
    version = data[0]
    if version != 3:
        raise HDF5FormatError(f"dataset {name!r}: data layout message "
                              f"version {version} (3 only)")
    cls = data[1]
    if cls == 2:
        raise HDF5FormatError(f"dataset {name!r} has a chunked layout: not "
                              "supported (contiguous only)")
    if cls == 0:
        raise HDF5FormatError(f"dataset {name!r} has a compact layout: not "
                              "supported (contiguous only)")
    if cls != 1:
        raise HDF5FormatError(f"dataset {name!r}: layout class {cls}")
    return struct.unpack_from("<QQ", data, 2)


# ------------------------------------------------------------------ writer
def _msg(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data += b"\0" * (-len(data) % 8)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _datatype_msg(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind == "f":
        exp, mant, bias = {2: (5, 10, 15), 4: (8, 23, 127),
                           8: (11, 52, 1023)}[size]
        # class 1 version 1; mantissa normalization "msb implied" (bits 4-5
        # = 2), the sign bit's position in the second byte
        return struct.pack("<B3BIHHBBBBI", 0x11, 0x20, 8 * size - 1, 0, size,
                           0, 8 * size, mant, exp, 0, mant, bias)
    signed = 0x08 if dtype.kind == "i" else 0
    return struct.pack("<B3BIHH", 0x10, signed, 0, 0, size, 0, 8 * size)


def _object_header(msgs: list) -> bytes:
    body = b"".join(msgs)
    return struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)) + body


def _symbol_entry(name_off: int, header: int, cache: int = 0,
                  scratch: bytes = b"") -> bytes:
    return struct.pack("<QQI4x", name_off, header, cache) + \
        scratch.ljust(16, b"\0")


def _align(n: int, a: int) -> int:
    return n + (-n % a)


def write_hdf5(path, datasets: Mapping[str, np.ndarray]) -> None:
    """Write ``datasets`` ({name: array}) as the datasets of the root group
    of a new HDF5 file at ``path``, as ``h5py`` writes plain
    ``create_dataset(name, data=array)`` calls: a version 0 superblock, one
    symbol-table node that holds every name (its leaf K raised to fit),
    version 1 object headers, contiguous little-endian data. Integer and
    float arrays of rank 1 or more, not empty; the file is written to a
    temporary name and moved into place."""
    items = []
    for name, arr in datasets.items():
        arr = np.asarray(arr)
        if arr.dtype.kind not in "fiu" or arr.dtype.itemsize not in (
                (1, 2, 4, 8) if arr.dtype.kind in "iu" else (2, 4, 8)):
            raise TypeError(f"dataset {name!r}: dtype {arr.dtype} (integers "
                            "and floats only)")
        if arr.ndim == 0 or arr.size == 0:
            raise ValueError(f"dataset {name!r}: shape {arr.shape} (scalars "
                             "and empty arrays are not supported)")
        if name in ("", ".") or "/" in name or "\0" in name:
            raise ValueError(f"dataset name {name!r}: an HDF5 link name is "
                             "not empty or '.' and holds no '/' or NUL")
        items.append((name, np.ascontiguousarray(
            arr, arr.dtype.newbyteorder("<"))))
    # the library finds a name by binary search over a node's entries
    items.sort(key=lambda it: it[0].encode("utf-8"))
    n = len(items)
    leaf_k = max(4, (n + 1) // 2)       # one SNOD holds 2 * leaf_k entries
    internal_k = 16

    # local heap: "" at 0, then the names, each NUL-terminated and padded to
    # 8 bytes, then one free block (h5py's heaps keep one too)
    heap_data, name_offs = bytearray(8), []
    for name, _ in items:
        name_offs.append(len(heap_data))
        b = name.encode("utf-8") + b"\0"
        heap_data += b + b"\0" * (-len(b) % 8)
    free_off = len(heap_data)
    heap_data += struct.pack("<QQ", _HEAP_FREE_NULL, 16)

    sb_at, root_at = 0, 96
    root_len = 16 + 8 + 16
    btree_at = root_at + root_len
    btree_len = 24 + (2 * internal_k + 1) * 8 + 2 * internal_k * 8
    heap_at = btree_at + btree_len
    heap_data_at = heap_at + 32
    snod_at = heap_data_at + len(heap_data)
    snod_len = 8 + 2 * leaf_k * 40
    at = snod_at + snod_len

    headers, header_at = [], []
    for name, arr in items:
        dims = struct.pack(f"<{arr.ndim}Q", *arr.shape)
        msgs = [_msg(_DATASPACE, struct.pack("<BBB5x", 1, arr.ndim, 1)
                     + dims + dims),
                _msg(_DATATYPE, _datatype_msg(arr.dtype), flags=1),
                # fill value version 2: allocated late, written if set,
                # defined as the default (zero)
                _msg(_FILL, struct.pack("<BBBBI", 2, 2, 2, 1, 0), flags=1),
                None]
        header_at.append(at)
        headers.append(msgs)
        at += 16 + sum(len(m) for m in msgs[:3]) + 8 + 24
    data_at = []
    for _, arr in items:
        at = _align(at, 64)
        data_at.append(at)
        at += arr.nbytes
    eof = at

    out = bytearray(eof)
    out[sb_at:sb_at + 56] = SIGNATURE + struct.pack(
        "<BBBBBBBBHHIQQQQ", 0, 0, 0, 0, 0, 8, 8, 0, leaf_k, internal_k, 0,
        0, UNDEF, eof, UNDEF)
    out[56:96] = _symbol_entry(0, root_at, 1,
                               struct.pack("<QQ", btree_at, heap_at))
    out[root_at:root_at + root_len] = _object_header(
        [_msg(_SYMBOL_TABLE, struct.pack("<QQ", btree_at, heap_at))])
    # a leaf B-tree node with one child, the SNOD; its keys bound the
    # child's names: "" below, the last name above
    last = name_offs[-1] if n else 0
    out[btree_at:btree_at + 48] = b"TREE" + struct.pack(
        "<BBHQQQQQ", 0, 0, 1, UNDEF, UNDEF, 0, snod_at, last)
    out[heap_at:heap_at + 32] = b"HEAP" + struct.pack(
        "<B3xQQQ", 0, len(heap_data), free_off, heap_data_at)
    out[heap_data_at:heap_data_at + len(heap_data)] = heap_data
    snod = b"SNOD" + struct.pack("<BBH", 1, 0, n) + b"".join(
        _symbol_entry(off, h) for off, h in zip(name_offs, header_at))
    out[snod_at:snod_at + len(snod)] = snod
    for (name, arr), msgs, h_at, d_at in zip(items, headers, header_at,
                                             data_at):
        msgs[3] = _msg(_LAYOUT, struct.pack("<BBQQ", 3, 1, d_at,
                                            arr.nbytes))
        hdr = _object_header(msgs)
        out[h_at:h_at + len(hdr)] = hdr
        out[d_at:d_at + arr.nbytes] = arr.tobytes()
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(out)
    os.replace(tmp, path)
