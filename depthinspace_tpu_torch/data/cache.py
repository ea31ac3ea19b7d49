"""The wire cache, port of ``depthinspace_tpu/data/cache.py``: its builder
and its reader.

A wire cache holds every sample of a dataset directory already in the 16-bit
wire encoding (``data/wire.py``), as memmappable ``.npy`` arrays:

    <data_dir>/wire_cache/meta.json        {version, names, fields}
    <data_dir>/wire_cache/im.npy           (N, 4, H, W)  uint16  x65535
    <data_dir>/wire_cache/ambient.npy      (N, 4, H, W)  uint16  x65535
    <data_dir>/wire_cache/disp.npy         (N, 4, H, W)  uint16  x256
    <data_dir>/wire_cache/R.npy            (N, 4, 3, 3)  float32
    <data_dir>/wire_cache/t.npy            (N, 4, 3)     float32
    [+ primary_disp / pseudo_gt / sgm_disp when built]

``build_wire_cache`` writes it from the samples' HDF5 files (read with
``data/hdf5.py``) with the JAX package's encoding, sample list and
meta.json, field by field (``python -m
depthinspace_tpu_torch.tools.build_cache``); the presave tools refresh the
field they rewrote.

``CachedTrackDataset`` serves the same batches as the JAX package's: the
same sample-name resolution through meta.json, the same refusal of missing
fields and samples, and the same frame permutation per index and epoch as
``TrackDataset``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

import numpy as np

from . import hdf5
from .batch import Batch
from .wire import encode_disp, encode_unit

CACHE_DIR_NAME = "wire_cache"
_VERSION = 1

def _as_f32(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float32)


# field -> (source HDF5 file, dataset name, wire encoding of float32 values)
_FIELDS = {
    "im": ("frames.hdf5", "im", encode_unit),
    "ambient": ("frames.hdf5", "ambient", encode_unit),
    "disp": ("frames.hdf5", "disp", encode_disp),
    "sgm_disp": ("frames.hdf5", "sgm_disp", encode_disp),
    "primary_disp": ("single_frame_disp.hdf5", "disp", encode_disp),
    "pseudo_gt": ("multi_frame_disp.hdf5", "disp", encode_disp),
    "R": ("frames.hdf5", "R", _as_f32),
    "t": ("frames.hdf5", "t", _as_f32),
}
BASE_FIELDS = ("im", "ambient", "disp", "R", "t")


def build_wire_cache(data_dir, fields: Sequence[str] = BASE_FIELDS,
                     progress: bool = False, force: bool = False) -> Path:
    """Build or extend the wire cache of ``data_dir`` from the HDF5 files of
    its samples (the directories ``0*`` that hold frames.hdf5, in sorted
    order), as the JAX package's ``build_wire_cache``. Idempotent per
    field: a field already cached for the same sample list is kept unless
    ``force`` (after a presave rewrote its files); a new sample list starts
    the cache afresh. A sample without the field's file (a presave over a
    subset of ``--ranges``) is zero-filled and listed under the field's
    "missing" in meta.json, which the reader refuses to serve."""
    data_dir = Path(data_dir)
    dirs = sorted(p for p in data_dir.glob("0*")
                  if p.is_dir() and (p / "frames.hdf5").exists())
    if not dirs:
        raise FileNotFoundError(f"no sample dirs under {data_dir}")
    names = [p.name for p in dirs]

    cache = data_dir / CACHE_DIR_NAME
    cache.mkdir(exist_ok=True)
    meta_path = cache / "meta.json"
    meta = {"version": _VERSION, "names": names, "fields": {}}
    if meta_path.exists():
        old = json.loads(meta_path.read_text())
        if old.get("names") == names and old.get("version") == _VERSION:
            meta = old

    for field in fields:
        src_file, key, encode = _FIELDS[field]
        out_path = cache / f"{field}.npy"
        if field in meta["fields"] and out_path.exists() and not force:
            continue
        arr, missing = None, []
        for i, d in enumerate(dirs):
            if not (d / src_file).exists():
                missing.append(d.name)
                continue
            with hdf5.File(d / src_file) as f:
                v = np.asarray(f[key])
            if v.ndim == 4 and v.shape[1] == 1:      # (4,1,H,W) -> (4,H,W)
                v = v[:, 0]
            enc = encode(v.astype(np.float32))
            if arr is None:
                arr = np.lib.format.open_memmap(
                    out_path, mode="w+", dtype=enc.dtype,
                    shape=(len(dirs),) + enc.shape)
            arr[i] = enc
            if progress and i % 256 == 0:
                print(f"cache {field}: {i}/{len(dirs)}", flush=True)
        if arr is None:
            raise FileNotFoundError(
                f"no sample has {src_file} (field {field!r})")
        arr.flush()
        meta["fields"][field] = {"shape": list(arr.shape),
                                 "dtype": arr.dtype.name,
                                 "missing": missing}
        meta_path.write_text(json.dumps(meta))
    return cache


def has_wire_cache(data_dir, fields: Sequence[str] = BASE_FIELDS) -> bool:
    """Whether ``data_dir`` holds a wire cache of this version with every
    one of ``fields``."""
    meta_path = Path(data_dir) / CACHE_DIR_NAME / "meta.json"
    if not meta_path.exists():
        return False
    meta = json.loads(meta_path.read_text())
    return (meta.get("version") == _VERSION
            and all(f in meta["fields"] for f in fields))


class CachedTrackDataset:
    """Memmap-backed, wire-encoded stand-in for ``TrackDataset``: the same
    ``__len__``, ``__getitem__`` (per-sample dicts, already encoded),
    ``current_epoch``, ``track_length`` and ``train``, and ``get_batch``,
    which ``DataLoader`` prefers: one gather a field straight into the
    track-major Batch.

    ``sample_names``: the split to serve, as sample directory names,
    resolved through meta.json so a split indexes the same samples whatever
    subset was cached."""

    def __init__(self, data_dir, sample_names: Sequence[str],
                 track_length: int = 4, train: bool = True,
                 load_primary: bool = False, load_pseudo_gt: bool = False,
                 load_sgm: bool = False):
        self.data_dir = Path(data_dir)
        cache = self.data_dir / CACHE_DIR_NAME
        meta = json.loads((cache / "meta.json").read_text())
        pos = {n: i for i, n in enumerate(meta["names"])}
        try:
            self.indices = np.asarray([pos[n] for n in sample_names],
                                      np.int64)
        except KeyError as e:
            raise FileNotFoundError(f"sample {e} not in wire cache") from e

        self.fields = {}
        need = list(BASE_FIELDS)
        if load_primary:
            need.append("primary_disp")
        if load_pseudo_gt:
            need.append("pseudo_gt")
        if load_sgm:
            need.append("sgm_disp")
        for f in need:
            if f not in meta["fields"]:
                raise FileNotFoundError(f"field {f!r} not in wire cache")
            bad = set(meta["fields"][f].get("missing", ())).intersection(
                sample_names)
            if bad:
                raise FileNotFoundError(
                    f"wire cache field {f!r} does not cover {len(bad)} "
                    f"requested samples (e.g. {sorted(bad)[0]}): rebuild "
                    "the cache")
            self.fields[f] = np.load(cache / f"{f}.npy", mmap_mode="r")

        self.track_length = track_length
        self.train = train
        self.current_epoch = 0

    def __len__(self):
        return len(self.indices)

    def _perm(self, idx: int) -> np.ndarray:
        """TrackDataset's frame choice: a training sample a permutation of
        its 4 frames seeded per index and epoch, else the first frames."""
        if self.train:
            rng = np.random.RandomState((self.current_epoch + 1) * len(self)
                                        + idx)
            return rng.permutation(4)[:self.track_length]
        return np.arange(self.track_length)

    def __getitem__(self, idx: int) -> dict:
        """One sample's dict (wire-encoded) for ``collate``."""
        gi = self.indices[idx]
        perm = self._perm(idx)
        ret = {"id": idx}
        for f, arr in self.fields.items():
            ret[f] = np.asarray(arr[gi][perm])
        return ret

    def get_batch(self, idxs: Sequence[int]) -> Batch:
        """The track-major wire-encoded Batch of samples ``idxs``: one
        gather a field and frame slot."""
        idxs = np.asarray(idxs)
        gidx = self.indices[idxs]
        perms = np.stack([self._perm(int(i)) for i in idxs])   # (bs, tl)
        out = {}
        for f, arr in self.fields.items():
            o = np.empty((self.track_length, len(idxs)) + arr.shape[2:],
                         arr.dtype)
            for ti in range(self.track_length):
                o[ti] = arr[gidx, perms[:, ti]]
            out[f] = o
        return Batch(im=out["im"], ambient=out["ambient"],
                     disp_gt=out["disp"], R=out["R"], t=out["t"],
                     primary_disp=out.get("primary_disp"),
                     pseudo_gt=out.get("pseudo_gt"),
                     sgm_disp=out.get("sgm_disp"))
