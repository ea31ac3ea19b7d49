"""Reader of the wire cache, port of the reading half of
``depthinspace_tpu/data/cache.py``.

A wire cache holds every sample of a dataset directory already in the 16-bit
wire encoding (``data/wire.py``), as memmappable ``.npy`` arrays:

    <data_dir>/wire_cache/meta.json        {version, names, fields}
    <data_dir>/wire_cache/im.npy           (N, 4, H, W)  uint16  x65535
    <data_dir>/wire_cache/ambient.npy      (N, 4, H, W)  uint16  x65535
    <data_dir>/wire_cache/disp.npy         (N, 4, H, W)  uint16  x256
    <data_dir>/wire_cache/R.npy            (N, 4, 3, 3)  float32
    <data_dir>/wire_cache/t.npy            (N, 4, 3)     float32
    [+ primary_disp / pseudo_gt / sgm_disp when built]

It is built from the HDF5 files by the JAX package
(``python -m depthinspace_tpu.tools.build_cache <data_dir>``, its
``build_wire_cache``), which this package does not port: building reads
HDF5. Reading needs numpy only, so a machine without h5py trains and
retests from a dataset directory that holds a cache.

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

from .batch import Batch

CACHE_DIR_NAME = "wire_cache"
_VERSION = 1
BASE_FIELDS = ("im", "ambient", "disp", "R", "t")


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
