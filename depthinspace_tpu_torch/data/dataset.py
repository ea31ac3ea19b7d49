"""Track datasets and the threaded loader, port of
``depthinspace_tpu/data/dataset.py``.

``TrackDataset`` reads the on-disk schema of the reference:

  <DATA_DIR>/settings.pkl
  <DATA_DIR>/<sample>/frames.hdf5   im/ambient/grad/disp (4,1,H,W), R (4,3,3),
                                    t (4,3) [+ sgm_disp for real data]
  <DATA_DIR>/<sample>/flow.hdf5     flow_{i}{j} (1,2,H,W), i != j
  <DATA_DIR>/<sample>/single_frame_disp.hdf5  disp (4,1,H,W)  (DIS-SF primary)
  <DATA_DIR>/<sample>/multi_frame_disp.hdf5   disp (4,1,H,W)  (pseudo GT)

with the same per-index RNG (a training sample takes a random permutation
of its 4 frames, then, with ``data_aug``, that RNG's host augmentation of
each frame, ``data/augment.py``). The files are read with ``data/hdf5.py``
(numpy alone), which maps each dataset and reads only the frames a sample
takes.

``SyntheticTrackDataset`` serves in-memory samples made by
``data/synthetic.py`` with the same ``__getitem__`` dict, for runs without a
dataset on disk. ``MultiDataset`` concatenates datasets.
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Sequence

import numpy as np

from ..parallel.mesh import pad_indices, shard_indices
from . import hdf5
from .augment import augment_frame
from .batch import Batch
from .settings import Settings
from .synthetic import make_track_batch


def _sample_rng(dset, idx: int) -> np.random.RandomState:
    """Sample ``idx``'s RNG, seeded per index and epoch for a training
    sample and per index for an evaluation one (the loader's threads never
    draw from the global RNG)."""
    return np.random.RandomState(
        (dset.current_epoch + 1) * len(dset) + idx if dset.train else idx)


def _track_indices(dset, idx: int, rng=None) -> np.ndarray:
    """The frames of sample ``idx``: a training sample takes a random
    permutation of its 4 frames from its RNG (``rng``, or a new
    :func:`_sample_rng`); an evaluation sample its first
    ``track_length``."""
    if not dset.train:
        return np.arange(dset.track_length)
    rng = _sample_rng(dset, idx) if rng is None else rng
    return rng.permutation(4)[:dset.track_length]


class TrackDataset:
    """Map-style dataset over per-sample directories of HDF5 files.
    ``data_aug`` augments each frame on the host with the sample's RNG
    (``data/augment.py``) and the knobs below, the JAX dataset's
    defaults."""

    def __init__(self, settings: Settings, sample_paths: Sequence[str],
                 track_length: int = 4, train: bool = True,
                 data_aug: bool = False, load_flow: bool = False,
                 load_primary: bool = False, load_pseudo_gt: bool = False,
                 load_grad: bool = False, data_type: str = "synthetic"):
        if track_length > 4:
            raise ValueError("track_length must be at most 4")
        self.settings = settings
        self.sample_paths = [str(p) for p in sample_paths]
        self.track_length = track_length
        self.train = train
        self.data_aug = data_aug
        self.load_flow = load_flow
        self.load_primary = load_primary
        self.load_pseudo_gt = load_pseudo_gt
        self.load_grad = load_grad
        self.data_type = data_type
        self.current_epoch = 0
        # augmentation knobs (the shear is off)
        self.max_shift = 0.0
        self.max_blur = 0.5
        self.max_noise = 3.0
        self.max_sp_noise = 0.0005

    def __len__(self):
        return len(self.sample_paths)

    def __getitem__(self, idx: int) -> dict:
        path = self.sample_paths[idx]
        tl = self.track_length
        rng = _sample_rng(self, idx)
        track_ind = _track_indices(self, idx, rng)

        def frames(f, key):
            return np.stack([f[key][i, 0] for i in track_ind]).astype(
                np.float32)

        ret: dict = {"id": idx}
        with hdf5.File(os.path.join(path, "frames.hdf5")) as f:
            for key, name in (("im", "im"), ("ambient", "ambient"),
                              ("disp", "disp")):
                ret[key] = frames(f, name)
            ret["R"] = np.stack([f["R"][i] for i in track_ind]).astype(
                np.float32)
            ret["t"] = np.stack([f["t"][i] for i in track_ind]).astype(
                np.float32)
            if self.load_grad:
                ret["grad"] = frames(f, "grad")
            if self.data_type == "real":
                ret["sgm_disp"] = frames(f, "sgm_disp")
        if self.load_flow:
            H, W = ret["im"].shape[-2:]
            flow = np.zeros((tl, tl, H, W, 2), np.float32)
            with hdf5.File(os.path.join(path, "flow.hdf5")) as f:
                for i0, t0 in enumerate(track_ind):
                    for i1, t1 in enumerate(track_ind):
                        if t0 != t1:
                            fl = np.asarray(f[f"flow_{t0}{t1}"])  # (1,2,H,W)
                            flow[i0, i1] = np.moveaxis(fl[0], 0, -1)
            ret["flow"] = flow
        if self.load_primary:
            with hdf5.File(os.path.join(path,
                                        "single_frame_disp.hdf5")) as f:
                ret["primary_disp"] = frames(f, "disp")
        if self.load_pseudo_gt:
            with hdf5.File(os.path.join(path,
                                        "multi_frame_disp.hdf5")) as f:
                ret["pseudo_gt"] = frames(f, "disp")
        if self.data_aug:
            self._augment(ret, rng)
        return ret

    def _augment(self, ret: dict, rng: np.random.RandomState) -> None:
        """Each frame through ``augment_frame`` with the sample's RNG, in
        frame order; the maps a sample does not carry stay None."""
        maps = ("primary_disp", "sgm_disp", "grad")
        for i in range(self.track_length):
            out = augment_frame(
                ret["im"][i], rng, amb=ret["ambient"][i], disp=ret["disp"][i],
                **{k: ret[k][i] if k in ret else None for k in maps},
                max_shift=self.max_shift, max_blur=self.max_blur,
                max_noise=self.max_noise, max_sp_noise=self.max_sp_noise)
            for k, v in zip(("im", "ambient", "disp") + maps, out):
                if k in ret:
                    ret[k][i] = v


class SyntheticSource:
    """In-memory synthetic samples in place of a dataset directory: sample
    ``i`` is ``make_track_batch(settings, tl=4, bs=1, seed=seed + i,
    primary_noise=primary_noise)``, made on first use and kept (the datasets
    of every split and every worker built on this source share them). With
    ``primary_noise`` the samples carry the stand-in primary disparity that
    DIS-MF needs in place of a presaved DIS-SF prediction."""

    def __init__(self, settings: Settings, n_samples: int, seed: int = 0,
                 primary_noise: float | None = None):
        self.settings = settings
        self.n_samples = n_samples
        self.seed = seed
        self.primary_noise = primary_noise
        self._cache: dict = {}
        self._lock = threading.Lock()

    def sample(self, i: int) -> Batch:
        with self._lock:
            b = self._cache.get(i)
        if b is None:
            b = make_track_batch(self.settings, tl=4, bs=1,
                                 seed=self.seed + i,
                                 primary_noise=self.primary_noise)
            with self._lock:
                self._cache[i] = b
        return b


class SyntheticTrackDataset:
    """The samples ``sample_ids`` of a :class:`SyntheticSource`, with
    TrackDataset's ``__getitem__`` dict and frame selection."""

    def __init__(self, source: SyntheticSource, sample_ids: Sequence[int],
                 track_length: int = 4, train: bool = True,
                 load_flow: bool = True, load_primary: bool = False):
        if track_length > 4:
            raise ValueError("track_length must be at most 4")
        if load_primary and source.primary_noise is None:
            raise ValueError("the source makes no primary disparity: give "
                             "it primary_noise")
        self.load_primary = load_primary
        self.source = source
        self.sample_ids = list(sample_ids)
        self.track_length = track_length
        self.train = train
        self.load_flow = load_flow
        self.current_epoch = 0

    def __len__(self):
        return len(self.sample_ids)

    def __getitem__(self, idx: int) -> dict:
        b = self.source.sample(self.sample_ids[idx])
        ti = _track_indices(self, idx)
        ret = {"id": idx, "im": b.im[ti, 0], "ambient": b.ambient[ti, 0],
               "disp": b.disp_gt[ti, 0], "R": b.R[ti, 0], "t": b.t[ti, 0]}
        if self.load_flow:
            ret["flow"] = b.flow[ti][:, ti][:, :, 0]
        if self.load_primary:
            ret["primary_disp"] = b.primary_disp[ti, 0]
        return ret


class MultiDataset:
    """The concatenation of datasets: sample i of the whole is sample i -
    offset of the dataset that holds it."""

    def __init__(self, *datasets):
        self.datasets = []
        self.cum_n_samples = [0]
        self.current_epoch = 0
        for d in datasets:
            self.append(d)

    def append(self, dataset):
        self.datasets.append(dataset)
        self.cum_n_samples.append(self.cum_n_samples[-1] + len(dataset))

    def dataset_updated(self):
        """Recount after a member dataset changed its length."""
        self.cum_n_samples = [0]
        for d in self.datasets:
            self.cum_n_samples.append(self.cum_n_samples[-1] + len(d))

    def __len__(self):
        return self.cum_n_samples[-1]

    def __getitem__(self, idx):
        didx = int(np.searchsorted(self.cum_n_samples, idx,
                                   side="right")) - 1
        return self.datasets[didx][idx - self.cum_n_samples[didx]]

    @property
    def track_length(self):
        return self.datasets[0].track_length


def collate(samples: Sequence[dict]) -> Batch:
    """Stack per-sample dicts to a track-major Batch (axis 1 = batch)."""
    def stack(key):
        if key not in samples[0]:
            return None
        return np.stack([s[key] for s in samples], axis=1)

    flow = None
    if "flow" in samples[0]:
        # (tl, tl, H, W, 2) per sample -> (tl, tl, bs, H, W, 2)
        flow = np.stack([s["flow"] for s in samples], axis=2)
    return Batch(im=stack("im"), ambient=stack("ambient"),
                 disp_gt=stack("disp"), R=stack("R"), t=stack("t"), flow=flow,
                 grad=stack("grad"), primary_disp=stack("primary_disp"),
                 pseudo_gt=stack("pseudo_gt"), sgm_disp=stack("sgm_disp"))


class DataLoader:
    """Threaded prefetching loader: a pool reads and collates the samples of
    the next batches while the consumer runs (or the dataset's
    ``get_batch`` assembles a batch at once, as the wire cache's does), and
    ``transform`` (for example the copy to the device) runs on its own
    thread. Shuffles with the global numpy RNG, like the JAX package's
    loader.

    Data parallel (``world > 1``): ``batch_size`` is the global batch and
    every rank draws the same order (the ranks seed the global RNG alike);
    rank ``rank`` loads only its part of each global batch
    (``parallel/mesh.py::shard_indices``, its block of each of ``accum``
    contiguous chunks). A ragged last batch (no ``drop_last``) is first
    padded to a multiple of the world by repeating its last sample
    (``mesh.pad_batch``'s rule); its first ``n_valid(i)`` samples count."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool = False,
                 prefetch: int = 4, transform=None, rank: int = 0,
                 world: int = 1, accum: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.transform = transform
        self.rank, self.world, self.accum = rank, world, accum

    def n_valid(self, i: int) -> int:
        """The number of real samples in global batch ``i``."""
        return min(self.batch_size, len(self.dataset) - i * self.batch_size)

    def _local(self, idxs: np.ndarray) -> np.ndarray:
        """This rank's part of the global batch ``idxs``."""
        if self.world == 1:
            return idxs
        idxs = idxs[pad_indices(len(idxs), self.world)]
        return idxs[shard_indices(len(idxs), self.rank, self.world,
                                  self.accum)]

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.shuffle(order)
        batches = [self._local(order[i * self.batch_size:
                                     (i + 1) * self.batch_size])
                   for i in range(len(self))]
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        get_batch = getattr(self.dataset, "get_batch", None)

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as ex, \
                        ThreadPoolExecutor(1) as tx:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        b = get_batch(idxs) if get_batch else collate(
                            list(ex.map(self.dataset.__getitem__, idxs)))
                        q.put(tx.submit(self.transform, b)
                              if self.transform else b)
            except BaseException as e:     # surface errors to the consumer
                q.put(e)
                return
            q.put(None)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                if isinstance(item, Future):
                    item = item.result()
                yield item
        finally:
            stop.set()
            while th.is_alive():          # unblock a producer waiting on put
                try:
                    q.get_nowait()
                except queue_mod.Empty:
                    th.join(timeout=0.05)
