"""The port's 16-bit wire encoding and wire-cache reader against the JAX
package's, bit for bit, on the CPU: encode and decode on seeded batches
with their edge values; the cache reader on a cache built by the JAX
package over a 64x56 fixture; the worker's choice of the cache over the
flag grid; and the batches that reach the port's steps and its test metric,
from HDF5, the cache and in-memory samples. Every comparison here is exact
(assert_array_equal on the bits), none has a tolerance."""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from depthinspace_tpu.data import DataLoader as JaxDataLoader
from depthinspace_tpu.data import generate_dataset
from depthinspace_tpu.data.cache import BASE_FIELDS as JAX_BASE_FIELDS
from depthinspace_tpu.data.cache import CachedTrackDataset as JaxCached
from depthinspace_tpu.data.cache import build_wire_cache
from depthinspace_tpu.data.dataset import Batch as JaxBatch
from depthinspace_tpu.data.dataset import collate as jax_collate
from depthinspace_tpu.data.settings import load_settings as jax_settings
from depthinspace_tpu.data.wire import decode_batch_np as jax_decode_np
from depthinspace_tpu.data.wire import encode_batch as jax_encode
from depthinspace_tpu.train.multi_frame import (
    MultiFrameWorker as JaxMFWorker)
from depthinspace_tpu.train.single_frame import (
    SingleFrameWorker as JaxSFWorker)
from depthinspace_tpu.train.worker import Worker as JaxWorker
from depthinspace_tpu_torch.config import RunConfig
from depthinspace_tpu_torch.data import (BASE_FIELDS, Batch,
                                         CachedTrackDataset, SyntheticSource,
                                         batch_to_torch, collate,
                                         decode_batch, decode_batch_np,
                                         decode_disp_np, encode_batch,
                                         has_wire_cache, load_settings)
from depthinspace_tpu_torch.data.dataset import SyntheticTrackDataset
from depthinspace_tpu_torch.train.single_frame import SingleFrameWorker
from depthinspace_tpu_torch.train.worker import Worker

H, W = 64, 56
FIELDS = ("primary_disp", "pseudo_gt")


def _as_jax(b: Batch) -> JaxBatch:
    return JaxBatch(**b._asdict())


def _assert_same(a, b, what=""):
    """Two batches field by field: both None, or the same dtype, shape and
    bits."""
    for k in Batch._fields:
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), f"{what} {k}"
        if x is not None:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, f"{what} {k}: {x.dtype} {y.dtype}"
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {k}")


def _edge_batch(seed, tl=4, bs=2, h=9, w=11, with_flow=True, extra=True):
    """A seeded batch whose fields hold the encoding's edge values: below
    0, 0, 1, above 1, exact rounding ties, disparities past 256 px, flows
    past +-128 px and at half steps of 1/256 px."""
    rng = np.random.RandomState(seed)

    def unit():
        v = rng.uniform(-0.2, 1.2, (tl, bs, h, w)).astype(np.float32)
        flat = v.reshape(-1)
        flat[:8] = [0.0, 1.0, -1e-9, 1.0 + 1e-7, 0.5 / 65535, 1.5 / 65535,
                    65534.5 / 65535, 2.5 / 65535]
        return v

    def disp():
        v = rng.uniform(-5.0, 300.0, (tl, bs, h, w)).astype(np.float32)
        v.reshape(-1)[:6] = [0.0, 255.99, 256.0, 300.0, 0.5 / 256,
                             1.5 / 256]
        return v

    flow = None
    if with_flow:
        flow = rng.uniform(-140.0, 140.0, (tl, tl, bs, h, w, 2)).astype(
            np.float32)
        flow.reshape(-1)[:8] = [128.0, -128.0, 127.999, -128.01, 0.5 / 256,
                                1.5 / 256, -2.5 / 256, 1e9]
    return Batch(im=unit(), ambient=unit(), disp_gt=disp(),
                 R=rng.randn(tl, bs, 3, 3).astype(np.float32),
                 t=rng.randn(tl, bs, 3).astype(np.float32), flow=flow,
                 grad=unit() if extra else None,
                 primary_disp=disp() if extra else None,
                 pseudo_gt=None, sgm_disp=disp() if extra else None)


@pytest.mark.parametrize("seed,with_flow,extra", [(0, True, True),
                                                  (1, False, False),
                                                  (2, True, False)])
def test_encode_and_decode_equal_the_jax_package(seed, with_flow, extra):
    b = _edge_batch(seed, with_flow=with_flow, extra=extra)
    enc = encode_batch(b)
    ref = jax_encode(_as_jax(b))
    _assert_same(enc, ref, "encode")
    assert enc.im.dtype == np.uint16 and enc.disp_gt.dtype == np.uint16
    assert enc.R.dtype == np.float32
    if with_flow:
        assert enc.flow.dtype == np.int16
        assert enc.flow.max() == 32767 and enc.flow.min() == -32768
    dec_ref = jax_decode_np(ref)
    _assert_same(decode_batch_np(enc), dec_ref, "decode_batch_np")
    got = decode_batch(batch_to_torch(enc, "cpu"))
    _assert_same(Batch(*(None if v is None else v.numpy() for v in got)),
                 dec_ref, "decode_batch")
    # 16-bit fields cross as 16 bits; float32 fields pass through decode
    on_dev = batch_to_torch(enc, "cpu")
    assert on_dev.im.dtype == torch.uint16 and on_dev.R.dtype == torch.float32
    plain = batch_to_torch(b, "cpu")
    assert all(x is y for x, y in zip(decode_batch(plain), plain))
    np.testing.assert_array_equal(decode_disp_np(enc.disp_gt),
                                  dec_ref.disp_gt)


def test_decode_of_integers_that_are_not_wire_fields_passes_through():
    """Only the wire fields in their wire dtype are decoded (a uint16 R or
    a float32 flow is left alone), as in the JAX package."""
    b = _edge_batch(3, extra=False)
    odd = b._replace(R=np.arange(36, dtype=np.uint16).reshape(4, 1, 3, 3),
                     flow=b.flow)
    _assert_same(decode_batch_np(odd), jax_decode_np(_as_jax(odd)))
    got = decode_batch(batch_to_torch(odd, "cpu"))
    assert got.R.dtype == torch.uint16 and got.flow.dtype == torch.float32


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    """8 fixture samples at 64x56 written by the JAX package, a presaved
    primary and pseudo GT per sample (seeded), and a wire cache built by
    the JAX package with every field."""
    import h5py
    d = tmp_path_factory.mktemp("wire_ds")
    generate_dataset(d, n_samples=8, imsize=(H, W), seed=5)
    rng = np.random.RandomState(6)
    for sample in sorted(p for p in d.glob("0*") if p.is_dir()):
        for name in ("single_frame_disp.hdf5", "multi_frame_disp.hdf5"):
            with h5py.File(sample / name, "w") as f:
                f["disp"] = rng.uniform(0, 40, (4, 1, H, W)).astype(
                    np.float32)
    build_wire_cache(d, fields=list(JAX_BASE_FIELDS) + list(FIELDS))
    return d


def _names(d):
    return sorted(p.name for p in d.glob("0*") if p.is_dir())


@pytest.mark.parametrize("train,epoch,extra", [
    (True, 0, ()), (True, 1, ()), (False, 0, ()), (True, 1, FIELDS),
    (False, 0, FIELDS)])
def test_cached_dataset_equals_the_jax_reader(fixture_dir, train, epoch,
                                              extra):
    names = _names(fixture_dir)[1:7]
    kw = dict(train=train, load_primary="primary_disp" in extra,
              load_pseudo_gt="pseudo_gt" in extra)
    port = CachedTrackDataset(fixture_dir, names, **kw)
    ref = JaxCached(fixture_dir, names, **kw)
    port.current_epoch = ref.current_epoch = epoch
    assert len(port) == len(ref) == 6
    for idxs in ([0, 1, 2, 3], [5, 2], [4]):
        _assert_same(port.get_batch(idxs), ref.get_batch(idxs), "get_batch")
    for i in range(len(port)):
        got, want = port[i], ref[i]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _assert_same(collate([port[i] for i in (3, 0)]),
                 jax_collate([ref[i] for i in (3, 0)]), "collate")
    assert has_wire_cache(fixture_dir, list(BASE_FIELDS) + list(extra))


def test_missing_field_or_sample_raises_in_both_packages(fixture_dir,
                                                         tmp_path):
    names = _names(fixture_dir)
    for cls in (CachedTrackDataset, JaxCached):
        with pytest.raises(FileNotFoundError, match="not in wire cache"):
            cls(fixture_dir, names + ["99999999"])
        with pytest.raises(FileNotFoundError, match="sgm_disp"):
            cls(fixture_dir, names, load_sgm=True)
    # a field built without some samples: those are refused
    import json
    import shutil
    d = tmp_path / "partial"
    shutil.copytree(fixture_dir / "wire_cache", d / "wire_cache")
    meta = json.loads((d / "wire_cache" / "meta.json").read_text())
    meta["fields"]["pseudo_gt"]["missing"] = [names[2]]
    (d / "wire_cache" / "meta.json").write_text(json.dumps(meta))
    for cls in (CachedTrackDataset, JaxCached):
        with pytest.raises(FileNotFoundError, match="does not cover"):
            cls(d, names, load_pseudo_gt=True)
        assert len(cls(d, names[:2] + names[3:], load_pseudo_gt=True)) == 7
    assert not has_wire_cache(d / "nowhere")


def _cfg(data_dir, **kw):
    base = dict(data_dir=data_dir, output_dir=data_dir, wire_cache=True,
                flow_source="rigid", device_augment=True,
                data_type="synthetic", track_length=4, use_pseudo_gt=False)
    base.update(kw)
    return SimpleNamespace(**base)


def _port_dataset(arch, cfg, settings, paths, train):
    me = SimpleNamespace(architecture=arch, cfg=cfg, settings=settings,
                         source=None)
    me.cached_dataset = functools.partial(Worker.cached_dataset, me)
    return Worker._dataset(me, paths, train)


def _jax_dataset(arch, cfg, settings, paths, train):
    me = SimpleNamespace(cfg=cfg, settings=settings)
    me.cached_dataset = functools.partial(JaxWorker.cached_dataset, me)
    cls = JaxMFWorker if arch == "multi_frame" else JaxSFWorker
    return cls._dataset(me, paths, train)


def _describe(dset):
    """What a dataset reads: the cache and its fields, or HDF5 and what it
    loads, and whether it augments on the host."""
    if isinstance(dset, (CachedTrackDataset, JaxCached)):
        return ("cache", tuple(sorted(dset.fields)), dset.train,
                len(dset))
    return ("hdf5", dset.load_flow, dset.load_primary, dset.load_pseudo_gt,
            dset.train, dset.data_aug, len(dset.sample_paths))


@pytest.mark.parametrize("arch,pseudo", [("single_frame", False),
                                         ("single_frame", True),
                                         ("multi_frame", False),
                                         ("multi_frame", True)])
def test_worker_picks_the_cache_where_the_jax_worker_does(fixture_dir,
                                                          tmp_path, arch,
                                                          pseudo):
    """The flag grid (wire_cache, flow_source, device_augment, the split)
    for DIS-SF, DIS-FTSF (SF with the pseudo GT) and DIS-MF, on the full
    cache and on one that lacks the pseudo GT."""
    import json
    import shutil
    partial = tmp_path / "partial"
    shutil.copytree(fixture_dir / "wire_cache", partial / "wire_cache")
    meta = json.loads((partial / "wire_cache" / "meta.json").read_text())
    del meta["fields"]["pseudo_gt"]
    (partial / "wire_cache" / "meta.json").write_text(json.dumps(meta))
    settings = load_settings(fixture_dir / "settings.pkl")
    jsettings = jax_settings(fixture_dir / "settings.pkl")
    paths = [str(fixture_dir / n) for n in _names(fixture_dir)]
    seen = set()
    for data_dir in (fixture_dir, partial):
        for wire in (True, False):
            for flow in ("file", "rigid", "pred"):
                for aug in (True, False):
                    for train in (True, False):
                        cfg = _cfg(data_dir, wire_cache=wire,
                                   flow_source=flow, device_augment=aug,
                                   use_pseudo_gt=pseudo)
                        got = _describe(_port_dataset(arch, cfg, settings,
                                                      paths, train))
                        want = _describe(_jax_dataset(arch, cfg, jsettings,
                                                      paths, train))
                        assert got == want, (data_dir.name, wire, flow, aug,
                                             train)
                        seen.add(got[0])
    assert seen == {"cache", "hdf5"}


def _worker_batches(worker, dset, n_batches, seed):
    """The batches that reach the port worker's train step in one epoch
    (the loader's), after the step's decode_batch, as numpy."""
    got = []

    def step(batch, epoch):
        got.append(Batch(*(None if v is None else v.numpy()
                           for v in decode_batch(batch))))
        return torch.zeros(4)
    worker.cfg.max_train_iter = n_batches
    np.random.seed(seed)
    worker.train_epoch(0, step, dset)
    return got


@pytest.mark.parametrize("wire,flow,kind", [(True, "rigid", "cache"),
                                            (False, "rigid", "hdf5"),
                                            (True, "file", "hdf5")])
def test_train_batches_equal_the_jax_workers_decoded(fixture_dir, tmp_path,
                                                     wire, flow, kind):
    """The port worker's train batches, as its step decodes them, against
    decode_batch_np(encode_batch(b)) of the JAX worker's loader on the same
    split, shuffle seed and epoch."""
    cfg = RunConfig(data_dir=fixture_dir, output_dir=tmp_path, epochs=1,
                    train_batch_size=2, num_workers=2, wire_cache=wire,
                    flow_source=flow)
    worker = SingleFrameWorker(cfg, device="cpu")
    dset = worker.make_train_set()
    assert _describe(dset)[0] == kind
    got = _worker_batches(worker, dset, 3, seed=11)
    jcfg = _cfg(fixture_dir, wire_cache=wire, flow_source=flow)
    jdset = _jax_dataset("single_frame", jcfg,
                         jax_settings(fixture_dir / "settings.pkl"),
                         [str(p) for p in sorted(fixture_dir.glob("0*/"))][2:],
                         True)
    assert _describe(jdset)[0] == kind
    np.random.seed(11)
    loader = JaxDataLoader(jdset, 2, shuffle=True, num_workers=2,
                           drop_last=True, transform=jax_encode)
    want = [jax_decode_np(b) for _, b in zip(range(3), loader)]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_same(g, w, kind)
        assert (g.flow is not None) == (flow == "file")


def test_in_memory_batches_are_encoded_and_decoded(tmp_path):
    """SyntheticTrackDataset's batches take the same encoding: what the
    step sees is decode_batch_np(encode_batch(b)) of the collated
    samples, by the JAX package's functions."""
    from depthinspace_tpu_torch.data import make_settings
    src = SyntheticSource(make_settings(32, 24), 6, seed=3)
    cfg = RunConfig(data_dir=tmp_path, output_dir=tmp_path, epochs=1,
                    train_batch_size=2, num_workers=1)
    worker = SingleFrameWorker(cfg, device="cpu", source=src)
    dset = worker.make_train_set()
    assert isinstance(dset, SyntheticTrackDataset)
    got = _worker_batches(worker, dset, 2, seed=4)
    np.random.seed(4)
    order = np.arange(len(dset))
    np.random.shuffle(order)
    for i, g in enumerate(got):
        b = collate([dset[j] for j in order[2 * i:2 * i + 2]])
        want = jax_decode_np(jax_encode(_as_jax(b)))
        _assert_same(g, want, "in memory")
        assert g.im.dtype == np.float32
        # the quantization happened: not the float32 samples themselves
        assert not np.array_equal(g.im, b.im)


def test_test_epoch_scores_against_the_decoded_gt(fixture_dir, tmp_path):
    """An eval step that returns the GT as its u16 disp0 scores zero error:
    the metric compares with the decoded GT, as the JAX worker does (the
    float32 GT would differ by up to 1/512 px)."""
    cfg = RunConfig(data_dir=fixture_dir, output_dir=tmp_path, epochs=1,
                    test_batch_size=2, num_workers=1, flow_source="rigid")
    worker = SingleFrameWorker(cfg, device="cpu")
    dset = worker.make_test_sets()[0].dset
    assert isinstance(dset, CachedTrackDataset)

    def eval_step(batch, epoch):
        assert batch.disp_gt.dtype == torch.uint16
        return batch.disp_gt, torch.ones(6)
    worker.test_epoch(0, 0, eval_step, dset)
    metrics = worker.metric_data["0"]["test"]["0"]
    assert metrics["dist2_max"] == 0.0 and metrics["of0.1"] == 0.0


def test_cache_written_by_numpy_alone(tmp_path):
    """A cache written with numpy (meta.json and .npy files, as the JAX
    package writes them) is read without the JAX package's builder."""
    import json
    d = tmp_path / "np_cache"
    (d / "wire_cache").mkdir(parents=True)
    rng = np.random.RandomState(0)
    arrays = {"im": rng.randint(0, 65536, (3, 4, 5, 6)).astype(np.uint16),
              "ambient": rng.randint(0, 65536, (3, 4, 5, 6)).astype(
                  np.uint16),
              "disp": rng.randint(0, 65536, (3, 4, 5, 6)).astype(np.uint16),
              "R": rng.randn(3, 4, 3, 3).astype(np.float32),
              "t": rng.randn(3, 4, 3).astype(np.float32)}
    for k, v in arrays.items():
        np.save(d / "wire_cache" / f"{k}.npy", v)
    names = ["00000000", "00000001", "00000002"]
    (d / "wire_cache" / "meta.json").write_text(json.dumps({
        "version": 1, "names": names,
        "fields": {k: {"shape": list(v.shape), "dtype": v.dtype.name,
                       "missing": []} for k, v in arrays.items()}}))
    for cls in (CachedTrackDataset, JaxCached):
        b = cls(d, names[1:], train=False).get_batch([1, 0])
        np.testing.assert_array_equal(b.im[:, 0], arrays["im"][2])
        np.testing.assert_array_equal(b.t[:, 1], arrays["t"][1])
