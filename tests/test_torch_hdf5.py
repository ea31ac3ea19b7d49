"""The port's HDF5 reader and writer (``depthinspace_tpu_torch/data/hdf5.py``,
numpy alone) against h5py: the JAX fixture's frames.hdf5 and flow.hdf5 read
bit for bit as h5py reads them, files the port writes read bit for bit by
h5py, a property over dtypes, ranks and dataset counts both ways, the
refusal of what the reader does not parse, and TrackDataset reading through
it."""
import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from depthinspace_tpu.data import TrackDataset as JaxTrackDataset
from depthinspace_tpu.data import generate_dataset
from depthinspace_tpu_torch.data import TrackDataset, load_settings
from depthinspace_tpu_torch.data.hdf5 import File, HDF5FormatError, write_hdf5

DTYPES = (np.float32, np.float64, np.uint16, np.int16, np.uint8)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fixture")
    generate_dataset(d, n_samples=2, imsize=(64, 56), seed=5)
    return d


def _assert_same(port: np.ndarray, ref: np.ndarray) -> None:
    assert port.dtype == ref.dtype and port.shape == ref.shape
    assert port.tobytes() == ref.tobytes()


@pytest.mark.parametrize("name", ["frames.hdf5", "flow.hdf5"])
def test_reads_the_jax_fixture_as_h5py(fixture_dir, name):
    """Every dataset of every sample's file (written by h5py: frames.hdf5's
    six, flow.hdf5's twelve, which h5py spreads over two symbol-table
    nodes) is the bytes h5py reads, as a read-only memmap."""
    for sample in sorted(fixture_dir.glob("0*")):
        with h5py.File(sample / name, "r") as ref, File(sample / name) as f:
            assert sorted(f.keys()) == sorted(ref.keys())
            for k in ref:
                arr = f[k]
                assert isinstance(arr, np.memmap) and not arr.flags.writeable
                _assert_same(np.asarray(arr), ref[k][()])


def test_h5py_reads_what_the_port_writes(tmp_path):
    """The hand-off file (one f32 'disp' of (4, 1, H, W)) and a flow.hdf5 of
    12 datasets, as presave_disp and presave_flow write them."""
    rng = np.random.RandomState(0)
    disp = (rng.rand(4, 1, 64, 56) * 128).astype(np.float32)
    write_hdf5(tmp_path / "single_frame_disp.hdf5", {"disp": disp})
    flow = {f"flow_{i}{j}": rng.randn(1, 2, 64, 56).astype(np.float32)
            for i in range(4) for j in range(4) if i != j}
    write_hdf5(tmp_path / "flow.hdf5", flow)
    with h5py.File(tmp_path / "single_frame_disp.hdf5", "r") as f:
        assert list(f.keys()) == ["disp"]
        _assert_same(f["disp"][()], disp)
    with h5py.File(tmp_path / "flow.hdf5", "r") as f:
        assert sorted(f.keys()) == sorted(flow)
        for k, v in flow.items():
            _assert_same(f[k][()], v)


# names an HDF5 link can have: "." is the group itself, "/" a separator
_names = st.text("abcdefghijklmnopqrstuvwxyzABCXYZ0123456789_.-",
                 min_size=1, max_size=12).filter(lambda n: n != ".")
_arrays = st.tuples(st.sampled_from(DTYPES),
                    st.lists(st.integers(1, 4), min_size=1, max_size=5),
                    st.integers(0, 2 ** 31 - 1))


@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(specs=st.dictionaries(_names, _arrays, min_size=1, max_size=16))
def test_roundtrip_property(tmp_path, specs):
    """f32, f64, u16, i16 and u8 of ranks 1-5, 1-16 datasets named in any
    order: the port's file read by h5py and h5py's file read by the port,
    bit for bit (NaN and infinity bit patterns included)."""
    data = {}
    for name, (dtype, shape, seed) in specs.items():
        rng = np.random.RandomState(seed)
        raw = rng.randint(0, 256, int(np.prod(shape)) * np.dtype(dtype)
                          .itemsize).astype(np.uint8)
        data[name] = raw.view(dtype).reshape(shape)
    write_hdf5(tmp_path / "port.hdf5", data)
    with h5py.File(tmp_path / "port.hdf5", "r") as f:
        assert sorted(f.keys()) == sorted(data)
        for k, v in data.items():
            _assert_same(f[k][()], v)
    with h5py.File(tmp_path / "h5py.hdf5", "w") as f:
        for k, v in data.items():
            f.create_dataset(k, data=v)
    with File(tmp_path / "h5py.hdf5") as f:
        assert sorted(f.keys()) == sorted(data)
        for k, v in data.items():
            _assert_same(np.asarray(f[k]), v)


@pytest.mark.parametrize("name", ["", ".", "a/b", "a\0b"])
def test_writer_refuses_names_hdf5_cannot_hold(tmp_path, name):
    """h5py refuses to create these ("." names the root group itself), so
    the writer does too, rather than write a file no reader resolves."""
    with pytest.raises(ValueError, match="HDF5 link name"):
        write_hdf5(tmp_path / "x.hdf5", {name: np.zeros(2, np.float32)})
    assert not (tmp_path / "x.hdf5").exists()


@pytest.mark.parametrize("feature,kwargs,match", [
    ("chunked", {"chunks": (4, 4)}, "chunked layout"),
    ("gzip", {"compression": "gzip"}, "compressed"),
    ("big-endian", {"dtype": ">f4"}, "big-endian"),
])
def test_unsupported_layouts_name_the_feature(tmp_path, feature, kwargs,
                                              match):
    path = tmp_path / f"{feature}.hdf5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.zeros((8, 8), np.float32), **kwargs)
    with pytest.raises(HDF5FormatError, match=match):
        File(path)


@pytest.mark.parametrize("libver,match", [
    (None, "nested groups"), ("latest", "superblock version 3")])
def test_unsupported_structures_name_the_feature(tmp_path, libver, match):
    path = tmp_path / "f.hdf5"
    with h5py.File(path, "w", **({"libver": libver} if libver else {})) as f:
        if libver is None:
            f.create_group("g").create_dataset("x", data=np.zeros(3))
        else:
            f.create_dataset("x", data=np.zeros(3))
    with pytest.raises(HDF5FormatError, match=match):
        File(path)


@pytest.mark.parametrize("train", [False, True])
def test_track_dataset_equals_the_jax_one(fixture_dir, train):
    """TrackDataset over the fixture (frames and flow) through the reader:
    the JAX TrackDataset's fields, dtypes and frame permutation."""
    paths = sorted(str(p) for p in fixture_dir.glob("0*"))
    port = TrackDataset(load_settings(fixture_dir / "settings.pkl"), paths,
                        train=train, load_flow=True)
    ref = JaxTrackDataset(fixture_dir / "settings.pkl", paths, train=train,
                          load_flow=True)
    port.current_epoch = ref.current_epoch = 3
    for i in range(len(paths)):
        a, b = port[i], ref[i]
        assert sorted(a) == sorted(b)
        for k in ("im", "ambient", "disp", "R", "t", "flow"):
            _assert_same(a[k], b[k])
