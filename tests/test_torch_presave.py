"""The port's presave tools against the JAX package's on copies of one JAX
fixture directory (3 samples at 64x56, so DIS-SF pads its tail batch of 8
and DIS-MF its batch of 4): presave_flow's rigid provider, presave_disp for
DIS-SF and DIS-MF from one net_0000.params written by the JAX test's
``serialization.to_bytes(template)``, and the wire-cache field each presave
refreshes against the JAX package's build_wire_cache.

DIS-MF follows the rule of the MF tests (tests/test_torch_mf.py): FuseNet's
neighbour selection turns float ulps into choices, so the two tools are held
together on a flow the forward-backward check rejects everywhere (a
constant 5 px flow.hdf5, which leaves each pixel its own frame's 3x3
candidates), both reading one identical single_frame_disp.hdf5; on the
rigid and predicted flows only the shape, finiteness and range are
checked."""
import json
import shutil
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from depthinspace_tpu.data import generate_dataset
from depthinspace_tpu.data import load_settings as jax_load_settings
from depthinspace_tpu.data.cache import build_wire_cache as jax_build_cache
from depthinspace_tpu.tools import presave_disp as jax_presave_disp
from depthinspace_tpu.tools import presave_flow as jax_presave_flow
from depthinspace_tpu_torch.data import BASE_FIELDS, hdf5
from depthinspace_tpu_torch.tools import build_cache, presave_disp, presave_flow
from flax import serialization

H, W, N = 64, 56, 3
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """base/: the JAX fixture; jax/ and port/: a copy each, the port's with
    a wire cache built by the port, so its presaves refresh a field."""
    r = tmp_path_factory.mktemp("presave")
    generate_dataset(r / "base", n_samples=N, imsize=(H, W), seed=5)
    for name in ("jax", "port"):
        shutil.copytree(r / "base", r / name)
    build_cache.main(["--data_dir", str(r / "port")])
    return r


def _samples(d):
    return sorted(p for p in d.glob("0*") if p.is_dir())


def _read(path):
    with hdf5.File(path) as f:
        return {k: np.array(f[k]) for k in f.keys()}


def _write_params(root, arch, template):
    for name in ("jax", "port"):
        d = root / name / "out" / arch
        d.mkdir(parents=True, exist_ok=True)
        (d / "net_0000.params").write_bytes(serialization.to_bytes(template))


def _run_both(root, *argv):
    for name in ("jax", "port"):
        args = list(argv) + ["--epoch", "0", "--data_dir",
                             str(root / name), "--output_dir",
                             str(root / name / "out")]
        if name == "jax":
            jax_presave_disp.main(args)
        else:
            presave_disp.main(args, device="cpu")


def test_presave_flow_rigid_matches_jax(root):
    """flow.hdf5: the same 12 datasets (1, 2, H, W) f32 within 1e-6 (the
    same numpy arithmetic: measured equal)."""
    jax_presave_flow.main(["--provider", "rigid", "--data_dir",
                           str(root / "jax")])
    presave_flow.main(["--provider", "rigid", "--data_dir",
                       str(root / "port")])
    for sample in _samples(root / "jax"):
        with h5py.File(sample / "flow.hdf5", "r") as f:
            ref = {k: f[k][()] for k in f}
        out = _read(root / "port" / sample.name / "flow.hdf5")
        assert sorted(out) == sorted(ref) and len(out) == 12
        for k in ref:
            assert out[k].dtype == np.float32 and out[k].shape == (1, 2, H, W)
            np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-6)


def test_rigid_flow_roundtrip_consistency(root):
    """flow_01 + flow_10 circle back to ~0 for a static scene away from
    occlusions (tests/test_tools.py's check, on the port's provider): the
    median residual of flow_10 sampled where flow_01 lands is below 0.5 px."""
    settings = jax_load_settings(root / "base" / "settings.pkl")
    with hdf5.File(_samples(root / "base")[0] / "frames.hdf5") as f:
        disp = np.asarray(f["disp"][:, 0])
        R, t = np.asarray(f["R"]), np.asarray(f["t"])
    depth = settings.baseline * settings.focal_length / np.maximum(disp, 1e-6)
    f01 = presave_flow.rigid_flow(depth[0], settings.K, R[0], t[0], R[1], t[1])
    f10 = presave_flow.rigid_flow(depth[1], settings.K, R[1], t[1], R[0], t[0])
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    x = np.clip(np.round(u + f01[0]).astype(int), 0, W - 1)
    y = np.clip(np.round(v + f01[1]).astype(int), 0, H - 1)
    resid = np.sqrt(((f01 + f10[:, y, x]) ** 2).sum(0))
    assert np.median(resid) < 0.5


def test_sf_presave_matches_jax(root):
    """single_frame_disp.hdf5 (4, 1, H, W) f32 in steps of 1/256 px, within
    one step of the JAX tool's (DispNet's f32 sums in another order can
    cross a rounding edge; measured on < 0.02 % of pixels)."""
    settings = jax_load_settings(root / "base" / "settings.pkl")
    template, _ = jax_presave_disp.build_sf_infer(settings)
    _write_params(root, "single_frame", template)
    _run_both(root, "single_frame")
    for sample in _samples(root / "jax"):
        with h5py.File(sample / "single_frame_disp.hdf5", "r") as f:
            ref = f["disp"][()]
        out = _read(root / "port" / sample.name / "single_frame_disp.hdf5")
        assert list(out) == ["disp"] and out["disp"].dtype == np.float32
        assert out["disp"].shape == (4, 1, H, W)
        np.testing.assert_array_equal(out["disp"] * 256,
                                      np.round(out["disp"] * 256))
        np.testing.assert_allclose(out["disp"], ref, rtol=0,
                                   atol=1.0 / 256 + 1e-6)


def test_mf_presave_matches_jax_on_rejected_flow(root):
    """multi_frame_disp.hdf5 within 1/256 px of the JAX tool's (FuseNet f32,
    its default), on a constant 5 px flow.hdf5 and one identical primary
    (the port's DIS-SF presave, copied to the JAX tool's directory)."""
    rejected = np.zeros((1, 2, H, W), np.float32)
    rejected[:, 0] = 5.0                   # |f + f_back|^2 = 100 > 1.0
    for sample in _samples(root / "port"):
        hdf5.write_hdf5(sample / "flow.hdf5", {
            f"flow_{i}{j}": rejected for i in range(4) for j in range(4)
            if i != j})
        for name in ("flow.hdf5", "single_frame_disp.hdf5"):
            shutil.copy(sample / name, root / "jax" / sample.name / name)
    settings = jax_load_settings(root / "base" / "settings.pkl")
    template, _, _ = jax_presave_disp.build_mf_infer(settings)
    _write_params(root, "multi_frame", template)
    _run_both(root, "multi_frame", "--flow_source", "file")
    for sample in _samples(root / "jax"):
        with h5py.File(sample / "multi_frame_disp.hdf5", "r") as f:
            ref = f["disp"][()]
        out = _read(root / "port" / sample.name / "multi_frame_disp.hdf5")
        assert out["disp"].shape == (4, 1, H, W)
        assert np.isfinite(out["disp"]).all()
        np.testing.assert_allclose(out["disp"], ref, rtol=0,
                                   atol=1.0 / 256 + 1e-6)


@pytest.mark.parametrize("flow_source", ["rigid", "pred"])
def test_mf_presave_rigid_and_pred_flow(root, flow_source):
    """The flow computed on the device from the GT disparity or the primary
    and the poses: shape, finiteness and range only."""
    presave_disp.main(["multi_frame", "--epoch", "0", "--flow_source",
                       flow_source, "--batch", "2", "--data_dir",
                       str(root / "port"), "--output_dir",
                       str(root / "port" / "out")], device="cpu")
    for sample in _samples(root / "port"):
        d = _read(sample / "multi_frame_disp.hdf5")["disp"]
        assert d.shape == (4, 1, H, W) and np.isfinite(d).all()
        assert d.min() >= 0 and d.max() <= 128


def test_presave_flow_farneback_matches_jax(root):
    """--provider farneback: the JAX tool's 12 datasets (1, 2, H, W)
    float32 from cv2, within tests/test_torch_farneback.py's tolerance
    (mean |d| <= 1e-3 px, 99.9th percentile <= 5e-2 px; measured equal bit
    for bit). At 64x56 no pyramid level runs; the pyramid is held there at
    512x432."""
    for name in ("fb_jax", "fb_port"):
        shutil.copytree(root / "base", root / name)
    jax_presave_flow.main(["--provider", "farneback", "--data_dir",
                           str(root / "fb_jax")])
    presave_flow.main(["--provider", "farneback", "--data_dir",
                       str(root / "fb_port")], device="cpu")
    for sample in _samples(root / "fb_jax"):
        with h5py.File(sample / "flow.hdf5", "r") as f:
            ref = {k: f[k][()] for k in f}
        out = _read(root / "fb_port" / sample.name / "flow.hdf5")
        assert sorted(out) == sorted(ref) and len(out) == 12
        d = []
        for k in ref:
            assert out[k].dtype == np.float32 and out[k].shape == (1, 2, H, W)
            d.append(np.abs(out[k] - ref[k]).ravel())
        d = np.concatenate(d)
        assert d.mean() <= 1e-3 and np.quantile(d, 0.999) <= 5e-2


@pytest.mark.parametrize("argv,written", [
    (["multi_frame", "--flow_source", "net"], "multi_frame_disp.hdf5"),
    (["--provider", "learned"], "flow.hdf5"),
], ids=["presave_disp-net", "presave_flow-learned"])
def test_flownet_providers_write(root, argv, written):
    """The FlowNet choices (output/flownet.msgpack) write their files:
    multi_frame_disp.hdf5 (4, 1, H, W) in [0, 128], and flow.hdf5's 12
    flows (1, 2, H, W), finite float32. The values are held to the JAX tool
    and to the port's own composition in tests/test_torch_flow_net_paths.py.
    """
    weights = str(REPO / "output" / "flownet.msgpack")
    d = ["--data_dir", str(root / "port"), "--flow_params", weights]
    if argv[0] == "multi_frame":
        presave_disp.main(argv + d + ["--epoch", "0", "--output_dir",
                                      str(root / "port" / "out")],
                          device="cpu")
    else:
        presave_flow.main(argv + d, device="cpu")
    for sample in _samples(root / "port"):
        out = _read(sample / written)
        if written == "flow.hdf5":
            assert len(out) == 12
            shapes = {(1, 2, H, W)}
        else:
            assert list(out) == ["disp"]
            assert 0 <= out["disp"].min() and out["disp"].max() <= 128
            shapes = {(4, 1, H, W)}
        assert {v.shape for v in out.values()} == shapes
        assert all(v.dtype == np.float32 and np.isfinite(v).all()
                   for v in out.values())


def _assert_caches_equal(port_dir, ref_dir):
    port = port_dir / "wire_cache"
    ref = ref_dir / "wire_cache"
    meta = json.loads((ref / "meta.json").read_text())
    assert json.loads((port / "meta.json").read_text()) == meta
    for field in meta["fields"]:
        a, b = np.load(port / f"{field}.npy"), np.load(ref / f"{field}.npy")
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field


def test_cache_refresh_equals_the_jax_build(root):
    """After both presaves the port's cache (built by build_cache, refreshed
    by each presave) equals the JAX build_wire_cache of the same HDF5 files:
    the .npy bytes and meta.json."""
    ref = root / "ref_cache"
    shutil.copytree(root / "port", ref, ignore=shutil.ignore_patterns(
        "wire_cache", "out"))
    jax_build_cache(ref, fields=list(BASE_FIELDS) + ["primary_disp",
                                                     "pseudo_gt"])
    _assert_caches_equal(root / "port", ref)


def test_build_cache_records_missing_samples_as_jax(root):
    """A presave over a subset (--ranges): the field's uncovered samples are
    zero-filled and listed as missing, as by the JAX build; an existing
    field is kept unless --force."""
    for name in ("a", "b"):
        shutil.copytree(root / "base", root / name)
    for sample in _samples(root / "a")[::2]:
        disp = np.full((4, 1, H, W), 3.5 + int(sample.name), np.float32)
        for name in ("a", "b"):
            hdf5.write_hdf5(root / name / sample.name /
                            "single_frame_disp.hdf5", {"disp": disp})
    fields = ",".join(list(BASE_FIELDS) + ["primary_disp"])
    build_cache.main(["--data_dir", str(root / "a"), "--fields", fields])
    jax_build_cache(root / "b", fields=fields.split(","))
    _assert_caches_equal(root / "a", root / "b")
    meta = json.loads((root / "a" / "wire_cache" / "meta.json").read_text())
    assert meta["fields"]["primary_disp"]["missing"] == ["00000001"]
    assert not np.load(root / "a" / "wire_cache" / "primary_disp.npy")[1].any()

    sample = _samples(root / "a")[0]
    hdf5.write_hdf5(sample / "single_frame_disp.hdf5",
                    {"disp": np.ones((4, 1, H, W), np.float32)})
    build_cache.main(["--data_dir", str(root / "a"), "--fields",
                      "primary_disp"])
    kept = np.load(root / "a" / "wire_cache" / "primary_disp.npy")
    assert kept[0, 0, 0, 0] == int(3.5 * 256 + 0.5)
    build_cache.main(["--data_dir", str(root / "a"), "--fields",
                      "primary_disp", "--force"])
    assert np.load(root / "a" / "wire_cache" / "primary_disp.npy")[
        0, 0, 0, 0] == 256
