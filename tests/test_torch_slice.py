"""The ported slice end to end against the JAX package on the CPU: the DIS-SF
evaluation step at 64x56, tl=4, bs=1 (flow from the batch and from the
prediction), the disparity server on a ragged request, and the port
running, reading and writing HDF5 with jax, flax, h5py, cv2 and the JAX
package absent."""
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from depthinspace_tpu.data.dataset import Batch as JaxBatch
from depthinspace_tpu.data.settings import Settings
from depthinspace_tpu.models import DispNet as JaxDispNet
from depthinspace_tpu.serve import DisparityServer as JaxServer
from depthinspace_tpu.train.objective import make_loss_context as jax_ctx
from depthinspace_tpu.train.checkpoint import (
    save_net_params as jax_save_net_params)
from depthinspace_tpu.train.steps import _make_step_fns
from depthinspace_tpu_torch.data import (batch_to_torch, make_dot_pattern,
                                         make_track_batch)
from depthinspace_tpu_torch.models import DispNet, dispnet_state_dict_from_flax
from depthinspace_tpu_torch.serve import DisparityServer, _bucket
from depthinspace_tpu_torch.train import make_loss_context, make_sf_eval_step
from depthinspace_tpu_torch.train.checkpoint import save_net_params

H, W = 64, 56
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup():
    K = np.array([[435.2, 0, W / 2], [0, 435.2, H / 2], [0, 0, 1]],
                 np.float32)
    settings = Settings(imsize=(H, W), pattern=make_dot_pattern(H, W),
                        baseline=0.025, K=K)
    model = JaxDispNet(max_disp=128.0)
    params = model.init(jax.random.key(0), jnp.zeros((1, H, W, 2)))
    net = DispNet().eval()
    net.load_state_dict(dispnet_state_dict_from_flax(
        jax.tree.map(np.asarray, params)))
    return settings, model, params, net


@pytest.mark.parametrize("flow_source", ["file", "pred"])
def test_sf_eval_step_matches_jax(setup, flow_source):
    """Components within rtol 1e-4 (measured ~2e-6: conv sums in another
    order); disp0 in u16 x256 units within 1 unit, equal on >= 99.9% of
    pixels (a float difference can cross a rounding edge)."""
    settings, model, params, net = setup
    batch = make_track_batch(settings, tl=4, bs=1, seed=1,
                             disp_range=(2.0, 12.0))
    ctx = jax_ctx(settings, track_length=4, flow_source=flow_source)
    _, eval_step, consts = _make_step_fns(model, ctx, optax.adam(1e-4),
                                          "single_frame")
    d_ref, c_ref = jax.jit(eval_step)(params, JaxBatch(**batch._asdict()),
                                      jnp.asarray(0.0), consts)

    step = make_sf_eval_step(net, make_loss_context(
        settings, 4, device="cpu", flow_source=flow_source))
    d_out, c_out = step(batch_to_torch(batch, "cpu"))

    assert c_out.shape == (6,) and bool(torch.all(c_out > 0))
    np.testing.assert_allclose(c_out.numpy(), np.asarray(c_ref), rtol=1e-4,
                               atol=0)
    assert d_out.dtype == torch.uint16 and d_out.shape == (4, 1, H, W)
    d_ref = np.asarray(d_ref).astype(np.int64)
    d_out = d_out.numpy().astype(np.int64)
    assert np.abs(d_out - d_ref).max() <= 1
    assert np.mean(d_out == d_ref) >= 0.999


def test_bucket():
    assert _bucket(1, 32) == 1
    assert _bucket(3, 32) == 4
    assert _bucket(33, 32) == 32


def test_server_matches_jax_server(setup, tmp_path):
    """Ragged request (4 + 2), outputs within 1e-3 px of the JAX server's;
    a net_%04d.params written by the JAX package, and one written by the
    port, load through from_net_params to the same outputs."""
    _, _, params, _ = setup
    rng = np.random.RandomState(0)
    ims = rng.rand(6, H, W).astype(np.float32)
    ref = JaxServer(params, imsize=(H, W), max_batch=4).infer(ims)
    srv = DisparityServer.from_jax_params(jax.tree.map(np.asarray, params),
                                          imsize=(H, W), max_batch=4,
                                          device="cpu")
    srv.warmup()
    out = srv.infer(ims)
    assert out.shape == (6, H, W)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_path = jax_save_net_params(tmp_path / "jax", 7, params)
    port_path = save_net_params(tmp_path / "port", 7, srv.model)
    for path in (jax_path, port_path):
        again = DisparityServer.from_net_params(path, imsize=(H, W),
                                                max_batch=4, device="cpu")
        np.testing.assert_array_equal(again.infer(ims), out)


def test_port_runs_without_jax_flax_h5py_cv2(tmp_path):
    """Imports every module of the port and runs the tiny slice in a process
    where the JAX stack, h5py, cv2, msgpack, matplotlib and the JAX package
    cannot be imported: an eval step, the server, one train step, and the
    worker for one epoch on in-memory synthetic samples, with a resume; a
    wire cache written with numpy, read, and trained and tested from by the
    worker; a dataset directory written through data/hdf5.py, read back by
    TrackDataset, and presave_disp single_frame over it; then FuseNet, one
    DIS-MF train step and one TrackDisparityServer request, with the flow
    given and with output/flownet.msgpack's FlowNet computing it; a
    plane-scene fixture generated, read back with host augmentation, one
    augment_frame with the shear, and one StreamingEvalMetric update."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys, time
        from pathlib import Path
        T0 = time.perf_counter()
        def mark(phase):
            print(f"{time.perf_counter() - T0:7.1f} s  {phase}",
                  file=sys.stderr, flush=True)
        BLOCKED = ("jax", "flax", "optax", "orbax", "msgpack", "h5py", "cv2",
                   "matplotlib", "depthinspace_tpu")
        for name in BLOCKED:
            sys.modules[name] = None
        import torch
        import depthinspace_tpu_torch as pkg
        for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(mod.name)
        mark("imports")
        from depthinspace_tpu_torch.config import RunConfig
        from depthinspace_tpu_torch.data import (SyntheticSource,
                                                 batch_to_torch, make_settings,
                                                 make_track_batch)
        from depthinspace_tpu_torch.models import DispNet, init_dispnet_
        from depthinspace_tpu_torch.serve import DisparityServer
        from depthinspace_tpu_torch.train import (TrainState,
                                                  make_loss_context,
                                                  make_sf_eval_step,
                                                  make_sf_train_step)
        from depthinspace_tpu_torch.train.single_frame import (
            SingleFrameWorker)
        s = make_settings(32, 24)
        b = make_track_batch(s, tl=4, bs=1, seed=0, disp_range=(2.0, 8.0))
        net = init_dispnet_(DispNet(), torch.Generator().manual_seed(0)).eval()
        ctx = make_loss_context(s, 4, device="cpu")
        _, comps = make_sf_eval_step(net, ctx)(batch_to_torch(b, "cpu"))
        assert comps.shape == (6,) and bool(torch.isfinite(comps).all())
        mark("eval step")
        out = DisparityServer(net, imsize=(32, 24), max_batch=2,
                              device="cpu").infer(b.im[0])
        assert out.shape == (1, 32, 24)
        mark("server")
        state = TrainState.create(net, device="cpu")
        comps = make_sf_train_step(net, ctx, state)(batch_to_torch(b, "cpu"))
        assert state.step == 1 and bool(torch.isfinite(comps).all())
        mark("train step")
        cfg = RunConfig(data_dir=Path("."), output_dir=Path(sys.argv[1]),
                        epochs=1, train_batch_size=1, max_train_iter=1,
                        test_batch_size=1, num_workers=1)
        src = SyntheticSource(s, 3)
        SingleFrameWorker(cfg, device="cpu", source=src).do("retrain")
        cfg.epochs = 2
        SingleFrameWorker(cfg, device="cpu", source=src).do("resume")
        exp = Path(sys.argv[1]) / "single_frame"
        assert (exp / "net_0001.params").exists()
        mark("worker retrain + resume")
        import json
        import numpy as np
        from depthinspace_tpu_torch.data import (CachedTrackDataset,
                                                 encode_batch, save_settings)
        from depthinspace_tpu_torch.data import wire, cache
        d = Path(sys.argv[1]) / "cached"
        (d / "wire_cache").mkdir(parents=True)
        save_settings(d / "settings.pkl", s)
        names = [f"{i:08d}" for i in range(4)]
        enc = [encode_batch(make_track_batch(s, tl=4, bs=1, seed=10 + i,
                                             disp_range=(2.0, 8.0)))
               for i in range(4)]
        meta = {"version": 1, "names": names, "fields": {}}
        for f, k in (("im", "im"), ("ambient", "ambient"),
                     ("disp", "disp_gt"), ("R", "R"), ("t", "t")):
            a = np.stack([getattr(e, k)[:, 0] for e in enc])
            np.save(d / cache.CACHE_DIR_NAME / f"{f}.npy", a)
            meta["fields"][f] = {"shape": list(a.shape),
                                 "dtype": a.dtype.name, "missing": []}
        (d / "wire_cache" / "meta.json").write_text(json.dumps(meta))
        for n in names:
            (d / n).mkdir()
        cb = CachedTrackDataset(d, names, train=False).get_batch([0, 1])
        assert cb.im.dtype == np.uint16 and cb.im.shape == (4, 2, 32, 24)
        np.testing.assert_array_equal(cb.disp_gt[:, 1], enc[1].disp_gt[:, 0])
        assert wire.decode_batch_np(cb).im.dtype == np.float32
        cfg = RunConfig(data_dir=d, output_dir=d / "out", epochs=1,
                        train_batch_size=1, max_train_iter=1,
                        test_batch_size=1, num_workers=1,
                        flow_source="rigid")
        SingleFrameWorker(cfg, device="cpu").do("retrain")
        log = (d / "out" / "single_frame" / "train.log").read_text()
        assert "using wire cache for train split" in log
        assert "using wire cache for test split" in log
        mark("worker from a wire cache written with numpy")
        from depthinspace_tpu_torch.data import TrackDataset, hdf5
        from depthinspace_tpu_torch.tools import presave_disp
        from depthinspace_tpu_torch.train.checkpoint import save_net_params
        hd = Path(sys.argv[1]) / "hdf5"
        hd.mkdir()
        save_settings(hd / "settings.pkl", s)
        written = []
        for i in range(2):
            b = make_track_batch(s, tl=4, bs=1, seed=20 + i,
                                 disp_range=(2.0, 8.0))
            (hd / f"{i:08d}").mkdir()
            hdf5.write_hdf5(hd / f"{i:08d}" / "frames.hdf5", {
                "im": b.im, "ambient": b.ambient, "disp": b.disp_gt,
                "R": b.R[:, 0], "t": b.t[:, 0]})
            written.append(b)
        ds = TrackDataset(s, sorted(str(p) for p in hd.glob("0*")),
                          train=False)
        for i, b in enumerate(written):
            np.testing.assert_array_equal(ds[i]["im"], b.im[:, 0])
            np.testing.assert_array_equal(ds[i]["R"], b.R[:, 0])
        mark("HDF5 written and read with numpy")
        (hd / "out" / "single_frame").mkdir(parents=True)
        save_net_params(hd / "out" / "single_frame", 0, net)
        presave_disp.main(["single_frame", "--epoch", "0", "--data_dir",
                           str(hd), "--output_dir", str(hd / "out")],
                          device="cpu")
        for i in range(2):
            with hdf5.File(hd / f"{i:08d}" / "single_frame_disp.hdf5") as f:
                sf = np.asarray(f["disp"])
            assert sf.shape == (4, 1, 32, 24) and np.isfinite(sf).all()
        mark("presave_disp single_frame")
        from depthinspace_tpu_torch.models import FuseNet, init_fusenet_
        from depthinspace_tpu_torch.serve import TrackDisparityServer
        from depthinspace_tpu_torch.train import make_mf_train_step
        mb = make_track_batch(s, tl=4, bs=1, seed=0, disp_range=(2.0, 8.0),
                              primary_noise=0.5)
        mf = init_fusenet_(FuseNet((32, 24), s.K, 4, block_num=1,
                                   channels=8),
                           torch.Generator().manual_seed(0))
        mstate = TrainState.create(mf, device="cpu")
        comps = make_mf_train_step(mf, ctx, mstate)(batch_to_torch(mb, "cpu"))
        assert mstate.step == 1 and comps.shape == (4,)
        assert bool(torch.isfinite(comps).all())
        mark("MF train step")
        srv = TrackDisparityServer(net, mf, imsize=(32, 24), K=s.K,
                                   device="cpu")
        mv = lambda a: a.swapaxes(0, 1)
        out = srv.infer(mv(mb.im), mv(mb.ambient), mv(mb.R), mv(mb.t),
                        mb.flow.transpose(2, 0, 1, 3, 4, 5))
        assert out.shape == (1, 4, 32, 24)
        mark("track server")
        from depthinspace_tpu_torch.tools.train_flow import load_flow_params
        fnet, ch = load_flow_params(Path("output") / "flownet.msgpack")
        assert ch == 2
        srv = TrackDisparityServer(net, mf, fnet, imsize=(32, 24), K=s.K,
                                   device="cpu")
        out = srv.infer(mv(mb.im), mv(mb.ambient), mv(mb.R), mv(mb.t))
        assert out.shape == (1, 4, 32, 24) and np.isfinite(out).all()
        mark("track server with FlowNet's flow")
        from depthinspace_tpu_torch.data import (augment_frame,
                                                 generate_dataset)
        from depthinspace_tpu_torch.utils.metric import StreamingEvalMetric
        fx = Path(sys.argv[1]) / "fixture"
        generate_dataset(fx, n_samples=1, imsize=(32, 24), write_sgm=True)
        fds = TrackDataset(s, [str(fx / "00000000")], train=True,
                           data_aug=True, load_grad=True, data_type="real")
        smp = fds[0]
        assert smp["sgm_disp"].shape == (4, 32, 24)
        assert np.isfinite(smp["im"]).all() and np.isfinite(smp["grad"]).all()
        aug = augment_frame(smp["im"][0], np.random.RandomState(0),
                            amb=smp["ambient"][0], disp=smp["disp"][0],
                            max_shift=64.0)
        assert aug[0].shape == (32, 24) and np.isfinite(aug[2]).all()
        mark("plane-scene fixture and host augmentation")
        met = StreamingEvalMetric()
        es = torch.from_numpy(wire.encode_disp(smp["disp"][:, None] + 0.5))
        gt = torch.from_numpy(wire.encode_disp(smp["disp"][:, None]))
        met.add(es, gt, 1)
        assert abs(met.get()["dist2_mean"] - 0.5) < 1e-2
        mark("streaming eval metric")
        assert not any(sys.modules.get(m) for m in BLOCKED)
        print("ok")
    """)
    # one intra-op thread: the test runs beside other test processes, each
    # with torch's default of one spinning thread per core; in a 6-worker
    # run of tests/ on 8 cores that took this process from 15 s (alone) to
    # 82 s, and to 26 s with one thread (the shapes are tiny: one thread is
    # as fast alone)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    t0 = time.perf_counter()
    try:
        res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                             cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=300)
    except subprocess.TimeoutExpired as e:
        err = e.stderr.decode() if isinstance(e.stderr, bytes) else e.stderr
        pytest.fail(f"timed out after {time.perf_counter() - t0:.1f} s; "
                    f"phases so far (stderr):\n{err}")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
