"""The staged pipeline DIS-SF -> presave -> DIS-MF -> presave -> DIS-FTSF
through the port's tools, datasets and steps on a JAX fixture at 64x56
(the mirror of tests/test_pipeline_staged.py):

1. a seeded DIS-SF net's disparities presaved by the port's presave_disp
   (single_frame_disp.hdf5);
2. an MF train step on them (4 components) and the MF presave
   (multi_frame_disp.hdf5);
3. the DIS-FTSF train step on that pseudo GT: 10 components, equal to the
   JAX FTSF step's on the same decoded batch and weights;
4. the FTSF worker trains an epoch and retests it to the same test loss,
   from HDF5 and from a wire cache with pseudo_gt;
5. both CLIs refuse --architecture multi_frame --use_pseudo_gt True."""
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from depthinspace_tpu.data import generate_dataset
from depthinspace_tpu.data import load_settings as jax_load_settings
from depthinspace_tpu.data.dataset import Batch as JaxBatch
from depthinspace_tpu.models import DispNet as JaxDispNet
from depthinspace_tpu.train import objective as jax_objective
from depthinspace_tpu.train.state import TrainState as JaxTrainState
from depthinspace_tpu.train.steps import _make_step_fns
from depthinspace_tpu_torch.config import RunConfig
from depthinspace_tpu_torch.data import (TrackDataset, batch_to_torch,
                                         collate, decode_batch_np,
                                         encode_batch, hdf5, load_settings)
from depthinspace_tpu_torch.models import (DispNet, FuseNet,
                                           flax_tree_from_dispnet_state_dict,
                                           init_dispnet_, init_fusenet_)
from depthinspace_tpu_torch.tools import build_cache, presave_disp
from depthinspace_tpu_torch.train import (TrainState, make_loss_context,
                                          make_mf_train_step,
                                          make_sf_train_step)
from depthinspace_tpu_torch.train.checkpoint import save_net_params
from depthinspace_tpu_torch.train.single_frame import SingleFrameWorker
from depthinspace_tpu_torch.utils import jrandom

H, W = 64, 56
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipeline_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("staged")
    generate_dataset(d, n_samples=4, imsize=(H, W), seed=5)
    return d


def _samples(d):
    return sorted(str(p) for p in Path(d).glob("0*"))


def _host_batch(d, n, **kw):
    ds = TrackDataset(load_settings(d / "settings.pkl"), _samples(d),
                      train=False, load_flow=True, **kw)
    return encode_batch(collate([ds[i] for i in range(n)]))


def _presave(d, arch, model, *argv):
    save_net_params(d / "out" / arch, 0, model)
    presave_disp.main([arch, "--epoch", "0", "--data_dir", str(d),
                       "--output_dir", str(d / "out"), *argv], device="cpu")
    for sample in _samples(d):
        with hdf5.File(Path(sample) / f"{arch}_disp.hdf5") as f:
            disp = np.asarray(f["disp"])
        assert disp.shape == (4, 1, H, W) and disp.dtype == np.float32
        assert np.all(np.isfinite(disp))
        assert disp.min() >= 0 and disp.max() <= 128


def test_stage1_sf_presave(pipeline_dir):
    (pipeline_dir / "out" / "single_frame").mkdir(parents=True)
    net = init_dispnet_(DispNet(max_disp=128.0),
                        jrandom.key(0))
    _presave(pipeline_dir, "single_frame", net)


def test_stage2_mf_train_step_and_presave(pipeline_dir):
    host = _host_batch(pipeline_dir, 2, load_primary=True)
    assert host.primary_disp is not None and host.primary_disp.dtype == \
        np.uint16
    settings = load_settings(pipeline_dir / "settings.pkl")
    model = init_fusenet_(FuseNet((H, W), settings.K, 4, block_num=1,
                                  channels=8),
                          jrandom.key(1))
    state = TrainState.create(model, 1e-4, seed=0, device="cpu")
    step = make_mf_train_step(model, make_loss_context(settings, 4,
                                                       device="cpu"), state)
    comps = step(batch_to_torch(host, "cpu")).numpy()
    assert comps.shape == (4,) and np.all(np.isfinite(comps))

    (pipeline_dir / "out" / "multi_frame").mkdir(parents=True)
    full = init_fusenet_(FuseNet((H, W), settings.K, 4),
                         jrandom.key(2))
    _presave(pipeline_dir, "multi_frame", full, "--flow_source", "file")


def test_stage3_ftsf_train_step_matches_jax(pipeline_dir):
    """The FTSF step's first components on the decoded HDF5 batch (2
    samples) from the same weights: 4 photometric + smoothness + geometric
    + 4 pseudo-GT terms, all finite, within the SF step's rtol 1e-4 of the
    JAX step (tests/test_torch_train.py)."""
    batch = decode_batch_np(_host_batch(pipeline_dir, 2,
                                        load_pseudo_gt=True))
    assert batch.pseudo_gt is not None
    settings = load_settings(pipeline_dir / "settings.pkl")
    net = init_dispnet_(DispNet(max_disp=128.0),
                        jrandom.key(3))
    params = jax.tree.map(jnp.asarray,
                          flax_tree_from_dispnet_state_dict(net.state_dict()))

    ctx = jax_objective.make_loss_context(
        jax_load_settings(pipeline_dir / "settings.pkl"), track_length=4,
        use_pseudo_gt=True)
    opt = optax.adam(1e-4)
    train_step, _, consts = _make_step_fns(JaxDispNet(max_disp=128.0), ctx,
                                           opt, "single_frame")
    _, ref = jax.jit(train_step)(
        JaxTrainState.create(params, opt, jax.random.key(1)),
        JaxBatch(**batch._asdict()), jnp.asarray(0.0), consts)

    state = TrainState.create(net, 1e-4, seed=0, device="cpu")
    step = make_sf_train_step(net, make_loss_context(
        settings, 4, device="cpu", use_pseudo_gt=True), state)
    comps = step(batch_to_torch(batch, "cpu")).numpy()
    assert comps.shape == (10,) and np.all(np.isfinite(comps))
    np.testing.assert_allclose(comps, np.asarray(ref), rtol=1e-4, atol=0)


@pytest.mark.parametrize("source", ["hdf5", "wire_cache"])
def test_ftsf_worker_retrain_and_retest(pipeline_dir, tmp_path, source):
    """SingleFrameWorker with use_pseudo_gt: one epoch (2 steps of 1) and a
    retest of epoch 0 to the same test loss; from HDF5 with flow.hdf5, and
    from a wire cache (built by build_cache with pseudo_gt) with rigid
    flow, which both splits then read."""
    d = tmp_path / "data"
    shutil.copytree(pipeline_dir, d, ignore=shutil.ignore_patterns("out"))
    flow_source = "file"
    if source == "wire_cache":
        build_cache.main(["--data_dir", str(d), "--fields",
                          "im,ambient,disp,R,t,pseudo_gt"])
        flow_source = "rigid"
    cfg = RunConfig(data_dir=d, output_dir=tmp_path / "out",
                    use_pseudo_gt=True, epochs=1, train_batch_size=1,
                    test_batch_size=1, max_train_iter=2, num_workers=1,
                    flow_source=flow_source)
    SingleFrameWorker(cfg, device="cpu").do("retrain")
    exp = tmp_path / "out" / "single_frame"
    m0 = json.loads((exp / "metrics.json").read_text())["0"]
    assert len(m0["train"]["loss"]) == 10
    assert np.all(np.isfinite(m0["train"]["loss"]))
    loss0 = m0["test"]["0"]["loss"]
    assert len(loss0) == 10 and np.all(np.isfinite(loss0))
    log = (exp / "train.log").read_text()
    cached = "using wire cache for train split" in log
    assert cached == (source == "wire_cache")
    assert cached == ("using wire cache for test split" in log)
    SingleFrameWorker(cfg, device="cpu").do("retest", epoch=0)
    again = json.loads((exp / "metrics.json").read_text())["0"]["test"]["0"]
    np.testing.assert_allclose(again["loss"], loss0, rtol=1e-5)


def test_cli_refuses_pseudo_gt_for_multi_frame(capsys):
    """The port's CLI exits with 1 and the JAX CLI's message, before any
    worker starts."""
    argv = ["--architecture", "multi_frame", "--use_pseudo_gt", "True"]
    spec = importlib.util.spec_from_file_location("jax_train_val",
                                                  REPO / "train_val.py")
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    with pytest.raises(SystemExit) as e:
        jax_cli.main(argv)
    assert e.value.code == 1
    message = capsys.readouterr().out
    assert "use_pseudo_gt is only applicable" in message

    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m",
                          "depthinspace_tpu_torch.train_val", *argv],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 1, res.stderr
    assert res.stdout == message
