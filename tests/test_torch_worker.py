"""The port's training runtime on the CPU: it learns (the mirror of
test_training_learns.py), a resumed run equals an uninterrupted one, the
single-frame worker keeps the JAX worker's experiment contract on a fixture
dataset written by the JAX package, and no entry point runs on the CPU
unless asked to."""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from depthinspace_tpu.data import generate_dataset
from depthinspace_tpu.models import DispNet as JaxDispNet
from depthinspace_tpu_torch.config import RunConfig
from depthinspace_tpu_torch.data import (TrackDataset, batch_to_torch,
                                         collate, load_settings,
                                         make_settings, make_track_batch)
from depthinspace_tpu_torch.models import (DispNet, dispnet_state_dict_from_flax,
                                           init_dispnet_)
from depthinspace_tpu_torch.serve import DisparityServer
from depthinspace_tpu_torch.train import (TrainState, make_loss_context,
                                          make_sf_eval_step,
                                          make_sf_train_step)
from depthinspace_tpu_torch.train.checkpoint import StateCheckpointer
from depthinspace_tpu_torch.train.single_frame import SingleFrameWorker


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test processes on the machine's cores at once;
    two intra-op threads per process keep torch from oversubscribing them
    (with all cores each, this file's steps ran ~10x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fixture(tmp_path, n_samples):
    d = tmp_path / "ds"
    generate_dataset(d, n_samples=n_samples, imsize=(64, 56), seed=3)
    return d


def test_port_learns_on_the_fixture(tmp_path):
    """20 Adam steps on 4 fixture samples with rigid flow, from the JAX
    test's init (flax key 42, converted): the photometric loss falls below
    0.7x and the disparity error below 0.5x of the start (the JAX test's
    thresholds; measured 0.254 -> 0.078 and 2.61 -> 0.46 px). The port's
    own init draws other weights from the same distribution; at this
    fixture's sub-pixel disparities 20 steps need a start near the 9x9
    census basin, as key 42 gives (2.9 px mean)."""
    d = _fixture(tmp_path, 4)
    settings = load_settings(d / "settings.pkl")
    paths = sorted(str(p) for p in d.glob("0*"))
    dset = TrackDataset(settings, paths, train=False)
    batch_np = collate([dset[i] for i in range(4)])
    gt = batch_np.disp_gt
    batch = batch_to_torch(batch_np, "cpu")

    params = JaxDispNet(max_disp=128.0).init(jax.random.key(42),
                                             jnp.zeros((1, 64, 56, 2)))
    net = DispNet()
    net.load_state_dict(dispnet_state_dict_from_flax(
        jax.tree.map(np.asarray, params)))
    ctx = make_loss_context(settings, 4, device="cpu", flow_source="rigid")
    state = TrainState.create(net, 1e-4, seed=42, device="cpu")
    train_step = make_sf_train_step(net, ctx, state)
    eval_step = make_sf_eval_step(net, ctx)

    def accuracy():
        disp_u16, comps = eval_step(batch)
        es = disp_u16.numpy().astype(np.float32) / 256.0
        return float(np.mean(np.abs(es - gt)[gt > 0])), float(comps[0])

    dist0, ph0 = accuracy()
    for _ in range(20):
        train_step(batch)
    dist1, ph1 = accuracy()
    assert ph1 < 0.7 * ph0, f"photometric did not drop: {ph0} -> {ph1}"
    assert dist1 < 0.5 * dist0, \
        f"disparity error did not drop: {dist0} -> {dist1}"


def test_resume_equals_uninterrupted_run(tmp_path):
    """2 steps, save, restore into a fresh state, 1 step: the same
    components and weights, bit for bit, as 3 steps in one run (with device
    augmentation on, so the step's generator must come back too)."""
    settings = make_settings(32, 24)
    batch = batch_to_torch(make_track_batch(settings, tl=4, bs=1, seed=0,
                                            disp_range=(2.0, 8.0)), "cpu")
    ctx = make_loss_context(settings, 4, device="cpu", augment=True,
                            aug_max_sp_noise=0.01)

    def fresh():
        net = init_dispnet_(DispNet(), torch.Generator().manual_seed(0))
        state = TrainState.create(net, 1e-4, seed=7, device="cpu")
        return state, make_sf_train_step(net, ctx, state)

    ref_state, ref_step = fresh()
    ref = [ref_step(batch) for _ in range(3)]

    state, step = fresh()
    for _ in range(2):
        step(batch)
    np.random.seed(5)
    StateCheckpointer(tmp_path).save(1, state, {"simple": 0.25})
    np.random.seed(9)
    state2, step2 = fresh()
    _, epoch, min_err = StateCheckpointer(tmp_path).restore(state2)
    assert (epoch, min_err, state2.step) == (1, {"simple": 0.25}, 2)
    assert np.random.randint(1 << 30) == np.random.RandomState(5).randint(
        1 << 30)
    assert torch.equal(step2(batch), ref[2])
    for a, b in zip(ref_state.model.parameters(), state2.model.parameters()):
        assert torch.equal(a, b)


def test_worker_trains_resumes_and_retests(tmp_path):
    """SingleFrameWorker on an 8-sample fixture written by the JAX package
    (2 test, 6 train samples; flow from flow.hdf5): train.log,
    metrics.json with the JAX worker's keys, state/, the best state and
    net_%04d.params; a resumed run starts after the saved epoch; a retest
    of epoch 0 reproduces that epoch's test loss."""
    d = _fixture(tmp_path, 8)
    out = tmp_path / "out"
    cfg = RunConfig(data_dir=d, output_dir=out, epochs=2, train_batch_size=2,
                    test_batch_size=2, num_workers=2)
    SingleFrameWorker(cfg, device="cpu").do("retrain")
    exp = out / "single_frame"
    names = {p.name for p in exp.iterdir()}
    assert {"train.log", "metrics.json", "state", "state_set_simple_best",
            "net_0000.params", "net_0001.params"} <= names
    metrics = json.loads((exp / "metrics.json").read_text())
    assert set(metrics) == {"0", "1"}
    test0 = metrics["0"]["test"]["0"]
    assert set(test0) == {"loss", "dist2_mean", "dist2_std", "dist2_median",
                          "dist2_q10", "dist2_q90", "dist2_min", "dist2_max",
                          "of0.1", "of0.5", "of1", "of2", "of5"}
    assert len(metrics["0"]["train"]["loss"]) == 6
    assert sorted(p.name for p in (exp / "state").iterdir()) == ["0", "1"]

    cfg.epochs = 3
    SingleFrameWorker(cfg, device="cpu").do("resume")
    metrics = json.loads((exp / "metrics.json").read_text())
    assert set(metrics) == {"0", "1", "2"}
    assert sorted(p.name for p in (exp / "state").iterdir()) == ["1", "2"]
    assert "Resumed from epoch 1" in (exp / "train.log").read_text()

    cfg.test_frequency = 5            # an explicit retest ignores it
    SingleFrameWorker(cfg, device="cpu").do("retest", epoch=0)
    again = json.loads((exp / "metrics.json").read_text())["0"]["test"]["0"]
    np.testing.assert_allclose(again["loss"], test0["loss"], rtol=1e-6)
    assert again["dist2_mean"] == pytest.approx(test0["dist2_mean"])


def test_entry_points_need_the_card_unless_asked_for_the_cpu(tmp_path,
                                                            monkeypatch):
    """device=None means the card: without one, the server, the train state
    and the worker raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = DispNet()
    with pytest.raises(RuntimeError, match="CUDA"):
        DisparityServer(net, imsize=(32, 24))
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainState.create(net)
    d = _fixture(tmp_path, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        SingleFrameWorker(RunConfig(data_dir=d, output_dir=tmp_path / "o"))
    assert DisparityServer(net, imsize=(32, 24), device="cpu").device.type \
        == "cpu"
