"""The port's self-supervised trainer learns on the port's own plane-scene
fixture (``depthinspace_tpu_torch/data/fixture.py``): the mirror of
test_training_learns.py. DIS-SF overfits 4 samples at 64x56 (seed 3) for
20 Adam(1e-4) steps on one fixed batch with rigid flow, from the JAX
test's init (flax key 42, carried across with ``models/convert.py``), and
must pass the JAX test's own margins: the photometric loss below 0.7x its
start and the mean disparity error against the GT below 0.5x (measured
0.254 -> 0.078 and 2.61 -> 0.46 px on the JAX fixture)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from depthinspace_tpu.models import DispNet as JaxDispNet
from depthinspace_tpu_torch.data import (TrackDataset, batch_to_torch,
                                         collate, encode_batch,
                                         generate_dataset, load_settings)
from depthinspace_tpu_torch.models import (DispNet,
                                           dispnet_state_dict_from_flax)
from depthinspace_tpu_torch.train import (TrainState, make_loss_context,
                                          make_sf_eval_step,
                                          make_sf_train_step)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_sf_overfit_loss_and_accuracy_drop(tmp_path):
    d = tmp_path / "ds"
    generate_dataset(d, n_samples=4, imsize=(64, 56), seed=3)
    settings = load_settings(d / "settings.pkl")
    paths = sorted(str(p) for p in d.glob("0*"))
    dset = TrackDataset(settings, paths, train=False, data_aug=False,
                        load_flow=False)
    batch = collate([dset[i] for i in range(4)])
    gt = batch.disp_gt.copy()
    dev = batch_to_torch(encode_batch(batch), "cpu")

    params = JaxDispNet(max_disp=128.0).init(jax.random.key(42),
                                             jnp.zeros((1, 64, 56, 2)))
    net = DispNet(max_disp=128.0)
    net.load_state_dict(dispnet_state_dict_from_flax(
        jax.tree.map(np.asarray, params)))
    ctx = make_loss_context(settings, track_length=4, device="cpu",
                            flow_source="rigid", augment=False)
    state = TrainState.create(net, 1e-4, seed=42, device="cpu")
    train_step = make_sf_train_step(net, ctx, state)
    eval_step = make_sf_eval_step(net, ctx)

    def accuracy():
        disp_u16, comps = eval_step(dev)
        es = disp_u16.numpy().astype(np.float32) / 256.0
        return float(np.mean(np.abs(es - gt)[gt > 0])), float(comps[0])

    dist0, ph0 = accuracy()
    for _ in range(20):
        train_step(dev)
    dist1, ph1 = accuracy()
    assert ph1 < 0.7 * ph0, f"photometric did not drop: {ph0} -> {ph1}"
    assert dist1 < 0.5 * dist0, \
        f"disparity error did not drop: {dist0} -> {dist1}"
