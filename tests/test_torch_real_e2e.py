"""--data_type real end to end through the port's CLI
(``depthinspace_tpu_torch.train_val.main``) on the port's plane-scene
fixture with SGM disparities: the mirror of test_real_e2e.py, with the
training split augmented on the device and, in a second run, on the host
(``--device_augment False``).

Covers: the real split rule (every 8th sample from the 4th is test),
sgm_disp loading, the SGM warmup terms and their epoch gate, and retest of
the trained network with the exact host metrics and with the device
histogram (``--eval_metrics exact`` / ``device``), which agree: min, max
and every of{t} equal, mean and std within 1e-6 relative, the quantiles
within 1/256 px."""
import json
import shutil

import numpy as np
import pytest
import torch

from depthinspace_tpu_torch import train_val
from depthinspace_tpu_torch.data import generate_dataset

ARGS = ["--architecture", "single_frame", "--data_type", "real",
        "--epochs", "2", "--warmup_epochs", "1", "--train_batch_size", "2"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def monkeypatch_module():
    from _pytest.monkeypatch import MonkeyPatch
    mp = MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module", params=[True, False],
                ids=["device_augment", "host_augment"])
def real_run(request, tmp_path_factory, monkeypatch_module):
    root = tmp_path_factory.mktemp("real")
    data_dir, out_dir = root / "dataset", root / "output"
    # focal and baseline put the GT disparity around the reference's SGM
    # validity threshold (> 30 px) at fixture scale
    generate_dataset(data_dir, n_samples=10, imsize=(64, 112), seed=11,
                     focal=300.0, baseline=0.35, write_sgm=True)
    cfg = root / "config.json"
    cfg.write_text(json.dumps({"OUTPUT_DIR": str(out_dir),
                               "DATA_DIR": str(data_dir)}))
    import depthinspace_tpu_torch.config as config_mod
    monkeypatch_module.setattr(config_mod, "DEFAULT_CONFIG_PATH", str(cfg))
    aug = ["--device_augment", str(request.param)]
    train_val.main(["--cmd", "retrain"] + ARGS + aug, device="cpu")
    yield out_dir / "single_frame", aug
    # the run's checkpoints hold DispNet's full-size state (~1.4 GB)
    shutil.rmtree(root)


def _metrics(exp):
    return json.loads((exp / "metrics.json").read_text())


def test_real_split_rule(real_run):
    """9 train / 1 test under the every-8th-from-the-4th rule for 10
    samples: 4 steps of 2 an epoch, and one test sample."""
    exp, _ = real_run
    log = (exp / "train.log").read_text()
    assert "Train epoch 0" in log and "Train epoch 1" in log
    assert "over 4 steps" in log
    assert "test e0: 1/1" in log


def test_sgm_warmup_terms_and_gate(real_run):
    exp, _ = real_run
    metrics = _metrics(exp)
    # train components: 4 photometric + smoothness + geometric + 4 SGM
    l0 = metrics["0"]["train"]["loss"]
    l1 = metrics["1"]["train"]["loss"]
    assert len(l0) == 10 and len(l1) == 10
    # epoch 0 < warmup_epochs = 1: the SGM terms are on (L1 to noisy SGM)
    assert all(v > 0 for v in l0[6:]), l0
    # epoch 1 >= warmup_epochs: the gate closes them exactly
    assert all(v == 0 for v in l1[6:]), l1
    # the test components carry no SGM terms
    assert len(metrics["0"]["test"]["0"]["loss"]) == 6


def test_real_retest_device_metric_equals_exact(real_run):
    exp, aug = real_run
    got = {}
    for mode in ("exact", "device"):
        train_val.main(["--cmd", "retest", "--epoch", "1", "--eval_metrics",
                        mode] + ARGS + aug, device="cpu")
        got[mode] = _metrics(exp)["1"]["test"]["0"]
    exact, dev = got["exact"], got["device"]
    assert set(exact) == set(dev)
    assert exact["loss"] == dev["loss"]
    for k in ("dist2_min", "dist2_max", "of0.1", "of0.5", "of1", "of2",
              "of5"):
        assert dev[k] == exact[k], (k, dev[k], exact[k])
    for k in ("dist2_mean", "dist2_std"):
        np.testing.assert_allclose(dev[k], exact[k], rtol=1e-6)
    for k in ("dist2_median", "dist2_q10", "dist2_q90"):
        assert abs(dev[k] - exact[k]) <= 1 / 256 + 1e-9, k
    assert np.isfinite(exact["dist2_mean"]) and exact["dist2_mean"] > 0
