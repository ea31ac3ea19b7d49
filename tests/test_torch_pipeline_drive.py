"""tools/pipeline_drive.py, the port of scripts/pipeline_drive.py: the
whole staged pipeline on a small plane-scene fixture on the CPU, and the
presave ranges it derives from the worker's splits against the JAX
script's ``512:{n}``."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from depthinspace_tpu_torch import config as config_mod
from depthinspace_tpu_torch.data import hdf5
from depthinspace_tpu_torch.data.fixture import generate_dataset
from depthinspace_tpu_torch.tools import pipeline_drive

H, W, N = 32, 24, 12


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_pipeline_drive_runs_every_stage(tmp_path, monkeypatch, capsys):
    """12 samples at 32x24 (test: the first quarter): DIS-SF, its retest,
    the SF presave, DIS-MF, its retest and presave, DIS-FTSF and its retest,
    one epoch each; every stage's metrics.json with the retest's full-split
    metrics, the self-supervised SF archived as single_frame_selfsup/, both
    presaves over every sample, and pipeline_summary.json."""
    data, out = tmp_path / "data", tmp_path / "out"
    generate_dataset(data, n_samples=N, imsize=(H, W), seed=5,
                     write_flow=False)
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"DATA_DIR": str(data),
                               "OUTPUT_DIR": str(out)}))
    monkeypatch.setattr(config_mod, "DEFAULT_CONFIG_PATH", str(cfg))
    summary = pipeline_drive.main(
        ["--minutes", "5", "--sf_epochs", "1", "--mf_epochs", "1",
         "--ftsf_epochs", "1", "--mf_max_iter", "1", "--reserve_s", "60",
         "--test_batch_size", "2"], device="cpu")
    text = capsys.readouterr().out
    stages = ["DIS-SF", "retest DIS-SF selfsup @ epoch 0", "presave SF",
              "DIS-MF", "retest DIS-MF @ epoch 0", "presave MF", "DIS-FTSF",
              "retest DIS-FTSF @ epoch 0", "report"]
    for name in stages:
        assert f"=== pipeline stage: {name}" in text, name
    assert sorted(p.name for p in out.iterdir()) == [
        "multi_frame", "pipeline_summary.json", "single_frame",
        "single_frame_selfsup"]
    for d, n_comps in (("single_frame_selfsup", 6), ("multi_frame", 3),
                       ("single_frame", 10)):
        m = json.loads((out / d / "metrics.json").read_text())
        test = m["0"]["test"]["0"]
        assert len(test["loss"]) == n_comps and np.isfinite(test["loss"]).all()
        assert 0 <= test["of1"] <= 1 and np.isfinite(test["dist2_mean"])
        assert (out / d / "net_0000.params").is_file()
    assert json.loads((out / "pipeline_summary.json").read_text()) == summary
    assert sorted(summary) == ["mf", "sf", "sf_selfsup", "stage_seconds"]
    assert len(summary["stage_seconds"]) == len(stages) - 1
    for sample in sorted(data.glob("0*")):
        for arch in ("single_frame", "multi_frame"):
            with hdf5.File(sample / f"{arch}_disp.hdf5") as f:
                disp = np.array(f["disp"])
            assert disp.shape == (4, 1, H, W) and np.isfinite(disp).all()


@pytest.mark.parametrize("n,want", [
    (1536, "512:1536"), (2048, "512:2048"), (1024, "0:1024"), (12, "0:12")])
def test_presave_ranges_cover_the_test_and_train_splits(tmp_path, n, want):
    """presave_disp's --ranges from the worker's splits: at more than 1024
    samples the JAX script's 512:{n} (test [512:1024] and train [1024:]);
    below that every sample, as the small-set split tests the first quarter
    and trains on the rest."""
    for i in range(n):
        (tmp_path / f"{i:08d}").mkdir()
        (tmp_path / f"{i:08d}" / "frames.hdf5").touch()
    (tmp_path / "settings.pkl").touch()
    assert pipeline_drive.presave_ranges(tmp_path) == want
    if n > 1024:
        assert want == f"512:{n}"
