"""Run configuration, port of ``depthinspace_tpu/config.py``: machine paths
from ``config.json`` (OUTPUT_DIR, DATA_DIR, ...) and the hyperparameters of
the CLI (``utils/args.py``) in one dataclass. It has the JAX package's
fields that this package uses; the CLI flags for machinery it does not have
(the device mesh, the device metric) are parsed and dropped.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, fields
from pathlib import Path

DEFAULT_CONFIG_PATH = os.environ.get(
    "DIS_CONFIG", os.path.join(os.path.dirname(__file__), "..", "config.json"))


def load_paths(config_path: str | None = None) -> dict:
    path = os.path.abspath(config_path or DEFAULT_CONFIG_PATH)
    with open(path) as fp:
        return json.load(fp)


@dataclass
class RunConfig:
    # paths
    data_dir: Path
    output_dir: Path
    # run identity
    architecture: str = "single_frame"      # single_frame | multi_frame
    data_type: str = "synthetic"            # synthetic | real
    # schedule
    epochs: int = 100
    warmup_epochs: int = 150
    # model / preprocessing
    lcn_radius: int = 5
    max_disp: float = 128.0
    track_length: int = 4
    # batching
    train_batch_size: int = 8
    test_batch_size: int = 4
    num_workers: int = 4
    # options
    use_pseudo_gt: bool = False
    accum_steps: int = 0                    # 0 = auto (Worker._resolve_accum)
    mf_dtype: str = "bfloat16"              # FuseNet compute dtype
    mf_remat: bool = False                  # checkpoint FuseNet's blocks
    device_augment: bool = True
    wire_cache: bool = True                 # read <data_dir>/wire_cache
    test_frequency: int = 1                 # eval every N epochs
    flow_source: str = "file"               # file | rigid | pred | net
    flow_params: str = ""                   # FlowNet msgpack for "net"
    photometric_pyramid: bool = False
    seed: int = 42
    learning_rate: float = 1e-4
    save_frequency: int = 1
    max_train_iter: int = -1
    test_samples: int = -1                  # cap eval-split size (-1 = all)
    deadline_ts: float = 0.0                # stop after this epoch time

    @classmethod
    def from_args(cls, args, config_path: str | None = None) -> "RunConfig":
        paths = load_paths(config_path)
        names = {f.name for f in fields(cls)}
        kw = {k: v for k, v in vars(args).items() if k in names}
        kw["max_disp"] = float(kw["max_disp"])
        return cls(data_dir=Path(paths["DATA_DIR"]),
                   output_dir=Path(paths["OUTPUT_DIR"]), **kw)
