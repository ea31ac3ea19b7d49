"""Presave the optical flow of every ordered frame pair of every track,
port of ``depthinspace_tpu/tools/presave_flow.py``:

  python -m depthinspace_tpu_torch.tools.presave_flow --provider rigid

writes ``<sample>/flow.hdf5`` with datasets flow_{i}{j} of shape (1, 2, H,
W), the schema the datasets read, for every sample directory of DATA_DIR
that holds a frames.hdf5. The ``rigid`` provider is the exact flow of a
static scene from the GT depth and the camera poses (numpy on the host, as
in the JAX tool). ``farneback`` (OpenCV's dense flow) and ``learned`` (the
JAX package's FlowNet) are valid choices that raise: neither OpenCV nor
FlowNet is part of this package. The tool uses no device.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..config import load_paths
from ..data import hdf5, load_settings
from ..data.synthetic import rigid_flow as _rigid_flow_hw2


def rigid_flow(depth_i, K, R_i, t_i, R_j, t_j) -> np.ndarray:
    """Exact static-scene flow i -> j, (2, H, W), from depth and poses."""
    return np.moveaxis(_rigid_flow_hw2(depth_i, K, R_i, t_i, R_j, t_j),
                       -1, 0)


def process_sample(sample: Path, K, baseline, focal) -> None:
    """Write ``sample``/flow.hdf5, the rigid flow, from its frames.hdf5."""
    with hdf5.File(sample / "frames.hdf5") as f:
        tl = f["im"].shape[0]
        disp = np.asarray(f["disp"][:, 0], np.float32)
        R = np.asarray(f["R"], np.float32)
        t = np.asarray(f["t"], np.float32)
    depth = baseline * focal / np.maximum(disp, 1e-6)
    pairs = [(i, j) for i in range(tl) for j in range(tl) if i != j]
    hdf5.write_hdf5(sample / "flow.hdf5", {
        f"flow_{i}{j}": rigid_flow(depth[i], K, R[i], t[i], R[j], t[j]
                                   )[None].astype(np.float32)
        for i, j in pairs})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--provider", default="rigid",
                    choices=["rigid", "farneback", "learned"])
    ap.add_argument("--data_dir", default=None)
    args = ap.parse_args(argv)
    if args.provider == "farneback":
        raise NotImplementedError(
            "the farneback provider needs OpenCV (cv2), which this package "
            "does not use; use --provider rigid")
    if args.provider == "learned":
        raise NotImplementedError(
            "the learned provider needs FlowNet (models/flownet.py), which "
            "is not ported yet; use --provider rigid")

    data_root = Path(args.data_dir or load_paths()["DATA_DIR"])
    settings = load_settings(data_root / "settings.pkl")
    sample_dirs = sorted(p for p in data_root.iterdir()
                         if p.is_dir() and (p / "frames.hdf5").exists())
    for i, sample in enumerate(sample_dirs):
        process_sample(sample, settings.K, settings.baseline,
                       settings.focal_length)
        if i % 100 == 0:
            print(f"{i + 1}/{len(sample_dirs)}")
    print(f"wrote flow.hdf5 ({args.provider}) for {len(sample_dirs)} samples")


if __name__ == "__main__":
    main()
