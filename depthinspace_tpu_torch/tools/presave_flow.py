"""Presave the optical flow of every ordered frame pair of every track,
port of ``depthinspace_tpu/tools/presave_flow.py``:

  python -m depthinspace_tpu_torch.tools.presave_flow --provider rigid
  python -m depthinspace_tpu_torch.tools.presave_flow --provider farneback
  python -m depthinspace_tpu_torch.tools.presave_flow --provider learned \
      [--flow_params output/flownet.msgpack]

writes ``<sample>/flow.hdf5`` with datasets flow_{i}{j} of shape (1, 2, H,
W), float32, the schema the datasets read, for every sample directory of
DATA_DIR that holds a frames.hdf5. Providers:

- ``rigid``: the exact flow of a static scene from the GT depth and the
  camera poses (numpy on the host, as in the JAX tool);
- ``learned``: FlowNet (``tools/train_flow.py``'s msgpack, default
  OUTPUT_DIR/flownet.msgpack) on the device, all ordered pairs of a sample
  in one batched call, on the checkpoint's input channels ([ambient, IR] or
  ambient; IR is read only for a 2-channel net);
- ``farneback``: OpenCV's dense Farnebäck flow on the ambient frames, for
  real captures without ground truth, with the JAX tool's parameters
  (``ops/farneback.py``, OpenCV's algorithm in PyTorch: no cv2); each
  frame is quantized to uint8 on the host as the JAX tool does, and the 12
  ordered pairs of a 4-frame sample are one batched call on the device.

``main(argv, device=None)`` runs the learned and farneback providers on
the card (``device="cpu"`` only when asked for); ``rigid`` uses no device.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..config import load_paths
from ..data import hdf5, load_settings
from ..data.synthetic import rigid_flow as _rigid_flow_hw2
from ..device import resolve_device
from ..models import flow_all_pairs
from ..ops.farneback import farneback


def rigid_flow(depth_i, K, R_i, t_i, R_j, t_j) -> np.ndarray:
    """Exact static-scene flow i -> j, (2, H, W), from depth and poses."""
    return np.moveaxis(_rigid_flow_hw2(depth_i, K, R_i, t_i, R_j, t_j),
                       -1, 0)


def _to_u8(img) -> np.ndarray:
    """The JAX tool's quantization of an image in [0, 1] to cv2's uint8."""
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def farneback_pairs(frames, src, dst, device) -> np.ndarray:
    """Farnebäck flow of frames[src[p]] -> frames[dst[p]], (P, 2, H, W),
    for (F, H, W) images in [0, 1], each frame expanded once a level."""
    u8 = torch.from_numpy(_to_u8(np.asarray(frames))).to(device)
    return farneback(u8, src, dst).cpu().numpy()


def farneback_flow(img_i, img_j, device=None) -> np.ndarray:
    """Farnebäck flow i -> j, (2, H, W), of two (H, W) images in [0, 1]: the
    JAX tool's ``farneback_flow`` on ``device`` (None: the card)."""
    return farneback_pairs(np.stack([img_i, img_j]), [0], [1],
                           resolve_device(device))[0]


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


def process_sample_learned(sample: Path, net, device) -> None:
    """Write ``sample``/flow.hdf5, FlowNet's flow of every ordered pair of
    its frames (one batched call on ``device``)."""
    with hdf5.File(sample / "frames.hdf5") as f:
        amb = np.array(f["ambient"][:, 0], np.float32)
        im = (np.array(f["im"][:, 0], np.float32)
              if net.in_channels == 2 else None)
    tl = amb.shape[0]
    to = lambda a: None if a is None else torch.from_numpy(a[:, None]).to(
        device)
    flow = flow_all_pairs(net, to(im), to(amb))
    flow = flow[:, :, 0].permute(0, 1, 4, 2, 3).cpu().numpy()  # (tl,tl,2,H,W)
    hdf5.write_hdf5(sample / "flow.hdf5", {
        f"flow_{i}{j}": np.ascontiguousarray(flow[i, j][None])
        for i in range(tl) for j in range(tl) if i != j})


def process_sample_farneback(sample: Path, device) -> None:
    """Write ``sample``/flow.hdf5, the Farnebäck flow of every ordered pair
    of its ambient frames (one batched call on ``device``)."""
    with hdf5.File(sample / "frames.hdf5") as f:
        amb = np.array(f["ambient"][:, 0], np.float32)
    tl = amb.shape[0]
    pairs = [(i, j) for i in range(tl) for j in range(tl) if i != j]
    flow = farneback_pairs(amb, [i for i, _ in pairs], [j for _, j in pairs],
                           device)
    hdf5.write_hdf5(sample / "flow.hdf5", {
        f"flow_{i}{j}": flow[p][None] for p, (i, j) in enumerate(pairs)})


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--provider", default="rigid",
                    choices=["rigid", "farneback", "learned"])
    ap.add_argument("--flow_params", default=None,
                    help="FlowNet params (train_flow.py output) for "
                         "--provider learned (default "
                         "OUTPUT_DIR/flownet.msgpack)")
    ap.add_argument("--data_dir", default=None)
    args = ap.parse_args(argv)

    paths = (load_paths() if not args.data_dir or (
        args.provider == "learned" and not args.flow_params) else {})
    data_root = Path(args.data_dir or paths["DATA_DIR"])
    settings = load_settings(data_root / "settings.pkl")
    if args.provider != "rigid":
        dev = resolve_device(device)
    if args.provider == "learned":
        from .train_flow import load_flow_params
        net = load_flow_params(args.flow_params or Path(
            paths["OUTPUT_DIR"]) / "flownet.msgpack")[0].to(dev)
    sample_dirs = sorted(p for p in data_root.iterdir()
                         if p.is_dir() and (p / "frames.hdf5").exists())
    for i, sample in enumerate(sample_dirs):
        if args.provider == "rigid":
            process_sample(sample, settings.K, settings.baseline,
                           settings.focal_length)
        elif args.provider == "farneback":
            process_sample_farneback(sample, dev)
        else:
            process_sample_learned(sample, net, dev)
        if i % 100 == 0:
            print(f"{i + 1}/{len(sample_dirs)}")
    print(f"wrote flow.hdf5 ({args.provider}) for {len(sample_dirs)} samples")


if __name__ == "__main__":
    main()
