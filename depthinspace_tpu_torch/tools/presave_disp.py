"""Presave network disparities for the staged training pipeline, port of
``depthinspace_tpu/tools/presave_disp.py``:

  python -m depthinspace_tpu_torch.tools.presave_disp single_frame --epoch 49
  python -m depthinspace_tpu_torch.tools.presave_disp multi_frame --epoch 49 \\
      [--flow_source file|rigid|pred|net] [--flow_params flownet.msgpack]

Runs the trained network OUTPUT_DIR/<architecture>/net_%04d.params (written
by either package) over every sample directory and writes
``<sample>/<architecture>_disp.hdf5`` with one dataset 'disp' of shape (4,
1, H, W): the DIS-SF primary that DIS-MF trains on
(single_frame_disp.hdf5) and the DIS-MF pseudo ground truth of DIS-FTSF
(multi_frame_disp.hdf5). The I/O is the JAX tool's: ``--batch`` samples a
call (8 DIS-SF, 4 DIS-MF; the tail batch padded), images cross to the
device as uint16 x65535, disparities as uint16 x256 and flow as int16 x256,
the output comes back as uint16 x256 and is written as float32 / 256.
DIS-MF's flow is flow.hdf5's (``file``), computed on the device from the
GT disparity (``rigid``) or the primary (``pred``) and the poses, or
FlowNet's on the device from the decoded images (``net``; ``--flow_params``,
default OUTPUT_DIR/flownet.msgpack), the flow DIS-MF trained with
``--flow_source net`` saw. After writing, an existing wire cache gets the
field refreshed (primary_disp or pseudo_gt).

``main(argv, device=None)`` runs on the card; ``device="cpu"`` only when
asked for.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..config import load_paths
from ..data import hdf5, load_settings
from ..data.cache import CACHE_DIR_NAME, build_wire_cache
from ..data.wire import (decode_field, encode_disp, encode_flow, encode_unit,
                         to_u16_disp)
from ..device import resolve_device
from ..losses import CameraGeometry
from ..models import DispNet, FuseNet, flow_all_pairs
from ..serve import lcn_input, mf_forward, sf_forward
from ..train.checkpoint import load_net_params
from ..train.objective import rigid_flow_device


def build_sf_infer(model: DispNet, device):
    """(N, H, W) uint16 x65535 images -> (N, H, W) uint16 x256 disparities,
    DIS-SF on ``device`` (the forward of ``DisparityServer``)."""
    model = model.to(device).eval()

    @torch.inference_mode()
    def infer(im_u16: np.ndarray) -> np.ndarray:
        im = decode_field("im", torch.from_numpy(im_u16).to(device))
        return to_u16_disp(sf_forward(model, lcn_input(im))).cpu().numpy()

    return infer


def build_mf_infer(settings, model: FuseNet, device,
                   flow_source: str = "file", flow_net=None):
    """DIS-MF on ``device`` (the FuseNet forward of ``TrackDisparityServer``,
    on the presaved primary): track-major (tl, N, H, W) uint16 images,
    primary (x256), R (tl, N, 3, 3), t (tl, N, 3) and, by flow source, the
    (tl, tl, N, H, W, 2) int16 x256 flow ("file") or the GT disparity
    (uint16 x256, "rigid") -> (tl, N, H, W) uint16 x256. "net" takes the
    FlowNet ``flow_net``."""
    if flow_source == "net":
        flow_net = flow_net.to(device).eval()
    H, W = settings.imsize
    model = model.to(device).eval()
    cam = CameraGeometry.create(settings.K, H, W, device=device)
    focal, baseline = settings.focal_length, settings.baseline

    @torch.inference_mode()
    def infer(im_u16, amb_u16, primary_u16, R, t, flow_i16=None,
              dispgt_u16=None) -> np.ndarray:
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        primary = decode_field("primary_disp", to(primary_u16))
        im = decode_field("im", to(im_u16))
        amb = decode_field("ambient", to(amb_u16))
        R, t = to(R), to(t)
        if flow_source == "file":
            flow = decode_field("flow", to(flow_i16))
        elif flow_source == "net":
            flow = flow_all_pairs(flow_net, im, amb)
        else:
            disp = (primary if flow_source == "pred" else
                    decode_field("disp_gt", to(dispgt_u16)))
            flow = rigid_flow_device(cam, disp, R, t, focal, baseline)
        out = mf_forward(model, lcn_input(im), amb, primary, R, t, flow,
                         focal, baseline)
        return to_u16_disp(out).cpu().numpy()

    return infer


def _read_sample(sample: Path, architecture: str, flow_source: str) -> dict:
    out = {}
    with hdf5.File(sample / "frames.hdf5") as f:
        out["im"] = encode_unit(np.asarray(f["im"][:, 0], np.float32))
        if architecture == "multi_frame":
            out["amb"] = encode_unit(np.asarray(f["ambient"][:, 0],
                                                np.float32))
            out["R"] = np.asarray(f["R"], np.float32)
            out["t"] = np.asarray(f["t"], np.float32)
            if flow_source == "rigid":
                out["disp_gt"] = encode_disp(
                    np.asarray(f["disp"][:, 0], np.float32))
    if architecture == "multi_frame":
        with hdf5.File(sample / "single_frame_disp.hdf5") as f:
            out["primary"] = encode_disp(np.asarray(f["disp"][:, 0],
                                                    np.float32))
        if flow_source == "file":
            tl, (H, W) = 4, out["im"].shape[1:]
            flow = np.zeros((tl, tl, H, W, 2), np.float32)
            with hdf5.File(sample / "flow.hdf5") as f:
                for i0 in range(tl):
                    for i1 in range(tl):
                        if i0 != i1:
                            flow[i0, i1] = np.moveaxis(
                                np.asarray(f[f"flow_{i0}{i1}"])[0], 0, -1)
            out["flow"] = encode_flow(flow)
    return out


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("architecture", choices=["single_frame", "multi_frame"])
    ap.add_argument("--epoch", default=-1, type=int)
    ap.add_argument("--data_dir", default=None,
                    help="override DATA_DIR from config.json")
    ap.add_argument("--output_dir", default=None)
    ap.add_argument("--batch", default=None, type=int,
                    help="samples per call (default: 8 SF / 4 MF)")
    ap.add_argument("--flow_source", default="file",
                    choices=["file", "rigid", "net", "pred"],
                    help="multi_frame only: file reads flow.hdf5; rigid "
                         "computes the flow on the device from the GT "
                         "disparity and the poses; pred from the presaved "
                         "primary and the poses; net with the frozen "
                         "FlowNet from the images")
    ap.add_argument("--flow_params", default=None,
                    help="FlowNet msgpack for --flow_source net "
                         "(default OUTPUT_DIR/flownet.msgpack)")
    ap.add_argument("--ranges", default=None,
                    help="comma-separated lo:hi index ranges into the "
                         "sorted sample list to presave (e.g. "
                         "'512:640,1024:2048'); default: every sample")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    paths = load_paths() if not (args.data_dir and args.output_dir) else {}
    data_root = Path(args.data_dir or paths["DATA_DIR"])
    output_dir = Path(args.output_dir or paths["OUTPUT_DIR"])
    model_path = (output_dir / args.architecture
                  / f"net_{args.epoch:04d}.params")
    settings = load_settings(data_root / "settings.pkl")

    sf = args.architecture == "single_frame"
    B = args.batch or (8 if sf else 4)
    if sf:
        model = DispNet(max_disp=128.0)
        infer = build_sf_infer(model, dev)
    else:
        model = FuseNet(imsize=settings.imsize, K=settings.K, track_length=4,
                        max_disp=128.0)
        flow_net = None
        if args.flow_source == "net":
            from .train_flow import load_flow_params
            fp_path = Path(args.flow_params
                           or output_dir / "flownet.msgpack")
            flow_net, flow_ch = load_flow_params(fp_path)
            print(f"FlowNet provider: {fp_path} ({flow_ch}-channel)")
        infer = build_mf_infer(settings, model, dev, args.flow_source,
                               flow_net)
    model.load_state_dict(load_net_params(model_path, model))

    # the worker's split enumeration (glob("0*"), sorted), so that --ranges
    # indexes the samples of its splits
    dirs = sorted(p for p in data_root.glob("0*")
                  if p.is_dir() and (p / "frames.hdf5").exists())
    if args.ranges:
        keep = []
        for rng in args.ranges.split(","):
            lo, hi = (int(v) for v in rng.split(":"))
            keep.extend(dirs[lo:hi])
        dirs = sorted(set(keep), key=str)
    for lo in range(0, len(dirs), B):
        group = dirs[lo:lo + B]
        data = [_read_sample(s, args.architecture, args.flow_source)
                for s in group]
        n = len(data)
        while len(data) < B:                    # pad the tail batch
            data.append(data[-1])
        if sf:
            im = np.concatenate([d["im"] for d in data], axis=0)  # (4B,H,W)
            disp = infer(im).astype(np.float32) / 256.0
            disp = disp.reshape(B, 4, *disp.shape[1:])
        else:
            st = lambda k: np.stack([d[k] for d in data], axis=1)
            out = infer(st("im"), st("amb"), st("primary"), st("R"), st("t"),
                        flow_i16=(np.stack([d["flow"] for d in data], axis=2)
                                  if args.flow_source == "file" else None),
                        dispgt_u16=(st("disp_gt")
                                    if args.flow_source == "rigid" else None))
            disp = np.moveaxis(out.astype(np.float32) / 256.0, 1, 0)
        for d_idx, sample in enumerate(group[:n]):
            hdf5.write_hdf5(sample / f"{args.architecture}_disp.hdf5",
                            {"disp": disp[d_idx][:, None]})
        if (lo // B) % 16 == 0:
            print(f"{lo + n}/{len(dirs)}: {group[-1].name}", flush=True)
    print(f"wrote {args.architecture}_disp.hdf5 for {len(dirs)} samples")

    # refresh the wire cache's field, so cached runs see these disparities
    if (data_root / CACHE_DIR_NAME / "meta.json").exists():
        field = "primary_disp" if sf else "pseudo_gt"
        build_wire_cache(data_root, fields=[field], force=True)
        print(f"wire cache field {field!r} refreshed")


if __name__ == "__main__":
    main()
