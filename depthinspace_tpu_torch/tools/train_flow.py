"""Train FlowNet on renderer output with exact rigid-flow labels, port of
``depthinspace_tpu/tools/train_flow.py``:

  python -m depthinspace_tpu_torch.tools.train_flow --steps 2000 \\
      --out output/flownet.msgpack

On synthetic data the static-scene rigid flow from the GT depth and the
camera poses is the true optical flow, so the renderer gives exact
supervision. Training pairs are drawn once into an in-RAM pool of 16-bit
pairs (``PairPool``, from the wire cache when there is one, else from the
HDF5 files), then cropped at random; each step is the multi-scale loss and
Adam with optax's warmup-cosine schedule (init lr/20, peak lr, linear
warmup over min(200, steps // 10 + 1) steps, cosine to lr/20 at ``steps``).
The parameters are written as flax msgpack, the file both packages'
``load_flow_params`` read and ``presave_flow --provider learned``,
``presave_disp --flow_source net``, ``--flow_source net`` training and
``TrackDisparityServer`` use.

Validation prints the mean endpoint error (EPE) of the learned flow on
held-out pairs, and at the end beside it the EPE of OpenCV's Farnebäck flow
(``presave_flow.farneback_flow``, in PyTorch on the training device) and of
zero flow (the no-skill floor), as the JAX tool does.

``main(argv, device=None)`` trains on the card; ``device="cpu"`` only when
asked for.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..config import load_paths
from ..data import CachedTrackDataset, hdf5, load_settings
from ..data.wire import encode_unit
from ..device import resolve_device
from ..models import (FlowNet, epe, flax_tree_from_flownet_state_dict,
                      flownet_state_dict_from_flax, init_flownet_,
                      multiscale_epe_loss)
from ..utils import flax_msgpack, jrandom
from .presave_flow import farneback_flow, rigid_flow


def _sample_dirs(data_root: Path):
    return sorted(p for p in data_root.iterdir()
                  if p.is_dir() and (p / "frames.hdf5").exists())


def _channels(load, k: int, in_channels: int) -> list:
    return ([load("ambient", k), load("im", k)] if in_channels == 2
            else [load("ambient", k)])


def load_pair(sample: Path, K, baseline, focal, rng: np.random.RandomState,
              in_channels: int = 2):
    """A random ordered frame pair of ``sample`` -> (x_i, x_j, the rigid
    flow i -> j), each (H, W, C) float32; C = [ambient, IR] or ambient."""
    with hdf5.File(sample / "frames.hdf5") as f:
        tl = f["im"].shape[0]
        i, j = rng.choice(tl, size=2, replace=False)
        load = lambda name, k: np.asarray(f[name][k, 0], np.float32)
        a = np.stack(_channels(load, i, in_channels), axis=-1)
        b = np.stack(_channels(load, j, in_channels), axis=-1)
        disp = load("disp", i)
        R = np.asarray(f["R"], np.float32)
        t = np.asarray(f["t"], np.float32)
    depth = baseline * focal / np.maximum(disp, 1e-6)
    fl = rigid_flow(depth, K, R[i], t[i], R[j], t[j])      # (2, H, W)
    return a, b, np.moveaxis(fl, 0, -1)


class PairPool:
    """An in-RAM pool of training pairs, wire-encoded: images (P, H, W, C)
    uint16 x65535 and the rigid flow (P, H, W, 2) int16 x256, drawn with
    the JAX tool's random sequence, from the wire cache's memmaps when the
    cache holds the samples, else from the HDF5 files."""

    def __init__(self, data_root: Path, samples, K, baseline, focal,
                 pool_size: int, rng, in_channels: int = 2):
        n = min(pool_size, len(samples) * 12)
        try:
            cached = CachedTrackDataset(data_root, [p.name for p in samples],
                                        train=False)
        except FileNotFoundError:
            cached = None
        a_l, b_l, gt_l = [], [], []
        for p in range(n):
            si = rng.randint(len(samples))
            i, j = rng.choice(4, size=2, replace=False)
            if cached is not None:
                gi = cached.indices[si]
                disp = (np.asarray(cached.fields["disp"][gi, i], np.float32)
                        * (1.0 / 256.0))
                R = np.asarray(cached.fields["R"][gi])
                t = np.asarray(cached.fields["t"][gi])
                load = lambda name, k: np.asarray(cached.fields[name][gi, k])
                a = np.stack(_channels(load, i, in_channels), axis=-1)
                b = np.stack(_channels(load, j, in_channels), axis=-1)
            else:
                with hdf5.File(samples[si] / "frames.hdf5") as f:
                    load = lambda name, k: np.asarray(f[name][k, 0],
                                                      np.float32)
                    a = encode_unit(np.stack(_channels(load, i, in_channels),
                                             axis=-1))
                    b = encode_unit(np.stack(_channels(load, j, in_channels),
                                             axis=-1))
                    disp = load("disp", i)
                    R = np.asarray(f["R"], np.float32)
                    t = np.asarray(f["t"], np.float32)
            depth = baseline * focal / np.maximum(disp, 1e-6)
            fl = np.moveaxis(rigid_flow(depth, K, R[i], t[i], R[j], t[j]),
                             0, -1)
            a_l.append(a)
            b_l.append(b)
            gt_l.append(np.clip(np.rint(fl * 256.0), -32768,
                                32767).astype(np.int16))
            if p % 128 == 0:
                print(f"pair pool: {p}/{n}", flush=True)
        self.a, self.b, self.gt = np.stack(a_l), np.stack(b_l), np.stack(gt_l)
        print(f"pair pool ready: {n} pairs, "
              f"{(self.a.nbytes + self.b.nbytes + self.gt.nbytes) / 1e9:.2f}"
              " GB", flush=True)

    @classmethod
    def from_arrays(cls, a, b, gt) -> "PairPool":
        pool = cls.__new__(cls)
        pool.a, pool.b, pool.gt = a, b, gt
        return pool

    def batch(self, rng, batch_size, crop=None):
        """``batch_size`` random pairs, each cropped at a random (ch, cw)
        window when ``crop`` is given (flow values are displacements, the
        same in a crop)."""
        idx = rng.randint(0, len(self.a), batch_size)
        a, b, gt = self.a[idx], self.b[idx], self.gt[idx]
        if crop is not None:
            ch, cw = crop
            H, W = a.shape[1:3]
            ys = rng.randint(0, H - ch + 1, batch_size)
            xs = rng.randint(0, W - cw + 1, batch_size)
            cut = lambda arr: np.stack([arr[k, y:y + ch, x:x + cw]
                                        for k, (y, x) in enumerate(zip(ys,
                                                                       xs))])
            a, b, gt = cut(a), cut(b), cut(gt)
        return a, b, gt


def save_params(net: FlowNet, path) -> None:
    """Write ``net``'s weights as flax msgpack (what the JAX tool's
    ``load_flow_params`` reads)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(flax_msgpack.to_bytes(
        flax_tree_from_flownet_state_dict(net.state_dict())))
    os.replace(tmp, path)


def load_flow_params(path, in_channels: int | None = None):
    """A FlowNet msgpack (written by either package's train_flow) ->
    (FlowNet on the CPU, in eval mode, in_channels). ``in_channels=None``
    reads it from the stored first encoder kernel, (3, 3, C, 16): 1- and
    2-channel nets both load."""
    tree = flax_msgpack.from_bytes(Path(path).read_bytes())
    if in_channels is None:
        in_channels = int(tree["params"]["encoder"]["down0"]["kernel"]
                          .shape[2])
    net = FlowNet(in_channels)
    net.load_state_dict(flownet_state_dict_from_flax(tree))
    return net.eval(), in_channels


def warmup_cosine_lr(count: int, lr: float, steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(init_value=lr * 0.05,
    peak_value=lr, warmup_steps=min(200, steps // 10 + 1),
    decay_steps=steps, end_value=lr / 20) at update ``count`` (from 0)."""
    init, end = lr * 0.05, lr / 20.0
    warmup = min(200, steps // 10 + 1)
    if count < warmup:
        return (init - lr) * (1.0 - count / warmup) + lr
    decay = steps - warmup
    c = min(count - warmup, decay)
    alpha = end / lr
    cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay))
    return lr * ((1.0 - alpha) * cosine + alpha)


def make_train_step(net: FlowNet, lr: float, steps: int):
    """Returns ``step(im1, im2, gt) -> (loss, epe)``: one Adam update of
    ``net`` (optax.adam's update, the lr of :func:`warmup_cosine_lr` at the
    update's count) on a wire-encoded batch on the net's device: images
    (N, H, W, C) uint16 x65535, GT flow (N, H, W, 2) int16 x256."""
    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    count = [0]

    def step(im1, im2, gt):
        net.train()
        im1 = im1.float() * (1.0 / 65535.0)
        im2 = im2.float() * (1.0 / 65535.0)
        gt = gt.float() * (1.0 / 256.0)
        flows = net(im1, im2)
        loss = multiscale_epe_loss(flows, gt)
        train_epe = epe(flows[-1].detach(), gt)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        for g in opt.param_groups:
            g["lr"] = warmup_cosine_lr(count[0], lr, steps)
        opt.step()
        count[0] += 1
        return loss.detach(), train_epe

    return step


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=(
        "Train FlowNet on rigid-flow labels. Validation prints the learned "
        "EPE, and at the end the Farneback and the zero-flow EPE."))
    ap.add_argument("--data_dir", default=None)
    ap.add_argument("--out", default=None,
                    help="output params path (default "
                         "OUTPUT_DIR/flownet.msgpack)")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4,
                    help="peak lr (warmup of min(200, steps // 10 + 1) "
                         "steps, cosine decay to lr/20)")
    ap.add_argument("--val_samples", type=int, default=16)
    ap.add_argument("--crop", type=int, nargs=2, default=(256, 224),
                    metavar=("H", "W"),
                    help="random training crop (divisible by 16); pass 0 0 "
                         "for full-resolution training")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--report_every", type=int, default=100)
    ap.add_argument("--val_every", type=int, default=2000,
                    help="mid-training learned-EPE checks (0 = end only)")
    ap.add_argument("--in_channels", type=int, default=2, choices=[1, 2],
                    help="2 = [ambient, IR], 1 = ambient")
    ap.add_argument("--pool_cache", default="",
                    help="npz path: load the pair pool from it if present, "
                         "else build it, then save it there")
    ap.add_argument("--pool_size", type=int, default=1024,
                    help="training pairs drawn into the in-RAM pool")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    paths = load_paths() if not (args.data_dir and args.out) else {}
    data_root = Path(args.data_dir or paths["DATA_DIR"])
    out_path = Path(args.out or Path(paths["OUTPUT_DIR"]) / "flownet.msgpack")
    settings = load_settings(data_root / "settings.pkl")
    K, baseline, focal = settings.K, settings.baseline, settings.focal_length

    samples = _sample_dirs(data_root)
    if len(samples) < 2:
        raise ValueError(f"fewer than 2 samples under {data_root}")
    val = samples[:args.val_samples]
    train = samples[args.val_samples:] or samples

    crop = tuple(args.crop) if args.crop and args.crop[0] > 0 else None
    rng = np.random.RandomState(args.seed)
    cache_p = Path(args.pool_cache) if args.pool_cache else None
    if cache_p is not None and cache_p.exists():
        z = np.load(cache_p)
        pool = PairPool.from_arrays(z["a"], z["b"], z["gt"])
        print(f"pair pool loaded from {cache_p}: {len(pool.a)} pairs",
              flush=True)
    else:
        pool = PairPool(data_root, train, K, baseline, focal, args.pool_size,
                        rng, args.in_channels)
        if cache_p is not None:
            np.savez(cache_p, a=pool.a, b=pool.b, gt=pool.gt)
            print(f"pair pool saved to {cache_p}", flush=True)
    # the JAX tool draws one batch to shape its init; the same draw keeps
    # the two tools' batch sequences aligned
    pool.batch(rng, args.batch_size, crop)
    net = init_flownet_(FlowNet(args.in_channels),
                        jrandom.key(args.seed)).to(dev)
    step = make_train_step(net, args.lr, args.steps)

    vrng = np.random.RandomState(12345)
    val_pairs = [load_pair(s, K, baseline, focal, vrng, args.in_channels)
                 for s in val]

    def validate(with_baselines=False) -> float:
        net.eval()
        learned, farneback, zero = [], [], []
        with torch.inference_mode():
            for a, b, fl_gt in val_pairs:
                to = lambda x: torch.from_numpy(x[None]).to(dev)
                pred = net(to(a), to(b))[-1][0].cpu().numpy()
                learned.append(float(np.mean(np.linalg.norm(pred - fl_gt,
                                                             axis=-1))))
                if with_baselines:
                    fb = np.moveaxis(farneback_flow(a[..., 0], b[..., 0],
                                                    dev), 0, -1)
                    farneback.append(float(np.mean(
                        np.linalg.norm(fb - fl_gt, axis=-1))))
                    zero.append(float(np.mean(np.linalg.norm(fl_gt,
                                                             axis=-1))))
        line = f"val EPE  learned {np.mean(learned):.3f}px"
        if with_baselines:
            line += (f"  farneback {np.mean(farneback):.3f}px"
                     f"  zero-flow {np.mean(zero):.3f}px"
                     f"  ({len(val_pairs)} held-out samples)")
        print(line, flush=True)
        return float(np.mean(learned))

    t0 = time.time()
    for it in range(args.steps):
        im1, im2, gt = pool.batch(rng, args.batch_size, crop)
        to = lambda x: torch.from_numpy(x).to(dev)
        loss, train_epe = step(to(im1), to(im2), to(gt))
        if it % args.report_every == 0 or it == args.steps - 1:
            print(f"step {it:5d}  loss {float(loss):.4f}  "
                  f"epe {float(train_epe):.3f}px  "
                  f"({time.time() - t0:.0f}s)", flush=True)
        if args.val_every and it and it % args.val_every == 0:
            validate()

    validate(with_baselines=True)
    save_params(net, out_path)
    print(f"saved {out_path}")


if __name__ == "__main__":
    main()
