"""Batched single-frame disparity inference, port of
``depthinspace_tpu/serve.py::DisparityServer``.

A request batch is cut into chunks of at most ``max_batch`` images, and each
chunk is padded (by repeating its last image) up to a power-of-2 bucket, as
the JAX server does. Images cross to the device as uint16 fixed point
(x 65535), so the outputs match the JAX server's for the same request.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models import DispNet, dispnet_state_dict_from_flax
from .ops import lcn


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class DisparityServer:
    """>>> srv = DisparityServer.from_net_params("net_0007.params")
    >>> disp = srv.infer(images)     # (n, H, W) float32 in [0, 1] -> (n, H, W)

    ``device=None`` is the card (raises without one); the CPU only when
    asked for with ``device="cpu"``."""

    def __init__(self, model: DispNet, imsize=(512, 432), max_batch: int = 32,
                 lcn_radius: int = 5, device=None):
        self.device = resolve_device(device)
        self.imsize = tuple(imsize)
        self.max_batch = int(max_batch)
        self.lcn_radius = lcn_radius
        self.model = model.to(self.device).eval()

    @classmethod
    def from_jax_params(cls, tree, max_disp: float = 128.0, **kw):
        """From the flax DispNet variables as nested dicts of numpy arrays."""
        model = DispNet(max_disp=max_disp)
        model.load_state_dict(dispnet_state_dict_from_flax(tree))
        return cls(model, **kw)

    @classmethod
    def from_net_params(cls, path, max_disp: float = 128.0, **kw):
        """From a ``net_%04d.params`` file (flax msgpack) written by either
        package's trainer."""
        from .train.checkpoint import load_net_params
        model = DispNet(max_disp=max_disp)
        model.load_state_dict(load_net_params(path))
        return cls(model, **kw)

    def warmup(self, buckets=None) -> None:
        """Run every bucket once ahead of traffic (cuDNN picks its
        algorithms per shape on first use)."""
        H, W = self.imsize
        if not buckets:
            buckets, b = [], 1
            while b <= self.max_batch:
                buckets.append(b)
                b *= 2
        for b in buckets:
            self._run(np.zeros((b, H, W), np.float32)).cpu()

    @torch.inference_mode()
    def _run(self, images: np.ndarray) -> torch.Tensor:
        enc = np.clip(images * 65535.0 + 0.5, 0, 65535).astype(np.uint16)
        im = torch.from_numpy(enc).to(self.device).to(torch.float32) \
            * (1.0 / 65535.0)
        im_lcn, _ = lcn(im, self.lcn_radius, 0.05)
        return self.model(torch.stack([im_lcn, im], dim=-1))[0][..., 0]

    def infer(self, images: np.ndarray) -> np.ndarray:
        """images (n, H, W) float32 in [0, 1] -> disparities (n, H, W)."""
        images = np.asarray(images, np.float32)
        n = images.shape[0]
        outs = []
        for lo in range(0, n, self.max_batch):
            chunk = images[lo:lo + self.max_batch]
            m = chunk.shape[0]
            b = _bucket(m, self.max_batch)
            if m < b:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], b - m, axis=0)], axis=0)
            outs.append(self._run(chunk)[:m].cpu().numpy())
        return np.concatenate(outs, axis=0)
