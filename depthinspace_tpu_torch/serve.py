"""Batched disparity inference, port of ``depthinspace_tpu/serve.py``:
``DisparityServer`` (DIS-SF on single frames) and ``TrackDisparityServer``
(DIS-SF then DIS-MF on tracks of frames with their poses and flow).

A request is cut into chunks of at most ``max_batch`` images (tracks), and
each chunk is padded (by repeating its last item) up to a power-of-2
bucket, as the JAX servers do. Images cross to the device as uint16 fixed
point (x 65535) and flow as int16 x 256, so the outputs match the JAX
servers' for the same request.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models import (DispNet, FuseNet, dispnet_state_dict_from_flax,
                     fusenet_state_dict_from_flax)
from .ops import disp_to_depth, lcn


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


def _pad_to(x: np.ndarray, b: int) -> np.ndarray:
    """Pad axis 0 to ``b`` by repeating the last item."""
    if x.shape[0] == b:
        return x
    return np.concatenate([x, np.repeat(x[-1:], b - x.shape[0], axis=0)])


def _encode_u16(x: np.ndarray) -> np.ndarray:
    return np.clip(x * 65535.0 + 0.5, 0, 65535).astype(np.uint16)


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
        im = torch.from_numpy(_encode_u16(images)).to(self.device).to(torch.float32) \
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
            chunk = _pad_to(chunk, _bucket(m, self.max_batch))
            outs.append(self._run(chunk)[:m].cpu().numpy())
        return np.concatenate(outs, axis=0)


def _default_K(imsize) -> np.ndarray:
    H, W = imsize
    return np.array([[435.2, 0, W / 2], [0, 435.2, H / 2], [0, 0, 1]],
                    np.float32)


class TrackDisparityServer:
    """The DIS pipeline on tracks: LCN, the DIS-SF network (the primary
    disparity), then FuseNet on the primary and the given pairwise optical
    flow, one forward per request bucket.

    >>> srv = TrackDisparityServer.from_net_params(
    ...     "single_frame/net_0029.params", "multi_frame/net_0009.params")
    >>> disp = srv.infer(im, ambient, R, t, flow)   # (n, tl, H, W) -> same

    The flow is the caller's: the JAX server can compute it with its
    learned FlowNet, which is not ported yet (``infer`` without flow
    raises). ``device=None`` is the card; the CPU only with
    ``device="cpu"``. ``compute_dtype`` is FuseNet's (DIS-SF runs in
    float32, as in the JAX server)."""

    def __init__(self, sf_model: DispNet, mf_model: FuseNet,
                 imsize=(512, 432), K=None, baseline: float = 0.025,
                 max_tracks: int = 4, lcn_radius: int = 5, device=None):
        self.device = resolve_device(device)
        self.imsize = tuple(imsize)
        self.track_length = mf_model.track_length
        self.max_tracks = int(max_tracks)
        self.lcn_radius = lcn_radius
        K = np.asarray(_default_K(self.imsize) if K is None else K,
                       np.float32)
        self.focal, self.baseline = float(K[0, 0]), float(baseline)
        self.sf = sf_model.to(self.device).eval()
        self.mf = mf_model.to(self.device).eval()

    @staticmethod
    def _fusenet(imsize, K, track_length, max_disp, compute_dtype):
        return FuseNet(imsize=imsize, K=_default_K(imsize) if K is None
                       else K, track_length=track_length, max_disp=max_disp,
                       compute_dtype=compute_dtype)

    @classmethod
    def from_jax_params(cls, sf_tree, mf_tree, imsize=(512, 432), K=None,
                        track_length: int = 4, max_disp: float = 128.0,
                        compute_dtype=torch.bfloat16, **kw):
        """From the flax DispNet and FuseNet variables as nested dicts of
        numpy arrays."""
        sf = DispNet(max_disp=max_disp)
        sf.load_state_dict(dispnet_state_dict_from_flax(sf_tree))
        mf = cls._fusenet(imsize, K, track_length, max_disp, compute_dtype)
        mf.load_state_dict(fusenet_state_dict_from_flax(mf_tree, mf))
        return cls(sf, mf, imsize=imsize, K=K, **kw)

    @classmethod
    def from_net_params(cls, sf_path, mf_path, imsize=(512, 432), K=None,
                        track_length: int = 4, max_disp: float = 128.0,
                        compute_dtype=torch.bfloat16, **kw):
        """From the two ``net_%04d.params`` files (flax msgpack) of a DIS-SF
        and a DIS-MF run, written by either package's trainer."""
        from .train.checkpoint import load_net_params
        sf = DispNet(max_disp=max_disp)
        sf.load_state_dict(load_net_params(sf_path))
        mf = cls._fusenet(imsize, K, track_length, max_disp, compute_dtype)
        mf.load_state_dict(load_net_params(mf_path, mf))
        return cls(sf, mf, imsize=imsize, K=K, **kw)

    @torch.inference_mode()
    def _run(self, im_u16, amb_u16, R, t, flow_i16) -> torch.Tensor:
        """Track-major device arrays: im/amb (tl, n, H, W) u16; R (tl, n, 3,
        3); t (tl, n, 3); flow (tl, tl, n, H, W, 2) int16 x 256. Returns the
        disparity (tl, n, H, W) as u16 x 256."""
        tl, n, H, W = im_u16.shape
        to = lambda x: torch.from_numpy(x).to(self.device)
        im = to(im_u16).to(torch.float32) * (1.0 / 65535.0)
        amb = to(amb_u16).to(torch.float32) * (1.0 / 65535.0)
        flow = to(flow_i16).to(torch.float32) * (1.0 / 256.0)
        im_lcn, _ = lcn(im.reshape(tl * n, H, W), self.lcn_radius, 0.05)
        ir = torch.stack([im_lcn, im.reshape(tl * n, H, W)], dim=-1)
        pd = self.sf(ir)[0].reshape(tl, n, H, W, 1)
        pdepth = disp_to_depth(pd, self.focal, self.baseline)
        out = self.mf(ir.reshape(tl, n, H, W, 2), amb[..., None], pd, pdepth,
                      to(R), to(t), flow)
        return torch.clamp(out[..., 0] * 256.0 + 0.5, 0, 65535).to(
            torch.int32).to(torch.uint16)

    def infer(self, im, ambient, R, t, flow=None) -> np.ndarray:
        """im/ambient (n, tl, H, W) float32 in [0, 1]; R (n, tl, 3, 3);
        t (n, tl, 3); flow (n, tl, tl, H, W, 2) in pixels, flow[:, i, j]
        from frame i to frame j. Returns the refined disparity (n, tl, H, W)
        float32, in steps of 1/256 px."""
        if flow is None:
            raise NotImplementedError(
                "TrackDisparityServer needs the flow from the caller: the "
                "learned flow provider (FlowNet, models/flownet.py) is not "
                "ported yet")
        arrays = [np.asarray(a, np.float32) for a in (im, ambient, R, t, flow)]
        n = arrays[0].shape[0]
        outs = []
        for lo in range(0, n, self.max_tracks):
            chunk = [a[lo:lo + self.max_tracks] for a in arrays]
            m = chunk[0].shape[0]
            b = _bucket(m, self.max_tracks)
            im_c, amb_c, R_c, t_c, fl_c = (_pad_to(a, b) for a in chunk)
            # the request is track-major per item (n, tl, ...); the device
            # layout is tl-major
            fl_i16 = np.clip(np.rint(np.moveaxis(fl_c, 0, 2) * 256.0),
                             -32768, 32767).astype(np.int16)
            out = self._run(_encode_u16(np.moveaxis(im_c, 0, 1)),
                            _encode_u16(np.moveaxis(amb_c, 0, 1)),
                            np.ascontiguousarray(np.moveaxis(R_c, 0, 1)),
                            np.ascontiguousarray(np.moveaxis(t_c, 0, 1)),
                            fl_i16)
            disp = out.cpu().numpy().astype(np.float32) * (1.0 / 256.0)
            outs.append(np.moveaxis(disp, 0, 1)[:m])
        return np.concatenate(outs, axis=0)
