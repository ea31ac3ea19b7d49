"""Learned optical flow, port of ``depthinspace_tpu/models/flownet.py``: a
small PWC-style coarse-to-fine network (the repository's replacement for
LiteFlowNet).

- Every input channel is LCN-normalized (radius 5, eps 0.05).
- A shared encoder gives features at 1/2, 1/4, 1/8 and 1/16 (16, 32, 64, 96
  channels; a stride-2 and a stride-1 3x3 conv a level, leaky ReLU 0.1,
  flax "SAME" padding, so odd sizes pad as flax pads them).
- Three levels, coarsest first (1/16, 1/8, 1/4): the previous flow resized
  to the level (``resize_flow``), the source features warped by it
  (``ops.sampling.warp``, zero padding), the correlation volume over 81
  static shifts, and a decoder on [corr, features, flow_up] that predicts a
  residual.
- The 1/4 flow resized to full resolution is the last of the four outputs.

The public layout is the JAX one: images (N, H, W, C), flows (N, h, w, 2) =
(u, v) in pixels. Inside, the convolutions run channels-first. The
correlation and the feature warp are plain PyTorch, as the JAX package
computes them in plain XLA; the warp's autograd passes the flow gradient
that training needs. float32 only.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import lcn, resize_flow, warp
from .dispnet import SameConv2d

_ENC_CHANNELS = (16, 32, 64, 96)
_DEC_CHANNELS = (96, 64, 32)
_LEVELS = (3, 2, 1)                  # pyramid indices, coarsest first


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """Normalized correlation volume from static shifts. f1, f2 (N, H, W, C)
    -> (N, H, W, (2r+1)^2); entry (dy, dx), dy-major, is mean_c f1[y, x, c]
    * f2[y + dy - r, x + dx - r, c] (zeros past the border) / sqrt(C)."""
    out = _correlation_nchw(f1.permute(0, 3, 1, 2), f2.permute(0, 3, 1, 2),
                            radius)
    return out.permute(0, 2, 3, 1)


def _correlation_nchw(f1: torch.Tensor, f2: torch.Tensor,
                      radius: int) -> torch.Tensor:
    """:func:`correlation` on (N, C, H, W) features -> (N, (2r+1)^2, H, W):
    the mean over channels, then the division by sqrt(C), as JAX."""
    _, c, h, w = f1.shape
    r = radius
    f2p = F.pad(f2, (r, r, r, r))
    cols = [torch.mean(f1 * f2p[:, :, dy:dy + h, dx:dx + w], dim=1)
            for dy in range(2 * r + 1) for dx in range(2 * r + 1)]
    return torch.stack(cols, dim=1) / math.sqrt(c)


def _leaky(x):
    return F.leaky_relu(x, 0.1)


class _Encoder(nn.Module):
    """The shared feature pyramid: levels at 1/2, 1/4, 1/8, 1/16."""

    def __init__(self, in_channels: int):
        super().__init__()
        cins = (in_channels,) + _ENC_CHANNELS[:-1]
        for i, (ci, co) in enumerate(zip(cins, _ENC_CHANNELS)):
            self.add_module(f"down{i}", SameConv2d(ci, co, 3, stride=2))
            self.add_module(f"conv{i}", SameConv2d(co, co, 3))

    def forward(self, x):
        feats = []
        for i in range(len(_ENC_CHANNELS)):
            x = _leaky(getattr(self, f"down{i}")(x))
            x = _leaky(getattr(self, f"conv{i}")(x))
            feats.append(x)
        return feats


class _FlowDecoder(nn.Module):
    """A level's residual flow predictor on [corr, feat, flow_up]."""

    def __init__(self, cin: int):
        super().__init__()
        cins = (cin,) + _DEC_CHANNELS[:-1]
        for i, (ci, co) in enumerate(zip(cins, _DEC_CHANNELS)):
            self.add_module(f"dec{i}", SameConv2d(ci, co, 3))
        self.flow_head = SameConv2d(_DEC_CHANNELS[-1], 2, 3)

    def forward(self, corr, feat, flow_up):
        """corr, feat (N, C, h, w); flow_up (N, h, w, 2) -> (N, h, w, 2)."""
        x = torch.cat([corr, feat, flow_up.permute(0, 3, 1, 2)], dim=1)
        for i in range(len(_DEC_CHANNELS)):
            x = _leaky(getattr(self, f"dec{i}")(x))
        return flow_up + self.flow_head(x).permute(0, 2, 3, 1)


class FlowNet(nn.Module):
    """Two-frame dense optical flow. forward(img1, img2), both (N, H, W,
    in_channels), -> [(N, h16, w16, 2), (N, h8, w8, 2), (N, h4, w4, 2), (N,
    H, W, 2)], coarse to fine; the last is the full-resolution flow 1 -> 2.
    Submodules are named after the flax tree (``encoder.down0``,
    ``level1.flow_head``, ...)."""

    def __init__(self, in_channels: int = 2, radius: int = 4):
        super().__init__()
        self.in_channels = in_channels
        self.radius = radius
        self.encoder = _Encoder(in_channels)
        corr = (2 * radius + 1) ** 2
        for li in _LEVELS:
            self.add_module(f"level{li}",
                            _FlowDecoder(corr + _ENC_CHANNELS[li] + 2))

    def encode(self, img: torch.Tensor) -> list:
        """(N, H, W, C) images -> their LCN'd feature pyramid, 4 x (N, C_l,
        h_l, w_l)."""
        n, h, w, c = img.shape
        flat = img.permute(0, 3, 1, 2).reshape(n * c, h, w)
        x, _ = lcn(flat, 5, 0.05)
        return self.encoder(x.reshape(n, c, h, w))

    def decode(self, p1: list, p2: list, height: int, width: int) -> list:
        """The flows from frame 1's pyramid to frame 2's (see forward)."""
        flows, flow = [], None
        for li in _LEVELS:
            f1, f2 = p1[li], p2[li]
            n, _, h, w = f1.shape
            if flow is None:
                flow_up = f1.new_zeros((n, h, w, 2))
            else:
                flow_up = resize_flow(flow, h, w)
            f2w = warp(f2.permute(0, 2, 3, 1), flow_up, padding="zeros")
            corr = _correlation_nchw(f1, f2w.permute(0, 3, 1, 2),
                                     self.radius)
            flow = getattr(self, f"level{li}")(corr, f1, flow_up)
            flows.append(flow)
        flows.append(resize_flow(flow, height, width))
        return flows

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> list:
        H, W = img1.shape[1:3]
        return self.decode(self.encode(img1), self.encode(img2), H, W)


def init_flownet_(model: FlowNet, key) -> FlowNet:
    """The weights flax's ``FlowNet.init`` gives for the same key
    (``utils.jrandom.key(seed)`` for ``jax.random.key(seed)``): lecun-normal
    kernels, zero biases (``models/init.py``)."""
    from .convert import flownet_state_dict_from_flax
    from .init import flownet_template, load_flax_init_
    return load_flax_init_(model, flownet_template(model), key,
                           flownet_state_dict_from_flax)


def flow_input(im: torch.Tensor, amb: torch.Tensor,
               in_channels: int) -> torch.Tensor:
    """FlowNet's input channels from images (..., H, W): [ambient, IR]
    (2 channels) or the ambient alone (``im`` unread, may be None)."""
    if in_channels == 2:
        return torch.stack([amb, im], dim=-1)
    return amb[..., None]


@torch.no_grad()
def flow_all_pairs(net: FlowNet, im, amb):
    """The flow of every ordered frame pair from a frozen FlowNet, on the
    net's input channels (``flow_input``; ``im`` unread for 1 channel).

    im/amb (tl, n, H, W) float32 -> (tl, tl, n, H, W, 2) with out[i, j] the
    flow from frame i to frame j and a zero diagonal, without gradient (the
    layout of flow.hdf5 batches). Each frame is encoded once; the pairs,
    ordered (i, j) for i != j as in the JAX function, are decoded in one
    batch."""
    tl, n, H, W = amb.shape
    c = net.in_channels
    pairs = [(i, j) for i in range(tl) for j in range(tl) if i != j]
    x = flow_input(im, amb, c).reshape(tl * n, H, W, c)
    feats = [f.reshape(tl, n, *f.shape[1:]) for f in net.encode(x)]
    src = torch.tensor([i for i, _ in pairs], device=amb.device)
    dst = torch.tensor([j for _, j in pairs], device=amb.device)
    take = lambda idx: [f[idx].flatten(0, 1) for f in feats]
    fl = net.decode(take(src), take(dst), H, W)[-1]
    out = amb.new_zeros((tl, tl, n, H, W, 2))
    out[src, dst] = fl.reshape(len(pairs), n, H, W, 2)
    return out


def multiscale_epe_loss(flows, flow_gt, weights=(0.32, 0.16, 0.08, 0.04)):
    """The supervised multi-scale loss: at each level, the generalized
    Charbonnier (|du| + |dv| + 0.01)^0.4 against the GT flow (N, H, W, 2)
    resized to the level, weighted and summed."""
    total = 0.0
    for fl, wgt in zip(flows, weights):
        gt = resize_flow(flow_gt, fl.shape[1], fl.shape[2])
        err = torch.sum(torch.abs(fl - gt), dim=-1)
        total = total + wgt * torch.mean((err + 0.01) ** 0.4)
    return total


def epe(flow, flow_gt):
    """Mean endpoint error."""
    return torch.mean(torch.linalg.vector_norm(flow - flow_gt, dim=-1))
