"""Output-head variants, port of ``depthinspace_tpu/models/heads.py`` (the
reference's OutputLayerFactory): linear, disp, disp_row, pos and pos_row.
DispNet uses 'disp' (``dispnet.SigmoidAffineHead``); the others are here
for the API. Layout NCHW, as the port's models; the flax parameters map
with ``models/convert.py::head_state_dict_from_flax``, and
``make_output_head(..., key=k)`` draws the weights the flax head's
``init(k)`` gives (``models/init.py``: lecun-normal kernels, truncated at 2
std, fan-in H * Ci for a per-row map; zero biases).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.geometry import disp_to_depth
from ..utils import jrandom
from ..utils.jrandom import Key
from .convert import head_state_dict_from_flax
from .dispnet import SameConv2d, SigmoidAffineHead
from .init import head_template, load_flax_init_


class MultiLinear(nn.Module):
    """An independent linear map per image row: (N, Ci, H, W) -> (N, F, H,
    W); weight (H, F, Ci), bias (H, F), drawn by ``make_output_head``."""

    def __init__(self, height: int, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(height, features,
                                               in_features))
        self.bias = nn.Parameter(torch.zeros(height, features))

    def forward(self, x):
        y = torch.einsum("nchw,hfc->nfhw", x, self.weight)
        return y + self.bias.t()[None, :, :, None]


class SigmoidAffine(nn.Module):
    """sigmoid(x / gamma - offset) * alpha + beta."""

    def __init__(self, alpha: float = 1.0, beta: float = 0.0,
                 gamma: float = 1.0, offset: float = 0.0):
        super().__init__()
        self.alpha, self.beta = alpha, beta
        self.gamma, self.offset = gamma, offset

    def forward(self, x):
        return torch.sigmoid(x / self.gamma - self.offset) * self.alpha \
            + self.beta


class DispRowHead(nn.Module):
    """'disp_row': a per-row linear map to one channel, then
    SigmoidAffine."""

    def __init__(self, height: int, in_features: int, alpha: float,
                 beta: float = 0.0, gamma: float = 1.0, offset: float = 3.0):
        super().__init__()
        self.linear = MultiLinear(height, in_features, 1)
        self.act = SigmoidAffine(alpha, beta, gamma, offset)

    def forward(self, x):
        return self.act(self.linear(x))


class PosOutput(nn.Module):
    """'pos' (a 3x3 conv) or 'pos_row' (a per-row linear map): the
    absolute position pos = SigmoidAffine(proj(x)); returns the disparity
    u - pos, (N, 1, H, W)."""

    def __init__(self, in_features: int, kind: str = "pos",
                 height: int | None = None, alpha: float = 1.0,
                 beta: float = 0.0, gamma: float = 1.0,
                 offset: float = 0.0):
        super().__init__()
        if kind == "pos":
            self.proj = SameConv2d(in_features, 1, 3)
        elif kind == "pos_row":
            if height is None:
                raise ValueError("pos_row needs the image height")
            self.proj = MultiLinear(height, in_features, 1)
        else:
            raise ValueError(kind)
        self.act = SigmoidAffine(alpha, beta, gamma, offset)

    def forward(self, x):
        pos = self.act(self.proj(x))
        u = torch.arange(x.shape[3], dtype=pos.dtype, device=pos.device)
        return u - pos


def pos_to_depth(pos: torch.Tensor, focal_length: float,
                 baseline: float) -> torch.Tensor:
    """disp = u - pos (u along the last axis), then disparity -> depth."""
    u = torch.arange(pos.shape[-1], dtype=pos.dtype, device=pos.device)
    return disp_to_depth(u - pos, focal_length, baseline)


def make_output_head(kind: str = "disp", in_features: int = 32, *,
                     height: int | None = None, key: Key = jrandom.key(0),
                     **params) -> nn.Module:
    """The head of ``kind`` (the reference factory's type names) on
    ``in_features`` channels, with the weights the flax head's
    ``init(key)`` gives; ``params``: alpha, beta, gamma, offset."""
    if kind == "linear":
        head = SameConv2d(in_features, 1, 3)
    elif kind == "disp":
        head = SigmoidAffineHead(in_features, **params)
    elif kind == "disp_row":
        head = DispRowHead(height, in_features, **params)
    elif kind in ("pos", "pos_row"):
        head = PosOutput(in_features, kind=kind, height=height, **params)
    else:
        raise ValueError(f"unknown output head {kind!r}")
    return load_flax_init_(head, head_template(head, kind), key,
                           lambda tree: head_state_dict_from_flax(tree, kind))
