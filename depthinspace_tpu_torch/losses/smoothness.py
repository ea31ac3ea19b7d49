"""Edge-aware disparity smoothness loss, port of
``depthinspace_tpu/losses/smoothness.py``: mean of |grad disp| *
exp(-|255 grad amb|) with 5x5 Sobel gradients (replicate padding)."""

from __future__ import annotations

import torch

from ..ops.sobel import sobel
from .reduce import global_mean


def smoothness_loss(disp: torch.Tensor, ambient: torch.Tensor,
                    group=None) -> torch.Tensor:
    """disp, ambient: (N, H, W). Returns a scalar: the mean over the
    global batch of ``group`` (this rank's share)."""
    g_d = sobel(disp[..., None])
    g_a = sobel(ambient[..., None])
    return global_mean(torch.abs(g_d * torch.exp(-torch.abs(255.0 * g_a))),
                       group)
