"""Photometric (pattern-similarity) loss, port of
``depthinspace_tpu/losses/photometric.py::photometric_loss``.

The projector pattern is shifted along each row by the predicted disparity
(K2), compared with the LCN'd IR image by census-SAD (K1), and averaged with
the LCN std map as weights.
"""

from __future__ import annotations

import torch

from ..ops.census import census_sad
from ..ops.resample import warp_pattern
from .reduce import global_mean, global_ratio


def photometric_loss(disp: torch.Tensor, im: torch.Tensor,
                     pattern: torch.Tensor, std: torch.Tensor | None = None,
                     block_size: int = 9, eps: float = 0.5, group=None):
    """disp, im, std: (N, H, W); pattern (H, W) LCN'd projector pattern.

    Returns (loss, pattern_proj): the std-weighted mean of the census map
    (plain mean without ``std``), over the global batch of ``group``
    (``losses/reduce.py``: this rank's share)."""
    pattern_proj = warp_pattern(pattern, disp)
    diff = census_sad(pattern_proj, im, block_size, eps)
    if std is not None:
        return (global_ratio(torch.sum(std * diff), torch.sum(std), group),
                pattern_proj)
    return global_mean(diff, group), pattern_proj
