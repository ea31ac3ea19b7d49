"""The batch-wide reductions of the losses, over one process or over the
ranks of a data-parallel group.

The JAX step on a mesh computes the single-device loss of the *global*
batch: GSPMD sums across devices before it divides. Several terms are
ratios over the whole batch (the photometric loss's std-weighted mean, the
geometric losses' masked means, the SGM warm-up term), and a mean of the
ranks' ratios (what a plain DistributedDataParallel average gives) weights
the ranks by their mask counts. So each rank's term is its *local*
numerator over the *all-reduced* denominator: the terms of the ranks sum to
the global value, and since no denominator carries a gradient (masks and
weights are data), the ranks' gradients sum to the global-batch gradient.

With ``group`` None (one process) each helper is the expression the losses
had before, bit for bit.
"""

from __future__ import annotations

import torch

from ..parallel.multihost import all_reduce_sum


def global_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's share of the mean of ``x`` over the global batch: its
    sum over the global element count (every rank holds as many)."""
    if group is None:
        return torch.mean(x)
    world = torch.distributed.get_world_size(group)
    return torch.sum(x) / (x.numel() * world)


def global_ratio(num: torch.Tensor, den: torch.Tensor, group=None,
                 eps: float | None = None,
                 min_den: float | None = None) -> torch.Tensor:
    """``num / den`` with ``den`` summed over the ranks (detached), then
    ``+ eps`` or clamped to at least ``min_den``, on the global sum."""
    if group is not None:
        den = all_reduce_sum(den.detach(), group)
    if eps is not None:
        den = den + eps
    if min_den is not None:
        den = torch.clamp(den, min=min_den)
    return num / den
