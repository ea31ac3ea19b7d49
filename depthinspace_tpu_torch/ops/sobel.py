"""5x5 Sobel gradient filters with replicate padding (port of
``depthinspace_tpu/ops/sobel.py``).

Written as a weighted sum of shifted slices of the edge-padded image rather
than a convolution, so it stays in full float32 on the card (cuDNN
convolutions default to TF32 there). The padding is
``ops.sampling.pad_edge``, whose backward is deterministic on the card: the
smoothness loss differentiates the disparity's Sobel.
"""

from __future__ import annotations

import numpy as np
import torch

from .sampling import pad_edge

_KX5 = np.array([[-5, -4, 0, 4, 5],
                 [-8, -10, 0, 10, 8],
                 [-10, -20, 0, 20, 10],
                 [-8, -10, 0, 10, 8],
                 [-5, -4, 0, 4, 5]], dtype=np.float32) / 240.0


def _filter(xp: torch.Tensor, k: np.ndarray, H: int, W: int) -> torch.Tensor:
    out = None
    for i in range(k.shape[0]):
        for j in range(k.shape[1]):
            if k[i, j] == 0.0:
                continue
            term = xp[:, i:i + H, j:j + W] * float(k[i, j])
            out = term if out is None else out + term
    return out


def sobel(x: torch.Tensor) -> torch.Tensor:
    """5x5 Sobel of x (N, H, W, 1) -> (N, H, W, 2) = (gx, gy), the only form
    the losses use (the JAX function's ksize=5, norm=False)."""
    N, H, W, _ = x.shape
    xp = pad_edge(x[..., 0], 2)
    return torch.stack([_filter(xp, _KX5, H, W), _filter(xp, _KX5.T, H, W)],
                       dim=-1)
