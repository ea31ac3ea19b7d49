"""Stereo-matching utilities of the reference's extension API, port of
``depthinspace_tpu/ops/matching.py``: nearest neighbours, the left-right
cross-check, the projective nearest neighbour and a normalized
cross-correlation cost volume. No pipeline path calls them; as in JAX they
carry no gradient (each runs under ``torch.no_grad``). Plain tensor code.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


@torch.no_grad()
def nn_search(in0: torch.Tensor, in1: torch.Tensor) -> torch.Tensor:
    """For each point of in0 (N, P0, C), the index of its nearest point of
    in1 (N, P1, C) under squared L2 (the first on a tie). int32 (N, P0)."""
    d = ((in0 ** 2).sum(-1)[:, :, None]
         - 2 * torch.einsum("npc,nqc->npq", in0, in1)
         + (in1 ** 2).sum(-1)[:, None, :])
    return torch.argmin(d, dim=-1).to(torch.int32)


@torch.no_grad()
def crosscheck(disp0: torch.Tensor, disp1: torch.Tensor,
               threshold: float = 1.0) -> torch.Tensor:
    """Left-right consistency of the disparities (N, H, W) of the left and
    right views: 1 where |disp0(u) - disp1(u - disp0(u))| < threshold (disp1
    sampled linearly, the coordinate clamped to the image), float32."""
    N, H, W = disp0.shape
    u = torch.arange(W, dtype=disp0.dtype, device=disp0.device)
    x = torch.clamp(u - disp0, 0.0, W - 1.0)
    x0 = torch.floor(x).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    f = x - x0
    d1 = (torch.gather(disp1, -1, x0) * (1 - f)
          + torch.gather(disp1, -1, x1) * f)
    return (torch.abs(disp0 - d1) < threshold).to(torch.float32)


@torch.no_grad()
def proj_nn(xyz0: torch.Tensor, xyz1: torch.Tensor, K: torch.Tensor | None = None,
            patch_size: int = 3) -> torch.Tensor:
    """For each pixel's point of xyz0 (N, H, W, 3), the nearest point of
    xyz1 within the patch_size^2 pixels around it (0 where none is finite),
    (N, H, W, 3). ``K`` is the JAX signature's and unused."""
    p = patch_size // 2
    N, H, W, _ = xyz0.shape
    xp = F.pad(xyz1.permute(0, 3, 1, 2), (p, p, p, p),
               value=float("inf")).permute(0, 2, 3, 1)
    cands = torch.stack([xp[:, dy:dy + H, dx:dx + W, :]
                         for dy in range(patch_size)
                         for dx in range(patch_size)], dim=-2)
    d = torch.sum((cands - xyz0[..., None, :]) ** 2, dim=-1)
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf")))
    idx = torch.argmin(d, dim=-1)
    out = torch.gather(cands, -2, idx[..., None, None].expand(
        *idx.shape, 1, 3))[..., 0, :]
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def _box(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """The sum over each pixel's block_size^2 window, edge padding."""
    p = block_size // 2
    N, H, W = x.shape
    xp = F.pad(x[:, None], (p, p, p, p), mode="replicate")[:, 0]
    rows = sum(xp[:, dy:dy + H, :] for dy in range(block_size))
    return sum(rows[:, :, dx:dx + W] for dx in range(block_size))


@torch.no_grad()
def xcorrvol(in0: torch.Tensor, in1: torch.Tensor, n_disps: int = 64,
             block_size: int = 9) -> torch.Tensor:
    """Zero-normalized cross-correlation of the rectified images in0, in1
    (N, H, W) over disparities: the block correlation of in0 at u with in1
    at u - d (in1 edge-padded on the left), (N, H, W, n_disps)."""
    n = float(block_size ** 2)
    mu0 = _box(in0, block_size) / n
    var0 = _box(in0 * in0, block_size) / n - mu0 ** 2
    N, H, W = in0.shape
    in1_pad = F.pad(in1[:, None], (n_disps, 0, 0, 0), mode="replicate")[:, 0]
    vol = []
    for d in range(n_disps):
        sh = in1_pad[:, :, n_disps - d:n_disps - d + W]
        mu1 = _box(sh, block_size) / n
        var1 = _box(sh * sh, block_size) / n - mu1 ** 2
        cov = _box(in0 * sh, block_size) / n - mu0 * mu1
        vol.append(cov * torch.rsqrt(torch.clamp(var0 * var1, min=1e-12)))
    return torch.stack(vol, dim=-1)
