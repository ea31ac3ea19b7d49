"""Camera projection geometry (port of ``depthinspace_tpu/ops/geometry.py``).

Conventions of the reference:
  unproject: xyz_cam = depth * ray;  xyz_world = (xyz_cam - t) @ R
  project:   xyz_cam = xyz_world @ R^T + t;  uvd = xyz_cam @ K^T;
             uv = uvd[..., :2] / (relu(uvd[..., 2]) + 1e-12)
"""

from __future__ import annotations

import numpy as np
import torch


def pixel_rays(K_inv: np.ndarray, height: int, width: int) -> np.ndarray:
    """Per-pixel unit-depth rays uv1 @ K^-T, (H*W, 3), v major."""
    u, v = np.meshgrid(range(width), range(height))
    uv = np.stack((u, v, np.ones_like(u)), axis=2).reshape(-1, 3)
    return (uv @ K_inv.T).astype(np.float32)


def unproject(depth: torch.Tensor, ray: torch.Tensor,
              R: torch.Tensor | None = None,
              t: torch.Tensor | None = None) -> torch.Tensor:
    """depth (N, H*W) or (N, H, W) + ray (H*W, 3) -> world xyz (N, H*W, 3)."""
    N = depth.shape[0]
    xyz = depth.reshape(N, -1, 1) * ray[None]
    if t is not None:
        xyz = xyz - t.reshape(N, 1, 3)
    if R is not None:
        xyz = torch.einsum("npi,nij->npj", xyz, R)
    return xyz


def project(xyz: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
            t: torch.Tensor):
    """World xyz (N, P, 3) -> pixel uv (N, P, 2) and depth d (N, P, 1)."""
    N = xyz.shape[0]
    xyz = torch.einsum("npj,nij->npi", xyz, R)
    xyz = xyz + t.reshape(N, 1, 3)
    uvd = torch.einsum("npj,ij->npi", xyz, K)
    d = uvd[:, :, 2:3]
    uv = uvd[:, :, :2] / (torch.relu(d) + 1e-12)
    return uv, d


def reproject(depth0, ray, K, R0, t0, R1, t1):
    """Unproject view-0 depth to world, project into view 1."""
    return project(unproject(depth0, ray, R0, t0), K, R1, t1)


def _scalar_over(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x as one rounded division, as JAX computes it (PyTorch's
    ``c / x`` is ``x.reciprocal() * c``, rounded twice)."""
    return torch.div(torch.tensor(c, dtype=x.dtype, device=x.device), x)


def disp_to_depth(disp: torch.Tensor, focal_length: float,
                  baseline: float) -> torch.Tensor:
    """depth = baseline * f / (relu(disp) + 1e-12)."""
    return _scalar_over(baseline * focal_length, torch.relu(disp) + 1e-12)


def depth_to_disp(depth: torch.Tensor, focal_length: float,
                  baseline: float) -> torch.Tensor:
    return _scalar_over(baseline * focal_length,
                        torch.clamp(depth, min=1e-12))
