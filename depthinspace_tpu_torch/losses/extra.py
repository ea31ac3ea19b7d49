"""Losses of the reference that no training path of the JAX package calls,
port of ``depthinspace_tpu/losses/extra.py``: the SSIM dissimilarity and
the projection-depth similarity loss over rigid flow with its
forward-backward occlusion masks. Plain tensor code on the port's
``bilinear_sample`` and ``reproject``; no kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.geometry import reproject
from ..ops.sampling import bilinear_sample
from .geometric import CameraGeometry


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """SSIM dissimilarity map, clamp((1 - SSIM) / 2, 0, 1), of x, y (N, H,
    W, C): 3x3 means with reflection padding, C1 = 0.01^2, C2 = 0.03^2."""
    def pool(a):
        ap = F.pad(a.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
        return (F.avg_pool2d(ap, 3, stride=1, divisor_override=1) / 9.0
                ).permute(0, 2, 3, 1)

    C1, C2 = 0.01 ** 2, 0.03 ** 2
    mu_x, mu_y = pool(x), pool(y)
    sigma_x = pool(x * x) - mu_x ** 2
    sigma_y = pool(y * y) - mu_y ** 2
    sigma_xy = pool(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)
    d = (mu_x ** 2 + mu_y ** 2 + C1) * (sigma_x + sigma_y + C2)
    return torch.clamp((1 - n / d) / 2, 0.0, 1.0)


def _rigid_flow_and_diff(cam: CameraGeometry, depth0, depth1, R0, t0, R1,
                         t1, clamp):
    """View 0's depth projected into view 1 against view 1's depth sampled
    (border padding) where it lands: (mean |difference|, rigid flow)."""
    N = depth0.shape[0]
    H, W = cam.height, cam.width
    uv1, d1 = reproject(depth0, cam.ray, cam.K, R0, t0, R1, t1)
    uv1 = uv1.reshape(N, H, W, 2)
    d1 = d1.reshape(N, H, W)
    rigid_flow = uv1 - cam.grid[None]
    depth10 = bilinear_sample(depth1[..., None], uv1[..., 0], uv1[..., 1],
                              padding="border")[..., 0]
    diff = torch.abs(d1 - depth10)
    if clamp > 0:
        diff = torch.clamp(diff, 0.0, clamp)
    return torch.mean(diff), rigid_flow


def occlusion_mask(cam: CameraGeometry, flow0: torch.Tensor,
                   flow1: torch.Tensor) -> torch.Tensor:
    """Forward-backward consistency of flows (N, H, W, 2): 1 where
    ||f0 + f1(p + f0)||^2 < 0.25 + 0.02 (||f0||^2 + ||f1(p + f0)||^2),
    (N, H, W, 1) float32."""
    x = flow0[..., 0] + cam.grid[None, ..., 0]
    y = flow0[..., 1] + cam.grid[None, ..., 1]
    flow0_proj = bilinear_sample(flow1, x, y, padding="border")
    lhs = torch.sum((flow0 + flow0_proj) ** 2, dim=-1)
    rhs = 0.25 + 0.02 * (torch.sum(flow0 ** 2, dim=-1)
                         + torch.sum(flow0_proj ** 2, dim=-1))
    return (lhs < rhs).to(torch.float32)[..., None]


def projection_depth_similarity_loss(cam: CameraGeometry, depth0, depth1,
                                     R0, t0, R1, t1, clamp: float = -1.0):
    """The symmetrized depth difference over rigid (pose-induced) flow,
    depths (N, H, W), poses R (N, 3, 3), t (N, 3); ``clamp`` > 0 clips
    each difference. Returns (loss, rigid_flow0, rigid_flow1, mask0,
    mask1), the masks from the detached flows."""
    l0, rf0 = _rigid_flow_and_diff(cam, depth0, depth1, R0, t0, R1, t1,
                                   clamp)
    l1, rf1 = _rigid_flow_and_diff(cam, depth1, depth0, R1, t1, R0, t0,
                                   clamp)
    rf0_s, rf1_s = rf0.detach(), rf1.detach()
    return (l0 + l1, rf0, rf1, occlusion_mask(cam, rf0_s, rf1_s),
            occlusion_mask(cam, rf1_s, rf0_s))
