"""Image resampling of the losses: the pattern warp by disparity (K2) and
the flow warp (K3). Port of ``depthinspace_tpu/ops/resample.py``.

Each public function is a ``torch.autograd.Function`` that runs its CUDA
kernels (forward and backward) on a CUDA tensor and their plain PyTorch
versions on a CPU tensor; the plain versions sit beside them. As in the JAX
package, the pattern and the flow are data: they get no gradient.
"""

from __future__ import annotations

import torch

from . import kernels
from .sampling import warp


def _xwarp_taps(pattern: torch.Tensor, disp: torch.Tensor):
    """The forward's taps, as losses/photometric.py::_xwarp_fwd_impl: the
    two corner values, the fraction and the strict inside mask."""
    N, H, W = disp.shape
    pattern = pattern.expand(N, H, W)
    u = torch.arange(W, dtype=disp.dtype, device=disp.device)[None, None, :]
    x = u - disp
    xc = torch.clamp(x, 0.0, W - 1.0)
    x0 = torch.floor(xc)
    f = xc - x0
    i0 = x0.long()
    i1 = torch.clamp(i0 + 1, max=W - 1)
    v0 = torch.gather(pattern, 2, i0)
    v1 = torch.gather(pattern, 2, i1)
    inside = ((x > 0.0) & (x < W - 1.0)).to(disp.dtype)
    return v0, v1, f, inside


def xwarp_plain(pattern: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Plain version of K2, after losses/photometric.py::_xwarp_fwd_impl:
    pattern (H, W) or (N, H, W) sampled along each row at
    clamp(u - disp, 0, W-1), linear. Returns (N, H, W)."""
    v0, v1, f, _ = _xwarp_taps(pattern, disp)
    return v0 * (1.0 - f) + v1 * f


def xwarp_bwd_plain(pattern: torch.Tensor, disp: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
    """Plain version of K2 bwd, written out as losses/photometric.py::
    _xwarp_bwd computes it (not autograd of xwarp_plain, whose clamp would
    pass the gradient where x is exactly 0 or W-1):
    grad_disp = -(v1 - v0) * inside * g."""
    v0, v1, _, inside = _xwarp_taps(pattern, disp)
    return -(v1 - v0) * inside * g


def warp2d_plain(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: ops/sampling.py::warp with zeros padding, a
    four-corner gather with per-corner validity. img (M, H, W, C), flow
    (M, H, W, 2)."""
    return warp(img, flow, padding="zeros")


def warp2d_bwd_plain(flow: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of K3 bwd: autograd of warp2d_plain with respect to the
    image, a scatter-add like the JAX autodiff of ops/sampling.py::warp (the
    warp is linear in the image, so the image's values do not matter)."""
    img = torch.zeros_like(g, requires_grad=True)
    with torch.enable_grad():
        out = warp2d_plain(img, flow.detach())
    return torch.autograd.grad(out, img, g)[0]


class XWarp(torch.autograd.Function):
    """K2 and K2 bwd; the gradient goes to disp only."""

    @staticmethod
    def forward(ctx, pattern, disp):
        ctx.save_for_backward(pattern, disp)
        if disp.device.type == "cpu":
            return xwarp_plain(pattern, disp)
        return kernels.xwarp_fwd(pattern.contiguous(), disp.contiguous())

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[1]:
            return None, None
        pattern, disp = ctx.saved_tensors
        if disp.device.type == "cpu":
            return None, xwarp_bwd_plain(pattern, disp, g)
        return None, kernels.xwarp_bwd(pattern.contiguous(),
                                       disp.contiguous(), g.contiguous())


class Warp2D(torch.autograd.Function):
    """K3 and K3 bwd; the gradient goes to the image only."""

    @staticmethod
    def forward(ctx, img, flow):
        ctx.save_for_backward(flow)
        if img.device.type == "cpu":
            return warp2d_plain(img, flow)
        return kernels.warp2d_fwd(img.contiguous(), flow.contiguous())

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        (flow,) = ctx.saved_tensors
        if flow.device.type == "cpu":
            return warp2d_bwd_plain(flow, g), None
        return kernels.warp2d_bwd(flow.contiguous(), g.contiguous()), None


def warp_pattern(pattern: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Rectified pattern warp: sample the pattern at u' = u - disp with
    border clamp. pattern (H, W) or (N, H, W); disp (N, H, W)."""
    return XWarp.apply(pattern.detach(), disp)


def flow_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Flow warp with zeros padding, out(p) = x(p + flow(p)). x (N, H, W, C),
    flow (N, H, W, 2), both float32."""
    return Warp2D.apply(x, flow.detach())
