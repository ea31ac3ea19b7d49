"""Image resampling: the pattern warp by disparity (K2), the flow warp (K3),
the pair-indexed flow warp of FuseNet (K4) and the flow warp's other TPU
entry point (K5, ``warp_kernel.warp2d``). Port of
``depthinspace_tpu/ops/resample.py``.

Each public function is a ``torch.autograd.Function`` that runs its CUDA
kernels (forward and backward) on a CUDA tensor and their plain PyTorch
versions on a CPU tensor; the plain versions sit beside them. As in the JAX
package, the pattern, the flow and the pair table are data: they get no
gradient. The JAX package's ``DIS_*`` switches between TPU kernel variants
are not ported: each entry point has one kernel.
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


def warp2d_pairs_plain(feat: torch.Tensor, flow: torch.Tensor,
                       src_idx) -> torch.Tensor:
    """Plain version of K4: out[m] = warp(feat[src_idx[m]], flow[m]), the
    sources gathered with index_select and warped in float32 (or wider),
    cast to feat's dtype. feat (S, H, W, C); flow (M, H, W, 2)."""
    acc = torch.promote_types(feat.dtype, torch.float32)
    src = torch.as_tensor(tuple(src_idx), dtype=torch.long,
                          device=feat.device)
    out = warp2d_plain(feat.index_select(0, src).to(acc), flow.to(acc))
    return out.to(feat.dtype)


def warp2d_pairs_bwd_plain(flow: torch.Tensor, src_idx, g: torch.Tensor,
                           S: int) -> torch.Tensor:
    """Plain version of K4 bwd: each pair's adjoint (warp2d_bwd_plain) in
    float32 (or wider), summed into its source plane with index_add_, cast
    to g's dtype. Returns (S, H, W, C)."""
    acc = torch.promote_types(g.dtype, torch.float32)
    src = torch.as_tensor(tuple(src_idx), dtype=torch.long, device=g.device)
    per_pair = warp2d_bwd_plain(flow.to(acc), g.to(acc))
    grad = torch.zeros((S, *g.shape[1:]), dtype=acc, device=g.device)
    return grad.index_add_(0, src, per_pair).to(g.dtype)


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


class Warp2DV1(torch.autograd.Function):
    """K5 and K5 bwd on K3's kernels under their own launch counters; the
    gradient goes to the image only."""

    @staticmethod
    def forward(ctx, img, flow):
        ctx.save_for_backward(flow)
        if img.device.type == "cpu":
            return warp2d_plain(img, flow)
        return kernels.warp2d_v1_fwd(img.contiguous(), flow.contiguous())

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        (flow,) = ctx.saved_tensors
        if flow.device.type == "cpu":
            return warp2d_bwd_plain(flow, g), None
        return kernels.warp2d_v1_bwd(flow.contiguous(), g.contiguous()), None


class Warp2DPairs(torch.autograd.Function):
    """K4 and K4 bwd; the gradient goes to feat only (the flow and the pair
    table get None)."""

    @staticmethod
    def forward(ctx, feat, flow, src_idx):
        ctx.save_for_backward(flow)
        ctx.src_idx, ctx.n_src = src_idx, feat.shape[0]
        if feat.device.type == "cpu":
            return warp2d_pairs_plain(feat, flow, src_idx)
        return kernels.warp2d_pairs_fwd(feat.contiguous(), flow.contiguous(),
                                        src_idx)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (flow,) = ctx.saved_tensors
        if flow.device.type == "cpu":
            grad = warp2d_pairs_bwd_plain(flow, ctx.src_idx, g, ctx.n_src)
        else:
            grad = kernels.warp2d_pairs_bwd(flow.contiguous(), ctx.src_idx,
                                            g.contiguous(), ctx.n_src)
        return grad, None, None


def warp_pattern(pattern: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Rectified pattern warp: sample the pattern at u' = u - disp with
    border clamp. pattern (H, W) or (N, H, W); disp (N, H, W)."""
    return XWarp.apply(pattern.detach(), disp)


def flow_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Flow warp with zeros padding, out(p) = x(p + flow(p)). x (N, H, W, C),
    flow (N, H, W, 2), both float32."""
    return Warp2D.apply(x, flow.detach())


def flow_warp_pairs(feat: torch.Tensor, flow: torch.Tensor,
                    src_idx) -> torch.Tensor:
    """Pair-indexed flow warp with zeros padding, out[m] = warp(feat[
    src_idx[m]], flow[m]): feat (S, H, W, C) float32 or bfloat16, flow
    (M, H, W, 2) float32, src_idx a static sequence of M ints in [0, S).
    Returns (M, H, W, C) in feat's dtype; the pair-major stack of sources is
    never built on the card."""
    return Warp2DPairs.apply(feat, flow.detach(),
                             tuple(int(s) for s in src_idx))


def warp2d_v1(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The entry point of ``ops/pallas/warp_kernel.py::warp2d`` (K5): the
    flow warp of :func:`flow_warp`, float32, unbounded like the CPU truth
    (the TPU kernel drops integer offsets beyond +-max_shift)."""
    return Warp2DV1.apply(img, flow.detach())
