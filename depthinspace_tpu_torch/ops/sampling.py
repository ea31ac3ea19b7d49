"""Bilinear sampling, warping and resizing (port of
``depthinspace_tpu/ops/sampling.py``).

Pixel coordinates throughout (``grid_sample`` with align_corners=True up to
the affine normalization), NHWC layout at the public functions.
"""

from __future__ import annotations

import numpy as np
import torch


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    padding: str = "border") -> torch.Tensor:
    """Sample ``img`` (N, H, W, C) at pixel coordinates x, y (N, Ho, Wo).

    padding 'border' clamps the coordinates; 'zeros' drops each of the four
    corners whose integer index lies outside the image (torch grid_sample
    semantics). Returns (N, Ho, Wo, C)."""
    N, H, W, C = img.shape
    if padding == "border":
        x = torch.clamp(x, 0.0, W - 1.0)
        y = torch.clamp(y, 0.0, H - 1.0)
    elif padding != "zeros":
        raise ValueError(f"unknown padding mode {padding!r}")

    x0f = torch.floor(x)
    y0f = torch.floor(y)
    x0 = x0f.long()
    y0 = y0f.long()
    x1 = x0 + 1
    y1 = y0 + 1
    wx1 = x - x0f
    wy1 = y - y0f
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1

    img_flat = img.reshape(N, H * W, C)

    def corner(yi, xi):
        flat = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(N, -1, 1)
        v = torch.gather(img_flat, 1, flat.expand(-1, -1, C))
        v = v.reshape(*yi.shape, C)
        if padding == "zeros":
            valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            v = v * valid[..., None].to(img.dtype)
        return v

    v00 = corner(y0, x0)
    v01 = corner(y0, x1)
    v10 = corner(y1, x0)
    v11 = corner(y1, x1)
    return (v00 * (wy0 * wx0)[..., None] + v01 * (wy0 * wx1)[..., None]
            + v10 * (wy1 * wx0)[..., None] + v11 * (wy1 * wx1)[..., None])


def pad_edge(x: torch.Tensor, p: int) -> torch.Tensor:
    """Replicate (edge) padding of the last two dims of x by p: F.pad's
    ``mode="replicate"`` values exactly, built from the border rows and
    columns expanded and concatenated. Its backward slices and sums the
    repeated borders (a reduction, deterministic on the card), where
    F.pad's replicate backward adds with float atomics there and raises
    under torch's deterministic mode."""
    if p == 0:
        return x
    lead, (H, W) = x.shape[:-2], x.shape[-2:]
    x = torch.cat([x[..., :1, :].expand(*lead, p, W), x,
                   x[..., -1:, :].expand(*lead, p, W)], dim=-2)
    return torch.cat([x[..., :1].expand(*lead, H + 2 * p, p), x,
                      x[..., -1:].expand(*lead, H + 2 * p, p)], dim=-1)


def warp(x: torch.Tensor, flow: torch.Tensor,
         padding: str = "zeros") -> torch.Tensor:
    """out(p) = x(p + flow(p)); x (N, H, W, C), flow (N, H, W, 2) = (u, v)."""
    N, H, W, _ = x.shape
    u = torch.arange(W, dtype=flow.dtype, device=flow.device)[None, None, :]
    v = torch.arange(H, dtype=flow.dtype, device=flow.device)[None, :, None]
    return bilinear_sample(x, flow[..., 0] + u, flow[..., 1] + v,
                           padding=padding)


_resize_taps: dict = {}


def _taps(n_in: int, n_out: int, align_corners: bool, device):
    """The two taps (i0, i1) and weights (1 - f, f) of each output row of a
    1-D bilinear resize, as ``_interp_matrix`` of the JAX package builds
    its rows (float64 positions, float32 fractions), and that dense
    (n_out, n_in) float32 matrix itself, on ``device``."""
    key = (n_in, n_out, align_corners, torch.device(device))
    taps = _resize_taps.get(key)
    if taps is None:
        if align_corners and n_out > 1:
            src = np.linspace(0, n_in - 1, n_out)
        else:
            src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        src = np.clip(src, 0, n_in - 1)
        i0 = np.floor(src).astype(np.int64)
        i1 = np.minimum(i0 + 1, n_in - 1)
        f = (src - i0).astype(np.float32)
        w0 = (1 - f).astype(np.float32)
        matrix = np.zeros((n_out, n_in), np.float32)
        np.add.at(matrix, (np.arange(n_out), i0), w0)
        np.add.at(matrix, (np.arange(n_out), i1), f)
        # normal tensors even when first made under inference_mode: the
        # indices are saved for the backward of a later training step
        with torch.inference_mode(False):
            as_t = lambda a: torch.from_numpy(a).to(device)
            taps = (as_t(i0), as_t(i1), as_t(w0), as_t(f), as_t(matrix))
        _resize_taps[key] = taps
    return taps


class _ResizeAxis(torch.autograd.Function):
    """One axis (``dim``) of the two-tap resize, float32: out = x[i0] * (1 -
    f) + x[i1] * f along it. The backward is the JAX resize's: the dense
    interpolation matrix's transpose times g, a matrix product, whose sums
    run in a fixed order on the card (the indexing's backward sorts its
    indices under torch's deterministic mode: 12.2 ms of a DIS-SF train
    step on an H100, chip_smoke.py phase 7's profile)."""

    @staticmethod
    def forward(ctx, x, dim: int, taps):
        i0, i1, w0, w1, matrix = taps
        ctx.dim, ctx.matrix = dim, matrix
        shape = [1] * x.dim()
        shape[dim] = -1
        return (x.index_select(dim, i0) * w0.view(shape)
                + x.index_select(dim, i1) * w1.view(shape))

    @staticmethod
    def backward(ctx, g):
        gx = torch.matmul(g.movedim(ctx.dim, -1), ctx.matrix)
        return gx.movedim(-1, ctx.dim), None, None


def resize_bilinear(x: torch.Tensor, height: int, width: int,
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of an NHWC tensor, no anti-aliasing: rows first,
    then columns, each output the two-tap sum a * (1 - f) + b * f in
    float32, returned in x's dtype. These are the JAX version's
    interpolation-matrix products with their zero terms dropped, and the
    same float32 roundings on every device; the gradient is that matrix
    product's, as in JAX."""
    N, H, W, C = x.shape
    if H == height and W == width:
        return x
    y = _ResizeAxis.apply(x.float(), 1,
                          _taps(H, height, align_corners, x.device))
    out = _ResizeAxis.apply(y, 2, _taps(W, width, align_corners, x.device))
    return out.to(x.dtype)


def resize_mask(mask: torch.Tensor, height: int,
                width: int) -> torch.Tensor:
    """Resize a binary mask (N, h, w, C) bilinearly (align_corners) and
    threshold it at 0.5 again, in the mask's dtype."""
    out = resize_bilinear(mask, height, width, align_corners=True)
    return (out > 0.5).to(mask.dtype)


def resize_flow(flow: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Resize a flow field (N, h, w, 2) and rescale its values by the size
    ratio (u by width / w, v by height / h)."""
    _, fh, fw, _ = flow.shape
    out = resize_bilinear(flow, height, width, align_corners=True)
    scale = torch.tensor([width / fw, height / fh], dtype=out.dtype,
                         device=out.device)
    return out * scale
