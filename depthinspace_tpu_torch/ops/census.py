"""Census-SAD photometric dissimilarity (port of
``depthinspace_tpu/ops/census.py::census_sad``).

  d_es(p, o) = es(p + o) - es(p)  over the BxB window (replicate padding)
  h(d)       = 0.5 * (1 + d / sqrt(d^2 + eps))
  out(p)     = sum_o |h(d_es(p,o)) - h(d_ta(p,o))| / B^2

The gradient goes to ``es`` only (``ta``, the IR image, gets none), as in
the JAX custom VJP. ``census_sad`` runs kernels K1 and K1 bwd
(``csrc/census_sad.cu``) on a CUDA tensor and ``census_sad_plain`` and
``census_sad_bwd_plain`` on a CPU tensor.

``photometric_dissimilarity`` is the JAX package's dispatch over the
reference op's four types: census_sad (the function above, K1 on the card)
and mse, sad and census_mse, plain tensor code off the training path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernels


def _soft_heaviside(d: torch.Tensor, eps: float) -> torch.Tensor:
    return 0.5 * (1.0 + d * torch.rsqrt(d * d + eps))


def _pad_edge(x: torch.Tensor, p: int) -> torch.Tensor:
    return F.pad(x[:, None], (p, p, p, p), mode="replicate")[:, 0]


def census_sad_plain(es: torch.Tensor, ta: torch.Tensor,
                     block_size: int = 9, eps: float = 0.5) -> torch.Tensor:
    """Plain PyTorch version: B^2 shifted slices of the edge-padded inputs,
    accumulated one at a time (O(1) extra memory), as ops/census.py scans
    them. es, ta: (N, H, W)."""
    N, H, W = es.shape
    p = block_size // 2
    es_pad, ta_pad = _pad_edge(es, p), _pad_edge(ta, p)
    acc = torch.zeros_like(es)
    for dy in range(block_size):
        for dx in range(block_size):
            h_es = _soft_heaviside(es_pad[:, dy:dy + H, dx:dx + W] - es, eps)
            h_ta = _soft_heaviside(ta_pad[:, dy:dy + H, dx:dx + W] - ta, eps)
            acc = acc + torch.abs(h_es - h_ta)
    return acc / block_size ** 2


def _unpad_edge_adjoint(g_pad: torch.Tensor, p: int) -> torch.Tensor:
    """Adjoint of replicate padding: fold the margins onto the border."""
    core = g_pad[:, p:-p, :].clone()
    core[:, 0, :] += g_pad[:, :p, :].sum(dim=1)
    core[:, -1, :] += g_pad[:, -p:, :].sum(dim=1)
    out = core[:, :, p:-p].clone()
    out[:, :, 0] += core[:, :, :p].sum(dim=2)
    out[:, :, -1] += core[:, :, -p:].sum(dim=2)
    return out


def census_sad_bwd_plain(es: torch.Tensor, ta: torch.Tensor, g: torch.Tensor,
                         block_size: int = 9,
                         eps: float = 0.5) -> torch.Tensor:
    """Plain version of K1 bwd, the O(1)-memory scan of
    ops/census.py::_census_bwd: the gradient of <g, census_sad(es, ta)>
    with respect to es. es, ta, g: (N, H, W)."""
    N, H, W = es.shape
    p = block_size // 2
    es_pad, ta_pad = _pad_edge(es, p), _pad_edge(ta, p)
    inv_b2 = 1.0 / block_size ** 2
    grad_pad = torch.zeros_like(es_pad)
    center = torch.zeros_like(es)
    for dy in range(block_size):
        for dx in range(block_size):
            d_es = es_pad[:, dy:dy + H, dx:dx + W] - es
            h_es = _soft_heaviside(d_es, eps)
            h_ta = _soft_heaviside(ta_pad[:, dy:dy + H, dx:dx + W] - ta, eps)
            q = d_es * d_es + eps
            dh = 0.5 * eps * torch.rsqrt(q) / q
            delta = torch.sign(h_es - h_ta) * dh * g * inv_b2
            grad_pad[:, dy:dy + H, dx:dx + W] += delta
            center = center + delta
    return _unpad_edge_adjoint(grad_pad, p) - center


class CensusSAD(torch.autograd.Function):
    """K1 and K1 bwd on CUDA tensors, their plain versions on CPU tensors.
    Saves only the inputs; the backward recomputes, as the JAX VJP does."""

    @staticmethod
    def forward(ctx, es, ta, block_size: int, eps: float):
        ctx.save_for_backward(es, ta)
        ctx.block_size, ctx.eps = block_size, eps
        if es.device.type == "cpu":
            return census_sad_plain(es, ta, block_size, eps)
        return kernels.census_sad_fwd(es.contiguous(), ta.contiguous(),
                                      block_size, eps)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        es, ta = ctx.saved_tensors
        if es.device.type == "cpu":
            grad = census_sad_bwd_plain(es, ta, g, ctx.block_size, ctx.eps)
        else:
            grad = kernels.census_sad_bwd(es.contiguous(), ta.contiguous(),
                                          g.contiguous(), ctx.block_size,
                                          ctx.eps)
        return grad, None, None, None


def census_sad(es: torch.Tensor, ta: torch.Tensor, block_size: int = 9,
               eps: float = 0.5) -> torch.Tensor:
    """K1 on a CUDA tensor, the plain version on a CPU tensor; differentiable
    with respect to es."""
    return CensusSAD.apply(es, ta, block_size, eps)


def photometric_dissimilarity(es: torch.Tensor, ta: torch.Tensor,
                              block_size: int = 9,
                              loss_type: str = "census_sad",
                              eps: float = 0.5) -> torch.Tensor:
    """The per-pixel dissimilarity of es and ta (N, H, W) over the BxB
    window (replicate padding): census_sad; mse or sad, the mean squared or
    absolute difference of the shifted images; census_mse, the mean squared
    difference of their soft census transforms."""
    loss_type = loss_type.lower()
    if loss_type == "census_sad":
        return census_sad(es, ta, block_size, eps)
    if loss_type not in ("mse", "sad", "census_mse"):
        raise ValueError(f"invalid loss type {loss_type!r}")
    N, H, W = es.shape
    p = block_size // 2
    es_pad, ta_pad = _pad_edge(es, p), _pad_edge(ta, p)
    acc = torch.zeros_like(es)
    for dy in range(block_size):
        for dx in range(block_size):
            es_o = es_pad[:, dy:dy + H, dx:dx + W]
            ta_o = ta_pad[:, dy:dy + H, dx:dx + W]
            if loss_type == "census_mse":
                d = (_soft_heaviside(es_o - es, eps)
                     - _soft_heaviside(ta_o - ta, eps))
            else:
                d = es_o - ta_o
            acc = acc + (torch.abs(d) if loss_type == "sad" else d * d)
    return acc / block_size ** 2
