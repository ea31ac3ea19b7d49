"""The ops the port put in place of those whose CUDA backward adds with float
atomics (and raises under torch's deterministic mode, which every entry
point that takes the card turns on): each equals what it replaces on the
CPU, its value and its gradient. DispNet and the smoothness loss stay held
to the JAX package by tests/test_torch_dispnet.py and
tests/test_torch_losses.py."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from depthinspace_tpu_torch.models.dispnet import _resize_nchw, _up2
from depthinspace_tpu_torch.ops.census import census_sad_plain
from depthinspace_tpu_torch.ops.sampling import pad_edge
from depthinspace_tpu_torch.ops.sobel import sobel


def _value_and_grad(fn, x, g):
    x = x.detach().clone().requires_grad_()
    out = fn(x)
    out.backward(g)
    return out.detach(), x.grad


def _inputs(shape, out_shape, seed):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(*shape).astype(np.float32)),
            torch.from_numpy(rng.randn(*out_shape).astype(np.float32)))


@pytest.mark.parametrize("shape", [(2, 9, 7), (1, 1, 1), (3, 2, 5),
                                   (2, 3, 4, 6)])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_pad_edge_equals_replicate_padding(shape, p):
    """The values bit for bit; the gradient (the border's repeated cells
    summed) within float32 rounding of a sum of up to (p + 1)^2 terms."""
    lead, (H, W) = shape[:-2], shape[-2:]
    x, g = _inputs(shape, (*lead, H + 2 * p, W + 2 * p), p)

    def replicate(t):
        flat = t.reshape(-1, 1, H, W)
        return F.pad(flat, (p, p, p, p), mode="replicate").reshape(
            *lead, H + 2 * p, W + 2 * p)

    out, grad = _value_and_grad(lambda t: pad_edge(t, p), x, g)
    ref, ref_grad = _value_and_grad(replicate, x, g)
    assert torch.equal(out, ref)
    torch.testing.assert_close(grad, ref_grad, rtol=1e-6, atol=1e-6)


def test_pad_edge_of_zero_is_the_input():
    x = torch.ones(2, 3, 4)
    assert pad_edge(x, 0) is x


@pytest.mark.parametrize("shape", [(2, 1, 8, 7), (1, 3, 5, 9), (2, 1, 1, 2)])
def test_dispnet_upsample_equals_bilinear_interpolate(shape):
    """DispNet's x2 upsample (the JAX model's two-tap resize) against
    F.interpolate(mode="bilinear", align_corners=False), which it replaces:
    the same taps and weights (0.25, 0.75), summed rows first."""
    N, C, h, w = shape
    x, g = _inputs(shape, (N, C, 2 * h, 2 * w), 1)
    ref_shape = torch.empty(N, C, 2 * h, 2 * w)
    out, grad = _value_and_grad(lambda t: _up2(t, ref_shape), x, g)
    ref, ref_grad = _value_and_grad(
        lambda t: F.interpolate(t, size=(2 * h, 2 * w), mode="bilinear",
                                align_corners=False), x, g)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(grad, ref_grad, rtol=1e-6, atol=1e-6)
    # NCHW strides, as F.interpolate's: a (N, 1, H, W) view of NHWC data
    # also reads as channels-last, which slowed the convolution after it
    # on the card
    assert out.stride() == ref.stride()


@pytest.mark.parametrize("src,dst", [((8, 7), (64, 56)), ((16, 14), (64, 56)),
                                     ((32, 27), (64, 54)), ((5, 3), (7, 11))])
def test_dispnet_full_resolution_resize_equals_interpolate(src, dst):
    """The resize of each coarser prediction to full resolution (DispNet's
    ``full``), against F.interpolate at the same sizes."""
    x, g = _inputs((2, 1, *src), (2, 1, *dst), 2)
    out, grad = _value_and_grad(lambda t: _resize_nchw(t, *dst), x, g)
    ref, ref_grad = _value_and_grad(
        lambda t: F.interpolate(t, size=dst, mode="bilinear",
                                align_corners=False), x, g)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(grad, ref_grad, rtol=1e-6, atol=1e-5)


def test_sobel_gradient_equals_replicate_padded_sobel():
    """The smoothness loss differentiates the disparity's Sobel: its value
    bit for bit and its gradient as with F.pad's replicate padding."""
    from depthinspace_tpu_torch.ops.sobel import _KX5, _filter

    def sobel_fpad(t):
        N, H, W, _ = t.shape
        xp = F.pad(t[..., 0][:, None], (2, 2, 2, 2), mode="replicate")[:, 0]
        return torch.stack([_filter(xp, _KX5, H, W),
                            _filter(xp, _KX5.T, H, W)], dim=-1)

    x, g = _inputs((2, 11, 9, 1), (2, 11, 9, 2), 3)
    out, grad = _value_and_grad(sobel, x, g)
    ref, ref_grad = _value_and_grad(sobel_fpad, x, g)
    assert torch.equal(out, ref)
    torch.testing.assert_close(grad, ref_grad, rtol=1e-6, atol=1e-6)


def test_census_plain_is_unchanged_by_the_edge_pad():
    """census_sad_plain pads with pad_edge: the same values as with F.pad's
    replicate padding (the padding only copies)."""
    rng = np.random.RandomState(4)
    es = torch.from_numpy(rng.rand(2, 13, 11).astype(np.float32))
    ta = torch.from_numpy(rng.rand(2, 13, 11).astype(np.float32))
    p = 4
    pad = lambda t: F.pad(t[:, None], (p, p, p, p), mode="replicate")[:, 0]
    assert torch.equal(pad_edge(es, p), pad(es))
    out = census_sad_plain(es, ta)
    assert out.shape == es.shape and bool(torch.isfinite(out).all())
