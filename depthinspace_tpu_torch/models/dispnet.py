"""DIS-SF single-frame disparity network, port of
``depthinspace_tpu/models/dispnet.py`` (DispNetS-style U-Net).

- 7 stride-2 encoder stages (stride-2 conv + ReLU + conv + ReLU), planes
  32..512 (x channel_multiplier), first kernels 7 and 5;
- 7 transposed-conv decoder stages with skip-concat 3x3 "iconv" convs;
- 4 heads at 1/8..1/1 scale: 3x3 conv, then sigmoid(x - 3) * max_disp / 2^s;
- each coarser prediction is upsampled bilinearly (align_corners=False,
  the JAX model's two-tap ``resize_bilinear``) into the next decoder
  stage; all four outputs return at full resolution.

The public layout is the JAX one: input (N, H, W, 2) = [LCN(IR), IR],
outputs 4 x (N, H, W, 1), finest first. Inside, the network runs NCHW.

Flax's "SAME" padding is reproduced exactly: a stride-1 conv pads k//2 on
both sides, and a stride-2 conv pads pad_total = max((ceil(n/2) - 1) * 2 +
k - n, 0) split as (pad_total // 2, rest), which depends on the parity of
the input size n (odd sizes pad evenly). A flax stride-2 "SAME"
ConvTranspose(3) is torch's conv_transpose2d with the kernel flipped
spatially, no padding, cropped to 2n (on the card under deterministic
cuDNN algorithms, as a 2x2 convolution and a pixel shuffle:
``SameConvTranspose2d``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.sampling import resize_bilinear


def _same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """nn.Conv2d with flax's "SAME" padding, computed per call."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, padding=0)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = _same_pads(x.shape[2], k, s)
        left, right = _same_pads(x.shape[3], k, s)
        return super().forward(F.pad(x, (left, right, top, bottom)))


# kernel row (column) of output parity a and input offset u: output row
# 2i + a sums input rows i - 1 (u = 0) and i (u = 1), with kernel rows 2 and
# 0 for a = 0, and none (the zero row 3) and 1 for a = 1
_PARITY_TAPS = torch.tensor([[2, 0], [3, 1]])


class SameConvTranspose2d(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose(3, strides=2, padding="SAME")``. The weight is
    stored already flipped (torch's convention); output is (2h, 2w).

    torch's conv_transpose2d cropped to (2h, 2w). On a CUDA tensor with
    cuDNN's deterministic algorithms on (the deterministic mode,
    ``device.set_deterministic``) the same function runs as a 2x2
    convolution of the input padded by one row and column at the top and
    left, into 4x the channels (channel c of output parity (a, b) at
    4c + 2a + b), then a pixel shuffle: cuDNN computes a transposed
    convolution with a backward-data kernel whose deterministic algorithm
    is slow (at the last decoder stage it took most of a server's
    forward), and a convolution's deterministic algorithms are its fast
    ones. Since every entry point that takes the card turns them on
    (``device.set_deterministic``), training runs this form too; the CPU
    keeps conv_transpose2d."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        if k != 3:
            raise ValueError("SameConvTranspose2d takes 3x3 kernels")
        super().__init__(cin, cout, k, stride=2, padding=0)

    def forward(self, x):
        if x.is_cuda and torch.backends.cudnn.deterministic:
            return self.as_convolution(x)
        h, w = x.shape[2], x.shape[3]
        return super().forward(x)[:, :, :2 * h, :2 * w]

    def as_convolution(self, x):
        """The forward as a 2x2 convolution and a pixel shuffle."""
        cin, cout = self.weight.shape[:2]
        taps = _PARITY_TAPS.to(x.device)
        # (cin, cout, a, b, u, v) -> (cout * 4, cin, u, v)
        w = F.pad(self.weight, (0, 1, 0, 1))[
            :, :, taps[:, None, :, None], taps[None, :, None, :]]
        w = w.permute(1, 2, 3, 0, 4, 5).reshape(cout * 4, cin, 2, 2)
        y = F.conv2d(F.pad(x, (1, 0, 1, 0)), w,
                     self.bias.repeat_interleave(4))
        return F.pixel_shuffle(y, 2)


class SigmoidAffineHead(nn.Module):
    """3x3 conv -> sigmoid(x / gamma - offset) * alpha + beta."""

    def __init__(self, cin: int, alpha: float, beta: float = 0.0,
                 gamma: float = 1.0, offset: float = 3.0):
        super().__init__()
        self.conv = SameConv2d(cin, 1, 3)
        self.alpha, self.beta = alpha, beta
        self.gamma, self.offset = gamma, offset

    def forward(self, x):
        x = self.conv(x)
        return torch.sigmoid(x / self.gamma - self.offset) * self.alpha \
            + self.beta


class _Down(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3):
        super().__init__()
        self.conv0 = SameConv2d(cin, features, kernel, stride=2)
        self.conv1 = SameConv2d(features, features, kernel)

    def forward(self, x):
        return F.relu(self.conv1(F.relu(self.conv0(x))))


class _Up(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv = SameConvTranspose2d(cin, features, 3)

    def forward(self, x):
        return F.relu(self.conv(x))


def _crop_like(x, ref):
    return x[:, :, :ref.shape[2], :ref.shape[3]]


def _resize_nchw(x, height: int, width: int):
    """The JAX DispNet's bilinear resize (align_corners=False) of an NCHW
    tensor: ``ops.sampling.resize_bilinear``, two taps a row and a column,
    whose backward (the JAX resize's matrix product) is deterministic on the
    card; F.interpolate's bilinear backward adds with float atomics there
    and raises under torch's deterministic mode."""
    out = resize_bilinear(x.permute(0, 2, 3, 1), height, width,
                          align_corners=False)
    # NCHW strides: a (N, 1, H, W) view of NHWC data has strides that also
    # read as channels-last, and the convolutions after the concatenation
    # then run on slower cuDNN kernels
    return out.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)


def _up2(x, ref):
    """Bilinear x2 upsample (align_corners=False), cropped to ref's HW."""
    h, w = x.shape[2], x.shape[3]
    return _crop_like(_resize_nchw(x, 2 * h, 2 * w), ref)


class DispNet(nn.Module):
    """Single-frame disparity network. forward((N, H, W, 2)) -> tuple of 4
    disparity maps (N, H, W, 1) at full resolution, finest first."""

    def __init__(self, max_disp: float = 128.0, channel_multiplier: int = 1):
        super().__init__()
        cm = channel_multiplier
        cp = [cm * c for c in (32, 64, 128, 256, 512, 512, 512)]
        up = [cm * c for c in (512, 512, 256, 128, 64, 32, 16)]
        self.max_disp = max_disp
        kernels = (7, 5, 3, 3, 3, 3, 3)
        cins = [2] + cp[:-1]
        self.downs = nn.ModuleList(
            _Down(ci, co, k) for ci, co, k in zip(cins, cp, kernels))
        up_in = [cp[6]] + up[:-1]
        self.ups = nn.ModuleList(_Up(ci, co) for ci, co in zip(up_in, up))
        # iconv inputs: upsampled features + skip (+ upsampled disparity)
        icv_in = [up[0] + cp[5], up[1] + cp[4], up[2] + cp[3], up[3] + cp[2],
                  up[4] + cp[1] + 1, up[5] + cp[0] + 1, up[6] + 1]
        self.iconvs = nn.ModuleList(
            SameConv2d(ci, co, 3) for ci, co in zip(icv_in, up))
        self.heads = nn.ModuleList(
            SigmoidAffineHead(c, max_disp / s)
            for c, s in zip((up[3], up[4], up[5], up[6]), (8, 4, 2, 1)))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        feats = []
        h = x
        for down in self.downs:
            h = down(h)
            feats.append(h)
        c1, c2, c3, c4, c5, c6, c7 = feats

        def iconv(i, *fs):
            return F.relu(self.iconvs[i](torch.cat(fs, dim=1)))

        i7 = iconv(0, _crop_like(self.ups[0](c7), c6), c6)
        i6 = iconv(1, _crop_like(self.ups[1](i7), c5), c5)
        i5 = iconv(2, _crop_like(self.ups[2](i6), c4), c4)
        i4 = iconv(3, _crop_like(self.ups[3](i5), c3), c3)
        disp4 = self.heads[0](i4)

        i3 = iconv(4, _crop_like(self.ups[4](i4), c2), c2, _up2(disp4, c2))
        disp3 = self.heads[1](i3)

        i2 = iconv(5, _crop_like(self.ups[5](i3), c1), c1, _up2(disp3, c1))
        disp2 = self.heads[2](i2)

        i1 = iconv(6, _crop_like(self.ups[6](i2), x), _up2(disp2, x))
        disp1 = self.heads[3](i1)

        H, W = disp1.shape[2], disp1.shape[3]

        def full(d):
            return resize_bilinear(d.permute(0, 2, 3, 1), H, W,
                                   align_corners=False)

        return (full(disp1), full(disp2), full(disp3), full(disp4))


def init_dispnet_(model: DispNet, key) -> DispNet:
    """The weights ``DispNet().init(jax.random.key(seed), x)`` gives for
    ``key = utils.jrandom.key(seed)``: flax's lecun-normal kernels (a
    normal truncated at 2 std, rescaled to variance 1/fan_in) and zero
    biases, each leaf from its flax key (``models/init.py``); drawn on the
    model's device."""
    from .convert import dispnet_state_dict_from_flax
    from .init import dispnet_template, load_flax_init_
    return load_flax_init_(model, dispnet_template(model), key,
                           dispnet_state_dict_from_flax)
