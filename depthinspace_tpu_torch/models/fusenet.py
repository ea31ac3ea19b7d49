"""DIS-MF multi-frame fusion network, port of
``depthinspace_tpu/models/fusenet.py`` (the frame-major branch; the
frame-packed ``models/packed.py`` form is a TPU matrix-unit workaround with
the same parameter tree and is not ported).

FuseNet fuses the frames of a track: it encodes each frame at half
resolution ("core"), unprojects the primary depth to per-frame point
clouds, warps the other frames' points and features into each target view
along the given optical flow, runs fusion blocks that mix 2D convolutions
with a k-nearest-neighbour convolution over the warped points, and decodes
a refined full-resolution disparity.

The public layout is the JAX one (track-major NHWC) and so is the
computation: convolutions run on NHWC tensors viewed as channels-last NCHW.
Submodules carry the names of the flax tree (``block0.conv3d_1.Dense_0``
is ``block0/conv3d_1/Dense_0``), so ``models/convert.py`` maps the weights
by name. ``compute_dtype`` is flax's ``dtype``: parameters stay float32 and
are cast to it at use; GroupNorm takes its statistics and applies its scale
in float32 and returns the compute dtype; the bilinear resizes compute in
float32; the neighbour selection, the geometry and the head run in float32.
The feature warps of the fusion blocks (K4) see the compute dtype, the
geometry warp (K3) float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.resample import flow_warp, flow_warp_pairs
from ..ops.sampling import resize_bilinear, resize_flow
from .dispnet import SigmoidAffineHead, _same_pads


class Conv(nn.Module):
    """flax ``nn.Conv(cout, (k, k), strides, padding="SAME")`` on an NHWC
    tensor, in the input's dtype (weights cast to it)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.k, self.stride = k, stride

    def forward(self, x):
        dt = x.dtype
        xc = x.permute(0, 3, 1, 2)
        top, bottom = _same_pads(xc.shape[2], self.k, self.stride)
        left, right = _same_pads(xc.shape[3], self.k, self.stride)
        if (top, left) == (bottom, right):
            pad = (top, left)
        else:
            xc, pad = F.pad(xc, (left, right, top, bottom)), 0
        y = F.conv2d(xc, self.weight.to(dt), self.bias.to(dt), self.stride,
                     pad)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """flax ``nn.Dense`` on the last axis, in the input's dtype."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 init: str = "lecun"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.init = init

    def forward(self, x):
        dt = x.dtype
        return F.linear(x, self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=1)``: per-sample statistics over all
    non-batch axes in float32 (variance E[x^2] - E[x]^2, clipped at 0),
    epsilon 1e-6 (torch's default is 1e-5), scale and bias applied in
    float32, the result in x's dtype."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        x32 = x.float()
        dims = tuple(range(1, x.dim()))
        mu = x32.mean(dims, keepdim=True)
        var = torch.clamp((x32 * x32).mean(dims, keepdim=True) - mu * mu,
                          min=0.0)
        y = (x32 - mu) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(x.dtype)


class ResNetBlock(nn.Module):
    """conv-SELU-GN, conv-GN, + identity, SELU."""

    def __init__(self, features: int):
        super().__init__()
        self.Conv_0 = Conv(features, features, 3)
        self.GroupNorm_0 = GroupNorm(features)
        self.Conv_1 = Conv(features, features, 3)
        self.GroupNorm_1 = GroupNorm(features)

    def forward(self, x):
        y = self.GroupNorm_0(F.selu(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        return F.selu(y + x)


def source_order(track_length: int) -> np.ndarray:
    """ORDER[i] = [i, the frames != i in ascending order]: stack position 0
    is the target frame itself."""
    return np.asarray([[i] + [j for j in range(track_length) if j != i]
                       for i in range(track_length)], np.int32)


def _extract_patches(x: torch.Tensor, ksize: int, stride: int) -> torch.Tensor:
    """x (..., h, w, C) -> (..., h', w', ksize^2, C), zero padding, taps in
    raster order; the values are copies, so this equals the JAX
    identity-kernel patches exactly."""
    p = (ksize - 1) // 2
    h, w = x.shape[-3:-1]
    ho = (h + 2 * p - ksize) // stride + 1
    wo = (w + 2 * p - ksize) // stride + 1
    xp = F.pad(x, (0, 0, p, p, p, p))
    return torch.stack([xp[..., a:a + stride * (ho - 1) + 1:stride,
                           b:b + stride * (wo - 1) + 1:stride, :]
                        for a in range(ksize) for b in range(ksize)], dim=-2)


def _merged_patches(v: torch.Tensor, ksize: int, stride: int) -> torch.Tensor:
    """(..., tl, N, h, w, C) -> (..., N, h', w', tl*k2, C): the 3x3 spatial
    taps of tl source frames merged frame-major (s = j*k2 + k)."""
    p = _extract_patches(v, ksize, stride).movedim(-6, -3)
    return p.reshape(*p.shape[:-3], p.shape[-3] * p.shape[-2], p.shape[-1])


def pointconv_select(xyz: torch.Tensor, mask: torch.Tensor,
                     neighbors: int = 9, ksize: int = 3, stride: int = 1):
    """Candidate selection of :class:`PointConv`, in float32.

    For every output location, take the 3x3 x tl spatio-temporal candidate
    points and pick the ``neighbors`` nearest in normalized image-plane
    distance to the target frame's centre point; masked candidates are set
    to the maximum distance + 1. Ties go to the lower candidate index (a
    stable ascending sort, as ``lax.top_k`` orders them), which decides
    which masked candidates fill the places where fewer than ``neighbors``
    are valid.

    xyz: (..., tl, N, h, w, 3) in the target camera (stack position 0 =
    target); mask: (..., tl, N, h, w, 1). Leading axes are independent
    targets, each with its own maximum (the JAX package vmaps over them).
    Returns (idx (..., N, h', w', k) int64 indices into the frame-major
    candidate axis, xyz_nb (..., N, h', w', k, 3) the centre-relative xyz of
    the selected neighbours)."""
    k2 = ksize * ksize
    xyz_p = _merged_patches(xyz.float(), ksize, stride)
    mask_p = _merged_patches(mask.float(), ksize, stride)
    xyz_plane = xyz_p / (xyz_p[..., 2:] + 1e-12)
    center = k2 // 2
    xyz_local = xyz_p - xyz_p[..., center:center + 1, :]
    plane_local = xyz_plane - xyz_plane[..., center:center + 1, :]
    sq = plane_local * plane_local
    dist = (sq[..., 0] + sq[..., 1]) + sq[..., 2]         # (..., N, h', w', S)
    m = mask_p[..., 0]
    top = torch.amax(dist, dim=(-4, -3, -2, -1), keepdim=True)
    dist_masked = m * dist + (1.0 - m) * (top + 1.0)
    idx = torch.sort(dist_masked, dim=-1, stable=True)[1][..., :neighbors]
    xyz_nb = torch.gather(xyz_local, -2,
                          idx[..., None].expand(*idx.shape, 3))
    return idx, xyz_nb


def _neighbor_rows(idx: torch.Tensor, h: int, w: int, stride: int,
                   ksize: int = 3) -> torch.Tensor:
    """Flat row indices of the selected neighbours into the zero-padded
    warped features (T, tl, N, h + 2p, w + 2p, C) viewed as (rows, C).
    idx: (T, N, h', w', k) candidate indices s = j*k2 + a*ksize + b (source
    j, tap (a, b)). Gathering these rows equals taking the neighbours from
    the merged patches, without building the k2*tl-fold patch tensor."""
    T, N, ho, wo, _ = idx.shape
    k2, p = ksize * ksize, (ksize - 1) // 2
    j, tap = idx // k2, idx % k2
    dev = idx.device
    y = (torch.arange(ho, device=dev) * stride)[None, None, :, None, None] \
        + tap // ksize
    x = (torch.arange(wo, device=dev) * stride)[None, None, None, :, None] \
        + tap % ksize
    t = torch.arange(T, device=dev)[:, None, None, None, None]
    n = torch.arange(N, device=dev)[None, :, None, None, None]
    return (((t * T + j) * N + n) * (h + 2 * p) + y) * (w + 2 * p) + x


class PointConv(nn.Module):
    """Continuous kNN convolution over the warped point clouds: an MLP on
    the neighbours' relative xyz gives per-neighbour weights for their
    features; the weighted sum goes through a linear map, SELU and
    GroupNorm."""

    def __init__(self, features: int):
        super().__init__()
        self.Dense_0 = Dense(3, features // 2)
        self.Dense_1 = Dense(features // 2, features)
        self.Dense_2 = Dense(features, features, bias=False, init="xavier")
        self.GroupNorm_0 = GroupNorm(features)

    def forward(self, feat, rows, xyz_nb):
        """feat (T, tl, N, h, w, C) (stack position 0 = target); rows
        (T, N, h', w', k) from :func:`_neighbor_rows`; xyz_nb (T, N, h', w',
        k, 3). Returns (T, N, h', w', features)."""
        C = feat.shape[-1]
        fp = F.pad(feat, (0, 0, 1, 1, 1, 1))
        feat_nb = fp.reshape(-1, C)[rows]                  # (T,N,h',w',k,C)
        wgt = F.selu(self.Dense_0(xyz_nb.to(feat.dtype)))
        wgt = F.selu(self.Dense_1(wgt))
        out = F.selu(self.Dense_2(torch.sum(wgt * feat_nb, dim=-2)))
        T, N, ho, wo, F_ = out.shape
        return self.GroupNorm_0(out.reshape(T * N, ho, wo, F_)).reshape(
            out.shape)


def _pair_list(track_length: int):
    """The (target i, source j != i) pairs, target-major, sources in
    ascending order (``source_order``)."""
    order = source_order(track_length)
    return [(i, int(j)) for i in range(track_length) for j in order[i][1:]]


def _pair_flows(flow: torch.Tensor) -> torch.Tensor:
    """(tl, tl, N, h, w, 2) -> the pair-major stack (tl*(tl-1)*N, h, w, 2)
    of flow[i, j] over :func:`_pair_list`."""
    tl = flow.shape[0]
    pf = torch.stack([flow[i, j] for i, j in _pair_list(tl)])
    return pf.reshape(-1, *pf.shape[2:]).contiguous()


class Block2D3D(nn.Module):
    """One fusion block: flow-warped multi-frame 2D merge at two scales and
    two point convolutions, fused with a residual SELU."""

    def __init__(self, features: int, track_length: int):
        super().__init__()
        F_, tl = features, track_length
        self.conv3d_1 = PointConv(F_)
        self.conv3d_2 = PointConv(F_)
        self.conv_mf = Conv(tl * F_, F_, 1)
        self.GroupNorm_0 = GroupNorm(F_)
        self.Conv_0 = Conv(F_, F_, 3)
        self.GroupNorm_1 = GroupNorm(F_)
        self.Conv_1 = Conv(F_, F_, 3)
        self.GroupNorm_2 = GroupNorm(F_)
        self.Conv_2 = Conv(F_, F_, 4, stride=2)
        self.GroupNorm_3 = GroupNorm(F_)
        self.Conv_3 = Conv(F_, F_, 3)
        self.GroupNorm_4 = GroupNorm(F_)
        self.conv_fuse = Conv(3 * F_, F_, 3)
        self.GroupNorm_5 = GroupNorm(F_)

    @staticmethod
    def gather_warped_feat(f, pair_flow):
        """f (tl, N, h, w, C) -> (tl_t, tl_s, N, h, w, C): for each target
        i, [f[i]] + [warp(f[j], flow[i, j]) for j != i], all pairs in one
        K4 call that reads each source plane in place."""
        tl, N, h, w, C = f.shape
        src_idx = tuple(j * N + n for _, j in _pair_list(tl)
                        for n in range(N))
        wf = flow_warp_pairs(f.reshape(tl * N, h, w, C), pair_flow, src_idx)
        return torch.cat([f[:, None], wf.reshape(tl, tl - 1, N, h, w, C)],
                         dim=1)

    def forward(self, feat, pair_flow, pair_flow_half, rows1, xyz_nb1, rows2,
                xyz_nb2, merge_w):
        """feat (tl, N, h, w, C); pair_flow(_half): :func:`_pair_flows` of
        the flow at (h, w) and (h/2, w/2); rows/xyz_nb: the stride-2 (full
        res candidates) and stride-1 (half res) neighbour selections;
        merge_w (tl_t, tl_s, N, h, w, 1). All but feat are shared by the
        blocks."""
        tl, N, h, w, C = feat.shape
        warped = self.gather_warped_feat(feat, pair_flow)
        out3d_1 = self.conv3d_1(warped, rows1, xyz_nb1)    # (tl,N,h/2,w/2,C)
        h2, w2 = out3d_1.shape[2:4]
        warped2 = self.gather_warped_feat(out3d_1, pair_flow_half)
        out3d_2 = self.conv3d_2(warped2, rows2, xyz_nb2)

        wf = warped * merge_w.to(warped.dtype)
        wf = wf.movedim(1, -2).reshape(tl * N, h, w, tl * C)
        mf = self.GroupNorm_0(self.conv_mf(wf))
        b1 = self.GroupNorm_1(F.selu(self.Conv_0(mf)))
        b1 = self.GroupNorm_2(F.selu(self.Conv_1(b1)))
        b2 = self.GroupNorm_3(F.selu(self.Conv_2(mf)))
        b2 = self.GroupNorm_4(F.selu(self.Conv_3(b2)))
        b2 = resize_bilinear(b2, h, w, align_corners=True)
        o3 = resize_bilinear(out3d_2.reshape(tl * N, h2, w2, C), h, w,
                             align_corners=True)
        fuse = self.conv_fuse(torch.cat([b1, b2, o3], dim=-1))
        fuse = self.GroupNorm_5(fuse)
        return F.selu(fuse.reshape(tl, N, h, w, C) + feat)


def _resize_leading(x, h, w):
    """(..., h0, w0, C) -> (..., h, w, C), bilinear, align_corners."""
    flat = x.reshape(-1, *x.shape[-3:])
    out = resize_bilinear(flat, h, w, align_corners=True)
    return out.reshape(*x.shape[:-3], h, w, x.shape[-1])


def _resize_flow_grid(flow, h, w):
    """A (tl, tl, N, h0, w0, 2) flow field resized, its values rescaled."""
    out = resize_flow(flow.reshape(-1, *flow.shape[3:]), h, w)
    return out.reshape(*flow.shape[:3], h, w, 2)


class FuseNet(nn.Module):
    """forward(ir, amb, primary_disp, primary_depth, R, t, flow):

      ir   (tl, N, H, W, 2)   [LCN(IR), IR]
      amb  (tl, N, H, W, 1)
      primary_disp, primary_depth (tl, N, H, W, 1)
      R    (tl, N, 3, 3);  t (tl, N, 3)
      flow (tl, tl, N, H, W, 2), flow[i, j] from frame i to frame j

    returns the disparity (tl, N, H, W, 1) in float32. ``use_remat`` wraps
    the fusion blocks and the decoder's residual blocks in
    ``torch.utils.checkpoint`` (activations recomputed in the backward)."""

    def __init__(self, imsize, K, track_length: int = 4, block_num: int = 4,
                 channels: int = 32, max_disp: float = 128.0,
                 use_remat: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.imsize = tuple(imsize)
        self.track_length = track_length
        self.channels = channels
        self.use_remat = use_remat
        self.compute_dtype = compute_dtype
        C, tl = channels, track_length
        self.conv1 = Conv(4, C // 2, 4, stride=2)
        self.conv2 = Conv(C // 2, C // 2, 3)
        self.conv3 = Conv(C // 2, C, 3)
        self.conv4 = Conv(C, C, 3)
        self.res1 = ResNetBlock(C)
        self.res2 = ResNetBlock(C)
        self.res3 = ResNetBlock(C)
        for b in range(block_num):
            self.add_module(f"block{b}", Block2D3D(C, tl))
        self.block_num = block_num
        self.amb_conv = Conv(1, 16, 3)
        self.amb_res1 = ResNetBlock(16)
        self.amb_res2 = ResNetBlock(16)
        self.ref_conv = Conv(C + 16, 32, 3)
        self.ref_res1 = ResNetBlock(32)
        self.ref_res2 = ResNetBlock(32)
        self.ref_res3 = ResNetBlock(32)
        self.final_conv = Conv(32, 16, 3)
        self.predict_disp = SigmoidAffineHead(16, max_disp)
        ray, self.core_size = self._core_ray(self.imsize, K)
        self.register_buffer("ray", ray, persistent=False)

    @staticmethod
    def _core_ray(imsize, K):
        """Half-res ray grid at the pixels cv2 INTER_NEAREST keeps: floor(
        i * W / cw) (even indices for even sizes)."""
        H, W = imsize
        ch, cw = H // 2, W // 2
        Ki = np.linalg.inv(np.asarray(K, np.float64))
        u = (np.arange(cw) * (W / cw)).astype(np.int64)
        v = (np.arange(ch) * (H / ch)).astype(np.int64)
        uu, vv = np.meshgrid(u, v)
        uv1 = np.stack([uu, vv, np.ones_like(uu)], axis=-1).reshape(-1, 3)
        return torch.from_numpy((uv1 @ Ki.T).astype(np.float32)), (ch, cw)

    def _run(self, module, *args):
        if self.use_remat and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False)
        return module(*args)

    def _geometry(self, primary_depth, R, t, flow):
        """The warped xyz and masks per target and what the blocks share;
        no gradient flows through any of it."""
        tl, N = primary_depth.shape[:2]
        ch, cw = self.core_size
        core_depth = _resize_leading(primary_depth.float(), ch, cw)
        core_flow = _resize_flow_grid(flow.float(), ch, cw)

        # unproject, xyz_world = (depth * ray - t) @ R, then into every
        # target frame i: xyz @ R_i^T + t_i. Written as elementwise
        # products summed in a fixed order, so every device rounds them
        # alike: the neighbour selection breaks near-ties by these bits.
        d = core_depth.reshape(tl, N, ch * cw)
        pk = [d * self.ray[:, k] - t[:, :, k, None] for k in range(3)]
        xw = [(pk[0] * R[:, :, 0, k, None] + pk[1] * R[:, :, 1, k, None])
              + pk[2] * R[:, :, 2, k, None] for k in range(3)]
        Rt, tt = R[:, None, :, :, :, None], t[:, None, :, :, None]
        xyz_t = torch.stack(
            [(xw[0][None] * Rt[:, :, :, i, 0] + xw[1][None] * Rt[:, :, :, i, 1])
             + xw[2][None] * Rt[:, :, :, i, 2] + tt[:, :, :, i]
             for i in range(3)], dim=-1).reshape(tl, tl, N, ch, cw, 3)

        # the tl*(tl-1) source warps of the xyz and the reverse flow (for
        # the forward-backward test; 0.01 here, 0.02 in the losses) in one
        # K3 call
        pairs = _pair_list(tl)
        src = torch.stack([torch.cat([xyz_t[i, j], core_flow[j, i]], dim=-1)
                           for i, j in pairs])
        fwd_flow = torch.stack([core_flow[i, j] for i, j in pairs])
        warped = flow_warp(src.reshape(-1, ch, cw, 5),
                           fwd_flow.reshape(-1, ch, cw, 2))
        warped = warped.reshape(tl, tl - 1, N, ch, cw, 5)
        f0 = fwd_flow.reshape(tl, tl - 1, N, ch, cw, 2)
        f10 = warped[..., 3:]
        fb = (torch.sum((f0 + f10) ** 2, -1)
              < 0.5 + 0.01 * (torch.sum(f0 ** 2, -1) + torch.sum(f10 ** 2, -1)))
        self_xyz = torch.stack([xyz_t[i, i] for i in range(tl)])[:, None]
        warped_xyz = torch.cat([self_xyz, warped[..., :3]], dim=1)
        warped_mask = torch.cat([torch.ones_like(self_xyz[..., :1]),
                                 fb.to(xyz_t.dtype)[..., None]], dim=1)

        h2, w2 = ch // 2, cw // 2
        idx1, xyz_nb1 = pointconv_select(warped_xyz, warped_mask, stride=2)
        xyz_half = _resize_leading(warped_xyz, h2, w2)
        mask_half = (_resize_leading(warped_mask, h2, w2) > 0.5).to(
            warped_mask.dtype)
        idx2, xyz_nb2 = pointconv_select(xyz_half, mask_half, stride=1)
        return dict(
            pair_flow=_pair_flows(core_flow),
            pair_flow_half=_pair_flows(_resize_flow_grid(core_flow, h2, w2)),
            rows1=_neighbor_rows(idx1, ch, cw, 2), xyz_nb1=xyz_nb1,
            rows2=_neighbor_rows(idx2, h2, w2, 1), xyz_nb2=xyz_nb2,
            merge_w=warped_mask / torch.mean(warped_mask, dim=1,
                                             keepdim=True))

    def forward(self, ir, amb, primary_disp, primary_depth, R, t, flow):
        tl, N, H, W, _ = ir.shape
        C, dt = self.channels, self.compute_dtype
        ch, cw = self.core_size

        x = torch.cat([ir, amb, primary_disp], dim=-1).reshape(
            tl * N, H, W, 4).to(dt)
        x = F.selu(self.conv1(x))
        x = F.selu(self.conv2(x))
        x = F.selu(self.conv3(x))
        x = F.selu(self.conv4(x))
        x = self.res3(self.res2(self.res1(x)))
        core_feat = x.reshape(tl, N, ch, cw, C)

        with torch.no_grad():
            g = self._geometry(primary_depth, R.float(), t.float(), flow)
        for b in range(self.block_num):
            core_feat = self._run(
                getattr(self, f"block{b}"), core_feat, g["pair_flow"],
                g["pair_flow_half"], g["rows1"], g["xyz_nb1"], g["rows2"],
                g["xyz_nb2"], g["merge_w"])

        up = resize_bilinear(core_feat.reshape(tl * N, ch, cw, C), H, W,
                             align_corners=True)
        a = F.selu(self.amb_conv(amb.reshape(tl * N, H, W, 1).to(dt)))
        a = self._run(self.amb_res1, a)
        a = self._run(self.amb_res2, a)
        y = F.selu(self.ref_conv(torch.cat([up, a], dim=-1)))
        for blk in (self.ref_res1, self.ref_res2, self.ref_res3):
            y = self._run(blk, y)
        y = F.selu(self.final_conv(y))
        disp = self.predict_disp(y.float().permute(0, 3, 1, 2))
        return disp.permute(0, 2, 3, 1).reshape(tl, N, H, W, 1)


@torch.no_grad()
def init_fusenet_(model: FuseNet, generator: torch.Generator) -> FuseNet:
    """Seeded init with flax's defaults: lecun-normal kernels (a normal
    truncated at 2 std, rescaled to variance 1/fan_in), xavier-uniform for
    the point convolutions' last linear map, zero biases, GroupNorm scale 1
    and bias 0."""
    for mod in model.modules():
        if isinstance(mod, Dense) and mod.init == "xavier":
            fan_out, fan_in = mod.weight.shape
            a = math.sqrt(6.0 / (fan_in + fan_out))
            nn.init.uniform_(mod.weight, -a, a, generator=generator)
        elif isinstance(mod, (Conv, Dense, nn.Conv2d)):
            w = mod.weight
            fan_in = int(np.prod(w.shape[1:]))
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, GroupNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
    return model
