"""DIS-SF / DIS-FTSF / DIS-MF objectives, port of ``depthinspace_tpu/
train/objective.py``:

  SF: components = [photometric(out_s) / 2^s for s in 0..3,
                    0.4 * smoothness(out_0),
                    (0.2 / C(tl,2)) * sum_pairs geometric_sf(depth(out_0)),
                    [use_pseudo_gt] 0.1 * L1(out_s, pseudo_gt) / 2^s,
                    [train, real data] 0.1 * [epoch < warmup]
                        * masked-noisy-L1(out_s, sgm_disp) for s in 0..3]
  MF: components = [photometric(out), 0.8 * smoothness(out),
                    (0.2 / C(tl,2)) * sum_pairs geometric_mf(depth(out)),
                    [train] 0.1 * [epoch < 2] * L1(out, primary_disp),
                    [train, real data] 0.1 * [epoch < warmup]
                        * masked-noisy-L1(out, sgm_disp)]

with the training-time device augmentation (``augment_batch_device``) and
the flow sources "file", "rigid", "pred" (DIS-MF: the rigid flow of the
primary disparity) and "net" (the frozen FlowNet's flow of the batch's
images). The JAX package draws its
random numbers from jax keys; here they come from an explicit
``torch.Generator``, or are passed in (the tests hand both packages the
same numbers).

Data parallel: with ``LossContext.group`` set, every batch-wide mean and
masked ratio is over the group's global batch (``losses/reduce.py``): a
rank's total is its share, whose gradients summed over the ranks are the
global-batch gradient, and the components are the all-reduced (global)
values, the JAX mesh step's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..losses import (CameraGeometry, geometric_loss_mf, geometric_loss_sf,
                      photometric_loss, smoothness_loss)
from ..losses.reduce import global_mean, global_ratio
from ..models import flow_all_pairs
from ..ops import disp_to_depth, lcn, resize_bilinear
from ..parallel.multihost import all_reduce_sum

FLOW_SOURCES = ("file", "rigid", "pred", "net")


class LossContext(NamedTuple):
    """Per-run loss configuration and constants on the run's device."""
    cam: CameraGeometry
    pattern_lcn: torch.Tensor        # (H, W) LCN-normalized pattern
    focal_length: float
    baseline: float
    track_length: int
    data_type: str = "synthetic"
    warmup_epochs: int = 150
    use_pseudo_gt: bool = False
    lcn_radius: int = 5
    smooth_weight_sf: float = 0.4
    smooth_weight_mf: float = 0.8
    geo_weight: float = 0.2
    pseudo_weight: float = 0.1
    sgm_weight: float = 0.1
    mf_primary_warmup_weight: float = 0.1
    mf_primary_warmup_epochs: int = 2
    sgm_noise_sigma: float = 1.5
    sgm_valid_threshold: float = 30.0
    geo_clamp: float = 0.1
    # device augmentation of the training batches (augment_batch_device)
    augment: bool = False
    aug_max_blur: float = 0.5
    aug_max_noise: float = 3.0
    aug_max_sp_noise: float = 0.0005
    # "file": flow comes with the batch; "rigid": from the GT disparity and
    # the poses (synthetic data); "pred": from the current prediction (SF)
    # or the primary disparity (MF) and the poses (GT-free); "net": from
    # the frozen FlowNet ``flow_net`` on the batch's images (GT-free), on
    # the net's own input channels
    flow_source: str = "file"
    flow_net: Optional[torch.nn.Module] = None
    # scale s of the photometric term at 1/2^s resolution, with the
    # per-scale LCN'd patterns for s = 1..3
    photometric_pyramid: bool = False
    pattern_pyr: Optional[tuple] = None
    # the data-parallel process group (parallel/multihost.py); None on one
    # process
    group: Optional[object] = None


def make_loss_context(settings, track_length: int = 4, device=None,
                      **kwargs) -> LossContext:
    """``settings``: any object with imsize, K, baseline, focal_length and
    pattern_gray() (``data.Settings`` or the JAX ``Settings``)."""
    flow_source = kwargs.get("flow_source", "file")
    if flow_source not in FLOW_SOURCES:
        raise ValueError(f"flow_source must be one of {FLOW_SOURCES}")
    if flow_source == "net" and kwargs.get("flow_net") is None:
        raise ValueError("flow_source='net' needs flow_net (a FlowNet)")
    H, W = settings.imsize
    cam = CameraGeometry.create(settings.K, H, W, device=device)
    radius = kwargs.get("lcn_radius", 5)
    pat_raw = torch.as_tensor(np.asarray(settings.pattern_gray(), np.float32),
                              device=device)
    pat_lcn, _ = lcn(pat_raw, radius, 0.05)
    if kwargs.get("photometric_pyramid", False):
        # downsample the RAW pattern, then LCN (the reference's order)
        kwargs["pattern_pyr"] = tuple(
            lcn(resize_bilinear(pat_raw[None, :, :, None], H >> s, W >> s,
                                align_corners=False)[0, :, :, 0],
                radius, 0.05)[0] for s in (1, 2, 3))
    return LossContext(cam=cam, pattern_lcn=pat_lcn,
                       focal_length=float(settings.focal_length),
                       baseline=float(settings.baseline),
                       track_length=track_length, **kwargs)


def rigid_flow_device(cam: CameraGeometry, disp, R, t, focal_length,
                      baseline):
    """All-pairs rigid optical flow from disparity + poses.

    disp (tl, bs, H, W); R (tl, bs, 3, 3); t (tl, bs, 3). Returns
    (tl, tl, bs, H, W, 2) with flow[i, j] mapping frame-i pixels into frame
    j and a zero diagonal. Same plane-by-plane arithmetic as the JAX version.
    """
    tl, bs, H, W = disp.shape
    depth = disp_to_depth(disp, focal_length, baseline)
    rays = [cam.ray[:, k].reshape(H, W) for k in range(3)]
    # world xyz per source frame: (depth * ray - t) @ R
    pk = [depth * rays[k][None, None] - t[..., k, None, None]
          for k in range(3)]
    xw = [sum(pk[j] * R[:, :, j, k, None, None] for j in range(3))
          for k in range(3)]
    # into every target frame: xyz @ R_i^T + t_i, planes (t, s, bs, H, W)
    Rt = R[:, None, :, :, :, None, None]
    tt = t[:, None, :, :, None, None]
    xc = [sum(xw[j][None] * Rt[:, :, :, k, j] for j in range(3))
          + tt[:, :, :, k] for k in range(3)]
    K = cam.K
    zi = 1.0 / (torch.relu(K[2, 0] * xc[0] + K[2, 1] * xc[1]
                           + K[2, 2] * xc[2]) + 1e-12)
    u = (K[0, 0] * xc[0] + K[0, 1] * xc[1] + K[0, 2] * xc[2]) * zi
    v = (K[1, 0] * xc[0] + K[1, 1] * xc[1] + K[1, 2] * xc[2]) * zi
    flow_u = torch.swapaxes(u - cam.grid[..., 0][None, None, None], 0, 1)
    flow_v = torch.swapaxes(v - cam.grid[..., 1][None, None, None], 0, 1)
    flow = torch.stack([flow_u, flow_v], dim=-1)
    diag = torch.eye(tl, dtype=flow.dtype,
                     device=flow.device).reshape(tl, tl, 1, 1, 1, 1)
    return (flow * (1.0 - diag)).detach()


def _gauss_blur5(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Per-frame 5x5 separable Gaussian blur, cv2.GaussianBlur(ksize=5,
    sigmaX=sigma) with REFLECT_101 borders. x: (n, H, W); sigma: (n, 1, 1)."""
    offs = torch.arange(-2.0, 3.0, dtype=x.dtype, device=x.device)
    w = torch.exp(-(offs ** 2)[None, :] / (2.0 * sigma.reshape(-1, 1) ** 2))
    w = w / torch.sum(w, dim=1, keepdim=True)            # (n, 5)

    def pass1d(v, axis):
        pad = (2, 2, 0, 0) if axis == 2 else (0, 0, 2, 2)
        vp = F.pad(v[:, None], pad, mode="reflect")[:, 0]
        n = v.shape[axis]
        acc = 0.0
        for j in range(5):
            sl = vp[:, :, j:j + n] if axis == 2 else vp[:, j:j + n, :]
            acc = acc + w[:, j, None, None] * sl
        return acc

    return pass1d(pass1d(x, 2), 1)


class AugmentDraws(NamedTuple):
    """The random numbers of one augmentation, per frame (n, 1, 1) unless
    noted (n = tl * bs)."""
    blur_coin: torch.Tensor           # U[0, 1): blur when < 0.5
    blur_sigma_im: torch.Tensor       # U[0.2, aug_max_blur)
    blur_sigma_amb: torch.Tensor
    noise_im: torch.Tensor            # (n, H, W) standard normal
    noise_scale_im: torch.Tensor      # U[0, aug_max_noise)
    noise_amb: torch.Tensor           # (n, H, W)
    noise_scale_amb: torch.Tensor
    sp_coin: torch.Tensor             # U[0, 1): salt & pepper when < 0.5
    sp_ratio: torch.Tensor            # U[0, aug_max_sp_noise)
    sp_u: torch.Tensor                # (2, n, H, W) U[0, 1)


def draw_augment(n: int, H: int, W: int, ctx: LossContext,
                 generator: torch.Generator) -> AugmentDraws:
    """Draw one augmentation's random numbers from ``generator``."""
    dev = generator.device

    def uni(lo, hi, shape=(n, 1, 1)):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=dev)

    def normal():
        return torch.randn((n, H, W), generator=generator, device=dev)

    return AugmentDraws(
        blur_coin=uni(0.0, 1.0), blur_sigma_im=uni(0.2, ctx.aug_max_blur),
        blur_sigma_amb=uni(0.2, ctx.aug_max_blur),
        noise_im=normal(), noise_scale_im=uni(0.0, ctx.aug_max_noise),
        noise_amb=normal(), noise_scale_amb=uni(0.0, ctx.aug_max_noise),
        sp_coin=uni(0.0, 1.0), sp_ratio=uni(0.0, ctx.aug_max_sp_noise),
        sp_u=uni(0.0, 1.0, (2, n, H, W)))


def augment_batch_device(batch, draws: AugmentDraws):
    """Training augmentation of the IR and ambient images on the device:
    Gaussian blur with p=0.5 (separate sigmas for IR and ambient),
    per-pixel Gaussian noise with a per-frame scale, salt & pepper with
    p=0.5 on the IR (levels = the frame's pre-noise min and max), clip to
    [0, 1]. Disparities are unchanged."""
    tl, bs, H, W = batch.im.shape
    n = tl * bs
    im = batch.im.reshape(n, H, W)
    amb = batch.ambient.reshape(n, H, W)
    min_val = torch.amin(im, dim=(1, 2), keepdim=True)
    max_val = torch.amax(im, dim=(1, 2), keepdim=True)

    blur_on = draws.blur_coin < 0.5
    im = torch.where(blur_on, _gauss_blur5(im, draws.blur_sigma_im), im)
    amb = torch.where(blur_on, _gauss_blur5(amb, draws.blur_sigma_amb), amb)

    im = im + draws.noise_im * draws.noise_scale_im / 255.0
    amb = amb + draws.noise_amb * draws.noise_scale_amb / 255.0

    ratio = torch.where(draws.sp_coin < 0.5, draws.sp_ratio,
                        torch.zeros_like(draws.sp_ratio))
    im = torch.where(draws.sp_u[0] < ratio, max_val, im)
    im = torch.where(draws.sp_u[1] < ratio, min_val, im)

    return batch._replace(im=torch.clamp(im, 0.0, 1.0).reshape(tl, bs, H, W),
                          ambient=torch.clamp(amb, 0.0, 1.0).reshape(
                              tl, bs, H, W))


def prepare_batch(batch, ctx: LossContext, multi_frame: bool = False):
    """The step's flow source: "rigid" computes the all-pairs flow from the
    GT disparity and the poses; "net" from the (decoded, augmented) images
    by the frozen FlowNet, without gradient; for DIS-MF "pred" computes it
    from the primary disparity (the SF predictions FuseNet fuses); "file"
    leaves the batch as it is, and so does SF "pred" (its flow comes from
    the live prediction inside sf_losses)."""
    if ctx.flow_source == "rigid":
        batch = batch._replace(flow=rigid_flow_device(
            ctx.cam, batch.disp_gt, batch.R, batch.t, ctx.focal_length,
            ctx.baseline))
    elif ctx.flow_source == "net":
        batch = batch._replace(flow=flow_all_pairs(
            ctx.flow_net, batch.im, batch.ambient))
    elif ctx.flow_source == "pred" and multi_frame:
        batch = batch._replace(flow=rigid_flow_device(
            ctx.cam, batch.primary_disp, batch.R, batch.t, ctx.focal_length,
            ctx.baseline))
    return batch


def preprocess_images(batch, lcn_radius: int = 5):
    """LCN the IR and build the 2-channel net input (tl*bs merged).

    Returns (net_in (tl*bs, H, W, 2), im_lcn, im_std, amb), the last three
    (tl*bs, H, W)."""
    tl, bs, H, W = batch.im.shape
    im = batch.im.reshape(tl * bs, H, W)
    im_lcn, im_std = lcn(im, lcn_radius, 0.05)
    net_in = torch.stack([im_lcn, im], dim=-1)
    amb = batch.ambient.reshape(tl * bs, H, W)
    return net_in, im_lcn, im_std, amb


def _sgm_warmup_term(out, sgm_disp, noise, ctx: LossContext):
    """Masked L1 to the SGM disparities with sigma * ``noise`` added
    (``noise`` standard normal, shaped like out)."""
    valid = (sgm_disp > ctx.sgm_valid_threshold).to(out.dtype)
    err = torch.abs(out - sgm_disp + ctx.sgm_noise_sigma * noise) * valid
    return global_ratio(torch.sum(err), torch.sum(valid), ctx.group,
                        min_den=1.0)


def _total_and_components(comps: list, ctx: LossContext):
    """(this rank's total, the components over the global batch)."""
    comps = torch.stack(comps)
    total = torch.sum(comps)
    if ctx.group is not None:
        comps = all_reduce_sum(comps.detach(), ctx.group)
    return total, comps


def sf_losses(outs, batch, ctx: LossContext, *, train: bool = False,
              epoch: float = 0, generator: Optional[torch.Generator] = None,
              sgm_noise=None):
    """DIS-SF / DIS-FTSF loss vector. outs: 4 full-resolution maps
    (tl*bs, H, W, 1), finest first. Returns (total, components): 6
    components, + 4 with ``use_pseudo_gt``, + 4 when training on real data.

    The SGM warmup term's noise is ``sgm_noise`` (4 standard-normal tensors
    shaped like the maps) or, when that is None, drawn from ``generator``."""
    tl, bs, H, W = batch.im.shape
    _, im_lcn, im_std, amb = preprocess_images(batch, ctx.lcn_radius)

    comps = []
    im_raw = batch.im.reshape(tl * bs, H, W)
    for s, o in enumerate(outs):
        if s == 0 or not ctx.photometric_pyramid:
            val, _ = photometric_loss(o[..., 0], im_lcn, ctx.pattern_lcn,
                                      std=im_std, group=ctx.group)
        else:
            # scale s at 1/2^s resolution; the scale-s head's values are
            # already disparities in scale-s pixels
            h_s, w_s = H >> s, W >> s
            im_s = resize_bilinear(im_raw[..., None], h_s, w_s,
                                   align_corners=False)[..., 0]
            im_lcn_s, std_s = lcn(im_s, ctx.lcn_radius, 0.05)
            disp_s = resize_bilinear(o, h_s, w_s, align_corners=False)[..., 0]
            val, _ = photometric_loss(disp_s, im_lcn_s,
                                      ctx.pattern_pyr[s - 1], std=std_s,
                                      group=ctx.group)
        comps.append(val / (2 ** s))
    comps.append(ctx.smooth_weight_sf * smoothness_loss(outs[0][..., 0], amb,
                                                        ctx.group))

    ge_num = ctx.track_length * (ctx.track_length - 1) / 2
    disp0 = outs[0][..., 0].reshape(tl, bs, H, W)
    depth = disp_to_depth(disp0, ctx.focal_length, ctx.baseline)
    if ctx.flow_source == "pred":
        flow = rigid_flow_device(ctx.cam, disp0.detach(), batch.R, batch.t,
                                 ctx.focal_length, ctx.baseline)
    else:
        flow = batch.flow
    ge = geometric_loss_sf(ctx.cam, depth, batch.R, batch.t, flow,
                           batch.ambient, clamp=ctx.geo_clamp,
                           group=ctx.group)
    comps.append(ctx.geo_weight / ge_num * ge)

    if ctx.use_pseudo_gt:
        pseudo = batch.pseudo_gt.reshape(tl * bs, H, W)
        for s, o in enumerate(outs):
            val = global_mean(torch.abs(o[..., 0] - pseudo), ctx.group)
            comps.append(ctx.pseudo_weight * val / (2 ** s))

    if train and ctx.data_type == "real":
        sgm = batch.sgm_disp.reshape(tl * bs, H, W)
        gate = 1.0 if epoch < ctx.warmup_epochs else 0.0
        for s, o in enumerate(outs):
            noise = (sgm_noise[s] if sgm_noise is not None else torch.randn(
                o[..., 0].shape, generator=generator, device=o.device))
            val = _sgm_warmup_term(o[..., 0], sgm, noise, ctx)
            comps.append(ctx.sgm_weight * gate * val)

    return _total_and_components(comps, ctx)


def mf_losses(out, batch, ctx: LossContext, *, train: bool = False,
              epoch: float = 0, generator: Optional[torch.Generator] = None,
              sgm_noise=None):
    """DIS-MF loss vector. out: (tl, bs, H, W, 1). Returns (total,
    components): 3 components, + 1 (the primary L1, gated to epoch < 2) when
    training, + 1 (the SGM warmup) when training on real data. The SGM
    term's noise is ``sgm_noise`` (standard normal, (tl*bs, H, W)) or, when
    that is None, drawn from ``generator``."""
    tl, bs, H, W = batch.im.shape
    _, im_lcn, im_std, amb = preprocess_images(batch, ctx.lcn_radius)
    o = out[..., 0].reshape(tl * bs, H, W)

    comps = []
    val, _ = photometric_loss(o, im_lcn, ctx.pattern_lcn, std=im_std,
                              group=ctx.group)
    comps.append(val)
    comps.append(ctx.smooth_weight_mf * smoothness_loss(o, amb, ctx.group))

    ge_num = ctx.track_length * (ctx.track_length - 1) / 2
    depth = disp_to_depth(out[..., 0], ctx.focal_length, ctx.baseline)
    primary_depth = disp_to_depth(batch.primary_disp, ctx.focal_length,
                                  ctx.baseline)
    ge = geometric_loss_mf(ctx.cam, depth, batch.R, batch.t, batch.flow,
                           batch.ambient, primary_depth, group=ctx.group)
    comps.append(ctx.geo_weight / ge_num * ge)

    if train:
        gate = 1.0 if epoch < ctx.mf_primary_warmup_epochs else 0.0
        val = global_mean(torch.abs(out[..., 0] - batch.primary_disp),
                          ctx.group)
        comps.append(ctx.mf_primary_warmup_weight * gate * val)
        if ctx.data_type == "real":
            sgm = batch.sgm_disp.reshape(tl * bs, H, W)
            gate_sgm = 1.0 if epoch < ctx.warmup_epochs else 0.0
            noise = (sgm_noise if sgm_noise is not None else torch.randn(
                o.shape, generator=generator, device=o.device))
            val = _sgm_warmup_term(o, sgm, noise, ctx)
            comps.append(ctx.sgm_weight * gate_sgm * val)

    return _total_and_components(comps, ctx)
