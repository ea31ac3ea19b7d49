"""Multi-view flow-consistency (geometric) losses, port of
``depthinspace_tpu/losses/geometric.py`` (``CameraGeometry``,
``pairwise_indices``, ``_ordered_directions``, ``geometric_loss_sf``,
``geometric_loss_mf`` and the per-pair ``flow_consistency_sf``,
``flow_consistency_mf``).

For an ordered view pair (a -> b): unproject view-a depth with pose a and
project it into view b (depth d1); sample view-b depth at the flow-displaced
coordinates (K3, zeros padding) -> depth10; diff = clamp(|d1 - depth10|, 0,
clamp). The forward-backward flow test (fb) and the ambient consistency
test (vc) mask the pixels; each direction is a masked mean of its own, and
the loss is their sum over all 2*C(tl,2) directions. The multi-frame
variant clamps nothing and adds a third mask (rf): view b's primary depth,
projected into view a and flow-warped back, must land within 1 px of where
it started. ``with_stats=True`` also returns the share of pixels each mask
accepts, over all directions: whether a flow provider's error starves the
loss (fb accepts ~0.7 px at zero motion).

With a data-parallel ``group`` the masked means and the statistics are
over the global batch (``losses/reduce.py``): each rank's loss is its share.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.geometry import pixel_rays, reproject
from ..ops.resample import flow_warp
from ..parallel.multihost import all_reduce_sum
from .reduce import global_mean, global_ratio


class CameraGeometry(NamedTuple):
    """Intrinsics + per-pixel rays + pixel grid, as tensors on one device."""
    K: torch.Tensor          # (3, 3)
    ray: torch.Tensor        # (H*W, 3)
    grid: torch.Tensor       # (H, W, 2) pixel coordinates (u, v)

    @property
    def height(self) -> int:
        return self.grid.shape[0]

    @property
    def width(self) -> int:
        return self.grid.shape[1]

    @staticmethod
    def create(K: np.ndarray, height: int, width: int,
               device=None) -> "CameraGeometry":
        K = np.asarray(K)
        ray = pixel_rays(np.linalg.inv(K), height, width)
        u, v = np.meshgrid(np.arange(width, dtype=np.float32),
                           np.arange(height, dtype=np.float32))
        grid = np.stack([u, v], axis=-1)
        as_t = lambda a: torch.as_tensor(a, device=device)
        return CameraGeometry(as_t(K.astype(np.float32)), as_t(ray),
                              as_t(grid))


def pairwise_indices(track_length: int) -> tuple[np.ndarray, np.ndarray]:
    """(i, j) for all C(tl, 2) unordered pairs, i < j, in the reference's
    loop order."""
    ii, jj = [], []
    for i in range(track_length):
        for j in range(i + 1, track_length):
            ii.append(i)
            jj.append(j)
    return np.asarray(ii, np.int32), np.asarray(jj, np.int32)


def _ordered_directions(track_length: int):
    """All 2*C(tl,2) ordered directions, (i, j) then (j, i) per pair: this
    order fixes the summation order of the loss."""
    dirs = []
    for i, j in zip(*pairwise_indices(track_length)):
        dirs.append((int(i), int(j)))
        dirs.append((int(j), int(i)))
    return dirs


def _directions(depth, R, t, flow, amb):
    """The per-direction stacks (nd*N, ...) of both losses."""
    dirs = _ordered_directions(depth.shape[0])
    a_idx = [a for a, _ in dirs]
    b_idx = [b for _, b in dirs]

    def gather_dir(x, idx):
        return torch.cat([x[i] for i in idx], dim=0)

    return dict(
        dirs=dirs, a_idx=a_idx, b_idx=b_idx,
        d0=gather_dir(depth, a_idx), d1_=gather_dir(depth, b_idx),
        Ra=gather_dir(R, a_idx), ta=gather_dir(t, a_idx),
        Rb=gather_dir(R, b_idx), tb=gather_dir(t, b_idx),
        f0=torch.cat([flow[a, b] for a, b in dirs], dim=0).detach(),
        f1=torch.cat([flow[b, a] for a, b in dirs], dim=0),
        a0=gather_dir(amb, a_idx), a1=gather_dir(amb, b_idx))


def _mask_stats(group=None, **masks) -> dict:
    """The mean of each boolean or 0/1 mask over the global batch, a
    float32 scalar tensor."""
    out = {k: global_mean(m.to(torch.float32), group)
           for k, m in masks.items()}
    if group is None:
        return out
    names = list(out)
    tot = all_reduce_sum(torch.stack([out[k] for k in names]), group)
    return dict(zip(names, tot))


def geometric_loss_sf(cam: CameraGeometry, depth, R, t, flow, amb,
                      clamp: float = 0.1, with_stats: bool = False,
                      group=None):
    """Sum of the SF direction losses.

    depth/amb: (tl, N, H, W); R: (tl, N, 3, 3); t: (tl, N, 3);
    flow: (tl, tl, N, H, W, 2) with flow[i, j] the flow from frame i to j.
    All ordered directions are stacked and go through one K3 call per
    channel count (1: the depth sample, 3: backward flow + ambient).
    ``with_stats``: (loss, {"fb", "vc", "accept"})."""
    g = _directions(depth, R, t, flow, amb)
    nd, N = len(g["dirs"]), depth.shape[1]
    Hh, Ww = cam.height, cam.width

    _, d1 = reproject(g["d0"], cam.ray, cam.K, g["Ra"], g["ta"], g["Rb"],
                      g["tb"])
    d1 = d1.reshape(nd * N, Hh, Ww)

    # flow is data: only the depth sample would carry a gradient
    f0 = g["f0"]
    depth10 = flow_warp(g["d1_"][..., None], f0)[..., 0]
    sampled = flow_warp(torch.cat([g["f1"], g["a1"][..., None]],
                                  dim=-1).detach(), f0)
    flow10 = sampled[..., 0:2]
    amb10 = sampled[..., 2]

    diff = torch.abs(d1 - depth10)
    if clamp > 0:
        diff = torch.clamp(diff, 0.0, clamp)

    fb = (torch.sum((f0 + flow10) ** 2, dim=-1)
          < 0.5 + 0.02 * (torch.sum(f0 ** 2, dim=-1)
                          + torch.sum(flow10 ** 2, dim=-1)))
    vc = torch.abs(g["a0"] - amb10) < 0.01
    mask = (fb.to(diff.dtype) * vc.to(diff.dtype)).detach()

    # per-direction masked means (the reference normalizes per direction)
    diff = (diff * mask).reshape(nd, -1).sum(dim=1)
    msum = mask.reshape(nd, -1).sum(dim=1)
    loss = torch.sum(global_ratio(diff, msum, group, eps=1e-8))
    if with_stats:
        return loss, _mask_stats(group, fb=fb, vc=vc, accept=mask)
    return loss


def geometric_loss_mf(cam: CameraGeometry, depth, R, t, flow, amb,
                      primary_depth, with_stats: bool = False, group=None):
    """Sum of the MF direction losses: the SF directions without the clamp,
    with the primary-depth round-trip mask rf.

    depth/amb/primary_depth: (tl, N, H, W); R: (tl, N, 3, 3); t: (tl, N, 3);
    flow: (tl, tl, N, H, W, 2). One K3 call with C=1 (the depth sample, the
    only one with a gradient) and one with C=5 (backward flow, ambient and
    the projected primary pixel). ``with_stats``: (loss, {"fb", "vc",
    "rf", "accept"})."""
    g = _directions(depth, R, t, flow, amb)
    nd, N = len(g["dirs"]), depth.shape[1]
    Hh, Ww = cam.height, cam.width
    pd1 = torch.cat([primary_depth[i] for i in g["b_idx"]], dim=0).detach()

    _, d1 = reproject(g["d0"], cam.ray, cam.K, g["Ra"], g["ta"], g["Rb"],
                      g["tb"])
    d1 = d1.reshape(nd * N, Hh, Ww)
    uv0, _ = reproject(pd1, cam.ray, cam.K, g["Rb"].detach(),
                       g["tb"].detach(), g["Ra"].detach(), g["ta"].detach())
    uv0 = uv0.reshape(nd * N, Hh, Ww, 2)

    f0 = g["f0"]
    depth10 = flow_warp(g["d1_"][..., None], f0)[..., 0]
    sampled = flow_warp(torch.cat([g["f1"], g["a1"][..., None], uv0],
                                  dim=-1).detach(), f0)
    flow10 = sampled[..., 0:2]
    amb10 = sampled[..., 2]
    warped_uv0 = sampled[..., 3:5]

    diff = torch.abs(d1 - depth10)
    fb = (torch.sum((f0 + flow10) ** 2, dim=-1)
          < 0.5 + 0.02 * (torch.sum(f0 ** 2, dim=-1)
                          + torch.sum(flow10 ** 2, dim=-1)))
    vc = torch.abs(g["a0"] - amb10) < 0.01
    rf = torch.sum((warped_uv0 - cam.grid[None]) ** 2, dim=-1) < 1.0
    mask = (fb.to(diff.dtype) * vc.to(diff.dtype) * rf.to(diff.dtype)).detach()

    diff = (diff * mask).reshape(nd, -1).sum(dim=1)
    msum = mask.reshape(nd, -1).sum(dim=1)
    loss = torch.sum(global_ratio(diff, msum, group, eps=1e-8))
    if with_stats:
        return loss, _mask_stats(group, fb=fb, vc=vc, rf=rf, accept=mask)
    return loss


def _pair_track(depth0, depth1, R0, t0, R1, t1, flow0, flow1, amb0, amb1):
    """One view pair as a track of 2 frames, whose directions are (0, 1)
    then (1, 0): flow[0, 1] = flow0, flow[1, 0] = flow1 (the diagonal,
    which no direction reads, zero)."""
    z = torch.zeros_like(flow0)
    flow = torch.stack([torch.stack([z, flow0]), torch.stack([flow1, z])])
    st = lambda a, b: torch.stack([a, b])
    return (st(depth0, depth1), st(R0, R1), st(t0, t1), flow,
            st(amb0, amb1))


def flow_consistency_sf(cam: CameraGeometry, depth0, depth1, R0, t0, R1, t1,
                        flow0, flow1, amb0, amb1, clamp: float = 0.1,
                        group=None):
    """The symmetrized SF loss of one view pair: the masked mean of
    direction 0 -> 1 plus that of 1 -> 0. depth/amb: (N, H, W); flow0 (0 ->
    1) and flow1 (1 -> 0): (N, H, W, 2); R: (N, 3, 3); t: (N, 3)."""
    return geometric_loss_sf(cam, *_pair_track(
        depth0, depth1, R0, t0, R1, t1, flow0, flow1, amb0, amb1),
        clamp=clamp, group=group)


def flow_consistency_mf(cam: CameraGeometry, depth0, depth1, R0, t0, R1, t1,
                        flow0, flow1, amb0, amb1, primary_depth0,
                        primary_depth1, group=None):
    """The symmetrized MF loss of one view pair, with the rf mask of each
    direction's target view's primary depth; shapes as
    :func:`flow_consistency_sf`."""
    return geometric_loss_mf(cam, *_pair_track(
        depth0, depth1, R0, t0, R1, t1, flow0, flow1, amb0, amb1),
        torch.stack([primary_depth0, primary_depth1]), group=group)
