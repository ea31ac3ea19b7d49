"""Procedural plane-scene datasets in numpy, port of
``depthinspace_tpu/data/fixture.py``: a slanted background plane and
floating rectangles, ray-cast from each camera pose of a track and lit by
the projector's dot pattern, so the frames of a track are views of one
scene and the rigid flow between them is exact. ``generate_dataset`` writes
the reference's schema (settings.pkl; per sample frames.hdf5 with im,
ambient, grad, disp (4, 1, H, W), R (4, 3, 3), t (4, 3) and, with
``write_sgm``, sgm_disp; flow.hdf5 with flow_{i}{j} (1, 2, H, W)) through
``data/hdf5.py``, with the JAX generator's signature and the same draws
from ``np.random.RandomState`` in the same order.

cv2 is replaced by ``data/imgproc.py`` (remap, box blur, 5x5 Sobel) and
``synthetic.make_dot_pattern`` (the 3x3 Gaussian blur); the rigid flow is
``synthetic.rigid_flow``. Conventions: camera-from-world X_c = R X_w + t;
the projector sits at t + (-baseline, 0, 0) with the camera's orientation.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import hdf5
from .imgproc import box_blur_reflect, remap, sobel5
from .settings import Settings, save_settings
from .synthetic import make_dot_pattern, rigid_flow


def _rotation_for_lookat(target: np.ndarray, eye: np.ndarray) -> np.ndarray:
    """Small rotation turning the optical axis towards (target - eye)."""
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    if np.linalg.norm(x) < 1e-8:
        x = np.array([1.0, 0.0, 0.0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0).astype(np.float32)


class PlaneScene:
    """Background plane n.X = c plus rectangles at constant world z."""

    def __init__(self, rng: np.random.RandomState, n_rects: int = 3):
        nx, ny = rng.uniform(-0.25, 0.25, 2)
        self.bg_n = np.array([nx, ny, 1.0], np.float32)
        self.bg_n /= np.linalg.norm(self.bg_n)
        self.bg_c = float(rng.uniform(3.0, 4.5) * self.bg_n[2])
        self.bg_albedo = rng.uniform(0.3, 0.9)
        self.rects = []
        for _ in range(n_rects):
            z = rng.uniform(1.5, 3.0)
            cx, cy = rng.uniform(-1.0, 1.0, 2)
            w, h = rng.uniform(0.3, 1.0, 2)
            albedo = rng.uniform(0.3, 0.95)
            self.rects.append((z, cx - w / 2, cx + w / 2,
                               cy - h / 2, cy + h / 2, albedo))

    def intersect(self, origins: np.ndarray, dirs: np.ndarray):
        """Ray cast from ``origins`` (3,) along world rays ``dirs`` (P, 3).
        Returns (distance along the ray (P,), albedo (P,), normal (P, 3))."""
        P = dirs.shape[0]
        best_s = np.full(P, np.inf, np.float32)
        albedo = np.full(P, 0.5, np.float32)
        normal = np.tile(np.array([0, 0, -1], np.float32), (P, 1))

        denom = dirs @ self.bg_n
        s = (self.bg_c - origins @ self.bg_n) / np.where(np.abs(denom) < 1e-9,
                                                         1e-9, denom)
        upd = (s > 0) & (s < best_s)
        best_s[upd] = s[upd]
        albedo[upd] = self.bg_albedo
        normal[upd] = -self.bg_n

        for (z, x0, x1, y0, y1, alb) in self.rects:
            denom = dirs[:, 2]
            s = (z - origins[2]) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            pt = origins[None, :] + s[:, None] * dirs
            valid = (s > 0) & (pt[:, 0] >= x0) & (pt[:, 0] <= x1) \
                & (pt[:, 1] >= y0) & (pt[:, 1] <= y1)
            upd = valid & (s < best_s)
            best_s[upd] = s[upd]
            albedo[upd] = alb
            normal[upd] = np.array([0, 0, -1], np.float32)
        return best_s, albedo, normal


def _render_frame(scene: PlaneScene, K: np.ndarray, R: np.ndarray,
                  t: np.ndarray, imsize, pattern_cam: np.ndarray,
                  baseline: float, blend: float):
    """Depth, ambient and IR image of one camera pose: the ambient is
    Lambertian under a headlight, the IR the projector pattern sampled
    where the projector sees each surface point, times the shading."""
    H, W = imsize
    Ki = np.linalg.inv(K)
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    pix = np.stack([u, v, np.ones_like(u)], axis=-1).reshape(-1, 3)
    d_cam = pix @ Ki.T                          # rays with z = 1 in the camera
    d_world = d_cam @ R                         # R^T d (column convention)
    origin = -R.T @ t                           # camera centre in the world

    s, albedo, normal = scene.intersect(origin.astype(np.float32),
                                        d_world.astype(np.float32))
    depth = s.reshape(H, W)                     # z_cam == s since d_cam_z = 1

    view = -d_world / np.linalg.norm(d_world, axis=1, keepdims=True)
    lamb = np.abs(np.sum(normal * view, axis=1))
    ambient = (albedo * lamb).reshape(H, W).astype(np.float32)

    Xw = origin[None, :] + s[:, None] * d_world
    t_proj = t + np.array([-baseline, 0, 0], np.float32)
    Xp = Xw @ R.T + t_proj[None, :]
    uvp = Xp @ K.T
    with np.errstate(divide="ignore", invalid="ignore"):
        up = uvp[:, 0] / np.maximum(uvp[:, 2], 1e-9)
        vp = uvp[:, 1] / np.maximum(uvp[:, 2], 1e-9)
    pat = pattern_cam.mean(axis=2)
    ir = remap(pat, up.reshape(H, W).astype(np.float32),
               vp.reshape(H, W).astype(np.float32))
    ir = (ir * lamb.reshape(H, W)).astype(np.float32)

    im = blend * ir + (1 - blend) * ambient
    return depth.astype(np.float32), ambient, im.astype(np.float32)


def _np_lcn(x, radius, eps):
    k = 2 * radius + 1
    mean = box_blur_reflect(x, k)
    sq = box_blur_reflect(x * x, k)
    std = np.sqrt(np.clip(sq - mean * mean, 0, None)) + eps
    return (x - mean) / std


def _grad(ambient: np.ndarray) -> np.ndarray:
    """The reference's edge map: the 5x5 Sobel magnitude of the ambient
    less 0.8, normalised by LCN and clipped to [0, 1]."""
    sx = sobel5(ambient, 1, 0)
    sy = sobel5(ambient, 0, 1)
    grad = np.maximum(np.sqrt(sx ** 2 + sy ** 2) - 0.8, 0.0)
    return np.clip(_np_lcn(grad, 5, 0.1), 0.0, 1.0)


def generate_dataset(out_dir, n_samples: int = 4, imsize=(64, 56),
                     track_length: int = 4, seed: int = 42,
                     focal: float = 40.0, baseline: float = 0.025,
                     blend: float = 0.6, write_flow: bool = True,
                     write_sgm: bool = False):
    """Write settings.pkl and per sample frames.hdf5 (and flow.hdf5).

    ``write_sgm=True`` adds ``sgm_disp`` to frames.hdf5: the GT disparity
    plus N(0, 0.5) noise with a fifth of the pixels zeroed (invalid), the
    stand-in for the semi-global-matching disparities of real captures
    that the ``--data_type real`` warmup terms read."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    H, W = imsize
    K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1]],
                 np.float32)
    pattern = make_dot_pattern(H, W, seed=seed)
    save_settings(out_dir / "settings.pkl",
                  Settings(imsize=imsize, pattern=pattern,
                           baseline=baseline, K=K))

    center = np.array([0, 0, 3.0], np.float32)
    for idx in range(n_samples):
        rng = np.random.RandomState(seed + idx)
        scene = PlaneScene(rng)
        base_jitter = rng.uniform(-0.15, 0.15, 3).astype(np.float32)

        frames = {k: [] for k in ("im", "ambient", "grad", "disp", "R", "t")}
        depths = []
        for _ in range(track_length):
            cam_pos = base_jitter + rng.uniform(-0.08, 0.08, 3).astype(
                np.float32)
            if np.linalg.norm(cam_pos[:2]) < 1e-9:
                Rc = np.eye(3, dtype=np.float32)
            else:
                Rc = _rotation_for_lookat(center, cam_pos)
            tc = (-Rc @ cam_pos).astype(np.float32)

            depth, ambient, im = _render_frame(
                scene, K, Rc, tc, imsize, pattern, baseline, blend)
            disp = baseline * focal / np.maximum(depth, 1e-6)
            frames["im"].append(im[None])
            frames["ambient"].append(ambient[None])
            frames["grad"].append(_grad(ambient)[None])
            frames["disp"].append(disp[None].astype(np.float32))
            frames["R"].append(Rc)
            frames["t"].append(tc)
            depths.append(depth)

        sample_dir = out_dir / f"{idx:08d}"
        sample_dir.mkdir(exist_ok=True)
        datasets = {k: np.stack(v, axis=0) for k, v in frames.items()}
        if write_sgm:
            disp = datasets["disp"]
            sgm = disp + rng.normal(0, 0.5, disp.shape).astype(np.float32)
            sgm[rng.rand(*sgm.shape) < 0.2] = 0.0       # invalid pixels
            datasets["sgm_disp"] = np.maximum(sgm, 0.0)
        hdf5.write_hdf5(sample_dir / "frames.hdf5", datasets)

        if write_flow:
            Rs, ts = frames["R"], frames["t"]
            flows = {}
            for i in range(track_length):
                for j in range(track_length):
                    if i != j:
                        fl = rigid_flow(depths[i], K, Rs[i], ts[i], Rs[j],
                                        ts[j])
                        flows[f"flow_{i}{j}"] = np.moveaxis(fl, -1, 0)[None]
            hdf5.write_hdf5(sample_dir / "flow.hdf5", flows)
    return out_dir
