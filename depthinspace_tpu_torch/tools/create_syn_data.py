"""Synthetic structured-light dataset generation, port of
``depthinspace_tpu/tools/create_syn_data.py`` without jax, h5py or cv2.

  python -m depthinspace_tpu_torch.tools.create_syn_data default \
      --objects procedural --n_samples 64 --data_dir DIR

A host tool: it uses no device. It renders 4-frame tracks of random scenes
(a background board and 4 randomly posed objects) with the C++ rasterizer
of ``native/render.cpp`` (``render/renderer.py`` builds it) and writes

  DATA_DIR/settings.pkl                     {imsize, pattern, baseline, K}
  DATA_DIR/<idx:08d>/frames.hdf5            im/ambient/grad/disp (4,1,H,W),
                                            R (4,3,3), t (4,3)
                                            [+ sgm_disp for ``real``]

Per frame: IR = blend * pattern projection + (1 - blend) * ambient, the
disparity from the rendered depth, and the ambient's edge map (Sobel,
threshold, LCN). Sample ``idx`` draws everything from
``np.random.RandomState(idx)`` in the JAX tool's order, so one seed gives
the JAX tool's scene, and samples can be made by several processes over
``--start`` / ``--n_samples`` ranges (``--n_samples`` is the end of the
range). Objects are ShapeNet ``.obj`` meshes where config.json's
SHAPENET_DIR names a ShapeNet tree, else 40 procedural blobs.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from ..config import load_paths
from ..data import hdf5
from ..data.fixture import _np_lcn
from ..data.imgproc import sobel5
from ..data.patterns import (map_pattern_to_camera, post_process,
                             read_pattern_file)
from ..data.settings import Settings, save_settings
from ..data.synthetic import make_dot_pattern
from ..render import Camera, RenderInput, Renderer, Shader
from ..utils import geometry3d as g3
from ..utils.io3d import read_obj


# ----------------------------------------------------------- cameras
def camera_config(pattern_type: str):
    """Projector and camera size, intrinsics and baseline of a pattern
    type: (imsize_proj, imsize, K_proj, K, baseline), sizes as (H, W)."""
    if pattern_type == "real":
        fl = 1112.1806640625
        imsize_proj = (1280, 1080)
        imsize = (1280, 1080)
        K_proj = np.array([[fl, 0, 517.0896606445312],
                           [0, fl, 649.6329956054688], [0, 0, 1]], np.float32)
        K = K_proj.copy()
        baseline = 0.0246
    else:
        fl_proj = 1582.06005876
        fl = 435.2
        imsize_proj = (4096, 4096)
        imsize = (512, 432)
        K_proj = np.array([[fl_proj, 0, 2047.5], [0, fl_proj, 2047.5],
                           [0, 0, 1]], np.float32)
        K = np.array([[fl, 0, 216], [0, fl, 256], [0, 0, 1]], np.float32)
        baseline = 0.025
    return imsize_proj, imsize, K_proj, K, baseline


def lookat_rotation(target, eye):
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    if np.linalg.norm(x) < 1e-9:
        x = np.array([1.0, 0.0, 0.0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0).astype(np.float32)


# ----------------------------------------------------------- objects
def procedural_object(rng: np.random.RandomState):
    """Random smooth blob mesh (a deformed icosphere), the stand-in for a
    ShapeNet object: (verts, faces, normals)."""
    # icosphere via subdivided octahedron
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], np.float64)
    faces = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                      [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int64)
    for _ in range(3):
        edge_mid = {}
        new_faces = []
        verts = list(map(np.asarray, verts))

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in edge_mid:
                m = verts[i] + verts[j]
                m = m / np.linalg.norm(m)
                verts.append(m)
                edge_mid[key] = len(verts) - 1
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        faces = np.asarray(new_faces, np.int64)
        verts = np.stack(verts)

    # radial deformation by random low-frequency harmonics
    freq = rng.uniform(1, 3, (3,))
    phase = rng.uniform(0, 2 * np.pi, (3,))
    amp = rng.uniform(0.05, 0.35)
    r = 1 + amp * (np.sin(freq[0] * verts[:, 0] * 3 + phase[0])
                   * np.sin(freq[1] * verts[:, 1] * 3 + phase[1])
                   * np.sin(freq[2] * verts[:, 2] * 3 + phase[2]))
    verts = verts * r[:, None]
    scale = rng.uniform(0.4, 1.0, (3,))
    verts = verts * scale[None, :]
    n = g3.mesh_vertex_normals(verts, faces.astype(np.int32))
    return (verts.astype(np.float32), faces.astype(np.int32),
            n.astype(np.float32))


SHAPENET_SYNSETS = {"chair": "03001627", "airplane": "02691156",
                    "car": "02958343", "watercraft": "04530566"}


def load_shapenet_objects(shapenet_dir, obj_classes=("chair",),
                          num_perclass=100):
    """The first ``num_perclass`` meshes of each class (sorted paths
    ``<synset>/**/models/*.obj``), scaled so the longest side is 2 and
    shifted so the bounding box's low corner is at -1."""
    objs = []
    for cls in obj_classes:
        paths = sorted(Path(shapenet_dir, SHAPENET_SYNSETS[cls]).glob(
            "**/models/*.obj"))
        for p in paths[:num_perclass]:
            v, f, _, n = read_obj(p)
            diffs = v.max(axis=0) - v.min(axis=0)
            v = v / (0.5 * diffs.max())
            v = v - (v.min(axis=0) + 1)
            objs.append((v, f, n))
    return objs


def build_scene(rng: np.random.RandomState, objs, min_z=0.0):
    """Background board + 4 random objects: (verts, faces, colors,
    normals)."""
    verts_l, faces_l, colors_l, normals_l = [], [], [], []

    # Background board: a 16x16-tile grid, not two large triangles: the
    # rasterizer drops every triangle with a vertex behind the camera
    # (native/render.cpp has no near-plane clipping), so one large quad
    # vanishes under the slightest camera rotation. +-24 units at z 3-5
    # cover the ~53 deg field of view.
    grid = np.linspace(-24.0, 24.0, 17, dtype=np.float32)
    gx, gy = np.meshgrid(grid, grid)
    v = np.stack([gx, gy, np.zeros_like(gx)], axis=-1).reshape(-1, 3)
    v[:, 2] += rng.uniform(3, 5)
    ii = np.arange(16)
    q = (ii[:, None] * 17 + ii[None, :]).reshape(-1)      # top-left corners
    f = np.concatenate([
        np.stack([q, q + 1, q + 17], axis=1),
        np.stack([q + 1, q + 18, q + 17], axis=1)], axis=0).astype(np.int32)
    n = np.tile(np.array([0, 0, -1], np.float32), (v.shape[0], 1))
    c = np.empty_like(v)
    c[:] = rng.uniform(0, 1, size=(3,))
    verts_l.append(v.astype(np.float32))
    faces_l.append(f)
    normals_l.append(n)
    colors_l.append(c)

    for _ in range(4):
        v, f, n = objs[rng.randint(0, len(objs))]
        v, n = v.copy(), n.copy()
        s = rng.uniform(0.25, 1)
        v = v * s
        R = g3.rotm_from_quat(g3.quat_random(rng=rng))
        v = v @ R.T
        n = n @ R.T
        v[:, 2] += -v[:, 2].min() + min_z + rng.uniform(0.5, 3)
        v[:, :2] += rng.uniform(-1, 1, size=(1, 2))
        c = np.empty_like(v)
        c[:] = rng.uniform(0, 1, size=(3,))
        verts_l.append(v.astype(np.float32))
        faces_l.append(f)
        normals_l.append(n.astype(np.float32))
        colors_l.append(c)

    verts, faces = g3.stack_mesh(verts_l, faces_l)
    normals = np.vstack(normals_l).astype(np.float32)
    colors = np.vstack(colors_l).astype(np.float32)
    return verts, faces, colors, normals


# -------------------------------------------------------------- main
def _edge_map(ambient: np.ndarray) -> np.ndarray:
    """The ambient's 5x5 Sobel magnitude less 0.8, normalised by LCN
    (radius 5) and clipped to [0, 1]."""
    sx = sobel5(ambient, 1, 0)
    sy = sobel5(ambient, 0, 1)
    grad = np.maximum(np.sqrt(sx ** 2 + sy ** 2) - 0.8, 0.0)
    return np.clip(_np_lcn(grad, 5, 0.1), 0.0, 1.0)


def create_sample(pattern_type, out_root, idx, n_samples, imsize_proj,
                  imsize, pattern, K_proj, K, K_processed, baseline,
                  blend_im, objs, track_length=4, textured=False):
    """Render sample ``idx`` and write ``out_root/<idx:08d>/frames.hdf5``.
    ``pattern`` is the projector image, best grayed once by the caller."""
    tic = time.time()
    rng = np.random.RandomState(idx)

    verts, faces, colors, normals = build_scene(rng, objs)
    data = RenderInput(verts, faces, colors, normals)

    # --textured: the albedo texture's parameters are drawn once a sample,
    # so the texture stays fixed to the scene over the track's frames
    tex = {}
    ka, kd = 0.5, 1.5
    if textured:
        tex = dict(tex_amp=rng.uniform(0.65, 0.9),
                   tex_scale=rng.uniform(3.0, 8.0),
                   tex_offset=tuple(rng.uniform(-50, 50, 3)))
        # ka + kd <= 1: the default 0.5 / 1.5 saturates bright surfaces at
        # 1.0 and would flatten the texture
        ka, kd = 0.4, 0.6

    center = np.array([0, 0, 3], np.float32)
    basevec = np.array([-baseline, 0, 0], np.float32)
    cam_base = rng.uniform(-0.2, 0.2, 3)
    blend = float(np.clip(blend_im + rng.uniform(-0.1, 0.1), 0, 1))
    d_beta = 0.0 if pattern_type == "default" else 0.35

    ret = {k: [] for k in ("im", "ambient", "grad", "disp", "R", "t")}
    if pattern_type == "real":
        # the stand-in for the semi-global-matching disparities of real
        # captures (the warmup loss reads them): the rendered disparity
        # with correlated noise and invalid dropouts
        ret["sgm_disp"] = []
    pat_gray = pattern.mean(axis=2) if pattern.ndim == 3 else pattern
    del pattern
    for _ in range(track_length):
        cam_pos = (cam_base + rng.uniform(-0.1, 0.1, 3)).astype(np.float32)
        if np.linalg.norm(cam_pos[:2]) < 1e-9:
            Rcam = np.eye(3, dtype=np.float32)
        else:
            Rcam = lookat_rotation(center, cam_pos)
        tcam = (-Rcam @ cam_pos).astype(np.float32)
        tproj = tcam + basevec

        H, W = imsize
        cam = Camera(K[0, 0], K[1, 1], K[0, 2], K[1, 2], Rcam, tcam, W, H)
        proj = Camera(K_proj[0, 0], K_proj[1, 1], K_proj[0, 2], K_proj[1, 2],
                      Rcam, tproj, imsize_proj[1], imsize_proj[0])

        r = Renderer(cam, Shader(ka, kd, 0.0, 10, **tex))
        r.mesh_proj(data, proj, pat_gray, d_alpha=0.0, d_beta=d_beta)

        ir = r.color()
        depth = r.depth()
        ambient = r.normal()

        focal = K_processed[0, 0]
        disp = np.where(depth > 0, baseline * focal / np.maximum(depth, 1e-9),
                        0.0).astype(np.float32)
        im = blend * ir + (1 - blend) * ambient
        grad = _edge_map(ambient)

        ret["R"].append(Rcam)
        ret["t"].append(tcam)
        for key, val in (("ambient", ambient), ("grad", grad), ("im", im),
                         ("disp", disp)):
            ret[key].append(
                post_process(pattern_type, val)[None].astype(np.float32))
        if pattern_type == "real":
            sgm = disp + rng.normal(0, 0.75, disp.shape).astype(np.float32)
            sgm[rng.rand(*sgm.shape) < 0.25] = 0.0
            ret["sgm_disp"].append(
                post_process(pattern_type, np.maximum(sgm, 0.0))[None]
                .astype(np.float32))

    out_dir = Path(out_root) / f"{idx:08d}"
    out_dir.mkdir(exist_ok=True, parents=True)
    hdf5.write_hdf5(out_dir / "frames.hdf5",
                    {k: np.stack(v, axis=0) for k, v in ret.items()})
    print(f"sample {idx + 1}/{n_samples} took {time.time() - tic:.2f}s",
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("pattern_type", default="default", nargs="?",
                    choices=["default", "kinect", "real"])
    ap.add_argument("--n_samples", type=int, default=2 ** 10 + 2 ** 13)
    ap.add_argument("--objects", default="auto",
                    choices=["auto", "shapenet", "procedural"])
    ap.add_argument("--pattern_path", default=None,
                    help="projector pattern PNG; procedural dots if absent")
    ap.add_argument("--data_dir", default=None)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--textured", action="store_true",
                    help="per-scene procedural albedo texture (3D value "
                         "noise in the renderer): the scene-fixed texture "
                         "that image-based optical flow training needs")
    args = ap.parse_args(argv)

    np.random.seed(42)
    paths = load_paths()
    out_root = Path(args.data_dir or paths["DATA_DIR"])
    out_root.mkdir(parents=True, exist_ok=True)

    imsize_proj, imsize, K_proj, K, baseline = camera_config(args.pattern_type)
    blend_im = 0.6

    if args.pattern_path:
        pattern = read_pattern_file(args.pattern_path, args.pattern_type,
                                    imsize_proj)
    else:
        pattern = make_dot_pattern(imsize_proj[0], imsize_proj[1],
                                   n_dots=imsize_proj[0] * imsize_proj[1] // 48)

    objs = []
    if args.objects in ("auto", "shapenet"):
        sn = paths.get("SHAPENET_DIR", "")
        if sn and Path(sn).exists():
            objs = load_shapenet_objects(sn)
    if not objs:
        if args.objects == "shapenet":
            raise FileNotFoundError("SHAPENET_DIR not configured/found")
        rng = np.random.RandomState(7)
        objs = [procedural_object(rng) for _ in range(40)]
        print(f"using {len(objs)} procedural objects")

    # camera-space pattern for the loss (settings.pkl)
    mapped = map_pattern_to_camera(pattern, K_proj, K, imsize)
    pattern_processed, K_processed = post_process(args.pattern_type, mapped, K)
    imsize_processed = pattern_processed.shape[:2]
    save_settings(out_root / "settings.pkl",
                  Settings(imsize=tuple(imsize_processed),
                           pattern=pattern_processed, baseline=baseline,
                           K=K_processed))

    # grayed once here: a mean over the (4096, 4096, 3) pattern costs
    # seconds, and create_sample would take it for every sample
    pat_gray = (pattern.mean(axis=2).astype(np.float32)
                if pattern.ndim == 3 else pattern)
    for idx in range(args.start, args.n_samples):
        create_sample(args.pattern_type, out_root, idx, args.n_samples,
                      imsize_proj, imsize, pat_gray, K_proj, K, K_processed,
                      baseline, blend_im, objs, textured=args.textured)


if __name__ == "__main__":
    main()
