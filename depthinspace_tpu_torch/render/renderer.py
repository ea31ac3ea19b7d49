"""ctypes binding of the CPU structured-light renderer, port of
``depthinspace_tpu/render/renderer.py``: ``Camera``, ``Shader``,
``RenderInput`` and ``Renderer`` over the C ABI ``dis_render_mesh_proj`` of
``native/render.cpp`` (a z-buffered rasterizer: depth, the projector's
pattern as the IR image, headlight Lambert shading as the ambient image).

The library is built from ``native/render.cpp`` with ``g++`` at first use,
into ``build/render/<hash>/librender.so`` at the repository root
(``utils/cbuild.py``); the hash covers the source and the flags, so an
edited source is rebuilt. The
flags carry no ``-march``, and ``-ffp-contract=off`` keeps the compiler
from fusing multiply-adds, so one seed renders the same images on any
x86-64 host. Each process compiles into a file of its own and renames it
into place, so generator processes started together do not collide. The
``native/librender.so`` beside the source is never loaded: it is an older
build without the procedural texture. A failed build raises with the
compiler's output.

The renderer runs on the host; it has no device path.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..utils import cbuild

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "render.cpp"
BUILD_ROOT = _ROOT / "build" / "render"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-ffp-contract=off")

_lib = None


def library_path() -> Path:
    return cbuild.library_path(SOURCE, BUILD_ROOT, "librender.so", CXX_FLAGS)


def build() -> tuple[Path, float]:
    """Compile the library unless it is already built. Returns (path,
    seconds spent compiling; 0.0 when it was built before)."""
    return cbuild.build_library(SOURCE, BUILD_ROOT, "librender.so",
                                CXX_FLAGS)


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.dis_render_mesh_proj.argtypes = [
        f32p, ctypes.c_int, i32p, ctypes.c_int, f32p, f32p,
        f32p, f32p, f32p, ctypes.c_int, ctypes.c_int,
        f32p, ctypes.c_int, ctypes.c_int, f32p, f32p, f32p]
    lib.dis_render_mesh_proj.restype = None
    _lib = lib
    return lib


def _f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


class Camera:
    """Pinhole camera: intrinsics + world->camera pose (X_c = R X_w + t)."""

    def __init__(self, fx, fy, px, py, R, t, width, height):
        self.fx, self.fy, self.px, self.py = fx, fy, px, py
        self.R = _f32(R).reshape(3, 3)
        self.t = _f32(t).reshape(3)
        self.width, self.height = int(width), int(height)

    def params(self) -> np.ndarray:
        return np.concatenate([
            np.array([self.fx, self.fy, self.px, self.py], np.float32),
            self.R.ravel(), self.t]).astype(np.float32)


class Shader:
    """Lambert/Phong shading + projector distance attenuation.

    ``tex_amp > 0`` modulates the albedo per pixel by 2-octave 3D value
    noise of the world position (``native/render.cpp``
    ``albedo_texture``): texture fixed to the scene, which image-based
    optical flow needs on the ambient renders."""

    def __init__(self, ka=0.5, kd=1.5, ks=0.0, alpha=10.0,
                 d_alpha=0.0, d_beta=0.0, tex_amp=0.0, tex_scale=4.0,
                 tex_offset=(0.0, 0.0, 0.0)):
        self.params_arr = np.array(
            [ka, kd, ks, alpha, d_alpha, d_beta, tex_amp, tex_scale,
             tex_offset[0], tex_offset[1], tex_offset[2]], np.float32)


class RenderInput:
    """Triangle mesh with per-vertex colors and normals."""

    def __init__(self, verts, faces, colors=None, normals=None):
        self.verts = _f32(verts).reshape(-1, 3)
        self.faces = np.ascontiguousarray(faces, np.int32).reshape(-1, 3)
        if colors is None:
            colors = np.ones_like(self.verts)
        self.colors = _f32(colors).reshape(-1, 3)
        if normals is None:
            from ..utils.geometry3d import mesh_vertex_normals
            normals = mesh_vertex_normals(self.verts, self.faces)
        self.normals = _f32(normals).reshape(-1, 3)


class Renderer:
    """Z-buffered rasterizer producing depth / IR (pattern-projected) /
    ambient images for a camera+projector rig."""

    def __init__(self, cam: Camera, shader: Shader):
        self.cam = cam
        self.shader = shader
        self._depth = None
        self._ir = None
        self._ambient = None

    def mesh_proj(self, data: RenderInput, proj: Camera,
                  pattern: np.ndarray, d_alpha: float = 0.0,
                  d_beta: float = 0.0):
        """Render; ``pattern`` is the projector image (H_p, W_p[, 3])."""
        lib = _load_lib()
        if pattern.ndim == 3:
            pattern = pattern.mean(axis=2)
        pattern = _f32(pattern)
        ph, pw = pattern.shape
        if (pw, ph) != (proj.width, proj.height):
            raise ValueError(f"pattern {pattern.shape} vs projector "
                             f"{(proj.height, proj.width)}")
        H, W = self.cam.height, self.cam.width
        depth = np.zeros((H, W), np.float32)
        ir = np.zeros((H, W), np.float32)
        ambient = np.zeros((H, W), np.float32)
        shader = self.shader.params_arr.copy()
        shader[4] = d_alpha
        shader[5] = d_beta

        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        cp = lambda a: a.ctypes.data_as(f32p)
        lib.dis_render_mesh_proj(
            cp(data.verts), len(data.verts),
            data.faces.ctypes.data_as(i32p), len(data.faces),
            cp(data.colors), cp(data.normals),
            cp(self.cam.params()), cp(proj.params()),
            cp(pattern), ph, pw, cp(shader), H, W,
            cp(depth), cp(ir), cp(ambient))
        self._depth, self._ir, self._ambient = depth, ir, ambient
        return self

    def depth(self) -> np.ndarray:
        return self._depth

    def color(self) -> np.ndarray:
        """IR (pattern-projected) image."""
        return self._ir

    def normal(self) -> np.ndarray:
        """Ambient (headlight-shaded) image."""
        return self._ambient
