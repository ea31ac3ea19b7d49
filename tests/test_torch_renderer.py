"""render/renderer.py of the port: the library it builds from
native/render.cpp, the JAX package's three renderer checks on it (the
procedural texture among them, which this build carries), and the port's
binding against the JAX package's binding on the same library."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import depthinspace_tpu.render.renderer as jr
from depthinspace_tpu_torch.render import Camera, RenderInput, Renderer, Shader
from depthinspace_tpu_torch.render import renderer as pr
from depthinspace_tpu_torch.utils.geometry3d import stack_mesh, xyplane

ROOT = Path(__file__).resolve().parents[1]


def _plane_scene(z=3.0, half=10.0):
    v, f, n = xyplane(z=z)
    v = v.copy()
    v[:, :2] *= half
    c = np.full_like(v, 0.8)
    return v, f, c


def test_library_is_built_from_the_source_under_build_render():
    so, _ = pr.build()
    assert so == pr.library_path()
    assert so.parent.parent == ROOT / "build" / "render"
    assert so.name == "librender.so" and so.exists()
    assert pr.SOURCE == ROOT / "native" / "render.cpp"
    assert "-march=native" not in pr.CXX_FLAGS
    assert "-ffp-contract=off" in pr.CXX_FLAGS
    assert pr.build() == (so, 0.0)          # built once


def test_process_maps_the_port_build_and_never_native_librender():
    """A fresh process renders through the port and lists the shared
    objects it mapped: the build under build/render, not
    native/librender.so."""
    code = textwrap.dedent("""
        import numpy as np
        from depthinspace_tpu_torch.render import (Camera, RenderInput,
                                                   Renderer, Shader)
        from depthinspace_tpu_torch.utils.geometry3d import xyplane
        v, f, _ = xyplane(z=3.0)
        cam = Camera(40, 40, 28, 32, np.eye(3), np.zeros(3), 56, 64)
        Renderer(cam, Shader()).mesh_proj(RenderInput(v * 10, f), cam,
                                          np.ones((64, 56), np.float32))
        maps = open("/proc/self/maps").read()
        print("\\n".join(sorted({ln.split()[-1] for ln in maps.splitlines()
                                 if "librender" in ln})))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mapped = out.stdout.split()
    assert mapped == [str(pr.library_path())], mapped


def test_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "render.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pr, "SOURCE", bad)
    monkeypatch.setattr(pr, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pr.build()
    assert not list((tmp_path / "build").rglob("*.so"))


def test_renders_fronto_parallel_plane():
    H, W = 64, 56
    f = 40.0
    v, faces, colors = _plane_scene(z=3.0)
    data = RenderInput(v, faces, colors)
    cam = Camera(f, f, W / 2, H / 2, np.eye(3), np.zeros(3), W, H)
    proj = Camera(f, f, W / 2, H / 2, np.eye(3), np.array([-0.025, 0, 0]),
                  W, H)
    pattern = np.zeros((H, W), np.float32)
    pattern[::4, ::4] = 1.0

    r = Renderer(cam, Shader(0.5, 1.5, 0.0, 10))
    r.mesh_proj(data, proj, pattern)

    depth = r.depth()
    assert depth.shape == (H, W)
    covered = depth > 0
    assert covered.mean() > 0.95
    np.testing.assert_allclose(depth[covered], 3.0, rtol=1e-4)
    assert r.normal()[covered].min() > 0.1
    ir = r.color()
    assert ir.max() > 0.05
    assert (ir < 0.01).mean() > 0.5


def test_occlusion_and_shadow():
    H, W = 64, 56
    f = 40.0
    v1, f1, c1 = _plane_scene(z=4.0)
    v2, f2, _ = xyplane(z=2.0)
    v2 = v2.copy()
    v2[:, :2] *= 0.5
    c2 = np.full_like(v2, 0.5)
    verts, faces = stack_mesh([v1, v2], [f1, f2])
    data = RenderInput(verts, faces, np.vstack([c1, c2]))

    cam = Camera(f, f, W / 2, H / 2, np.eye(3), np.zeros(3), W, H)
    proj = Camera(f, f, W / 2, H / 2, np.eye(3), np.array([-0.4, 0, 0]), W, H)
    r = Renderer(cam, Shader(0.5, 1.5, 0.0, 10))
    r.mesh_proj(data, proj, np.ones((H, W), np.float32))
    depth = r.depth()

    assert abs(depth[H // 2, W // 2] - 2.0) < 1e-3
    assert abs(depth[2, 2] - 4.0) < 1e-3
    ir = r.color()
    near_mask = np.abs(depth - 2.0) < 1e-3
    far_mask = np.abs(depth - 4.0) < 1e-3
    assert ir[near_mask].mean() > 0.05
    shadow_zone = far_mask & (ir < 1e-6)
    assert shadow_zone.sum() > 10, "expected projector shadow on far plane"


def test_procedural_albedo_texture():
    """tex_amp > 0 adds scene-fixed variance to the ambient image; the
    texture moves rigidly with the scene under camera translation and
    depth is untouched."""
    H, W, f = 64, 56, 40.0
    v, faces, colors = _plane_scene(z=3.0)
    data = RenderInput(v, faces, colors)
    proj = Camera(f, f, W / 2, H / 2, np.eye(3), np.array([-0.025, 0, 0]),
                  W, H)
    pattern = np.zeros((H, W), np.float32)
    pattern[::4, ::4] = 1.0
    tex = dict(tex_amp=0.5, tex_scale=3.0, tex_offset=(1.0, 2.0, 3.0))

    def render(cam_t, **shader_kw):
        cam = Camera(f, f, W / 2, H / 2, np.eye(3), cam_t, W, H)
        r = Renderer(cam, Shader(0.5, 1.5, 0.0, 10, **shader_kw))
        r.mesh_proj(data, proj, pattern)
        return r

    r_flat = render(np.zeros(3))
    r_tex = render(np.zeros(3), **tex)
    cov = r_flat.depth() > 0
    np.testing.assert_allclose(r_flat.depth(), r_tex.depth())
    assert r_flat.normal()[cov].std() < 1e-5
    assert r_tex.normal()[cov].std() > 0.01

    # camera shifted +0.1 at z=3 -> image content shifts fx*0.1/3 = -1.33 px
    # (scene-fixed texture); integer cross-correlation peak at -1
    r_tex2 = render(np.array([0.1, 0.0, 0.0]), **tex)
    a, b = r_tex.normal(), r_tex2.normal()
    prod = np.fft.ifft2(np.fft.fft2(a) * np.conj(np.fft.fft2(b))).real
    dy, dx = np.unravel_index(prod.argmax(), prod.shape)
    assert dy == 0 and dx in (W - 1, W - 2), (dy, dx)


def test_binding_matches_jax_binding_on_the_same_library(monkeypatch):
    """The same scene through both bindings, the JAX one pointed at the
    port's build: depth, IR and ambient equal bit for bit, with texture,
    attenuation and a 3-channel pattern."""
    monkeypatch.setattr(jr, "_LIB_PATH", pr.build()[0])
    monkeypatch.setattr(jr, "_lib", None)
    rng = np.random.RandomState(2)
    H, W, f = 48, 40, 30.0
    v1, f1, c1 = _plane_scene(z=4.0)
    v2, f2, _ = xyplane(z=2.5)
    verts, faces = stack_mesh([v1, v2 * [0.6, 0.6, 1]], [f1, f2])
    colors = rng.uniform(0, 1, (len(verts), 3)).astype(np.float32)
    pattern = rng.rand(60, 50, 3).astype(np.float32)
    R = np.array([[0.995, 0, 0.0998], [0, 1, 0], [-0.0998, 0, 0.995]])
    out = []
    for mod in (jr, pr):
        cam = mod.Camera(f, f, W / 2, H / 2, R, [0.05, 0, 0], W, H)
        proj = mod.Camera(35.0, 35.0, 25, 30, R, [0.0, 0, 0], 50, 60)
        r = mod.Renderer(cam, mod.Shader(0.4, 0.6, 0.2, 10, tex_amp=0.7,
                                         tex_scale=5.0,
                                         tex_offset=(3.0, -2.0, 1.0)))
        r.mesh_proj(mod.RenderInput(verts, faces, colors), proj, pattern,
                    d_alpha=0.1, d_beta=0.35)
        out.append((r.depth(), r.color(), r.normal()))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    assert (out[1][0] > 0).mean() > 0.9 and out[1][1].max() > 0
