"""utils/geometry3d.py of the port against the JAX package's: every public
function on the same seeded numpy inputs. Both are the same numpy code, so
the outputs are held bit for bit."""

import inspect

import numpy as np
import pytest

from depthinspace_tpu.utils import geometry3d as ref
from depthinspace_tpu_torch.utils import geometry3d as port


def _rot(rng):
    return ref.rotm_from_quat(ref.quat_random(rng=rng))


def _rots(rng, n=5):
    return np.stack([_rot(rng) for _ in range(n)])


def _quats(rng, n=5):
    return rng.normal(size=(n, 4))


def _mesh(rng):
    v, f = ref.icosahedron()
    return v + 0.05 * rng.normal(size=v.shape).astype(np.float32), f


def _proj(rng):
    K = np.array([[500.0, 0.5, 320.0], [0, 480.0, 240.0], [0, 0, 1]])
    return ref.compose_projection_matrix(K, _rot(rng), rng.normal(size=3))


# name -> inputs from a RandomState; the RandomState itself where the
# function draws (a fresh one of the same seed for each package)
CASES = {
    "quat_identity": lambda r: ((3,), {}),
    "quat_random": lambda r: ((), {"rng": r, "n": 4}),
    "quat_normalize": lambda r: ((_quats(r),), {}),
    "quat_conjugate": lambda r: ((_quats(r),), {}),
    "quat_mul": lambda r: ((_quats(r), _quats(r)), {}),
    "quat_slerp": lambda r: ((r.normal(size=4), r.normal(size=4), 0.3), {}),
    "rotm_from_quat": lambda r: ((r.normal(size=4),), {}),
    "quat_from_rotm": lambda r: ((_rot(r),), {}),
    "rotm_from_axisangle": lambda r: ((r.normal(size=3), 1.1), {}),
    "skew": lambda r: ((r.normal(size=3),), {}),
    "rotm_from_euler_xyz": lambda r: (tuple(r.uniform(-3, 3, 3)), {}),
    "so3_log": lambda r: ((_rot(r),), {}),
    "so3_exp": lambda r: ((r.normal(size=3),), {}),
    "se3_exp": lambda r: ((r.normal(size=6),), {}),
    "se3_log": lambda r: ((ref.se3_exp(r.normal(size=6)),), {}),
    "rotm_distance_identity": lambda r: ((_rots(r), _rots(r)), {}),
    "rotm_distance_geodesic": lambda r: ((_rots(r), _rots(r)), {}),
    "rotm_distance_geodesic_unit_sphere": lambda r: ((_rots(r), _rots(r)),
                                                     {}),
    "quat_distance_angle": lambda r: ((_quats(r), _quats(r)), {}),
    "quat_distance_mineucl": lambda r: ((_quats(r), _quats(r)), {}),
    "quat_distance_normdiff": lambda r: ((_quats(r), _quats(r)), {}),
    "xyplane": lambda r: ((2.5,), {"interleaved": True}),
    "stack_mesh": lambda r: (([_mesh(r)[0], _mesh(r)[0]],
                              [_mesh(r)[1], _mesh(r)[1]]), {}),
    "mesh_triangle_areas": lambda r: (_mesh(r), {}),
    "mesh_vertex_normals": lambda r: (_mesh(r), {}),
    "rot_x": lambda r: ((r.normal(),), {}),
    "rot_y": lambda r: ((r.normal(),), {}),
    "rot_z": lambda r: ((r.normal(),), {}),
    "rotm_from_xyz": lambda r: ((r.uniform(-3, 3, 3),), {}),
    "xyz_from_rotm": lambda r: ((_rot(r),), {}),
    "rotm_from_lookat": lambda r: ((r.normal(size=3),), {}),
    "nearest_orthogonal_matrix": lambda r: ((r.normal(size=(3, 3)),), {}),
    "axisangle_from_rotm": lambda r: ((_rot(r),), {}),
    "axisangle_from_quat": lambda r: ((_quats(r),), {}),
    "axisangle_apply": lambda r: ((r.normal(size=3), r.normal(size=(6, 3))),
                                  {}),
    "cart_to_spherical": lambda r: ((r.normal(size=(6, 3)),), {}),
    "spherical_to_cart": lambda r: ((r.uniform(0, 3, (6, 3)),), {}),
    "spherical_random": lambda r: ((), {"r": 2.0, "n": 5, "rng": r}),
    "center_pcl": lambda r: ((r.normal(size=(9, 3)),), {"robust": True}),
    "to_homogeneous": lambda r: ((r.normal(size=(6, 3)),), {}),
    "from_homogeneous": lambda r: ((r.uniform(1, 2, (6, 4)),), {}),
    "project_xyz": lambda r: ((r.normal(size=(6, 3)) + [0, 0, 5],
                               np.diag([500.0, 500.0, 1.0]), _rot(r),
                               r.normal(size=3)), {}),
    "relative_motion": lambda r: ((_rot(r), r.normal(size=3), _rot(r),
                                   r.normal(size=3)), {}),
    "translation_to_cameracenter": lambda r: ((_rot(r), r.normal(size=3)),
                                              {}),
    "cameracenter_to_translation": lambda r: ((_rot(r), r.normal(size=3)),
                                              {}),
    "compose_projection_matrix": lambda r: ((np.eye(3) * 300, _rot(r),
                                             r.normal(size=3)), {}),
    "decompose_projection_matrix": lambda r: ((_proj(r),), {}),
    "point_plane_distance": lambda r: ((r.normal(size=(7, 3)),
                                        r.normal(size=4)), {}),
    "fit_plane": lambda r: ((r.normal(size=(9, 3)) * [3, 2, 0.01],), {}),
    "tetrahedron": lambda r: ((), {}),
    "cube": lambda r: ((), {}),
    "octahedron": lambda r: ((), {}),
    "icosahedron": lambda r: ((), {}),
    "normalize_mesh": lambda r: ((_mesh(r)[0] * 3 + 1,), {}),
    "mesh_independent_verts": lambda r: (_mesh(r) + (r.normal(size=(12, 3)),),
                                         {}),
    "subdivide_mesh": lambda r: (_mesh(r), {"n": 2}),
    "mesh_adjust_winding_order": lambda r: (
        (_mesh(r)[0], _mesh(r)[1][:, [0, 2, 1]],
         ref.mesh_vertex_normals(*_mesh(r))), {}),
    "pcl_to_shapecl": lambda r: ((r.normal(size=(4, 3)),),
                                 {"shape": "octahedron", "width": 0.5,
                                  "colors": r.uniform(0, 1, (4, 3))}),
}


def _public(mod):
    return {n for n, f in vars(mod).items() if callable(f)
            and not n.startswith("_") and inspect.isfunction(f)
            and f.__module__ == mod.__name__}


def test_cases_cover_every_function():
    """The cases name every public function of the JAX module, and the
    port defines each of them."""
    names = _public(ref) | {"rotm_distance_geodesic_unit_sphere"}
    assert names == set(CASES)
    assert names <= set(vars(port))


def _assert_same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_geometry3d_function_matches_jax_package(name):
    args_r, kw_r = CASES[name](np.random.RandomState(3))
    args_p, kw_p = CASES[name](np.random.RandomState(3))
    _assert_same(getattr(ref, name)(*args_r, **kw_r),
                 getattr(port, name)(*args_p, **kw_p))
