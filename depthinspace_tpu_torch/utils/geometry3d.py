"""Host-side 3D geometry (numpy), port of
``depthinspace_tpu/utils/geometry3d.py``, whole: rotations, quaternions,
SE3, rotation distances, primitive meshes and mesh operations. The data
generator (``tools/create_syn_data.py``) draws its scenes with
``quat_random``, ``rotm_from_quat``, ``stack_mesh`` and
``mesh_vertex_normals``; the rotation metrics of ``utils/metric.py`` use
the distance functions. Conventions: quaternions are (w, x, y, z);
rotation matrices act on column vectors.
"""

from __future__ import annotations

import numpy as np


# ----------------------------------------------------------- quaternions
def quat_identity(n: int = 1) -> np.ndarray:
    q = np.zeros((n, 4))
    q[:, 0] = 1
    return q.squeeze()


def quat_random(rng=None, n: int = 1) -> np.ndarray:
    """Uniform random unit quaternion(s) (Shoemake's method)."""
    rng = rng or np.random
    u1, u2, u3 = rng.uniform(0, 1, (3, n))
    q = np.stack([
        np.sqrt(1 - u1) * np.sin(2 * np.pi * u2),
        np.sqrt(1 - u1) * np.cos(2 * np.pi * u2),
        np.sqrt(u1) * np.sin(2 * np.pi * u3),
        np.sqrt(u1) * np.cos(2 * np.pi * u3),
    ], axis=1)
    return q[0] if n == 1 else q


def quat_normalize(q):
    q = np.asarray(q, dtype=np.float64)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def quat_conjugate(q):
    q = np.asarray(q)
    out = q.copy()
    out[..., 1:] *= -1
    return out


def quat_mul(a, b):
    a, b = np.asarray(a), np.asarray(b)
    w1, x1, y1, z1 = np.moveaxis(a, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(b, -1, 0)
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def quat_slerp(q0, q1, t):
    q0, q1 = quat_normalize(q0), quat_normalize(q1)
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        return quat_normalize(q0 + t * (q1 - q0))
    theta = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * theta) * q0 + np.sin(t * theta) * q1) / np.sin(theta)


def rotm_from_quat(q) -> np.ndarray:
    """Unit quaternion (w,x,y,z) -> 3x3 rotation matrix."""
    w, x, y, z = quat_normalize(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def quat_from_rotm(R) -> np.ndarray:
    """3x3 rotation matrix -> unit quaternion (w,x,y,z), Shepperd's method."""
    R = np.asarray(R, dtype=np.float64)
    t = np.trace(R)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        return quat_normalize(np.array([
            0.25 / s, (R[2, 1] - R[1, 2]) * s,
            (R[0, 2] - R[2, 0]) * s, (R[1, 0] - R[0, 1]) * s]))
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 0.0))
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return quat_normalize(q)


# ------------------------------------------------------- rotations (misc)
def rotm_from_axisangle(axis, angle) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    K = skew(axis)
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def skew(v) -> np.ndarray:
    x, y, z = v
    return np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]], dtype=np.float64)


def rotm_from_euler_xyz(rx, ry, rz) -> np.ndarray:
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def so3_log(R) -> np.ndarray:
    """Rotation matrix -> axis-angle vector (log map)."""
    R = np.asarray(R, np.float64)
    cos_t = np.clip((np.trace(R) - 1) / 2, -1, 1)
    theta = np.arccos(cos_t)
    if theta < 1e-10:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return theta / (2 * np.sin(theta)) * w


def so3_exp(w) -> np.ndarray:
    theta = np.linalg.norm(w)
    if theta < 1e-10:
        return np.eye(3)
    return rotm_from_axisangle(w / theta, theta)


def se3_exp(xi) -> np.ndarray:
    """Twist (v, w) -> 4x4 transform."""
    v, w = np.asarray(xi[:3]), np.asarray(xi[3:])
    theta = np.linalg.norm(w)
    R = so3_exp(w)
    if theta < 1e-10:
        V = np.eye(3)
    else:
        K = skew(w / theta)
        V = (np.eye(3) + (1 - np.cos(theta)) / theta * K
             + (theta - np.sin(theta)) / theta * (K @ K))
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def se3_log(T) -> np.ndarray:
    R, t = T[:3, :3], T[:3, 3]
    w = so3_log(R)
    theta = np.linalg.norm(w)
    if theta < 1e-10:
        V_inv = np.eye(3)
    else:
        K = skew(w / theta)
        V = (np.eye(3) + (1 - np.cos(theta)) / theta * K
             + (theta - np.sin(theta)) / theta * (K @ K))
        V_inv = np.linalg.inv(V)
    return np.concatenate([V_inv @ t, w])


# ---------------------------------------------------- rotation distances
def rotm_distance_identity(es, ta) -> np.ndarray:
    """||I - R_es R_ta^T||_F per pair; es, ta: (N, 3, 3)."""
    rel = np.einsum("nij,nkj->nik", es, ta)
    return np.linalg.norm(np.eye(3)[None] - rel, axis=(1, 2))


def rotm_distance_geodesic(es, ta) -> np.ndarray:
    """Geodesic angle between rotations; es, ta: (N, 3, 3)."""
    rel = np.einsum("nij,nkj->nik", es, ta)
    tr = np.trace(rel, axis1=1, axis2=2)
    return np.arccos(np.clip((tr - 1) / 2, -1, 1))


# alias matching the reference metric's name (co/metric.py:186)
rotm_distance_geodesic_unit_sphere = rotm_distance_geodesic


def quat_distance_angle(es, ta) -> np.ndarray:
    d = np.abs(np.sum(quat_normalize(es) * quat_normalize(ta), axis=-1))
    return 2 * np.arccos(np.clip(d, -1, 1))


def quat_distance_mineucl(es, ta) -> np.ndarray:
    return np.minimum(np.linalg.norm(es - ta, axis=-1),
                      np.linalg.norm(es + ta, axis=-1))


def quat_distance_normdiff(es, ta) -> np.ndarray:
    return 1 - np.abs(np.sum(quat_normalize(es) * quat_normalize(ta), axis=-1))


# ----------------------------------------------------------------- meshes
def xyplane(z: float = 0.0, interleaved: bool = False):
    """Unit xy quad at depth z: (verts, faces, normals).

    interleaved=True returns two independent triangles (6 verts, shared
    edge split by eps) like the reference co/geometry.py:662-674 — used
    for per-triangle attribute rendering.
    """
    if interleaved:
        eps = 1e-6
        v = np.array([[-1, -1, z], [-1, 1, z], [1, 1, z],
                      [1 - eps, 1, z], [1 - eps, -1, z], [-1 - eps, -1, z]],
                     np.float32)
        f = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    else:
        v = np.array([[-1, -1, z], [-1, 1, z], [1, 1, z], [1, -1, z]],
                     np.float32)
        f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    n = np.tile(np.array([[0, 0, -1]], np.float32), (len(v), 1))
    return v, f, n


def stack_mesh(verts_list, faces_list):
    """Concatenate meshes with face-index offsets."""
    verts, faces = [], []
    off = 0
    for v, f in zip(verts_list, faces_list):
        verts.append(np.asarray(v, np.float32))
        faces.append(np.asarray(f, np.int64) + off)
        off += len(v)
    return np.vstack(verts), np.vstack(faces).astype(np.int32)


def mesh_triangle_areas(verts, faces) -> np.ndarray:
    a = verts[faces[:, 1]] - verts[faces[:, 0]]
    b = verts[faces[:, 2]] - verts[faces[:, 0]]
    return 0.5 * np.linalg.norm(np.cross(a, b), axis=1)


def mesh_vertex_normals(verts, faces) -> np.ndarray:
    """Area-weighted per-vertex normals."""
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(norm, 1e-12)


# ------------------------------------------------ Euler / axis conversions
# (reference co/geometry.py:76-153 parity surface; fresh formulations)
def rot_x(a) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def rot_y(a) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def rot_z(a) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def rotm_from_xyz(xyz) -> np.ndarray:
    """R = Rz(z) @ Ry(y) @ Rx(x) — intrinsic x-y-z Euler angles."""
    x, y, z = np.asarray(xyz, np.float64)
    return rot_z(z) @ rot_y(y) @ rot_x(x)


def xyz_from_rotm(R) -> np.ndarray:
    """Inverse of :func:`rotm_from_xyz` (gimbal-safe branch at |cy|~0)."""
    R = np.asarray(R, np.float64)
    cy = np.hypot(R[0, 0], R[1, 0])
    if cy > 1e-9:
        x = np.arctan2(R[2, 1], R[2, 2])
        y = np.arctan2(-R[2, 0], cy)
        z = np.arctan2(R[1, 0], R[0, 0])
    else:
        x = np.arctan2(-R[1, 2], R[1, 1])
        y = np.arctan2(-R[2, 0], cy)
        z = 0.0
    return np.array([x, y, z])


def rotm_from_lookat(direction, up=None) -> np.ndarray:
    """Rotation whose +z axis points along ``direction``."""
    z = np.asarray(direction, np.float64)
    z = z / np.linalg.norm(z)
    up = np.array([0.0, 1.0, 0.0]) if up is None else np.asarray(up, float)
    x = np.cross(up, z)
    if np.linalg.norm(x) < 1e-12:
        x = np.array([1.0, 0.0, 0.0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)


def nearest_orthogonal_matrix(R) -> np.ndarray:
    """Closest (Frobenius) rotation to R via SVD with det correction."""
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    return U @ D @ Vt


def axisangle_from_rotm(R) -> np.ndarray:
    """(3,) rotation vector (axis * angle) — alias view of so3_log."""
    return so3_log(np.asarray(R, np.float64))


def axisangle_from_quat(q) -> np.ndarray:
    q = quat_normalize(q)
    # canonical sign (w >= 0) keeps the principal angle in [0, pi] so the
    # result agrees with so3_log's branch
    q = np.where(q[..., :1] < 0, -q, q)
    angle = 2.0 * np.arctan2(np.linalg.norm(q[..., 1:], axis=-1), q[..., 0])
    n = np.linalg.norm(q[..., 1:], axis=-1, keepdims=True)
    axis = q[..., 1:] / np.maximum(n, 1e-12)
    return axis * np.asarray(angle)[..., None]


def axisangle_apply(aa, x) -> np.ndarray:
    """Rotate point(s) x by rotation vector aa (Rodrigues)."""
    aa = np.asarray(aa, np.float64)
    x = np.asarray(x, np.float64)
    theta = np.linalg.norm(aa)
    if theta < 1e-12:
        return x.copy()
    k = aa / theta
    kx = np.cross(np.broadcast_to(k, x.shape), x)       # k x x per point
    return (x * np.cos(theta) + kx * np.sin(theta)
            + k * (x @ k)[..., None] * (1 - np.cos(theta)))


# ------------------------------------------------------ spherical / pcl
def cart_to_spherical(x) -> np.ndarray:
    """(..., 3) xyz -> (r, theta [polar, from +z], phi [azimuth])."""
    x = np.asarray(x, np.float64)
    r = np.linalg.norm(x, axis=-1)
    theta = np.arccos(np.clip(x[..., 2] / np.maximum(r, 1e-15), -1, 1))
    phi = np.arctan2(x[..., 1], x[..., 0])
    return np.stack([r, theta, phi], axis=-1)


def spherical_to_cart(s) -> np.ndarray:
    s = np.asarray(s, np.float64)
    r, theta, phi = s[..., 0], s[..., 1], s[..., 2]
    st = np.sin(theta)
    return np.stack([r * st * np.cos(phi), r * st * np.sin(phi),
                     r * np.cos(theta)], axis=-1)


def spherical_random(r=1.0, n=1, rng=None) -> np.ndarray:
    """Uniform points on the radius-r sphere."""
    rng = rng or np.random
    z = rng.uniform(-1, 1, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    s = np.sqrt(1 - z ** 2)
    out = r * np.stack([s * np.cos(phi), s * np.sin(phi), z], axis=-1)
    return out[0] if n == 1 else out


def center_pcl(pcl, robust=False) -> np.ndarray:
    """Subtract the (median if robust else mean) center; pcl (N, 3)."""
    pcl = np.asarray(pcl, np.float64)
    c = np.median(pcl, axis=0) if robust else pcl.mean(axis=0)
    return pcl - c


# --------------------------------------------- homogeneous / projections
def to_homogeneous(x) -> np.ndarray:
    x = np.asarray(x)
    return np.concatenate([x, np.ones_like(x[..., :1])], axis=-1)


def from_homogeneous(x) -> np.ndarray:
    x = np.asarray(x)
    return x[..., :-1] / x[..., -1:]


def project_xyz(xyz, K=None, R=None, t=None) -> np.ndarray:
    """World points (N, 3) -> pixel uv (N, 2) under K [R|t]."""
    xyz = np.asarray(xyz, np.float64)
    K = np.eye(3) if K is None else np.asarray(K, np.float64)
    R = np.eye(3) if R is None else np.asarray(R, np.float64)
    t = np.zeros(3) if t is None else np.asarray(t, np.float64).reshape(3)
    xc = xyz @ R.T + t
    uvw = xc @ K.T
    return uvw[..., :2] / np.maximum(uvw[..., 2:], 1e-15)


def relative_motion(R0, t0, R1, t1) -> tuple:
    """(R, t) taking frame-0 camera coordinates into frame 1
    (poses given as world->camera)."""
    R0, R1 = np.asarray(R0, np.float64), np.asarray(R1, np.float64)
    t0 = np.asarray(t0, np.float64).reshape(3)
    t1 = np.asarray(t1, np.float64).reshape(3)
    R = R1 @ R0.T
    t = t1 - R @ t0
    return R, t


def translation_to_cameracenter(R, t) -> np.ndarray:
    """World-space camera center C = -R^T t."""
    return -(np.asarray(R, np.float64).T @ np.asarray(t, np.float64)
             .reshape(3))


def cameracenter_to_translation(R, C) -> np.ndarray:
    return -(np.asarray(R, np.float64) @ np.asarray(C, np.float64)
             .reshape(3))


def compose_projection_matrix(K=None, R=None, t=None) -> np.ndarray:
    K = np.eye(3) if K is None else np.asarray(K, np.float64)
    R = np.eye(3) if R is None else np.asarray(R, np.float64)
    t = np.zeros(3) if t is None else np.asarray(t, np.float64).reshape(3)
    return K @ np.concatenate([R, t[:, None]], axis=1)


def decompose_projection_matrix(P) -> tuple:
    """P (3, 4) -> (K, R, t) with K upper triangular, positive diagonal,
    K[2,2]=1, det(R)=+1 (RQ decomposition via flipped QR)."""
    P = np.asarray(P, np.float64)
    M = P[:, :3]
    # RQ from QR of the antitranspose
    F = np.flipud(M).T
    Q, U = np.linalg.qr(F)
    K = np.flipud(U.T)[:, ::-1]
    R = np.flipud(Q.T)
    sgn = np.sign(np.diag(K))
    sgn[sgn == 0] = 1
    K = K * sgn[None, :]
    R = R * sgn[:, None]
    if np.linalg.det(R) < 0:
        K[:, 2] *= -1
        R[2] *= -1
    t = np.linalg.solve(K, P[:, 3])
    return K / K[2, 2], R, t


# ----------------------------------------------------------------- planes
def point_plane_distance(pts, plane) -> np.ndarray:
    """Signed distances of (N, 3) points to plane (a, b, c, d) with
    ax+by+cz+d = 0 and (a,b,c) unit."""
    plane = np.asarray(plane, np.float64)
    n = plane[:3] / np.linalg.norm(plane[:3])
    d = plane[3] / np.linalg.norm(plane[:3])
    return np.asarray(pts, np.float64) @ n + d


def fit_plane(pts) -> np.ndarray:
    """Least-squares plane (a, b, c, d) through (N, 3) points (unit
    normal = smallest singular vector of the centered cloud)."""
    pts = np.asarray(pts, np.float64)
    c = pts.mean(axis=0)
    _, _, Vt = np.linalg.svd(pts - c)
    n = Vt[-1]
    return np.concatenate([n, [-n @ c]])


# ------------------------------------------------------ primitive meshes
def tetrahedron():
    v = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                 np.float32) / np.sqrt(3.0)
    f = np.array([[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]], np.int32)
    return v, f


def cube():
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def octahedron():
    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                  [0, 0, 1], [0, 0, -1]], np.float32)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    return v, f


def icosahedron():
    p = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([[-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0],
                  [0, -1, p], [0, 1, p], [0, -1, -p], [0, 1, -p],
                  [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1]],
                 np.float32)
    v /= np.linalg.norm(v[0])
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int32)
    return v, f


# ------------------------------------------------------------- mesh ops
def normalize_mesh(verts) -> np.ndarray:
    """Center at the bbox midpoint, scale the longest axis to [-0.5, 0.5]."""
    v = np.asarray(verts, np.float64)
    lo, hi = v.min(axis=0), v.max(axis=0)
    return ((v - (lo + hi) / 2) / max((hi - lo).max(), 1e-12)).astype(
        np.float32)


def mesh_independent_verts(verts, faces, normals=None):
    """Duplicate vertices so every face owns its 3 (per-face attributes)."""
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    flat = faces.reshape(-1)
    new_v = verts[flat]
    new_f = np.arange(len(flat), dtype=np.int32).reshape(-1, 3)
    if normals is None:
        return new_v, new_f
    return new_v, new_f, np.asarray(normals)[flat]


def subdivide_mesh(verts, faces, n=1):
    """Loop-style 4-way topological subdivision (midpoint split), n times."""
    verts = [np.asarray(v, np.float64) for v in np.asarray(verts)]
    faces = np.asarray(faces, np.int64)
    for _ in range(n):
        mids = {}
        out = []

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in mids:
                verts.append((verts[i] + verts[j]) / 2.0)
                mids[key] = len(verts) - 1
            return mids[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            out += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        faces = np.asarray(out, np.int64)
    return np.stack(verts).astype(np.float32), faces.astype(np.int32)


def mesh_adjust_winding_order(verts, faces, normals) -> np.ndarray:
    """Flip faces whose geometric normal opposes the mean vertex normal."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces).copy()
    vn = np.asarray(normals, np.float64)
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    fn = np.cross(e1, e2)
    ref = (vn[faces[:, 0]] + vn[faces[:, 1]] + vn[faces[:, 2]]) / 3.0
    flip = np.sum(fn * ref, axis=1) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return faces


def pcl_to_shapecl(pcl, shape="cube", width=1.0, colors=None):
    """Stamp a primitive mesh at every point of a point cloud; returns
    (verts, faces[, colors]) — the reference's debug-visualization helper."""
    base_v, base_f = {"cube": cube, "tetrahedron": tetrahedron,
                      "octahedron": octahedron,
                      "icosahedron": icosahedron}[shape]()
    base_v = base_v * (width / 2.0)
    pcl = np.asarray(pcl, np.float32).reshape(-1, 3)
    n, m = len(pcl), len(base_v)
    verts = (pcl[:, None, :] + base_v[None]).reshape(-1, 3)
    faces = (base_f[None] + (np.arange(n)[:, None, None] * m)).reshape(-1, 3)
    if colors is None:
        return verts, faces.astype(np.int32)
    col = np.repeat(np.asarray(colors, np.float32).reshape(-1, 3), m, axis=0)
    return verts, faces.astype(np.int32), col
