"""utils/io3d.py of the port against the JAX package's: read_obj on a small
ShapeNet-like tree (quads, negative indices, v/vt/vn tokens), the ShapeNet
loader of the data generators, and the PLY writer and reader. Both are the
same numpy code: outputs and files are held bit for bit."""

import numpy as np
import pytest

from depthinspace_tpu.tools import create_syn_data as jtool
from depthinspace_tpu.utils import io3d as ref
from depthinspace_tpu_torch.tools import create_syn_data as ptool
from depthinspace_tpu_torch.utils import io3d as port

# a unit cube as 6 quads in the forms ShapeNet files use: "f v/vt/vn",
# "f v//vn", "f v/vt", plain and negative (relative) indices, comments
CUBE_OBJ = """# cube
mtllib model.mtl
v -1 -1 -1
v -1 -1 1
v -1 1 -1
v -1 1 1
v 1 -1 -1
v 1 -1 1
v 1 1 -1
v 1 1 1
vt 0 0
vt 1 0
vt 1 1
vn 0 0 1
usemtl m0
f 1/1/1 2/2/1 4/3/1 3/1/1
f 5//1 7//1 8//1 6//1
f 1/1 5/2 6/3 2/1
f 3 4 8 7
f -8 -6 -2 -4
f -7 -3 -1 -5
"""


def _shapenet_tree(root, rng):
    """Two chair models (and one airplane) in ShapeNet's layout
    <synset>/<model id>/models/model_normalized.obj."""
    for synset, model, scale in (("03001627", "b", 2.0), ("03001627", "a", 0.5),
                                 ("02691156", "c", 1.0)):
        d = root / synset / model / "models"
        d.mkdir(parents=True)
        lines = []
        for ln in CUBE_OBJ.splitlines():
            if ln.startswith("v "):
                xyz = np.array(ln.split()[1:], float) * scale + rng.normal(
                    size=3) * 0.1
                ln = "v " + " ".join(f"{c:.6f}" for c in xyz)
            lines.append(ln)
        (d / "model_normalized.obj").write_text("\n".join(lines) + "\n")


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_read_obj_matches_jax_package(tmp_path):
    p = tmp_path / "cube.obj"
    p.write_text(CUBE_OBJ)
    got, want = port.read_obj(p), ref.read_obj(p)
    assert got[1].shape == (12, 3)              # 6 quads, fan-triangulated
    for a, b in zip(got, want):
        _same(a, b)


def test_load_shapenet_objects_matches_jax_tool(tmp_path):
    _shapenet_tree(tmp_path, np.random.RandomState(0))
    for classes in (("chair",), ("chair", "airplane")):
        got = ptool.load_shapenet_objects(tmp_path, classes)
        want = jtool.load_shapenet_objects(tmp_path, classes)
        assert len(got) == len(want) == len(classes) + 1
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                _same(a, b)
    one = ptool.load_shapenet_objects(tmp_path, num_perclass=1)
    assert len(one) == 1
    _same(one[0][0], jtool.load_shapenet_objects(tmp_path,
                                                 num_perclass=1)[0][0])


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("with_colors,with_faces", [(True, True),
                                                    (False, True),
                                                    (True, False)])
def test_ply_write_and_read_match_jax_package(tmp_path, binary, with_colors,
                                              with_faces):
    rng = np.random.RandomState(1)
    verts = rng.normal(size=(9, 3)).astype(np.float32)
    colors = rng.randint(0, 256, (9, 3)) if with_colors else None
    faces = rng.randint(0, 9, (5, 3)) if with_faces else None
    port.write_ply(tmp_path / "p.ply", verts, faces, colors, binary=binary)
    ref.write_ply(tmp_path / "r.ply", verts, faces, colors, binary=binary)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "r.ply").read_bytes()
    got, want = port.read_ply(tmp_path / "r.ply"), ref.read_ply(
        tmp_path / "p.ply")
    for a, b in zip(got, want):
        _same(a, b)
    if binary:
        np.testing.assert_array_equal(got[0], verts)
    if with_faces:
        np.testing.assert_array_equal(got[1], faces)
