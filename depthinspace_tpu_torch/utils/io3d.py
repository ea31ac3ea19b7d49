"""Minimal 3D mesh I/O (numpy), port of ``depthinspace_tpu/utils/io3d.py``:
``read_obj`` (the ShapeNet meshes of ``tools/create_syn_data.py
--objects shapenet``), and ``write_ply`` / ``read_ply`` (binary little
endian or ascii point clouds and meshes).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from .geometry3d import mesh_vertex_normals


def read_obj(path):
    """Read a triangle OBJ. Returns (verts, faces, colors=None, normals).

    Faces with >3 vertices are fan-triangulated; per-vertex normals are
    recomputed area-weighted from the geometry (the reference aggregates
    vertex normals the same way)."""
    verts, faces = [], []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = tok.split("/")[0]
                    idx.append(int(i))
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    normals = mesh_vertex_normals(verts, faces).astype(np.float32)
    return verts, faces, None, normals


def write_ply(path, verts, faces=None, colors=None, binary=True):
    """Write a PLY mesh/point cloud (binary_little_endian or ascii)."""
    verts = np.asarray(verts, np.float32)
    n = len(verts)
    header = ["ply",
              "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        colors = np.clip(np.asarray(colors), 0, 255).astype(np.uint8)
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    if faces is not None:
        faces = np.asarray(faces, np.int32)
        header += [f"element face {len(faces)}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            for i in range(n):
                f.write(struct.pack("<fff", *verts[i]))
                if colors is not None:
                    f.write(struct.pack("<BBB", *colors[i]))
            if faces is not None:
                for face in faces:
                    f.write(struct.pack("<Biii", 3, *face))
        else:
            for i in range(n):
                row = f"{verts[i, 0]} {verts[i, 1]} {verts[i, 2]}"
                if colors is not None:
                    row += f" {colors[i, 0]} {colors[i, 1]} {colors[i, 2]}"
                f.write((row + "\n").encode())
            if faces is not None:
                for face in faces:
                    f.write(f"3 {face[0]} {face[1]} {face[2]}\n".encode())


def read_ply(path):
    """Read a PLY file (ascii or binary_little_endian, float32 xyz [+ uchar
    rgb] vertices, optional triangle faces). Returns (verts, faces, colors)."""
    with open(path, "rb") as f:
        # ---- header
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError("not a ply file")
        fmt = None
        n_verts = n_faces = 0
        vert_props = []
        in_vertex = False
        while True:
            line = f.readline().strip().decode()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if parts[1] == "vertex":
                    n_verts = int(parts[2])
                elif parts[1] == "face":
                    n_faces = int(parts[2])
            elif parts[0] == "property" and in_vertex and parts[1] != "list":
                vert_props.append((parts[2], parts[1]))

        has_color = any(p[0] in ("red", "green", "blue") for p in vert_props)
        verts = np.zeros((n_verts, 3), np.float32)
        colors = np.zeros((n_verts, 3), np.uint8) if has_color else None
        faces = np.zeros((n_faces, 3), np.int32) if n_faces else None

        if fmt == "ascii":
            for i in range(n_verts):
                vals = f.readline().split()
                verts[i] = [float(v) for v in vals[:3]]
                if has_color:
                    colors[i] = [int(v) for v in vals[3:6]]
            for i in range(n_faces):
                vals = f.readline().split()
                faces[i] = [int(v) for v in vals[1:4]]
        elif fmt == "binary_little_endian":
            type_size = {"float": 4, "uchar": 1, "int": 4, "double": 8}
            for i in range(n_verts):
                vals = []
                ci = []
                for name, typ in vert_props:
                    raw = f.read(type_size[typ])
                    if typ == "float":
                        val = struct.unpack("<f", raw)[0]
                    elif typ == "uchar":
                        val = raw[0]
                    elif typ == "int":
                        val = struct.unpack("<i", raw)[0]
                    else:
                        val = struct.unpack("<d", raw)[0]
                    if name in ("x", "y", "z"):
                        vals.append(val)
                    elif name in ("red", "green", "blue"):
                        ci.append(val)
                verts[i] = vals[:3]
                if has_color:
                    colors[i] = ci[:3]
            for i in range(n_faces):
                cnt = f.read(1)[0]
                idx = struct.unpack(f"<{cnt}i", f.read(4 * cnt))
                faces[i] = idx[:3]
        else:
            raise ValueError(f"unsupported ply format {fmt}")
    return verts, faces, colors
