"""Wavefront OBJ loader (tinyobjloader-equivalent subset).

The reference vendors tinyobjloader v0.x (reference src/tinyobjloader/*,
called from src/scene.cpp:241). The scenes only use v/vn/vt/f records with
triangle, quad, and n-gon faces; n-gons are fan-triangulated, matching what
tinyobjloader produces for these files.

Returns NumPy arrays; per-mesh world-space pre-transform happens in
scene.py (mirroring Scene::loadMesh, src/scene.cpp:234-311).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class ObjMesh:
    positions: np.ndarray   # (V, 3) float32
    normals: np.ndarray     # (Vn, 3) float32, may be empty
    texcoords: np.ndarray   # (Vt, 2) float32, may be empty
    # per-triangle-corner indices, (F, 3) int32 each; -1 where absent
    pos_idx: np.ndarray
    nrm_idx: np.ndarray
    uv_idx: np.ndarray


def _parse_face_corner(tok: str):
    """'v', 'v/vt', 'v//vn', 'v/vt/vn' -> (pi, ti, ni) 0-based or -1."""
    parts = tok.split("/")
    pi = int(parts[0])
    ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
    return pi - 1, ti - 1, ni - 1


def load_obj_native(path: str):
    """Native C++ loader (ptdn/native/obj_loader.cpp); None if the
    library is unavailable. Byte-identical output to load_obj_python."""
    from ptdn.native import get_library

    lib = get_library()
    if lib is None:
        return None
    import ctypes

    if lib.ptdn_obj_parse(path.encode()) != 0:
        raise FileNotFoundError(path)
    n_pos = ctypes.c_int64()
    n_nrm = ctypes.c_int64()
    n_uv = ctypes.c_int64()
    n_tri = ctypes.c_int64()
    lib.ptdn_obj_counts(ctypes.byref(n_pos), ctypes.byref(n_nrm),
                        ctypes.byref(n_uv), ctypes.byref(n_tri))
    pos = np.empty((n_pos.value, 3), np.float32)
    nrm = np.empty((n_nrm.value, 3), np.float32)
    uv = np.empty((n_uv.value, 2), np.float32)
    pi = np.empty((n_tri.value, 3), np.int32)
    ni = np.empty((n_tri.value, 3), np.int32)
    ti = np.empty((n_tri.value, 3), np.int32)
    lib.ptdn_obj_fill(pos, nrm, uv, pi, ni, ti)
    lib.ptdn_obj_free()
    return ObjMesh(positions=pos, normals=nrm, texcoords=uv,
                   pos_idx=pi, nrm_idx=ni, uv_idx=ti)


def load_obj(path: str, native: bool = True) -> ObjMesh:
    if native:
        try:
            mesh = load_obj_native(path)
            if mesh is not None:
                return mesh
        except OSError:
            pass
    return load_obj_python(path)


def load_obj_python(path: str) -> ObjMesh:
    positions: List[List[float]] = []
    normals: List[List[float]] = []
    texcoords: List[List[float]] = []
    pos_idx: List[List[int]] = []
    nrm_idx: List[List[int]] = []
    uv_idx: List[List[int]] = []

    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            key = tok[0]
            if key == "v":
                positions.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif key == "vn":
                normals.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif key == "vt":
                texcoords.append([float(tok[1]), float(tok[2])])
            elif key == "f":
                corners = [_parse_face_corner(t) for t in tok[1:]]
                # fan triangulation (tinyobjloader behavior for n-gons)
                for k in range(1, len(corners) - 1):
                    tri = [corners[0], corners[k], corners[k + 1]]
                    pos_idx.append([c[0] for c in tri])
                    uv_idx.append([c[1] for c in tri])
                    nrm_idx.append([c[2] for c in tri])
            # g / mtllib / usemtl / s / o: ignored (scenes don't use materials
            # from .mtl; the scene .txt assigns materials)

    def arr(x, w):
        return (np.asarray(x, dtype=np.float32).reshape(-1, w)
                if x else np.zeros((0, w), dtype=np.float32))

    return ObjMesh(
        positions=arr(positions, 3),
        normals=arr(normals, 3),
        texcoords=arr(texcoords, 2),
        pos_idx=np.asarray(pos_idx, dtype=np.int32).reshape(-1, 3),
        nrm_idx=np.asarray(nrm_idx, dtype=np.int32).reshape(-1, 3),
        uv_idx=np.asarray(uv_idx, dtype=np.int32).reshape(-1, 3),
    )
