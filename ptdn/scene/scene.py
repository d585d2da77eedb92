"""Scene assembly: parsed .txt -> host arrays -> device pytree.

Mirrors the reference's load pipeline (Scene::Scene, src/scene.cpp:9-46):
parse materials/objects/camera, load OBJ meshes with world-space
pre-transform (scene.cpp:266-296: positions by `transform`, normals by
`invTranspose`, stored UN-normalized), accumulate per-mesh world AABBs,
assign global triangle ids, build the single global SAH BVH (which
reorders triangles into leaf order, scene.cpp:40-44), then scan emissive
geoms into the light list (scene.cpp:313-324).

Device data layout: everything device-side is an SoA of statically
shaped float32/int32 jnp arrays inside a registered-dataclass pytree
(`DeviceScene`). Geometry counts, types and triangle ranges stay host-side
static so the jitted tracer can unroll the (tiny) analytic-geom loop and
dispatch mesh traversal at trace time.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from ptdn.scene import parser as P
from ptdn.scene.bvh import FlatBVH, build_bvh
from ptdn.scene.objloader import load_obj
from ptdn.utils import math3d
from ptdn.utils.image_io import load_texture_rgb

F = np.float32


def _register_pytree_dataclass(cls):
    import jax

    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_pytree_node(
        cls,
        lambda s: (tuple(getattr(s, f) for f in fields), None),
        lambda _, c: cls(**dict(zip(fields, c))),
    )
    return cls


@_register_pytree_dataclass
@dataclasses.dataclass
class DeviceScene:
    """All per-scene device arrays (one pytree, resident in device memory)."""
    # geoms (G)
    geom_translation: object    # (G, 3) f32
    geom_transform: object      # (G, 4, 4) f32
    geom_inverse: object        # (G, 4, 4) f32
    geom_inv_transpose: object  # (G, 4, 4) f32
    # materials (M)
    mat_color: object           # (M, 3) f32
    mat_spec_color: object      # (M, 3) f32
    mat_spec_exponent: object   # (M,) f32
    mat_reflective: object      # (M,) f32
    mat_refractive: object      # (M,) f32
    mat_ior: object             # (M,) f32
    mat_emittance: object       # (M,) f32
    mat_texid: object           # (M,) i32 (-1 = untextured)
    # triangles (T, world space, BVH leaf order)
    tri_v: object               # (T, 3, 3) f32 vertices
    tri_n: object               # (T, 3, 3) f32 per-vertex normals (unnormalized)
    tri_uv: object              # (T, 3, 2) f32
    tri_geom: object            # (T,) i32 owner geom index
    tri_mat: object             # (T,) i32 owner material id
    # flattened BVH (N nodes)
    bvh_min: object             # (N, 3) f32
    bvh_max: object             # (N, 3) f32
    bvh_count: object           # (N,) i32  (>0 leaf)
    bvh_axis: object            # (N,) i32
    bvh_prim_off: object        # (N,) i32
    bvh_right: object           # (N,) i32
    # texture atlas (K textures padded to a common size)
    tex_atlas: object           # (K, Hmax, Wmax, 3) f32, raw 0..255 values
    tex_flat_u32: object        # (K*Hmax*Wmax,) u32 — texels byte-packed
                                # r | g<<8 | b<<16: one gather per texel
    tex_wh: object              # (K, 2) i32 (w, h)


@dataclasses.dataclass
class HostGeom:
    type: int
    material_id: int
    translation: np.ndarray
    rotation: np.ndarray
    scale: np.ndarray
    transform: np.ndarray
    inverse: np.ndarray
    inv_transpose: np.ndarray
    tri_start: int = 0          # [tri_start, tri_end) in ORIGINAL tri ids
    tri_end: int = 0
    bound_idx: int = -1


@dataclasses.dataclass
class Light:
    """Emissive-geom light entry (Scene::loadLight, scene.cpp:313-324)."""
    type: str
    geom_idx: int
    mat_idx: int


class Scene:
    """Host-side scene: parsing, mesh/texture load, BVH build, upload."""

    def __init__(self, path: str):
        parsed = P.parse_scene(path)
        self.path = path
        self.parsed = parsed
        self.camera = parsed.camera
        self.resolution: Tuple[int, int] = parsed.camera.resolution
        self.image_name: str = parsed.camera.image_name or "render"

        # ---- materials + textures ----
        self.materials = parsed.materials
        self.textures: List[np.ndarray] = []
        for m in self.materials:
            if m.texture_file is not None:
                tex_path = os.path.join(parsed.scene_dir, "Textures", m.texture_file)
                m.texid = len(self.textures)
                self.textures.append(load_texture_rgb(tex_path))

        # ---- geoms + meshes (world-space pre-transform) ----
        self.geoms: List[HostGeom] = []
        tri_v, tri_n, tri_uv, tri_geom, tri_mat = [], [], [], [], []
        self.mesh_bb_min: List[np.ndarray] = []
        self.mesh_bb_max: List[np.ndarray] = []
        next_tri = 0
        for gi, g in enumerate(parsed.geoms):
            tf = math3d.build_transformation_matrix(g.translation, g.rotation, g.scale)
            hg = HostGeom(
                type=g.type, material_id=g.material_id,
                translation=g.translation, rotation=g.rotation, scale=g.scale,
                transform=tf, inverse=np.linalg.inv(tf.astype(np.float64)).astype(F),
                inv_transpose=math3d.inverse_transpose(tf),
            )
            if g.type == P.MESH:
                mesh = load_obj(os.path.join(parsed.scene_dir, "Models", g.obj_file))
                v, nrm, uv = self._world_triangles(mesh, tf, hg.inv_transpose)
                hg.tri_start = next_tri
                hg.tri_end = next_tri + v.shape[0]
                hg.bound_idx = len(self.mesh_bb_min)
                next_tri = hg.tri_end
                tri_v.append(v); tri_n.append(nrm); tri_uv.append(uv)
                tri_geom.append(np.full(v.shape[0], gi, np.int32))
                tri_mat.append(np.full(v.shape[0], g.material_id, np.int32))
                self.mesh_bb_min.append(v.reshape(-1, 3).min(axis=0))
                self.mesh_bb_max.append(v.reshape(-1, 3).max(axis=0))
            self.geoms.append(hg)

        if tri_v:
            self.tri_v = np.concatenate(tri_v, axis=0)
            self.tri_n = np.concatenate(tri_n, axis=0)
            self.tri_uv = np.concatenate(tri_uv, axis=0)
            self.tri_geom = np.concatenate(tri_geom, axis=0)
            self.tri_mat = np.concatenate(tri_mat, axis=0)
        else:
            self.tri_v = np.zeros((0, 3, 3), F)
            self.tri_n = np.zeros((0, 3, 3), F)
            self.tri_uv = np.zeros((0, 3, 2), F)
            self.tri_geom = np.zeros(0, np.int32)
            self.tri_mat = np.zeros(0, np.int32)
        self.n_tris = int(self.tri_v.shape[0])

        # ---- global BVH over all triangles; reorder tris to leaf order ----
        if self.n_tris > 0:
            bmin = self.tri_v.min(axis=1)
            bmax = self.tri_v.max(axis=1)
            self.bvh, order = build_bvh(bmin, bmax)
            self.tri_order = order          # new position -> original id
            self.tri_v = self.tri_v[order]
            self.tri_n = self.tri_n[order]
            self.tri_uv = self.tri_uv[order]
            self.tri_geom = self.tri_geom[order]
            self.tri_mat = self.tri_mat[order]
        else:
            self.bvh = build_bvh(np.zeros((0, 3), F), np.zeros((0, 3), F))[0]
            self.tri_order = np.zeros(0, np.int64)

        # ---- lights (every emissive geom; AREALIGHT only) ----
        self.lights: List[Light] = [
            Light(type="AREALIGHT", geom_idx=i, mat_idx=hg.material_id)
            for i, hg in enumerate(self.geoms)
            if self.materials[hg.material_id].emittance > 0
        ]

        self._device: Optional[DeviceScene] = None

    @staticmethod
    def _world_triangles(mesh, transform, inv_transpose):
        """Pre-transform triangles to world space (scene.cpp:266-296)."""
        ntri = mesh.pos_idx.shape[0]
        v = mesh.positions[mesh.pos_idx.reshape(-1)].reshape(ntri, 3, 3)
        ones = np.ones((ntri, 3, 1), F)
        vh = np.concatenate([v, ones], axis=-1)            # (T,3,4)
        vw = np.einsum("ij,tkj->tki", transform, vh)[..., :3].astype(F)

        if mesh.normals.shape[0] > 0 and (mesh.nrm_idx >= 0).all():
            nobj = mesh.normals[mesh.nrm_idx.reshape(-1)].reshape(ntri, 3, 3)
            nh = np.concatenate([nobj, np.zeros((ntri, 3, 1), F)], axis=-1)
            nw = np.einsum("ij,tkj->tki", inv_transpose, nh)[..., :3].astype(F)
        else:
            # OBJ without normals: geometric face normal (the reference
            # leaves these uninitialized — we pick the sane definition)
            e1 = vw[:, 1] - vw[:, 0]
            e2 = vw[:, 2] - vw[:, 0]
            fn = np.cross(e1, e2)
            fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
            nw = np.repeat(fn[:, None, :], 3, axis=1).astype(F)

        if mesh.texcoords.shape[0] > 0 and (mesh.uv_idx >= 0).all():
            uv = mesh.texcoords[mesh.uv_idx.reshape(-1)].reshape(ntri, 3, 2).astype(F)
        else:
            uv = np.zeros((ntri, 3, 2), F)
        return vw, nw, uv

    # ------------------------------------------------------------------
    def device(self) -> DeviceScene:
        """Upload (lazily, once) and return the DeviceScene pytree."""
        if self._device is None:
            self._device = self._build_device()
        return self._device

    def _build_device(self) -> DeviceScene:
        import jax.numpy as jnp

        geoms = self.geoms
        mats = self.materials

        def pad1(x, dt=F):
            """Ensure at least one row so gathers stay well-defined."""
            x = np.asarray(x, dt)
            if x.shape[0] == 0:
                x = np.zeros((1,) + x.shape[1:], dt)
            return x

        def pad_mult(x, dt=F, mult=128):
            """Pad rows to a multiple of `mult` so the brute-force mesh
            path's chunked dynamic slices never clamp (padding rows are
            degenerate triangles)."""
            x = pad1(x, dt)
            n = x.shape[0]
            target = -(-n // mult) * mult
            if target != n:
                x = np.concatenate(
                    [x, np.zeros((target - n,) + x.shape[1:], dt)], axis=0)
            return x

        # texture atlas: pad to common size
        if self.textures:
            hm = max(t.shape[0] for t in self.textures)
            wm = max(t.shape[1] for t in self.textures)
            atlas = np.zeros((len(self.textures), hm, wm, 3), F)
            wh = np.zeros((len(self.textures), 2), np.int32)
            for k, t in enumerate(self.textures):
                atlas[k, : t.shape[0], : t.shape[1]] = t.astype(F)
                wh[k] = (t.shape[1], t.shape[0])
        else:
            atlas = np.zeros((1, 1, 1, 3), F)
            wh = np.ones((1, 2), np.int32)

        j = jnp.asarray
        bvh = self.bvh
        return DeviceScene(
            geom_translation=j(pad1([g.translation for g in geoms])),
            geom_transform=j(pad1([g.transform for g in geoms])),
            geom_inverse=j(pad1([g.inverse for g in geoms])),
            geom_inv_transpose=j(pad1([g.inv_transpose for g in geoms])),
            mat_color=j(pad1([m.color for m in mats])),
            mat_spec_color=j(pad1([m.specular_color for m in mats])),
            mat_spec_exponent=j(pad1([m.specular_exponent for m in mats])),
            mat_reflective=j(pad1([m.has_reflective for m in mats])),
            mat_refractive=j(pad1([m.has_refractive for m in mats])),
            mat_ior=j(pad1([m.index_of_refraction for m in mats])),
            mat_emittance=j(pad1([m.emittance for m in mats])),
            mat_texid=j(pad1([m.texid for m in mats], np.int32)),
            tri_v=j(pad_mult(self.tri_v)),
            tri_n=j(pad_mult(self.tri_n)),
            tri_uv=j(pad_mult(self.tri_uv)),
            tri_geom=j(pad_mult(self.tri_geom, np.int32)),
            tri_mat=j(pad_mult(self.tri_mat, np.int32)),
            bvh_min=j(pad1(bvh.bounds_min)),
            bvh_max=j(pad1(bvh.bounds_max)),
            bvh_count=j(pad1(bvh.prim_count, np.int32)),
            bvh_axis=j(pad1(bvh.axis, np.int32)),
            bvh_prim_off=j(pad1(bvh.prim_offset, np.int32)),
            bvh_right=j(pad1(bvh.right_child, np.int32)),
            tex_atlas=j(atlas),
            tex_flat_u32=j((atlas[..., 0].astype(np.uint32)
                            + (atlas[..., 1].astype(np.uint32) << 8)
                            + (atlas[..., 2].astype(np.uint32) << 16)
                            ).reshape(-1)),
            tex_wh=j(wh),
        )

    # static metadata used to build traced programs
    @property
    def geom_types(self) -> Tuple[int, ...]:
        return tuple(g.type for g in self.geoms)

    @property
    def geom_material_ids(self) -> Tuple[int, ...]:
        return tuple(g.material_id for g in self.geoms)

    @property
    def geom_tri_ranges(self) -> Tuple[Tuple[int, int], ...]:
        """Triangle ranges in ORIGINAL id space (Geom.T_startidx/T_endidx)."""
        return tuple((g.tri_start, g.tri_end) for g in self.geoms)
