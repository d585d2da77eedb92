"""Wavefront path tracer: the reference's `rt` megakernel as a masked
flat ray batch stepped through the bounce loop.

The CUDA reference runs one divergent thread per pixel through the whole
path (reference src/pathtrace.cu:300-401). Here that becomes:

* a flat SoA ray batch of N = W*H lanes (origins, directions, throughput,
  radiance, flags) — every op below is dense elementwise math over
  (N, ...) that XLA fuses into the bounce loop's body;
* the bounce loop is a `lax.scan` over depth 1..max_depth (depth <= 10);
  dead lanes are masked, not compacted (XLA static shapes);
* per-lane LCG seeds re-derived each depth from (pixel, frame+depth) via
  the TEA hash, exactly like initRand (pathtrace.cu:328) — so the variate
  streams match the CUDA build bit-for-bit;
* closest-hit dispatch (computeIntersection, pathtrace.cu:210-281)
  becomes a statically unrolled loop over the handful of analytic geoms
  plus ONE global mesh query (the reference traverses the same global BVH
  once per mesh geom and filters by triangle range — attributing the
  global closest mesh hit to its owning geom is equivalent);
* the G-buffer is a pytree of (N, ...) arrays with the reference layout
  (position/normal/albedo/ialbedo/geomId, sceneStructs.h:113-119).

Two backends share this code. "xla" is the plain oracle: the mesh query
is `mesh_bvh_batched` (or brute force for small meshes). "gpu" is the
production path: the same frame with the mesh query on the CUDA
per-thread traversal kernel (ops/cuda_bvh.py).
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from ptdn.ops import bsdf, cuda_bvh
from ptdn.ops.bvh_traverse import (mesh_brute_force, mesh_bvh_batched,
                                   mesh_closest_hit_attrs)
from ptdn.ops.intersect import FLT_MAX, box_intersect, sphere_intersect
from ptdn.ops.rng import init_rand
from ptdn.scene.parser import CUBE, MESH, SPHERE

COLORDIVIDOR = jnp.float32(0.003921568627)   # utilities.h:24
BRUTE_FORCE_MAX_TRIS = 2048
BACKENDS = ("gpu", "xla")


def sample_texture(ds, texid, uv):
    """Nearest-neighbor texel fetch with V flip (Texture::getColor,
    sceneStructs.h:208-221). texid must be pre-clamped >= 0.

    Texels are byte-packed into ONE u32 per texel and fetched with a
    single flat-index gather (unpacked in-jit); values are bit-identical
    to the 3-channel atlas (bytes 0..255)."""
    wh = ds.tex_wh[texid]
    w = wh[..., 0].astype(jnp.float32)
    h = wh[..., 1].astype(jnp.float32)
    x = jnp.minimum(w * uv[..., 0], w - 1.0).astype(jnp.int32)
    y = jnp.minimum(h * (1.0 - uv[..., 1]), h - 1.0).astype(jnp.int32)
    hm, wm = ds.tex_atlas.shape[1], ds.tex_atlas.shape[2]
    x = jnp.clip(x, 0, wm - 1)
    y = jnp.clip(y, 0, hm - 1)
    packed = jnp.take(ds.tex_flat_u32, texid * (hm * wm) + y * wm + x)
    rgb = jnp.stack([packed & jnp.uint32(0xFF),
                     (packed >> 8) & jnp.uint32(0xFF),
                     (packed >> 16) & jnp.uint32(0xFF)], axis=-1)
    return rgb.astype(jnp.float32) * COLORDIVIDOR


def read_mat(ds, mat_idx):
    """Material properties of each lane's material id."""
    return {"color": ds.mat_color[mat_idx],
            "spec_color": ds.mat_spec_color[mat_idx],
            "refl": ds.mat_reflective[mat_idx],
            "refr": ds.mat_refractive[mat_idx],
            "ior": ds.mat_ior[mat_idx],
            "emit": ds.mat_emittance[mat_idx],
            "texid": ds.mat_texid[mat_idx]}


def albedo_from(ds, mv, uv, show_texture: bool = True):
    """Material color or texture sample (pathtrace.cu:320-322, 343-354)
    given an already-read material view. Untextured lanes sample texel
    (0,0), so their gather indices stay coherent. show_texture=False is
    the reference's SHOW_TEXTURE=0 compile flag."""
    if not show_texture:
        return mv["color"]
    texid = mv["texid"]
    textured = texid >= 0
    uv0 = jnp.where(textured[..., None], uv, 0.0)
    tex = sample_texture(ds, jnp.maximum(texid, 0), uv0)
    return jnp.where(textured[..., None], tex, mv["color"])


def check_backend(cfg) -> None:
    """Refuse an unknown backend, and the production backend anywhere
    but on a GPU (it never falls back to the oracle)."""
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown backend {cfg.backend!r}; expected one "
                         f"of {BACKENDS}")
    if cfg.backend == "gpu":
        cuda_bvh.require_gpu()


def _mesh_mode(scene, cfg) -> str:
    """none | brute | bvh (plain traversal) | cuda (traversal kernel).

    The oracle takes brute force up to BRUTE_FORCE_MAX_TRIS triangles.
    The production backend takes the kernel for every mesh: even on
    cornell's 38-triangle wall it beats brute force (H100 at 400 W,
    800x800, depth 8 with SVGF: 35.9 vs 49.9 ms/frame)."""
    if scene.n_tris == 0:
        return "none"
    if cfg.mesh_mode == "brute" or not cfg.use_bvh:
        return "brute"
    if cfg.backend == "gpu":
        return "cuda"
    if cfg.mesh_mode == "bvh":
        return "bvh"
    return "brute" if scene.n_tris <= BRUTE_FORCE_MAX_TRIS else "bvh"


def make_intersector(scene, cfg, mesh=None, traversal=None):
    """Build the scene-specialized closest-hit function.

    Returns intersect(ds, o, d) -> dict(t, normal, uv, mat_id, geom_id,
    hit). Geom order and strict-< updates reproduce computeIntersection's
    first-wins tie-breaking (pathtrace.cu:230-265).

    `mesh`: the device mesh of a row-sharded step (the traversal kernel
    then runs under shard_map). `traversal`: a stand-in for the kernel
    with its signature (cuda_bvh.plain_call), for measurements.
    """
    check_backend(cfg)
    geom_types = scene.geom_types
    geom_mats = scene.geom_material_ids
    mode = _mesh_mode(scene, cfg)
    n_tris = scene.n_tris
    max_prims = max(int(scene.bvh.prim_count.max()), 1) if n_tris else 1
    has_mesh = any(t == MESH for t in geom_types)
    if mode == "cuda" and traversal is None:
        cuda_bvh.load()

    def intersect(ds, o, d) -> Dict[str, jnp.ndarray]:
        n = o.shape[0]
        best_t = jnp.full(n, FLT_MAX)
        best_geom = jnp.full(n, -1, jnp.int32)
        best_normal = jnp.zeros((n, 3))
        best_uv = jnp.zeros((n, 2))

        if has_mesh and mode != "none":
            if mode == "brute":
                mt, mu, mv, mi, mh = mesh_brute_force(ds, o, d, n_tris)
            elif mode == "cuda":
                mt, mu, mv, mi, mh = cuda_bvh.closest_hit(
                    ds, o, d, mesh=mesh, call=traversal)
            else:
                mt, mu, mv, mi, mh = mesh_bvh_batched(ds, o, d,
                                                      max_prims=max_prims)
            m_normal, m_uv, m_geom, _ = mesh_closest_hit_attrs(
                ds, o, d, mt, mu, mv, mi, mh, compat=cfg.compat)

        for gi, gtype in enumerate(geom_types):
            if gtype == CUBE:
                t, _, nrm, _, _ = box_intersect(
                    ds.geom_transform[gi], ds.geom_inverse[gi], o, d)
                uv = None
            elif gtype == SPHERE:
                t, _, nrm, _, _ = sphere_intersect(
                    ds.geom_transform[gi], ds.geom_inverse[gi],
                    ds.geom_inv_transpose[gi], o, d)
                uv = None
            else:  # MESH: global closest hit, owned-geom filter
                t = jnp.where(m_geom == gi, mt, -1.0)
                nrm = m_normal
                uv = m_uv
            better = (t > 0.0) & (t < best_t)
            best_t = jnp.where(better, t, best_t)
            best_geom = jnp.where(better, gi, best_geom)
            best_normal = jnp.where(better[..., None], nrm, best_normal)
            if uv is not None:
                best_uv = jnp.where(better[..., None], uv, best_uv)

        hit = best_geom >= 0
        # static geom->material table baked into the program
        mat_table = jnp.asarray(np.asarray(geom_mats, np.int32))
        mat_id = jnp.where(hit, mat_table[jnp.maximum(best_geom, 0)], 0)
        return {
            "t": jnp.where(hit, best_t, -1.0),
            "normal": best_normal,
            "uv": best_uv,
            "mat_id": mat_id,
            "geom_id": best_geom,
            "hit": hit,
        }

    return intersect


def make_trace_fn(scene, cfg, resolution, mesh=None, traversal=None):
    """Build trace(ds, cam, params, frame_u32) -> (radiance (N,3), gbuffer,
    primary).

    `radiance` is the raw 1-spp estimate (accumulation-over-frames happens
    in the frame step, pathtrace.cu:395-399). The static config baked in:
    trace_depth, shadow_ray, reduce_var, sep_color x denoise, mesh mode.
    `mesh` / `traversal`: see make_intersector.
    """
    from ptdn.ops.camera import generate_camera_rays

    intersect = make_intersector(scene, cfg, mesh=mesh, traversal=traversal)
    w, h = resolution
    n = w * h
    light_geom = 0   # reference hardcodes geoms[0] (pathtrace.cu:360-361)

    def light_visible(ds, o, d):
        """Shadow-ray visibility of the light geom — the only thing the
        NEE block consumes (pathtrace.cu:374): did the closest hit land
        on it? A full closest-hit query: an any-hit early-out would
        change which geom is reported."""
        return intersect(ds, o, d)["geom_id"] == light_geom

    # the shadow-hit material is geom 0's material — static
    # (pathtrace.cu:374-383: the contribution only reads its emittance/color)
    light_mat = scene.materials[scene.geom_material_ids[light_geom]]
    light_emissive = float(light_mat.emittance) > 0.0
    light_emit_color = np.asarray(light_mat.color, np.float32) * np.float32(
        light_mat.emittance)
    # ---- native-mode uniform light selection (PARITY.md quirk #6) ----
    # The reference NEE always samples geoms[0] ("// TODO: pick random
    # light", pathtrace.cu:359-361). compat=False with >1 emissive geom
    # draws one uniformly per diffuse lane per bounce and weights the
    # contribution by n_lights (the standard MC estimator).
    light_ids = tuple(lg.geom_idx for lg in scene.lights)
    multi_light = ((not cfg.compat) and cfg.shadow_ray
                   and len(light_ids) > 1)
    if multi_light:
        light_emits = np.stack([
            np.asarray(scene.materials[scene.geom_material_ids[g]].color,
                       np.float32)
            * np.float32(
                scene.materials[scene.geom_material_ids[g]].emittance)
            for g in light_ids])
    # static bypass: a scene with zero loaded textures can never sample
    # one (every mat_texid is -1), so skip the per-bounce texture gather
    show_tex = cfg.show_texture and len(scene.textures) > 0

    def trace(ds, cam, params, frame, primary_cache=None, cam_changed=None):
        """primary_cache/cam_changed enable primary-visibility caching: the
        first hit is a deterministic function of the camera, so a static
        camera reuses last frame's intersection + albedo (one whole
        intersect pass + a texture fetch saved). Pass primary_cache=None to
        always recompute."""
        origin, direction = generate_camera_rays(cam, (w, h))
        throughput = jnp.ones((n, 3))
        radiance = jnp.zeros((n, 3))
        diffuse_flag = jnp.zeros(n, bool)
        lane = jnp.arange(n, dtype=jnp.uint32)

        def compute_primary(_):
            isect = intersect(ds, origin, direction)
            alb = albedo_from(ds, read_mat(ds, isect["mat_id"]),
                              isect["uv"], show_tex)
            return dict(isect, albedo=alb)

        if primary_cache is None:
            primary = compute_primary(None)
        else:
            primary = jax.lax.cond(cam_changed, compute_primary,
                                   lambda _: primary_cache, None)
        isect = {k: v for k, v in primary.items() if k != "albedo"}
        gb_albedo = primary["albedo"]

        # ---- G-buffer from the primary hit (pathtrace.cu:314-323) ----
        gbuffer = {
            "position": origin + isect["t"][..., None] * direction,
            "normal": isect["normal"],
            "albedo": gb_albedo,
            "ialbedo": jnp.ones((n, 3)),
            "geom_id": isect["geom_id"],
        }
        active = isect["hit"]

        def bounce(carry, depth):
            """One reference bounce-loop iteration (pathtrace.cu:325-394).
            `depth` is traced so the whole loop compiles ONCE (scan)."""
            (origin, direction, throughput, radiance, diffuse_flag, active,
             isect, alb) = carry
            seed = init_rand(lane, jnp.uint32(frame) + depth.astype(jnp.uint32))
            mat = isect["mat_id"]
            mv = read_mat(ds, mat)
            emitt = mv["emit"]
            emissive = emitt > 0.0

            # emissive hit terminates; skipped for NEE'd diffuse paths
            # (pathtrace.cu:331-336)
            add_emit = active & emissive
            if cfg.shadow_ray and cfg.reduce_var:
                add_emit = add_emit & ~diffuse_flag
            radiance = radiance + jnp.where(
                add_emit[..., None],
                throughput * mv["color"] * emitt[..., None], 0.0)
            active = active & ~emissive

            ipos = origin + isect["t"][..., None] * direction
            inormal = isect["normal"]
            m_refl = mv["refl"]
            m_refr = mv["refr"]
            mat_is_diffuse = (m_refl < 1e-6) & (m_refr < 1e-6)

            # throughput *= albedo; sepcolor skips the first-hit albedo so
            # SVGF can remodulate it after filtering (pathtrace.cu:343-355;
            # the reference's glm::clamp there discards its result — no-op).
            # `alb` rides the carry: fetched with each intersection.
            apply_alb = active
            if cfg.sep_color and cfg.denoise_enable:
                apply_alb = apply_alb & (depth > 1)
            throughput = jnp.where(apply_alb[..., None], throughput * alb,
                                   throughput)

            # ---- NEE shadow ray to geom 0 (pathtrace.cu:357-385) ----
            if cfg.shadow_ray and multi_light:
                # native mode, >1 emissive geom: uniform light selection
                # (fixes "// TODO: pick random light", pathtrace.cu:359).
                # Draw order: selection FIRST, then the disk sample's
                # theta/radius — ours to define, the reference stream has
                # no selection draw.
                nee = active & mat_is_diffuse
                s_origin = ipos + 1e-4 * inormal
                k = len(light_ids)
                seed, r_sel = bsdf.next_rand_masked(seed, nee)
                li = jnp.minimum((r_sel * k).astype(jnp.int32), k - 1)
                l_tr = ds.geom_translation[jnp.asarray(light_ids)][li]
                seed, s_dir, s_dist = bsdf.sample_shadow_ray(
                    seed, s_origin, l_tr, params["light_radius"], nee)
                tgt = jnp.asarray(light_ids, jnp.int32)[li]
                lit = nee & (intersect(ds, s_origin, s_dir)["geom_id"]
                             == tgt)
                lambert = jnp.maximum(0.0, jnp.sum(s_dir * inormal, axis=-1))
                intensity = params["shadow_intensity"] / (s_dist * s_dist)
                # x k: inverse of the uniform selection pdf
                contrib = (throughput * jnp.asarray(light_emits)[li]
                           * (k * intensity * lambert)[..., None])
                radiance = radiance + jnp.where(lit[..., None], contrib, 0.0)
            elif cfg.shadow_ray:
                nee = active & mat_is_diffuse
                s_origin = ipos + 1e-4 * inormal
                seed, s_dir, s_dist = bsdf.sample_shadow_ray(
                    seed, s_origin, ds.geom_translation[light_geom],
                    params["light_radius"], nee)
                lit = nee & light_visible(ds, s_origin, s_dir)
                if not light_emissive:
                    lit = jnp.zeros_like(lit)
                lambert = jnp.maximum(0.0, jnp.sum(s_dir * inormal, axis=-1))
                intensity = params["shadow_intensity"] / (s_dist * s_dist)
                contrib = (throughput * jnp.asarray(light_emit_color)
                           * (intensity * lambert)[..., None])
                radiance = radiance + jnp.where(lit[..., None], contrib, 0.0)

            # ---- scatter + next intersection, skipped at max depth
            # (pathtrace.cu:388-392); lax.cond keeps one compiled copy ----
            def do_scatter(args):
                (origin, direction, throughput, diffuse_flag, active, isect,
                 alb, seed) = args
                seed, origin, direction, throughput, became_diffuse, _ = (
                    bsdf.scatter_ray(seed, direction, throughput, ipos,
                                     inormal, m_refl, m_refr,
                                     mv["ior"], mv["spec_color"],
                                     active))
                diffuse_flag = diffuse_flag | became_diffuse
                nxt = intersect(ds, origin, direction)
                active = active & nxt["hit"]
                nalb = albedo_from(ds, read_mat(ds, nxt["mat_id"]),
                                   nxt["uv"], show_tex)
                return (origin, direction, throughput, diffuse_flag, active,
                        nxt, nalb)

            def no_scatter(args):
                (origin, direction, throughput, diffuse_flag, active, isect,
                 alb, _) = args
                return (origin, direction, throughput, diffuse_flag, active,
                        isect, alb)

            (origin, direction, throughput, diffuse_flag, active, isect,
             alb) = jax.lax.cond(
                    depth < cfg.trace_depth, do_scatter, no_scatter,
                    (origin, direction, throughput, diffuse_flag, active,
                     isect, alb, seed))
            return (origin, direction, throughput, radiance, diffuse_flag,
                    active, isect, alb), None

        carry = (origin, direction, throughput, radiance, diffuse_flag,
                 active, isect, gb_albedo)
        if cfg.trace_depth == 1:
            carry, _ = bounce(carry, jnp.int32(1))
        else:
            carry, _ = jax.lax.scan(
                bounce, carry, jnp.arange(1, cfg.trace_depth + 1,
                                          dtype=jnp.int32))
        return carry[3], gbuffer, primary

    return trace
