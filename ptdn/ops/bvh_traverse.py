"""Mesh intersection on device: brute-force and BVH traversal paths.

The reference traverses its flattened BVH with a per-thread 64-deep stack
(reference src/intersections.h:265-329). In plain JAX this module provides
two semantically identical strategies:

* `mesh_brute_force` — triangle-chunked streaming over ALL triangles with
  a running min. No divergence at all: dense elementwise math over static
  shapes, which pays for small meshes.
* `mesh_bvh_batched` — faithful per-ray stack traversal expressed as one
  batched `lax.while_loop` (every lane advances one BVH node per
  iteration, lanes that finished idle). This is the oracle for the CUDA
  per-thread traversal kernel (ops/cuda_bvh.py), which runs the same
  rules one thread per ray.

Both return the closest mesh hit over the WHOLE global triangle array
(the reference queries the same global BVH once per mesh geom and filters
by triangle range, pathtrace.cu:243-256 — attributing the global closest
hit to the owning geom is equivalent and does 1 query instead of G).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ptdn.ops.intersect import FLT_MAX, aabb_hit, ray_triangle

MAX_BVH_DEPTH = 64   # intersections.h:265
MAX_LEAF_PRIMS = 16  # >= MaxPrimsInNode=10, padded for aligned slices


def _gather_tri(ds, idx):
    v = ds.tri_v[idx]
    return v[..., 0, :], v[..., 1, :], v[..., 2, :]


def mesh_closest_hit_attrs(ds, o, d, t, u, v, tri_idx, hit, compat=True):
    """Resolve (normal, uv, geom, mat) for per-ray best triangles."""
    from ptdn.ops.intersect import interpolate_tri_hit

    idx = jnp.maximum(tri_idx, 0)
    n = ds.tri_n[idx]
    tuv = ds.tri_uv[idx]
    normal, uv = interpolate_tri_hit(
        u, v, n[..., 0, :], n[..., 1, :], n[..., 2, :],
        tuv[..., 0, :], tuv[..., 1, :], tuv[..., 2, :], compat=compat)
    geom = jnp.where(hit, ds.tri_geom[idx], -1)
    mat = jnp.where(hit, ds.tri_mat[idx], 0)
    return normal, uv, geom, mat


def mesh_brute_force(ds, o, d, n_tris: int, chunk: int = 128):
    """Closest hit over all triangles, streaming in fixed chunks.

    Returns (t, u, v, tri_idx, hit); t = -1 on miss. Strict-< running min
    means the lowest triangle index wins exact ties (the BVH traversal
    order differs only on measure-zero exact-equal t).
    """
    N = o.shape[0]
    chunk = min(chunk, int(ds.tri_v.shape[0]))
    nchunk = max(1, -(-n_tris // chunk))

    def body(c, state):
        best_t, best_u, best_v, best_i = state
        base = c * chunk
        sl = jax.lax.dynamic_slice_in_dim(ds.tri_v, base, chunk, axis=0)
        v0, v1, v2 = sl[:, 0], sl[:, 1], sl[:, 2]
        # (N, chunk) pairwise tests
        t, u, vv, hit = ray_triangle(
            o[:, None, :], d[:, None, :], v0[None], v1[None], v2[None])
        valid = hit & ((base + jnp.arange(chunk))[None, :] < n_tris) & (t > 0)
        t = jnp.where(valid, t, FLT_MAX)
        k = jnp.argmin(t, axis=1)
        rows = jnp.arange(N)
        ct, cu, cv = t[rows, k], u[rows, k], vv[rows, k]
        better = ct < best_t
        return (jnp.where(better, ct, best_t),
                jnp.where(better, cu, best_u),
                jnp.where(better, cv, best_v),
                jnp.where(better, base + k, best_i))

    init = (jnp.full(N, FLT_MAX), jnp.zeros(N), jnp.zeros(N),
            jnp.full(N, -1, jnp.int32))
    best_t, best_u, best_v, best_i = jax.lax.fori_loop(0, nchunk, body, init)
    hit = best_i >= 0
    return jnp.where(hit, best_t, -1.0), best_u, best_v, best_i, hit


def mesh_bvh_batched(ds, o, d, max_prims: int = MAX_LEAF_PRIMS):
    """Per-ray stack BVH traversal as one batched while_loop.

    Faithful to IntersectBVH (intersections.h:265-329): pure AABB test
    (no t-range culling), front-to-back child ordering by direction sign
    on the split axis, fixed 64-deep stack that silently drops the far
    subtree on overflow, strict-< closest-hit update.
    """
    N = o.shape[0]
    invd = 1.0 / d
    neg = d < 0

    stack = jnp.zeros((N, MAX_BVH_DEPTH), jnp.int32)
    state = dict(
        stack=stack,
        sp=jnp.zeros(N, jnp.int32),
        cur=jnp.zeros(N, jnp.int32),
        active=jnp.ones(N, bool),
        best_t=jnp.full(N, FLT_MAX),
        best_u=jnp.zeros(N),
        best_v=jnp.zeros(N),
        best_i=jnp.full(N, -1, jnp.int32),
    )
    rows = jnp.arange(N)

    def cond(s):
        return jnp.any(s["active"])

    def body(s):
        cur = s["cur"]
        act = s["active"]
        bmin = ds.bvh_min[cur]
        bmax = ds.bvh_max[cur]
        count = ds.bvh_count[cur]
        axis = ds.bvh_axis[cur]
        poff = ds.bvh_prim_off[cur]
        right = ds.bvh_right[cur]

        box = aabb_hit(o, invd, bmin, bmax) & act
        is_leaf = count > 0

        # ---- leaf: test up to max_prims triangles ----
        best_t, best_u, best_v, best_i = (
            s["best_t"], s["best_u"], s["best_v"], s["best_i"])
        leaf = box & is_leaf
        for k in range(max_prims):
            tid = poff + k
            valid = leaf & (k < count)
            idx = jnp.where(valid, tid, 0)
            v0, v1, v2 = _gather_tri(ds, idx)
            t, u, vv, h = ray_triangle(o, d, v0, v1, v2)
            upd = valid & h & (t < best_t)
            best_t = jnp.where(upd, t, best_t)
            best_u = jnp.where(upd, u, best_u)
            best_v = jnp.where(upd, vv, best_v)
            best_i = jnp.where(upd, idx, best_i)

        # ---- control flow: pop or push ----
        interior_hit = box & ~is_leaf
        pop = act & ~interior_hit                   # missed box or finished leaf
        overflow = s["sp"] >= MAX_BVH_DEPTH         # drop far subtree
        push = interior_hit & ~overflow

        dir_neg = jnp.take_along_axis(neg, jnp.maximum(axis, 0)[:, None],
                                      axis=1)[:, 0]
        near = jnp.where(dir_neg, right, cur + 1)
        far = jnp.where(dir_neg, cur + 1, right)

        sp = s["sp"]
        stack = s["stack"]
        stack = stack.at[rows, jnp.clip(sp, 0, MAX_BVH_DEPTH - 1)].set(
            jnp.where(push, far, stack[rows, jnp.clip(sp, 0, MAX_BVH_DEPTH - 1)]))
        sp_after_push = jnp.where(push, sp + 1, sp)

        # pop path: done if stack empty, else take top
        can_pop = sp_after_push > 0
        done = pop & ~can_pop
        top = stack[rows, jnp.clip(sp_after_push - 1, 0, MAX_BVH_DEPTH - 1)]
        # overflow on interior hit: reference pops instead of pushing
        # (intersections.h:308-311 gives up the whole interior node)
        pop_now = pop | (interior_hit & overflow)
        new_cur = jnp.where(push, near, jnp.where(pop_now & can_pop, top, cur))
        new_sp = jnp.where(push, sp_after_push,
                           jnp.where(pop_now & can_pop, sp_after_push - 1,
                                     sp_after_push))
        new_active = act & ~(pop_now & ~can_pop)

        return dict(stack=stack, sp=new_sp, cur=new_cur, active=new_active,
                    best_t=best_t, best_u=best_u, best_v=best_v, best_i=best_i)

    out = jax.lax.while_loop(cond, body, state)
    hit = out["best_i"] >= 0
    t = jnp.where(hit, out["best_t"], -1.0)
    return t, out["best_u"], out["best_v"], out["best_i"], hit
