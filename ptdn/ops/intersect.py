"""Ray/primitive intersection math — batched, jit-friendly, float32.

Each function takes a batch of rays (origins/directions of shape (N, 3))
and is dense elementwise math that XLA fuses; the analytic-geom set per
scene is tiny (<= ~12), so the per-geom dispatch is a statically unrolled
host loop in the engine.

Reference parity (quirks preserved on purpose):
* unit-cube slab test with sequential per-axis tmin update and the
  transform-(not invTranspose)-mapped normal (intersections.h:50-92);
* unit-sphere test (intersections.h:104-146);
* getPointOnRay's 1e-4 backoff along the NORMALIZED direction
  (intersections.h:29-31);
* distance-based return t = |origin - world_hit| (intersections.h:89,145);
* glm 0.9.x intersectRayTriangle: BACKFACE-CULLED Moller-Trumbore,
  epsilon = FLT_EPSILON, t >= 0 (external/include/glm/gtx/intersect.inl);
* Triangle::Intersect's swapped barycentric weights for the smoothed
  normal — n0*u + n1*v + n2*(1-u-v) instead of the uv interpolation's
  n0*(1-u-v) + n1*u + n2*v (sceneStructs.h:162-170).
"""

from __future__ import annotations

import jax.numpy as jnp

FLT_MAX = jnp.float32(3.402823466e38)
FLT_EPSILON = jnp.float32(1.1920929e-07)
BACKOFF = jnp.float32(1e-4)   # getPointOnRay epsilon (intersections.h:30)


def _mat_vec(m, v, w):
    """Apply a 4x4 to batched vec3s with homogeneous coord w (0 or 1)."""
    return v @ m[:3, :3].T + w * m[:3, 3]


def _normalize(v, axis=-1):
    return v / jnp.linalg.norm(v, axis=axis, keepdims=True)


def box_intersect(transform, inverse, o, d):
    """Unit-cube [-0.5, 0.5]^3 slab test (intersections.h:50-92).

    Returns (t, point, normal, outside, hit): t is the world-space
    distance |o - hit_point| (or -1), matching the reference contract.
    """
    qo = _mat_vec(inverse, o, 1.0)
    qd = _normalize(_mat_vec(inverse, d, 0.0))

    tmin = jnp.full(o.shape[:-1], -1e38, jnp.float32)
    tmax = jnp.full(o.shape[:-1], 1e38, jnp.float32)
    tmin_n = jnp.zeros_like(qo)
    tmax_n = jnp.zeros_like(qo)
    eye = jnp.eye(3, dtype=jnp.float32)
    for xyz in range(3):
        # one reciprocal per slab axis and two multiplies (the goldens
        # were rendered this way; ~1 ulp from two divides)
        rqx = 1.0 / qd[..., xyz]
        t1 = (-0.5 - qo[..., xyz]) * rqx
        t2 = (0.5 - qo[..., xyz]) * rqx
        ta = jnp.minimum(t1, t2)
        tb = jnp.maximum(t1, t2)
        n = jnp.where(t2 < t1, 1.0, -1.0)[..., None] * eye[xyz]
        upd_min = (ta > 0) & (ta > tmin)
        tmin = jnp.where(upd_min, ta, tmin)
        tmin_n = jnp.where(upd_min[..., None], n, tmin_n)
        upd_max = tb < tmax
        tmax = jnp.where(upd_max, tb, tmax)
        tmax_n = jnp.where(upd_max[..., None], n, tmax_n)

    hit = (tmax >= tmin) & (tmax > 0)
    inside = tmin <= 0
    outside = ~inside
    t_obj = jnp.where(inside, tmax, tmin)
    n_obj = jnp.where(inside[..., None], tmax_n, tmin_n)
    p_obj = qo + (t_obj - BACKOFF)[..., None] * qd
    point = _mat_vec(transform, p_obj, 1.0)
    normal = _normalize(_mat_vec(transform, n_obj, 0.0))
    t = jnp.where(hit, jnp.linalg.norm(o - point, axis=-1), -1.0)
    return t, point, normal, outside, hit


def sphere_intersect(transform, inverse, inv_transpose, o, d):
    """Unit sphere radius 0.5 (intersections.h:104-146)."""
    ro = _mat_vec(inverse, o, 1.0)
    rd = _normalize(_mat_vec(inverse, d, 0.0))

    vdot = jnp.sum(ro * rd, axis=-1)
    radicand = vdot * vdot - (jnp.sum(ro * ro, axis=-1) - 0.25)
    has_root = radicand >= 0
    sq = jnp.sqrt(jnp.maximum(radicand, 0.0))
    t1 = -vdot + sq
    t2 = -vdot - sq
    both_neg = (t1 < 0) & (t2 < 0)
    both_pos = (t1 > 0) & (t2 > 0)
    outside = both_pos
    t_obj = jnp.where(both_pos, jnp.minimum(t1, t2), jnp.maximum(t1, t2))
    hit = has_root & ~both_neg

    p_obj = ro + (t_obj - BACKOFF)[..., None] * rd
    point = _mat_vec(transform, p_obj, 1.0)
    normal = _normalize(_mat_vec(inv_transpose, p_obj, 0.0))
    normal = jnp.where(outside[..., None], normal, -normal)
    t = jnp.where(hit, jnp.linalg.norm(o - point, axis=-1), -1.0)
    return t, point, normal, outside, hit


def ray_triangle(o, d, v0, v1, v2):
    """glm::intersectRayTriangle (glm/gtx/intersect.inl:36-74), batched.

    Backface-culled Moller-Trumbore. Returns (t, u, v, hit) with
    t = distance along d (d is NOT normalized here; callers pass unit d),
    u = weight of v1, v = weight of v2, hit includes t >= 0.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    p = jnp.cross(d, e2)
    a = jnp.sum(e1 * p, axis=-1)
    front = a >= FLT_EPSILON
    f = 1.0 / jnp.where(front, a, 1.0)
    s = o - v0
    u = f * jnp.sum(s * p, axis=-1)
    q = jnp.cross(s, e1)
    v = f * jnp.sum(d * q, axis=-1)
    t = f * jnp.sum(e2 * q, axis=-1)
    hit = front & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 0)
    return t, u, v, hit


def interpolate_tri_hit(u, v, n0, n1, n2, uv0, uv1, uv2, compat: bool = True):
    """Triangle::Intersect attribute interpolation (sceneStructs.h:160-172).

    compat=True keeps the reference's swapped normal weights
    (n0*u + n1*v + n2*(1-u-v)); compat=False uses the correct
    barycentric weights.
    """
    w = (1.0 - u - v)[..., None]
    uu = u[..., None]
    vv = v[..., None]
    uv = uv0 * w + uv1 * uu + uv2 * vv
    if compat:
        n = n0 * uu + n1 * vv + n2 * w
    else:
        n = n0 * w + n1 * uu + n2 * vv
    return _normalize(n), uv


def aabb_hit(o, invd, bmin, bmax):
    """BoundingBox::AABBIntersect2 slab test (boundingbox.h:62-79).
    Pure boolean — the reference does not range-cull by current best t."""
    t0 = (bmin - o) * invd
    t1 = (bmax - o) * invd
    tmin = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tmax = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (tmax >= 0) & (tmin <= tmax)
