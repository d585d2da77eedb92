"""BSDF sampling + light sampling, batched with exact RNG stream parity.

Replicates scatterRay (reference src/interactions.h:94-136): refractive
materials use Schlick's approximation to choose refract-vs-reflect,
reflective materials reflect with probability `hasReflective`, the rest
do a cosine-weighted diffuse bounce. The per-lane LCG seed advances only
at the draw sites the reference's control flow would reach, so masked
vector lanes consume the identical variate sequence as CUDA threads.

Also the NEE disk light sampler computeShadowRay (pathtrace.cu:284-297),
including glm::rotation's quaternion construction
(glm/gtx/quaternion.inl:248-283).
"""

from __future__ import annotations

import jax.numpy as jnp

from ptdn.ops.rng import next_rand_masked

TWO_PI = jnp.float32(6.2831853071795864769)
SQRT_ONE_THIRD = jnp.float32(0.5773502691896257645)


def _normalize(v):
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def reflect(i, n):
    return i - 2.0 * jnp.sum(i * n, axis=-1, keepdims=True) * n


def refract(i, n, eta):
    """glm::refract: returns 0-vector on total internal reflection."""
    ndi = jnp.sum(n * i, axis=-1, keepdims=True)
    eta = eta[..., None]
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    out = eta * i - (eta * ndi + jnp.sqrt(jnp.maximum(k, 0.0))) * n
    return jnp.where(k < 0.0, 0.0, out)


def cosine_hemisphere(normal, r_up, r_around):
    """calculateRandomDirectionInHemisphere (interactions.h:37-67)."""
    up = jnp.sqrt(r_up)
    over = jnp.sqrt(1.0 - up * up)
    around = r_around * TWO_PI

    ax, ay = jnp.abs(normal[..., 0]), jnp.abs(normal[..., 1])
    dnn = jnp.where(
        (ax < SQRT_ONE_THIRD)[..., None],
        jnp.array([1.0, 0.0, 0.0], jnp.float32),
        jnp.where((ay < SQRT_ONE_THIRD)[..., None],
                  jnp.array([0.0, 1.0, 0.0], jnp.float32),
                  jnp.array([0.0, 0.0, 1.0], jnp.float32)))
    p1 = _normalize(jnp.cross(normal, dnn))
    p2 = _normalize(jnp.cross(normal, p1))
    return (up[..., None] * normal
            + (jnp.cos(around) * over)[..., None] * p1
            + (jnp.sin(around) * over)[..., None] * p2)


def scatter_ray(seed, direction, color, intersect_pos, normal,
                m_refl, m_refr, m_ior, m_spec_color, active):
    """One scatter step for every lane where `active`.

    Returns (seed, origin, direction, color, became_diffuse, specular).
    Seed stream: refractive AND non-refractive lanes draw exactly one
    variate first (Schlick test / reflect test); diffuse lanes draw two
    more (interactions.h:107-135).
    """
    origin = intersect_pos + 1e-4 * normal

    is_refr = m_refr != 0.0          # C float truthiness (interactions.h:107)

    # draw 1: Schlick test (refractive) or reflect test (everyone else)
    seed, r1 = next_rand_masked(seed, active)

    # ---- refractive branch ----
    eta_in = 1.0 / m_ior
    proj = jnp.sum(direction * normal, axis=-1)
    eta = jnp.where(proj > 0, m_ior, eta_in)
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    schlick = r0 + (1.0 - r0) * (1.0 - jnp.abs(proj)) ** 5
    do_refract = is_refr & (schlick < r1)
    refr_dir = refract(direction, normal, eta)

    # ---- reflective branch ----
    do_reflect = is_refr & ~do_refract | (~is_refr & (r1 < m_refl))
    refl_dir = reflect(direction, normal)

    # ---- diffuse branch: draws 2 more ----
    is_diffuse = ~is_refr & ~(r1 < m_refl)
    seed, r_up = next_rand_masked(seed, active & is_diffuse)
    seed, r_around = next_rand_masked(seed, active & is_diffuse)
    diff_dir = cosine_hemisphere(normal, r_up, r_around)

    new_dir = jnp.where(do_refract[..., None], refr_dir,
                        jnp.where(do_reflect[..., None], refl_dir, diff_dir))
    new_color = jnp.where(do_reflect[..., None], color * m_spec_color, color)

    act3 = active[..., None]
    return (seed,
            jnp.where(act3, origin, intersect_pos),
            jnp.where(act3, new_dir, direction),
            jnp.where(act3, new_color, color),
            active & is_diffuse,
            active & do_reflect)


def quat_rotate_from_z(dest, p):
    """rotate(glm::rotation((0,0,1), dest), p) — Stan Melax construction
    (glm/gtx/quaternion.inl:248-283) specialized to orig = +z."""
    cos_t = dest[..., 2]
    opposite = cos_t < -1.0 + 1.1920929e-07
    # general case: axis = cross(z, dest) = (-dest.y, dest.x, 0)
    s = jnp.sqrt(jnp.maximum((1.0 + cos_t) * 2.0, 1e-30))
    invs = 1.0 / s
    qw = 0.5 * s
    qx = -dest[..., 1] * invs
    qy = dest[..., 0] * invs
    qz = jnp.zeros_like(qw)
    # opposite case: angleAxis(pi, normalize(cross((1,0,0), z))) = (0,(0,-1,0))
    qw = jnp.where(opposite, 0.0, qw)
    qx = jnp.where(opposite, 0.0, qx)
    qy = jnp.where(opposite, -1.0, qy)
    q = jnp.stack([qx, qy, qz], axis=-1)
    t = 2.0 * jnp.cross(q, p)
    return p + qw[..., None] * t + jnp.cross(q, t)


def sample_shadow_ray(seed, origin_pos, light_translation, light_radius, active):
    """computeShadowRay (pathtrace.cu:284-297): uniform-in-radius sample on
    a light-facing disk. Draws theta then radius. Returns
    (seed, dir, expect_dist). `light_translation` may be a single (3,)
    light or a per-lane (n, 3) choice (native-mode uniform light
    selection, engine/wavefront.py)."""
    lt = (light_translation if light_translation.ndim == 2
          else light_translation[None, :])
    to_center = _normalize(lt - origin_pos)
    seed, r_theta = next_rand_masked(seed, active)
    theta = TWO_PI * r_theta
    circ = jnp.stack([jnp.cos(theta), jnp.sin(theta), jnp.zeros_like(theta)],
                     axis=-1)
    sample_dir = quat_rotate_from_z(to_center, circ)
    seed, r_rad = next_rand_masked(seed, active)
    sample_point = lt + sample_dir * (r_rad * light_radius)[..., None]
    delta = sample_point - origin_pos
    expect_dist = jnp.linalg.norm(delta, axis=-1)
    return seed, _normalize(delta), expect_dist
