"""Spatial variance estimation — the SVGF-paper fallback the reference
stubbed out.

The reference's ``EstimateVariance`` kernel writes a constant 10.0
(reference src/denoise.cu:320-329, "TODO: Estimate Variance" — the stub
ships in the demo binary), so with temporal accumulation off (and for
the first frames after a disocclusion, when the temporal moments rest on
1-3 samples) the à-trous luminance weight runs on garbage. Compat mode
replicates the stub; native mode (``compat=False``) uses this module:
the SVGF paper's §4.2 remedy — estimate the luminance moments SPATIALLY
with a bilateral 7x7 filter driven by the geometry edge-stopping
weights, and use ``max(mu2 - mu1^2, 0)`` as the variance until the
temporal history is long enough (< 4 frames, the paper's threshold).

Like the à-trous filter, every tap is a static whole-image shift, so the
49-tap loop compiles to fused elementwise arithmetic with zero gathers. The luminance edge weight is deliberately omitted — luminance
statistics are the quantity being estimated.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ptdn.denoise.reproject import luminance

HIST_THRESHOLD = 4     # SVGF paper §4.2: spatial fallback below 4 frames


def _shift(img, dy: int, dx: int):
    """out[y, x] = img[y + dy, x + dx]; zeros outside (as atrous)."""
    h, w = img.shape[0], img.shape[1]
    py0, py1 = max(dy, 0), max(-dy, 0)
    px0, px1 = max(dx, 0), max(-dx, 0)
    pad = [(py1, py0), (px1, px0)] + [(0, 0)] * (img.ndim - 2)
    return jnp.pad(img, pad)[py0:py0 + h, px0:px0 + w]


def spatial_variance(color, gbuffer, sigma_n, sigma_x, radius: int = 3):
    """Bilateral spatial estimate of per-pixel luminance variance.

    7x7 (radius 3) window; weights are the à-trous normal/position
    edge-stopping factors (denoise.cu:128-135 conventions) so the
    estimate never averages moments across geometric edges. Returns
    an (h, w) f32 variance map (>= 0)."""
    lp = luminance(color)
    pp = gbuffer["position"]
    np_ = gbuffer["normal"]
    m1 = jnp.zeros_like(lp)
    m2 = jnp.zeros_like(lp)
    wsum = jnp.zeros_like(lp)
    ones = jnp.ones_like(lp)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            inb = _shift(ones, dy, dx)
            lq = _shift(lp, dy, dx)
            nq = _shift(np_, dy, dx)
            pq = _shift(pp, dy, dx)
            wn = jnp.minimum(1.0, jnp.exp(
                -jnp.linalg.norm(np_ - nq, axis=-1) / (sigma_n + 1e-6)))
            wx = jnp.minimum(1.0, jnp.exp(
                -jnp.linalg.norm(pp - pq, axis=-1) / (sigma_x + 1e-6)))
            w = inb * wn * wx
            m1 = m1 + w * lq
            m2 = m2 + w * lq * lq
            wsum = wsum + w
    inv = 1.0 / jnp.maximum(wsum, 1e-20)
    mu1 = m1 * inv
    mu2 = m2 * inv
    return jnp.maximum(mu2 - mu1 * mu1, 0.0)


def variance_with_spatial_fallback(variance, history_length, color,
                                   gbuffer, sigma_n, sigma_x):
    """Native-mode variance post-pass: pixels whose temporal history is
    shorter than HIST_THRESHOLD frames take the spatial estimate. The
    49-tap filter only runs when some pixel needs it (steady static
    cameras skip it entirely via the cond)."""
    need = history_length < HIST_THRESHOLD

    def with_spatial(_):
        sv = spatial_variance(color, gbuffer, sigma_n, sigma_x)
        return jnp.where(need, sv, variance)

    return jax.lax.cond(jnp.any(need), with_spatial,
                        lambda _: variance, None)
