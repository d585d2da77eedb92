"""Edge-stopping à-trous wavelet filter (ATrousFilter rebuild).

Replicates the reference kernel (reference src/denoise.cu:77-170): a 5x5
B3-spline kernel dilated by step = 1 << level, luminance/normal/position
edge-stopping weights, variance propagated with squared weights, an
optional 3x3 Gaussian pre-blur of variance (border-renormalized), and
albedo remodulation on the final level.

Every tap is a STATIC shift of the whole image (pad+slice), so the
25-tap loop is pure fused elementwise arithmetic — no gathers, no
divergence. One important deviation: the reference updates its variance
buffer IN PLACE while other threads are still reading it (a data race,
denoise.cu:153-161); we read the level's input variance and write a fresh
output, i.e. the intended race-free semantics.
"""

from __future__ import annotations

import jax.numpy as jnp

from ptdn.denoise.reproject import luminance

# 5x5 B3-spline weights (denoise.cu:82-86)
_H = [1/256, 1/64, 3/128, 1/64, 1/256,
      1/64, 1/16, 3/32, 1/16, 1/64,
      3/128, 3/32, 9/64, 3/32, 3/128,
      1/64, 1/16, 3/32, 1/16, 1/64,
      1/256, 1/64, 3/128, 1/64, 1/256]

# 3x3 Gaussian (denoise.cu:89-91)
_G = [1/16, 1/8, 1/16,
      1/8, 1/4, 1/8,
      1/16, 1/8, 1/16]


def _shift(img, dy: int, dx: int):
    """Shift so out[y, x] = img[y + dy, x + dx]; zeros outside."""
    h, w = img.shape[0], img.shape[1]
    py0, py1 = max(dy, 0), max(-dy, 0)
    px0, px1 = max(dx, 0), max(-dx, 0)
    pad = [(py1, py0), (px1, px0)] + [(0, 0)] * (img.ndim - 2)
    return jnp.pad(img, pad)[py0:py0 + h, px0:px0 + w]


def _shift_mask(shape, dy: int, dx: int):
    ones = jnp.ones(shape[:2], jnp.float32)
    return _shift(ones, dy, dx)


def gaussian3x3(variance):
    """Border-renormalized 3x3 blur of variance (denoise.cu:101-115)."""
    s = jnp.zeros_like(variance)
    sw = jnp.zeros_like(variance)
    k = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            g = _G[k]; k += 1
            m = _shift_mask(variance.shape, dy, dx)
            s = s + g * _shift(variance, dy, dx)
            sw = sw + g * m
    return jnp.maximum(s / sw, 0.0)


def atrous_level(color_in, variance_in, gbuffer, level: int, is_last: bool,
                 sigma_l, sigma_n, sigma_x, blur_variance: bool,
                 add_color: bool):
    """One à-trous level. Returns (color_out, variance_out)."""
    step = 1 << level
    var_p = gaussian3x3(variance_in) if blur_variance else jnp.maximum(
        variance_in, 0.0)

    lp = luminance(color_in)
    pp = gbuffer["position"]
    np_ = gbuffer["normal"]

    denom_l = jnp.sqrt(var_p) * sigma_l + 1e-6
    color_sum = jnp.zeros_like(color_in)
    var_sum = jnp.zeros_like(variance_in)
    w_sum = jnp.zeros_like(variance_in)
    w2_sum = jnp.zeros_like(variance_in)

    k = 0
    for j in (-2, -1, 0, 1, 2):          # y offset (reference j loops cols?
        for i in (-2, -1, 0, 1, 2):      # k = (2+i) + (2+j)*5, denoise.cu:148
            hk = _H[k]; k += 1
            dy, dx = j * step, i * step
            inb = _shift_mask(color_in.shape, dy, dx)
            cq = _shift(color_in, dy, dx)
            lq = luminance(cq)
            pq = _shift(pp, dy, dx)
            nq = _shift(np_, dy, dx)
            wl = jnp.exp(-jnp.abs(lp - lq) / denom_l)
            wn = jnp.minimum(1.0, jnp.exp(
                -jnp.linalg.norm(np_ - nq, axis=-1) / (sigma_n + 1e-6)))
            wx = jnp.minimum(1.0, jnp.exp(
                -jnp.linalg.norm(pp - pq, axis=-1) / (sigma_x + 1e-6)))
            wgt = hk * wl * wn * wx * inb
            w_sum = w_sum + wgt
            w2_sum = w2_sum + wgt * wgt
            color_sum = color_sum + cq * wgt[..., None]
            var_sum = var_sum + _shift(variance_in, dy, dx) * wgt * wgt

    ok = w_sum > 1e-5                    # 10e-6 (denoise.cu:159)
    color_out = jnp.where(ok[..., None],
                          color_sum / jnp.maximum(w_sum, 1e-20)[..., None],
                          color_in)
    variance_out = jnp.where(ok, var_sum / jnp.maximum(w2_sum, 1e-30),
                             variance_in)
    if is_last and add_color:
        color_out = color_out * gbuffer["albedo"] * gbuffer["ialbedo"]
    return color_out, variance_out
