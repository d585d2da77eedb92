"""SVGF temporal reprojection + accumulation (BackProjection rebuild).

Replicates the reference kernel (reference src/denoise.cu:185-317) as one
fused image-space function over (H, W, ...) arrays:

* world position -> previous-frame view space via the stored previous
  view matrix; NDC WITHOUT the tan(fov/2) term — the reference comments
  it out (denoise.cu:202-203) and we replicate;
* 2x2 bilinear tap with per-tap validity (in-bounds + same geomId +
  normal distance <= 0.1, denoise.cu:172-182), requiring ALL four taps
  valid, else a 3x3 uniform-average fallback search (denoise.cu:262-286);
* EWMA with alpha = max(1/(N+1), alpha_min); NOTE the reference applies
  color_alpha to the CURRENT color but moment_alpha to the PREVIOUS
  moments (denoise.cu:297-301) — replicated;
* variance = max(0, m2 - m1^2); total rejection writes history=1,
  variance=100 (denoise.cu:311-315).

All gathers have static 2x2/3x3 neighborhoods around a dynamic base —
they lower to XLA gathers over the (H, W) grid and fuse cleanly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

LUM = jnp.asarray([0.2126, 0.7152, 0.0722], jnp.float32)


def luminance(c):
    return c @ LUM


def _gather2d(img, yy, xx):
    """img[(yy, xx)] with clamped indices (validity handled by masks)."""
    h, w = img.shape[0], img.shape[1]
    yy = jnp.clip(yy, 0, h - 1)
    xx = jnp.clip(xx, 0, w - 1)
    return img[yy, xx]


def _reproj_valid(res, prev_x, prev_y, curr_geom, curr_normal,
                  prev_geom_img, prev_normal_img):
    """isReprjValid (denoise.cu:172-182) for integer prev coords."""
    w, h = res
    inb = (prev_x >= 0) & (prev_x < w) & (prev_y >= 0) & (prev_y < h)
    pg = _gather2d(prev_geom_img, prev_y, prev_x)
    pn = _gather2d(prev_normal_img, prev_y, prev_x)
    same_geom = (pg != -1) & (pg == curr_geom)
    nd = jnp.linalg.norm(pn - curr_normal, axis=-1)
    return inb & same_geom & (nd <= 0.1)


def _accumulate_from_taps(taps, base_valid, fracx, fracy, current_color,
                          curr_geom, history_length, lum, color_alpha_min,
                          moment_alpha_min):
    """Shared tail: 2x2 bilinear + 3x3 fallback + EWMA + rejection
    (denoise.cu:219-315) given per-tap (values[...,10], valid) for the
    3x3 window keyed by (dy, dx)."""
    n_hist = history_length.astype(jnp.float32)

    quad = [((0, 0), (1 - fracx) * (1 - fracy)),
            ((1, 0), fracx * (1 - fracy)),       # offset (dx=1, dy=0)
            ((0, 1), (1 - fracx) * fracy),       # offset (dx=0, dy=1)
            ((1, 1), fracx * fracy)]
    all_valid = base_valid
    for (dx, dy), _ in quad:
        all_valid = all_valid & taps[(dy, dx)][1]
    pc = jnp.zeros_like(current_color)
    pm = jnp.zeros(curr_geom.shape + (2,))
    ph = jnp.zeros(curr_geom.shape)
    sumw = jnp.zeros(curr_geom.shape)
    for (dx, dy), wgt in quad:
        a, v = taps[(dy, dx)]
        mw = jnp.where(all_valid & v, wgt, 0.0)
        pc = pc + mw[..., None] * a[..., 0:3]
        pm = pm + mw[..., None] * a[..., 3:5]
        ph = ph + mw * a[..., 5]
        sumw = sumw + mw
    bilinear_ok = all_valid & (sumw >= 0.01)
    safe = jnp.maximum(sumw, 1e-20)
    pc_b, pm_b, ph_b = pc / safe[..., None], pm / safe[..., None], ph / safe

    # ---- 3x3 uniform fallback ----
    fc = jnp.zeros_like(current_color)
    fm = jnp.zeros(curr_geom.shape + (2,))
    fh = jnp.zeros(curr_geom.shape)
    cnt = jnp.zeros(curr_geom.shape)
    for (dy, dx), (a, v) in taps.items():
        mv = jnp.where(v, 1.0, 0.0)
        fc = fc + mv[..., None] * a[..., 0:3]
        fm = fm + mv[..., None] * a[..., 3:5]
        fh = fh + mv * a[..., 5]
        cnt = cnt + mv
    fallback_ok = ~bilinear_ok & (cnt > 0)
    safe_cnt = jnp.maximum(cnt, 1e-20)
    pc = jnp.where(bilinear_ok[..., None], pc_b, fc / safe_cnt[..., None])
    pm = jnp.where(bilinear_ok[..., None], pm_b, fm / safe_cnt[..., None])
    ph = jnp.where(bilinear_ok, ph_b, fh / safe_cnt)

    valid = ((bilinear_ok | fallback_ok) & (history_length > 0)
             & (curr_geom != -1))

    color_alpha = jnp.maximum(1.0 / (n_hist + 1.0), color_alpha_min)
    moment_alpha = jnp.maximum(1.0 / (n_hist + 1.0), moment_alpha_min)
    acc_color = (current_color * color_alpha[..., None]
                 + pc * (1.0 - color_alpha)[..., None])
    m1 = moment_alpha * pm[..., 0] + (1.0 - moment_alpha) * lum
    m2 = moment_alpha * pm[..., 1] + (1.0 - moment_alpha) * lum * lum
    var = jnp.maximum(m2 - m1 * m1, 0.0)

    color_acc = jnp.where(valid[..., None], acc_color, current_color)
    moment_acc = jnp.where(valid[..., None], jnp.stack([m1, m2], axis=-1),
                           jnp.stack([lum, lum * lum], axis=-1))
    variance = jnp.where(valid, var, 100.0)
    history_update = jnp.where(valid, ph.astype(jnp.int32) + 1, 1)
    return variance, color_acc, moment_acc, history_update


def back_projection_window(res, current_color, curr_gb, prev_gb,
                           prev_viewmat, color_history, moment_history,
                           history_length, color_alpha_min,
                           moment_alpha_min):
    """back_projection with ONE row gather: prev-frame data is packed as
    a stride-1 grid of complete 3x3x10ch windows (90 f32 per row), so a
    pixel's whole tap neighborhood is one gathered row and every tap is
    a direct channel slice (no select tree): one 360-B-row gather in
    place of nine 40-B-row ones."""
    import jax

    w, h = res
    pos = curr_gb["position"]
    curr_geom = curr_gb["geom_id"]
    curr_normal = curr_gb["normal"]
    lum = luminance(current_color)

    vs = pos @ prev_viewmat[:3, :3].T + prev_viewmat[:3, 3]
    prevx = (-(vs[..., 0] / vs[..., 2]) * 0.5 + 0.5) * w - 0.5
    prevy = (-(vs[..., 1] / vs[..., 2]) * 0.5 + 0.5) * h - 0.5
    floorx = jnp.floor(prevx)
    floory = jnp.floor(prevy)
    fracx = prevx - floorx
    fracy = prevy - floory
    fx = floorx.astype(jnp.int32)
    fy = floory.astype(jnp.int32)
    base_valid = (floorx >= 0) & (floory >= 0) & (floorx < w) & (floory < h)

    # per-pixel prev planes, padded by 2 on every side; padding geom = -1
    # so out-of-image taps can never validate as a real match. The grid
    # covers window centers fy in [-1, h] (a tap can be in-bounds while
    # the center is one off the edge).
    pix9 = jnp.concatenate([
        color_history.reshape(h, w, 3),
        moment_history.reshape(h, w, 2),
        history_length.reshape(h, w, 1).astype(jnp.float32),
        prev_gb["normal"].reshape(h, w, 3),
    ], axis=-1)
    pad9 = jnp.pad(pix9, ((2, 2), (2, 2), (0, 0)))
    padg = jnp.pad(prev_gb["geom_id"].astype(jnp.float32)[..., None],
                   ((2, 2), (2, 2), (0, 0)), constant_values=-1.0)
    padded = jnp.concatenate([pad9, padg], axis=-1)   # (h+4, w+4, 10)

    gh, gw = h + 2, w + 2
    cells = []
    for a in range(3):
        for b in range(3):
            cells.append(padded[a:a + gh, b:b + gw, :])
    table = jnp.concatenate(cells, axis=-1).reshape(gh * gw, 90)
    table = jax.lax.optimization_barrier(table)

    gi = jnp.clip(fy + 1, 0, gh - 1)
    gj = jnp.clip(fx + 1, 0, gw - 1)
    idx = (gi * gw + gj).reshape(-1)
    g = table[idx].reshape(h, w, 9, 10)

    geo_f = curr_geom.astype(jnp.float32)
    taps = {}
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            a = g[..., (dy + 1) * 3 + (dx + 1), :]
            qx = fx + dx
            qy = fy + dy
            inb = (qx >= 0) & (qx < w) & (qy >= 0) & (qy < h)
            pg = a[..., 9]
            same = (pg != -1) & (pg == geo_f)
            nd = jnp.linalg.norm(a[..., 6:9] - curr_normal, axis=-1)
            taps[(dy, dx)] = (a, inb & same & (nd <= 0.1))

    return _accumulate_from_taps(taps, base_valid, fracx, fracy,
                                 current_color, curr_geom, history_length,
                                 lum, color_alpha_min, moment_alpha_min)


def back_projection_packed(res, current_color, curr_gb, prev_gb,
                           prev_viewmat, color_history, moment_history,
                           history_length, color_alpha_min,
                           moment_alpha_min):
    """back_projection with all prev-frame reads packed into ONE row table
    and the 3x3 fallback neighborhood reused for the 2x2 bilinear taps.

    The naive formulation needs ~40 gathers, this one exactly 9 — the
    2x2 bilinear offsets {0,1}^2 are a subset of the 3x3 {-1,0,1}^2
    fallback window (denoise.cu:219 vs :262-286)."""
    import jax

    w, h = res
    pos = curr_gb["position"]
    curr_geom = curr_gb["geom_id"]
    curr_normal = curr_gb["normal"]
    n_hist = history_length.astype(jnp.float32)
    lum = luminance(current_color)

    vs = pos @ prev_viewmat[:3, :3].T + prev_viewmat[:3, 3]
    clipx = vs[..., 0] / vs[..., 2]
    clipy = vs[..., 1] / vs[..., 2]
    prevx = (-clipx * 0.5 + 0.5) * w - 0.5
    prevy = (-clipy * 0.5 + 0.5) * h - 0.5
    floorx = jnp.floor(prevx)
    floory = jnp.floor(prevy)
    fracx = prevx - floorx
    fracy = prevy - floory
    fx = floorx.astype(jnp.int32)
    fy = floory.astype(jnp.int32)
    base_valid = (floorx >= 0) & (floory >= 0) & (floorx < w) & (floory < h)

    # packed prev table: color (0:3), moment (3:5), histlen (5),
    # normal (6:9), geom (9)
    pack = jnp.concatenate([
        color_history.reshape(-1, 3),
        moment_history.reshape(-1, 2),
        history_length.reshape(-1, 1).astype(jnp.float32),
        prev_gb["normal"].reshape(-1, 3),
        prev_gb["geom_id"].reshape(-1, 1).astype(jnp.float32),
    ], axis=1)
    pack = jax.lax.optimization_barrier(pack)

    taps = {}
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            qx = fx + dx
            qy = fy + dy
            inb = (qx >= 0) & (qx < w) & (qy >= 0) & (qy < h)
            rows = (jnp.clip(qy, 0, h - 1) * w
                    + jnp.clip(qx, 0, w - 1)).reshape(-1)
            a = pack[rows].reshape(curr_geom.shape + (10,))
            pg = a[..., 9]
            same = (pg != -1) & (pg == curr_geom.astype(jnp.float32))
            nd = jnp.linalg.norm(a[..., 6:9] - curr_normal, axis=-1)
            taps[(dy, dx)] = (a, inb & same & (nd <= 0.1))

    # ---- 2x2 bilinear: all four taps must be valid ----
    quad = [((0, 0), (1 - fracx) * (1 - fracy)),
            ((1, 0), fracx * (1 - fracy)),       # offset (dx=1, dy=0)
            ((0, 1), (1 - fracx) * fracy),       # offset (dx=0, dy=1)
            ((1, 1), fracx * fracy)]
    all_valid = base_valid
    for (dx, dy), _ in quad:
        all_valid = all_valid & taps[(dy, dx)][1]
    pc = jnp.zeros_like(current_color)
    pm = jnp.zeros(curr_geom.shape + (2,))
    ph = jnp.zeros(curr_geom.shape)
    sumw = jnp.zeros(curr_geom.shape)
    for (dx, dy), wgt in quad:
        a, v = taps[(dy, dx)]
        mw = jnp.where(all_valid & v, wgt, 0.0)
        pc = pc + mw[..., None] * a[..., 0:3]
        pm = pm + mw[..., None] * a[..., 3:5]
        ph = ph + mw * a[..., 5]
        sumw = sumw + mw
    bilinear_ok = all_valid & (sumw >= 0.01)
    safe = jnp.maximum(sumw, 1e-20)
    pc_b, pm_b, ph_b = pc / safe[..., None], pm / safe[..., None], ph / safe

    # ---- 3x3 uniform fallback ----
    fc = jnp.zeros_like(current_color)
    fm = jnp.zeros(curr_geom.shape + (2,))
    fh = jnp.zeros(curr_geom.shape)
    cnt = jnp.zeros(curr_geom.shape)
    for (dy, dx), (a, v) in taps.items():
        mv = jnp.where(v, 1.0, 0.0)
        fc = fc + mv[..., None] * a[..., 0:3]
        fm = fm + mv[..., None] * a[..., 3:5]
        fh = fh + mv * a[..., 5]
        cnt = cnt + mv
    fallback_ok = ~bilinear_ok & (cnt > 0)
    safe_cnt = jnp.maximum(cnt, 1e-20)
    pc = jnp.where(bilinear_ok[..., None], pc_b, fc / safe_cnt[..., None])
    pm = jnp.where(bilinear_ok[..., None], pm_b, fm / safe_cnt[..., None])
    ph = jnp.where(bilinear_ok, ph_b, fh / safe_cnt)

    valid = ((bilinear_ok | fallback_ok) & (history_length > 0)
             & (curr_geom != -1))

    color_alpha = jnp.maximum(1.0 / (n_hist + 1.0), color_alpha_min)
    moment_alpha = jnp.maximum(1.0 / (n_hist + 1.0), moment_alpha_min)
    acc_color = (current_color * color_alpha[..., None]
                 + pc * (1.0 - color_alpha)[..., None])
    m1 = moment_alpha * pm[..., 0] + (1.0 - moment_alpha) * lum
    m2 = moment_alpha * pm[..., 1] + (1.0 - moment_alpha) * lum * lum
    var = jnp.maximum(m2 - m1 * m1, 0.0)

    color_acc = jnp.where(valid[..., None], acc_color, current_color)
    moment_acc = jnp.where(valid[..., None], jnp.stack([m1, m2], axis=-1),
                           jnp.stack([lum, lum * lum], axis=-1))
    variance = jnp.where(valid, var, 100.0)
    history_update = jnp.where(valid, ph.astype(jnp.int32) + 1, 1)
    return variance, color_acc, moment_acc, history_update


def _reproj_base(res, pos, prev_viewmat):
    """Shared prologue: reproject world position through the previous
    view matrix to prev-frame pixel coords (denoise.cu:195-217, incl.
    the reference's omitted tan(fov/2) quirk)."""
    w, h = res
    vs = pos @ prev_viewmat[:3, :3].T + prev_viewmat[:3, 3]
    prevx = (-(vs[..., 0] / vs[..., 2]) * 0.5 + 0.5) * w - 0.5
    prevy = (-(vs[..., 1] / vs[..., 2]) * 0.5 + 0.5) * h - 0.5
    floorx = jnp.floor(prevx)
    floory = jnp.floor(prevy)
    fracx = prevx - floorx
    fracy = prevy - floory
    fx = floorx.astype(jnp.int32)
    fy = floory.astype(jnp.int32)
    base_valid = (floorx >= 0) & (floory >= 0) & (floorx < w) & (floory < h)
    return fx, fy, fracx, fracy, base_valid


def back_projection_stencil(res, current_color, curr_gb, prev_gb,
                            prev_viewmat, color_history, moment_history,
                            history_length, color_alpha_min,
                            moment_alpha_min):
    """back_projection specialized for |reprojected base - pixel| <= 1
    (every static-camera frame, incl. float jitter around pixel centers,
    and sub-pixel motion). The caller MUST gate on that bound
    (back_projection_auto). Then every 3x3-window tap lies in a static
    +-2 neighborhood, so the whole prev-frame fetch is 9 shared masks +
    shifted-view FMAs — zero gathers (no per-pixel window gather and no
    packed-table build). Tap values and math are identical to
    back_projection_window, so results match bit-for-bit."""
    w, h = res
    pos = curr_gb["position"]
    curr_geom = curr_gb["geom_id"]
    curr_normal = curr_gb["normal"]
    lum = luminance(current_color)
    fx, fy, fracx, fracy, base_valid = _reproj_base(res, pos, prev_viewmat)

    iy = jnp.arange(h, dtype=jnp.int32)[:, None]
    ix = jnp.arange(w, dtype=jnp.int32)[None, :]
    ey = jnp.clip(fy - iy, -1, 1)
    ex = jnp.clip(fx - ix, -1, 1)

    # same padding contract as back_projection_window: zeros, geom -1
    pix = jnp.concatenate([
        color_history.reshape(h, w, 3),
        moment_history.reshape(h, w, 2),
        history_length.reshape(h, w, 1).astype(jnp.float32),
        prev_gb["normal"].reshape(h, w, 3),
        prev_gb["geom_id"].reshape(h, w, 1).astype(jnp.float32),
    ], axis=-1)
    padded = jnp.pad(pix, ((2, 2), (2, 2), (0, 0)))
    padded = padded.at[:2, :, 9].set(-1.0).at[-2:, :, 9].set(-1.0)
    padded = padded.at[:, :2, 9].set(-1.0).at[:, -2:, 9].set(-1.0)

    def shifted(oy, ox):
        return jax.lax.slice(padded, (2 + oy, 2 + ox, 0),
                             (2 + oy + h, 2 + ox + w, 10))

    # one mask per base-offset cell, shared by all taps and channels;
    # exactly one is hot per pixel under the gate
    masks = {(a, b): ((ey == a) & (ex == b)).astype(jnp.float32)
             for a in (-1, 0, 1) for b in (-1, 0, 1)}

    geo_f = curr_geom.astype(jnp.float32)
    taps = {}
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            vals = jnp.zeros((h, w, 10), jnp.float32)
            for (a, b), m in masks.items():
                vals = vals + m[..., None] * shifted(dy + a, dx + b)
            qx = fx + dx
            qy = fy + dy
            inb = (qx >= 0) & (qx < w) & (qy >= 0) & (qy < h)
            pg = vals[..., 9]
            same = (pg != -1) & (pg == geo_f)
            nd = jnp.linalg.norm(vals[..., 6:9] - curr_normal, axis=-1)
            taps[(dy, dx)] = (vals, inb & same & (nd <= 0.1))

    return _accumulate_from_taps(taps, base_valid, fracx, fracy,
                                 current_color, curr_geom, history_length,
                                 lum, color_alpha_min, moment_alpha_min)


def back_projection_banded(res, current_color, curr_gb, prev_gb,
                           prev_viewmat, color_history, moment_history,
                           history_length, color_alpha_min,
                           moment_alpha_min, band_rows=64, margin=16):
    """back_projection_window restructured as per-band SLAB gathers with
    a per-band dynamic vertical shift, so it handles ARBITRARY-magnitude
    smooth camera motion without ever materializing the full packed
    window table (~750 MB at 1080p). Per output band of `band_rows` rows:

      * the band's mean vertical displacement s_b (over valid-geometry
        pixels) recenters its slab via lax.dynamic_slice — a pure pan of
        ANY speed lands every tap inside a slab of just
        band_rows + 2*margin + 1 rows;
      * the 3x3x10ch window packing (90 f32/row, one gather per pixel —
        see back_projection_window) is built per-slab from the shared
        (h+4, w+4, 10) padded source, never for the whole frame.

    Horizontal motion is unbounded by construction (slabs span full
    rows). Vertical tolerance is |dy - s_b| <= ~margin; a tap whose row
    falls outside its slab is REJECTED (history restart for that pixel,
    denoise.cu:178 disocclusion semantics) rather than clamped — the
    only deviation vs back_projection_window, and it needs per-pixel
    vertical flow that differs from the band mean by >margin px/frame
    (violent rotation/parallax). Value-exact vs back_projection_window
    whenever per-band residual displacement stays within the margin:
    valid-geometry pixels index identical values; geom_id==-1 pixels
    gather arbitrary rows in EITHER path, and every tap of theirs fails
    the isReprjValid geom test, so their outputs never read the
    gathered values."""
    import jax

    w, h = res
    pos = curr_gb["position"]
    curr_geom = curr_gb["geom_id"]
    curr_normal = curr_gb["normal"]
    lum = luminance(current_color)

    fx, fy, fracx, fracy, base_valid = _reproj_base(res, pos, prev_viewmat)

    pix9 = jnp.concatenate([
        color_history.reshape(h, w, 3),
        moment_history.reshape(h, w, 2),
        history_length.reshape(h, w, 1).astype(jnp.float32),
        prev_gb["normal"].reshape(h, w, 3),
    ], axis=-1)
    pad9 = jnp.pad(pix9, ((2, 2), (2, 2), (0, 0)))
    padg = jnp.pad(prev_gb["geom_id"].astype(jnp.float32)[..., None],
                   ((2, 2), (2, 2), (0, 0)), constant_values=-1.0)
    padded = jnp.concatenate([pad9, padg], axis=-1)   # (h+4, w+4, 10)

    gh, gw = h + 2, w + 2
    n_bands = -(-h // band_rows)
    slab_h = min(band_rows + 2 * margin + 1, gh)

    gj = jnp.clip(fx + 1, 0, gw - 1)
    gi = jnp.clip(fy + 1, 0, gh - 1)
    iy = jnp.arange(h, dtype=jnp.int32)[:, None]
    dyv = fy - iy
    validg = curr_gb["geom_id"].reshape(h, w) >= 0

    outs = []
    in_slabs = []
    for b in range(n_bands):
        r0, r1 = b * band_rows, min((b + 1) * band_rows, h)
        vb = validg[r0:r1]
        cnt = jnp.maximum(jnp.sum(vb.astype(jnp.int32)), 1)
        s_b = jnp.floor(jnp.sum(jnp.where(vb, dyv[r0:r1], 0).astype(
            jnp.float32)) / cnt.astype(jnp.float32) + 0.5).astype(jnp.int32)
        # grid-row window [start, start+slab_h); padded rows add +2 halo
        start = jnp.clip(r0 + s_b - margin, 0, gh - slab_h)
        src = jax.lax.dynamic_slice(
            padded, (start, jnp.int32(0), jnp.int32(0)),
            (slab_h + 2, w + 4, 10))
        cells = []
        for a in range(3):
            for c in range(3):
                cells.append(src[a:a + slab_h, c:c + gw, :])
        slab = jax.lax.optimization_barrier(
            jnp.concatenate(cells, axis=-1).reshape(slab_h * gw, 90))
        li = gi[r0:r1] - start
        in_slabs.append((li >= 0) & (li < slab_h))
        idx = (jnp.clip(li, 0, slab_h - 1) * gw + gj[r0:r1]).reshape(-1)
        outs.append(slab[idx].reshape(r1 - r0, w, 9, 10))
    g = jnp.concatenate(outs, axis=0)
    in_slab = jnp.concatenate(in_slabs, axis=0)

    geo_f = curr_geom.astype(jnp.float32)
    taps = {}
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            a = g[..., (dy + 1) * 3 + (dx + 1), :]
            qx = fx + dx
            qy = fy + dy
            inb = ((qx >= 0) & (qx < w) & (qy >= 0) & (qy < h) & in_slab)
            pg = a[..., 9]
            same = (pg != -1) & (pg == geo_f)
            nd = jnp.linalg.norm(a[..., 6:9] - curr_normal, axis=-1)
            taps[(dy, dx)] = (a, inb & same & (nd <= 0.1))

    return _accumulate_from_taps(taps, base_valid & in_slab, fracx, fracy,
                                 current_color, curr_geom, history_length,
                                 lum, color_alpha_min, moment_alpha_min)


def motion_bounds(res, curr_gb, prev_viewmat):
    """Classify this frame's reprojection displacement: returns traced
    booleans (near, banded_ok) — near: every reprojected base within
    +-1 px of its own pixel (the gather-free stencil domain); banded_ok:
    GLOBAL vertical displacement within BAND_MARGIN (kept for tests /
    diagnostics; back_projection_banded's per-band shift now makes the
    banded path itself cover arbitrary smooth motion)."""
    w, h = res
    fx, fy, _, _, _ = _reproj_base(res, curr_gb["position"], prev_viewmat)
    iy = jnp.arange(h, dtype=jnp.int32)[:, None]
    ix = jnp.arange(w, dtype=jnp.int32)[None, :]
    # miss/background lanes (geom_id == -1) carry arbitrary positions and
    # must not veto the fast path — their taps are rejected by the geomId
    # validity test either way (isReprjValid, reference src/denoise.cu:178)
    valid = curr_gb["geom_id"].reshape(h, w) >= 0
    dyv = jnp.where(valid, jnp.abs(fy - iy), 0)
    dxv = jnp.where(valid, jnp.abs(fx - ix), 0)
    near = (jnp.max(dyv) <= 1) & (jnp.max(dxv) <= 1)
    banded_ok = jnp.max(dyv) <= BAND_MARGIN
    return near, banded_ok


def back_projection_auto(res, current_color, curr_gb, prev_gb,
                         prev_viewmat, color_history, moment_history,
                         history_length, color_alpha_min, moment_alpha_min):
    """Runtime dispatch: the gather-free stencil path when every
    reprojected base is within +-1 pixel of its own position (static or
    sub-pixel camera motion — the common interactive case); else the
    per-band-shifted slab gather (back_projection_banded), which covers
    ARBITRARY smooth camera motion. The single-gather packed-window
    path (back_projection_window) is deliberately NOT a branch here:
    its ~750 MB table at 1080p raises the program's peak device memory
    even on frames that never take it (XLA reserves cond-branch
    temporaries), and the banded path replaces it everywhere but
    >margin-per-band residual flow, where banded restarts history
    instead (see its docstring)."""
    import jax

    near, _ = motion_bounds(res, curr_gb, prev_viewmat)
    args = (current_color, curr_gb, prev_gb, prev_viewmat, color_history,
            moment_history, history_length, color_alpha_min,
            moment_alpha_min)
    return jax.lax.cond(
        near,
        lambda a: back_projection_stencil(res, *a),
        lambda a: back_projection_banded(res, *a, margin=BAND_MARGIN),
        args)


# vertical-motion bound (pixels/frame) under which the banded slab
# gather is value-exact; beyond it the full window gather runs
BAND_MARGIN = 16


def back_projection_packed2(res, current_color, curr_gb, prev_gb,
                            prev_viewmat, color_history, moment_history,
                            history_length, color_alpha_min,
                            moment_alpha_min):
    """back_projection with prev-frame data packed per 2x2 PIXEL BLOCK,
    so the whole 3x3 tap window (which always spans exactly 2x2 blocks)
    needs only FOUR row gathers."""
    import jax

    w, h = res
    hb, wb = h // 2, w // 2
    pos = curr_gb["position"]
    curr_geom = curr_gb["geom_id"]
    curr_normal = curr_gb["normal"]
    n_hist = history_length.astype(jnp.float32)
    lum = luminance(current_color)

    vs = pos @ prev_viewmat[:3, :3].T + prev_viewmat[:3, 3]
    prevx = (-(vs[..., 0] / vs[..., 2]) * 0.5 + 0.5) * w - 0.5
    prevy = (-(vs[..., 1] / vs[..., 2]) * 0.5 + 0.5) * h - 0.5
    floorx = jnp.floor(prevx)
    floory = jnp.floor(prevy)
    fracx = prevx - floorx
    fracy = prevy - floory
    fx = floorx.astype(jnp.int32)
    fy = floory.astype(jnp.int32)
    base_valid = (floorx >= 0) & (floory >= 0) & (floorx < w) & (floory < h)

    # pack per 2x2 block: slot s = (y&1)*2 + (x&1), 10 values per pixel
    def pack2(x, c):
        return x.reshape(hb, 2, wb, 2, c).transpose(0, 2, 1, 3, 4)

    pix = jnp.concatenate([
        color_history.reshape(h, w, 3),
        moment_history.reshape(h, w, 2),
        history_length.reshape(h, w, 1).astype(jnp.float32),
        prev_gb["normal"].reshape(h, w, 3),
        prev_gb["geom_id"].reshape(h, w, 1).astype(jnp.float32),
    ], axis=-1)                                    # (H, W, 10)
    table = pack2(pix, 10).reshape(hb * wb, 40)
    table = jax.lax.optimization_barrier(table)

    by0 = jnp.floor_divide(fy - 1, 2)
    bx0 = jnp.floor_divide(fx - 1, 2)
    blocks = {}
    for a in (0, 1):
        for b in (0, 1):
            by = jnp.clip(by0 + a, 0, hb - 1)
            bx = jnp.clip(bx0 + b, 0, wb - 1)
            rows = (by * wb + bx).reshape(-1)
            blocks[(a, b)] = table[rows].reshape(curr_geom.shape + (40,))

    shape = curr_geom.shape
    geo_f = curr_geom.astype(jnp.float32)
    # bilinear tap validity flags v[dy][dx] for (dy,dx) in {0,1}^2
    vbil = {k: jnp.zeros(shape, bool) for k in
            [(0, 0), (1, 0), (0, 1), (1, 1)]}
    slot_data = []
    for a in (0, 1):
        for b in (0, 1):
            g = blocks[(a, b)]
            for i in (0, 1):
                for j in (0, 1):
                    vals = g[..., (i * 2 + j) * 10:(i * 2 + j) * 10 + 10]
                    gy = 2 * (by0 + a) + i
                    gx = 2 * (bx0 + b) + j
                    dy = gy - fy
                    dx = gx - fx
                    inb = (gx >= 0) & (gx < w) & (gy >= 0) & (gy < h)
                    pg = vals[..., 9]
                    same = (pg != -1) & (pg == geo_f)
                    nd = jnp.linalg.norm(vals[..., 6:9] - curr_normal,
                                         axis=-1)
                    valid = inb & same & (nd <= 0.1)
                    slot_data.append((vals, dy, dx, valid))
                    for (ty, tx) in vbil:
                        vbil[(ty, tx)] = vbil[(ty, tx)] | (
                            (dy == ty) & (dx == tx) & valid)

    all_valid = (base_valid & vbil[(0, 0)] & vbil[(1, 0)] & vbil[(0, 1)]
                 & vbil[(1, 1)])

    pc = jnp.zeros(shape + (3,))
    pm = jnp.zeros(shape + (2,))
    ph = jnp.zeros(shape)
    sumw = jnp.zeros(shape)
    fc = jnp.zeros(shape + (3,))
    fm = jnp.zeros(shape + (2,))
    fh = jnp.zeros(shape)
    cnt = jnp.zeros(shape)
    for vals, dy, dx, valid in slot_data:
        # bilinear weight: nonzero only for (dy,dx) in {0,1}^2
        wy = jnp.where(dy == 0, 1.0 - fracy, jnp.where(dy == 1, fracy, 0.0))
        wx = jnp.where(dx == 0, 1.0 - fracx, jnp.where(dx == 1, fracx, 0.0))
        bw = jnp.where(all_valid & valid, wy * wx, 0.0)
        pc = pc + bw[..., None] * vals[..., 0:3]
        pm = pm + bw[..., None] * vals[..., 3:5]
        ph = ph + bw * vals[..., 5]
        sumw = sumw + bw
        # fallback: uniform over the valid 3x3 window
        fb = jnp.where(valid & (jnp.abs(dy) <= 1) & (jnp.abs(dx) <= 1),
                       1.0, 0.0)
        fc = fc + fb[..., None] * vals[..., 0:3]
        fm = fm + fb[..., None] * vals[..., 3:5]
        fh = fh + fb * vals[..., 5]
        cnt = cnt + fb

    bilinear_ok = all_valid & (sumw >= 0.01)
    safe = jnp.maximum(sumw, 1e-20)
    safe_cnt = jnp.maximum(cnt, 1e-20)
    fallback_ok = ~bilinear_ok & (cnt > 0)
    pc = jnp.where(bilinear_ok[..., None], pc / safe[..., None],
                   fc / safe_cnt[..., None])
    pm = jnp.where(bilinear_ok[..., None], pm / safe[..., None],
                   fm / safe_cnt[..., None])
    ph = jnp.where(bilinear_ok, ph / safe, fh / safe_cnt)

    valid = ((bilinear_ok | fallback_ok) & (history_length > 0)
             & (curr_geom != -1))
    color_alpha = jnp.maximum(1.0 / (n_hist + 1.0), color_alpha_min)
    moment_alpha = jnp.maximum(1.0 / (n_hist + 1.0), moment_alpha_min)
    acc_color = (current_color * color_alpha[..., None]
                 + pc * (1.0 - color_alpha)[..., None])
    m1 = moment_alpha * pm[..., 0] + (1.0 - moment_alpha) * lum
    m2 = moment_alpha * pm[..., 1] + (1.0 - moment_alpha) * lum * lum
    var = jnp.maximum(m2 - m1 * m1, 0.0)

    color_acc = jnp.where(valid[..., None], acc_color, current_color)
    moment_acc = jnp.where(valid[..., None], jnp.stack([m1, m2], axis=-1),
                           jnp.stack([lum, lum * lum], axis=-1))
    variance = jnp.where(valid, var, 100.0)
    history_update = jnp.where(valid, ph.astype(jnp.int32) + 1, 1)
    return variance, color_acc, moment_acc, history_update


def back_projection(res, current_color, curr_gb, prev_gb, prev_viewmat,
                    color_history, moment_history, history_length,
                    color_alpha_min, moment_alpha_min):
    """Returns (variance, color_acc, moment_acc, history_update)."""
    w, h = res
    pos = curr_gb["position"]                       # (H, W, 3)
    curr_geom = curr_gb["geom_id"]                  # (H, W) i32
    curr_normal = curr_gb["normal"]

    n_hist = history_length.astype(jnp.float32)     # N (pre-update)
    lum = luminance(current_color)

    # ---- previous-frame pixel coordinates (denoise.cu:200-207) ----
    vs = pos @ prev_viewmat[:3, :3].T + prev_viewmat[:3, 3]
    clipx = vs[..., 0] / vs[..., 2]
    clipy = vs[..., 1] / vs[..., 2]
    prevx = (-clipx * 0.5 + 0.5) * w - 0.5
    prevy = (-clipy * 0.5 + 0.5) * h - 0.5

    floorx = jnp.floor(prevx)
    floory = jnp.floor(prevy)
    fracx = prevx - floorx
    fracy = prevy - floory
    fx = floorx.astype(jnp.int32)
    fy = floory.astype(jnp.int32)

    base_valid = (floorx >= 0) & (floory >= 0) & (floorx < w) & (floory < h)

    prev_geom_img = prev_gb["geom_id"]
    prev_normal_img = prev_gb["normal"]

    # ---- 2x2 bilinear tap, all four must be valid (denoise.cu:219-259) ----
    taps = [(0, 0), (1, 0), (0, 1), (1, 1)]
    weights = [(1 - fracx) * (1 - fracy), fracx * (1 - fracy),
               (1 - fracx) * fracy, fracx * fracy]
    all_valid = base_valid
    tap_valid = []
    for dx, dy in taps:
        v = _reproj_valid(res, fx + dx, fy + dy, curr_geom, curr_normal,
                          prev_geom_img, prev_normal_img)
        tap_valid.append(v)
        all_valid = all_valid & v

    pc = jnp.zeros_like(current_color)
    pm = jnp.zeros(current_color.shape[:2] + (2,))
    ph = jnp.zeros(current_color.shape[:2])
    sumw = jnp.zeros(current_color.shape[:2])
    for (dx, dy), wgt, v in zip(taps, weights, tap_valid):
        m = (all_valid & v)
        mw = jnp.where(m, wgt, 0.0)
        pc = pc + mw[..., None] * _gather2d(color_history, fy + dy, fx + dx)
        pm = pm + mw[..., None] * _gather2d(moment_history, fy + dy, fx + dx)
        ph = ph + mw * _gather2d(history_length.astype(jnp.float32),
                                 fy + dy, fx + dx)
        sumw = sumw + mw
    bilinear_ok = all_valid & (sumw >= 0.01)
    safe = jnp.maximum(sumw, 1e-20)
    pc_b = pc / safe[..., None]
    pm_b = pm / safe[..., None]
    ph_b = ph / safe

    # ---- 3x3 uniform fallback (denoise.cu:262-286) ----
    fc = jnp.zeros_like(current_color)
    fm = jnp.zeros(current_color.shape[:2] + (2,))
    fh = jnp.zeros(current_color.shape[:2])
    cnt = jnp.zeros(current_color.shape[:2])
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            v = _reproj_valid(res, fx + dx, fy + dy, curr_geom, curr_normal,
                              prev_geom_img, prev_normal_img)
            mv = jnp.where(v, 1.0, 0.0)
            fc = fc + mv[..., None] * _gather2d(color_history, fy + dy, fx + dx)
            fm = fm + mv[..., None] * _gather2d(moment_history, fy + dy, fx + dx)
            fh = fh + mv * _gather2d(history_length.astype(jnp.float32),
                                     fy + dy, fx + dx)
            cnt = cnt + mv
    fallback_ok = ~bilinear_ok & (cnt > 0)
    safe_cnt = jnp.maximum(cnt, 1e-20)
    pc = jnp.where(bilinear_ok[..., None], pc_b, fc / safe_cnt[..., None])
    pm = jnp.where(bilinear_ok[..., None], pm_b, fm / safe_cnt[..., None])
    ph = jnp.where(bilinear_ok, ph_b, fh / safe_cnt)

    valid = (bilinear_ok | fallback_ok) & (history_length > 0) & (curr_geom != -1)

    # ---- EWMA accumulation (denoise.cu:288-307) ----
    color_alpha = jnp.maximum(1.0 / (n_hist + 1.0), color_alpha_min)
    moment_alpha = jnp.maximum(1.0 / (n_hist + 1.0), moment_alpha_min)
    acc_color = (current_color * color_alpha[..., None]
                 + pc * (1.0 - color_alpha)[..., None])
    m1 = moment_alpha * pm[..., 0] + (1.0 - moment_alpha) * lum
    m2 = moment_alpha * pm[..., 1] + (1.0 - moment_alpha) * lum * lum
    acc_moment = jnp.stack([m1, m2], axis=-1)
    var = jnp.maximum(m2 - m1 * m1, 0.0)
    hist_up = ph.astype(jnp.int32) + 1

    # ---- total rejection (denoise.cu:311-315) ----
    v3 = valid[..., None]
    color_acc = jnp.where(v3, acc_color, current_color)
    moment_acc = jnp.where(valid[..., None], acc_moment,
                           jnp.stack([lum, lum * lum], axis=-1))
    variance = jnp.where(valid, var, 100.0)
    history_update = jnp.where(valid, hist_up, 1)
    return variance, color_acc, moment_acc, history_update
