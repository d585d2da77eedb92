"""SVGF denoiser unit tests: reprojection math against hand-computed
cases, à-trous invariants, reprojection-variant parity, debug views."""

import numpy as np
import pytest

import jax.numpy as jnp

from ptdn.denoise.atrous import atrous_level, gaussian3x3
from ptdn.denoise.reproject import back_projection, luminance
from ptdn.denoise.svgf import init_denoise_state, make_denoise_fn
from ptdn.utils.config import RenderConfig

H = W = 16


def _flat_gbuffer(z=-5.0):
    """A flat wall at depth z, all same geom, normals +z."""
    ys, xs = np.mgrid[0:H, 0:W]
    pos = np.stack([xs - W / 2, ys - H / 2, np.full_like(xs, z)],
                   axis=-1).astype(np.float32)
    return {
        "position": jnp.asarray(pos),
        "normal": jnp.asarray(np.broadcast_to([0, 0, 1.0], (H, W, 3))
                              .astype(np.float32)),
        "geom_id": jnp.zeros((H, W), jnp.int32),
    }


def test_backprojection_identity_reprojection():
    """With identity view matrix & history, a static camera reprojects a
    pixel onto itself and the EWMA follows denoise.cu:288-307."""
    gb = _flat_gbuffer()
    # craft a prev view matrix that maps position -> the same pixel:
    # prevx = (-x/z*0.5 + 0.5)*W - 0.5 must equal the pixel x.
    # Use the camera basis at the origin looking down -z: view=(0,0,-1).
    vm = np.eye(4, dtype=np.float32)
    vm[2, 2] = -1.0  # view space z = -world z (camera looks down -z)
    color = jnp.full((H, W, 3), 0.5, jnp.float32)
    hist_color = jnp.full((H, W, 3), 1.0, jnp.float32)
    hist_moment = jnp.asarray(
        np.broadcast_to([0.5, 0.25], (H, W, 2)).astype(np.float32))
    hist_len = jnp.full((H, W), 4, jnp.int32)

    var, cacc, macc, hup = back_projection(
        (W, H), color, gb, gb, jnp.asarray(vm), hist_color, hist_moment,
        hist_len, jnp.float32(0.2), jnp.float32(0.2))

    var, cacc, macc, hup = map(np.asarray, (var, cacc, macc, hup))
    # the central pixels must have valid history
    c = H // 2
    lum = float(luminance(color)[c, c])
    assert hup[c, c] >= 2  # accumulated
    # alpha = max(1/5, 0.2) = 0.2: color = 0.2*cur + 0.8*prev
    valid = hup > 1
    assert valid.any()
    np.testing.assert_allclose(cacc[valid], 0.2 * 0.5 + 0.8 * 1.0, atol=1e-3)
    # moments: INVERTED alpha (denoise.cu:300-301): m = 0.2*prev + 0.8*cur
    np.testing.assert_allclose(macc[valid][:, 0],
                               0.2 * 0.5 + 0.8 * lum, atol=1e-3)
    # rejected pixels get variance 100, history 1 (denoise.cu:311-315)
    rej = hup == 1
    if rej.any():
        np.testing.assert_allclose(var[rej], 100.0)


def test_backprojection_rejects_geometry_change():
    gb_curr = _flat_gbuffer()
    gb_prev = dict(gb_curr)
    gb_prev["geom_id"] = jnp.ones((H, W), jnp.int32)  # different geom
    vm = np.eye(4, dtype=np.float32)
    vm[2, 2] = -1.0
    color = jnp.full((H, W, 3), 0.5, jnp.float32)
    var, cacc, macc, hup = back_projection(
        (W, H), color, gb_curr, gb_prev, jnp.asarray(vm), color,
        jnp.zeros((H, W, 2)), jnp.full((H, W), 4, jnp.int32),
        jnp.float32(0.2), jnp.float32(0.2))
    assert (np.asarray(hup) == 1).all()
    assert (np.asarray(var) == 100.0).all()
    np.testing.assert_allclose(np.asarray(cacc), 0.5)


def test_gaussian3x3_uniform_invariance():
    v = jnp.full((8, 8), 3.0, jnp.float32)
    out = np.asarray(gaussian3x3(v))
    np.testing.assert_allclose(out, 3.0, atol=1e-6)  # border renormalized


def test_atrous_preserves_uniform_image():
    color = jnp.full((H, W, 3), 0.25, jnp.float32)
    var = jnp.full((H, W), 1.0, jnp.float32)
    gb = _flat_gbuffer()
    gb["albedo"] = jnp.ones((H, W, 3), jnp.float32)
    gb["ialbedo"] = jnp.ones((H, W, 3), jnp.float32)
    out, var_out = atrous_level(color, var, gb, 1, False,
                                0.45, 0.2, 0.35, True, False)
    np.testing.assert_allclose(np.asarray(out), 0.25, atol=1e-5)
    # the reference normalizes propagated variance by sum(w^2)
    # (denoise.cu:161), so uniform variance is a fixed point
    np.testing.assert_allclose(np.asarray(var_out), 1.0, atol=1e-5)


def test_atrous_edge_stopping_at_normal_edge():
    """A hard normal edge must not leak color across it with small sigma."""
    color = np.zeros((H, W, 3), np.float32)
    color[:, : W // 2] = 1.0
    gb = _flat_gbuffer()
    normal = np.zeros((H, W, 3), np.float32)
    normal[:, : W // 2, 2] = 1.0
    normal[:, W // 2:, 0] = 1.0
    gb["normal"] = jnp.asarray(normal)
    gb["albedo"] = jnp.ones((H, W, 3), jnp.float32)
    gb["ialbedo"] = jnp.ones((H, W, 3), jnp.float32)
    out, _ = atrous_level(jnp.asarray(color), jnp.full((H, W), 1.0),
                          gb, 1, False, 0.45, 1e-5, 1e9, False, False)
    out = np.asarray(out)
    np.testing.assert_allclose(out[:, : W // 2], 1.0, atol=1e-3)
    np.testing.assert_allclose(out[:, W // 2:], 0.0, atol=1e-3)


def test_svgf_debug_views():
    cfg = RenderConfig(denoise_enable=True, temporal_enable=True,
                       spatial_enable=True, right_view_option=2)
    den = make_denoise_fn(cfg, (W, H))
    state = init_denoise_state((W, H))
    gb = _flat_gbuffer()
    gb["albedo"] = jnp.ones((H, W, 3), jnp.float32)
    gb["ialbedo"] = jnp.ones((H, W, 3), jnp.float32)
    raw = jnp.full((H, W, 3), 0.5, jnp.float32)
    out, st = den(state, raw, gb, jnp.eye(4), cfg.traced_params())
    # first frame: no history -> variance = 100 -> debug view = 100/0.1
    np.testing.assert_allclose(np.asarray(out), 1000.0)


def test_svgf_spatial_stub_variance():
    """Temporal off: EstimateVariance stub = 10.0 (denoise.cu:320-329)."""
    cfg = RenderConfig(denoise_enable=True, temporal_enable=False,
                       spatial_enable=True, right_view_option=2)
    den = make_denoise_fn(cfg, (W, H))
    state = init_denoise_state((W, H))
    gb = _flat_gbuffer()
    gb["albedo"] = jnp.ones((H, W, 3), jnp.float32)
    gb["ialbedo"] = jnp.ones((H, W, 3), jnp.float32)
    raw = jnp.full((H, W, 3), 0.5, jnp.float32)
    out, st = den(state, raw, gb, jnp.eye(4), cfg.traced_params())
    np.testing.assert_allclose(np.asarray(out), 100.0)  # 10.0/0.1


def test_spatial_variance_native_mode():
    """compat=False replaces the 10.0 stub with the SVGF-paper bilateral
    spatial moment estimate: on a flat wall with iid noise the estimate
    approaches the true luminance variance; across a geometric edge the
    bilateral weights keep the moments from mixing."""
    from ptdn.denoise.variance import spatial_variance

    rng = np.random.default_rng(7)
    gb = _flat_gbuffer()
    # uniform [0,1) noise, gray: luminance == channel value
    noise = rng.random((H, W, 1)).astype(np.float32)
    color = jnp.asarray(np.repeat(noise, 3, axis=-1))
    var = np.asarray(spatial_variance(color, gb, jnp.float32(0.2),
                                      jnp.float32(5.0)))
    assert var.shape == (H, W)
    # interior pixels see a full 7x7 iid window: E[var_hat] = 1/12
    interior = var[4:-4, 4:-4]
    assert abs(interior.mean() - 1.0 / 12.0) < 0.02
    assert (var >= 0).all()

    # two half-planes of constant but different luminance, separated by
    # a geometry edge: bilateral weights must not mix them (a box filter
    # would report large variance along the seam)
    gb2 = _flat_gbuffer()
    pos = np.asarray(gb2["position"]).copy()
    pos[:, W // 2:, 2] += 100.0          # far wall on the right half
    gb2["position"] = jnp.asarray(pos)
    flat = np.full((H, W, 3), 0.25, np.float32)
    flat[:, W // 2:, :] = 0.75
    var2 = np.asarray(spatial_variance(jnp.asarray(flat), gb2,
                                       jnp.float32(0.2), jnp.float32(0.5)))
    assert var2.max() < 1e-3

    # end-to-end: temporal off + compat=False routes the estimate into
    # the variance debug view (constant image -> ~0, not the stub's 100)
    cfg = RenderConfig(denoise_enable=True, temporal_enable=False,
                       spatial_enable=True, right_view_option=2,
                       compat=False)
    den = make_denoise_fn(cfg, (W, H))
    state = init_denoise_state((W, H))
    gb3 = _flat_gbuffer()
    gb3["albedo"] = jnp.ones((H, W, 3), jnp.float32)
    gb3["ialbedo"] = jnp.ones((H, W, 3), jnp.float32)
    raw = jnp.full((H, W, 3), 0.5, jnp.float32)
    out, _ = den(state, raw, gb3, jnp.eye(4), cfg.traced_params())
    np.testing.assert_allclose(np.asarray(out), 0.0, atol=1e-5)


def test_spatial_variance_short_history_fallback():
    """Temporal ON + compat=False: pixels with history < 4 frames take
    the spatial estimate; long-history pixels keep the temporal one."""
    from ptdn.denoise.variance import variance_with_spatial_fallback

    gb = _flat_gbuffer()
    color = jnp.full((H, W, 3), 0.5, jnp.float32)
    temporal_var = jnp.full((H, W), 7.0, jnp.float32)
    hist = np.full((H, W), 10, np.int32)
    hist[:4] = 1                          # fresh rows
    out = np.asarray(variance_with_spatial_fallback(
        temporal_var, jnp.asarray(hist), color, gb,
        jnp.float32(0.2), jnp.float32(5.0)))
    # constant image -> spatial estimate ~0 on the fresh rows
    np.testing.assert_allclose(out[:4], 0.0, atol=1e-5)
    np.testing.assert_allclose(out[4:], 7.0)
    # nothing below threshold -> cond skips the 49-tap filter, values
    # pass through untouched
    out2 = np.asarray(variance_with_spatial_fallback(
        temporal_var, jnp.full((H, W), 9, jnp.int32), color, gb,
        jnp.float32(0.2), jnp.float32(5.0)))
    np.testing.assert_allclose(out2, 7.0)


def test_backprojection_packed_parity():
    """The 9-gather packed reprojection must match the reference-shaped
    implementation exactly."""
    from ptdn.denoise.reproject import back_projection_packed

    rng = np.random.default_rng(5)
    h = w = 24
    gb_c = {
        "position": jnp.asarray(rng.normal(size=(h, w, 3)).astype(np.float32) * 3),
        "normal": jnp.asarray(rng.normal(size=(h, w, 3)).astype(np.float32)),
        "geom_id": jnp.asarray(rng.integers(-1, 3, size=(h, w)).astype(np.int32)),
    }
    gb_p = {
        "position": jnp.asarray(rng.normal(size=(h, w, 3)).astype(np.float32) * 3),
        "normal": jnp.asarray(gb_c["normal"] + 0.05 * rng.normal(size=(h, w, 3)).astype(np.float32)),
        "geom_id": jnp.asarray(rng.integers(-1, 3, size=(h, w)).astype(np.int32)),
    }
    vm = np.eye(4, dtype=np.float32)
    vm[2, 2] = -1.0
    color = jnp.asarray(rng.uniform(size=(h, w, 3)).astype(np.float32))
    ch = jnp.asarray(rng.uniform(size=(h, w, 3)).astype(np.float32))
    mh = jnp.asarray(rng.uniform(size=(h, w, 2)).astype(np.float32))
    hl = jnp.asarray(rng.integers(0, 6, size=(h, w)).astype(np.int32))
    args = ((w, h), color, gb_c, gb_p, jnp.asarray(vm), ch, mh, hl,
            jnp.float32(0.2), jnp.float32(0.2))
    from ptdn.denoise.reproject import (back_projection_packed2,
                                        back_projection_window)

    a = back_projection(*args)
    for impl in (back_projection_packed, back_projection_packed2,
                 back_projection_window):
        b = impl(*args)
        for x, y, name in zip(a, b, ["var", "color", "moment", "hist"]):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       atol=1e-5, err_msg=name)


@pytest.fixture
def stencil_args():
    """Inputs whose reprojection lands sub-pixel-jittered around each
    pixel center — the stencil fast path's gated domain."""
    rng = np.random.default_rng(7)
    h = w = 24
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    # positions whose reprojection through vm (vs_z = -z = 1) lands
    # sub-pixel-jittered around each pixel center
    jx = rng.uniform(-0.45, 0.45, size=(h, w)).astype(np.float32)
    jy = rng.uniform(-0.45, 0.45, size=(h, w)).astype(np.float32)
    px = xs + 0.5 + jx
    py = ys + 0.5 + jy
    z = -np.ones_like(px, np.float32)
    vx = -((px + 0.5) / w - 0.5) * 2.0
    vy = -((py + 0.5) / h - 0.5) * 2.0
    vm = np.eye(4, dtype=np.float32)
    vm[2, 2] = -1.0
    gb_c = {
        "position": jnp.asarray(np.stack([vx, vy, z], -1).astype(np.float32)),
        "normal": jnp.asarray(rng.normal(size=(h, w, 3)).astype(np.float32)),
        "geom_id": jnp.asarray(rng.integers(-1, 3, size=(h, w)).astype(np.int32)),
    }
    gb_p = {
        "position": gb_c["position"],
        # noise well below the nd<=0.1 validity threshold so ULP-level
        # fusion differences (eager vs lax.cond-compiled) can't flip taps
        "normal": jnp.asarray(np.asarray(gb_c["normal"])
                              + 0.01 * rng.normal(size=(h, w, 3)).astype(np.float32)),
        "geom_id": jnp.asarray(rng.integers(-1, 3, size=(h, w)).astype(np.int32)),
    }
    color = jnp.asarray(rng.uniform(size=(h, w, 3)).astype(np.float32))
    ch = jnp.asarray(rng.uniform(size=(h, w, 3)).astype(np.float32))
    mh = jnp.asarray(rng.uniform(size=(h, w, 2)).astype(np.float32))
    hl = jnp.asarray(rng.integers(0, 6, size=(h, w)).astype(np.int32))
    return ((w, h), color, gb_c, gb_p, jnp.asarray(vm), ch, mh, hl,
            jnp.float32(0.2), jnp.float32(0.2))


def test_backprojection_stencil_parity(stencil_args):
    """The gather-free stencil path must match back_projection_window
    BIT-exactly when every reprojected base is within +-1 px (its gate),
    and back_projection_auto must dispatch to it."""
    from ptdn.denoise.reproject import (back_projection_auto,
                                        back_projection_stencil,
                                        back_projection_window)

    args = stencil_args
    a = back_projection_window(*args)
    b = back_projection_stencil(*args)
    for x, y, name in zip(a, b, ["var", "color", "moment", "hist"]):
        assert np.array_equal(np.asarray(x), np.asarray(y)), name
    c = back_projection_auto(*args)
    for x, y, name in zip(a, c, ["var", "color", "moment", "hist"]):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   atol=1e-5, err_msg=name)


def test_backprojection_banded_parity():
    """The banded slab gather must match back_projection_window
    BIT-exactly whenever vertical displacement <= its margin (the
    back_projection_auto gate), including partial last bands and
    geom_id == -1 pixels (whose gathered rows differ between paths but
    are never read through the validity mask)."""
    from ptdn.denoise.reproject import (back_projection_banded,
                                        back_projection_window)

    rng = np.random.default_rng(11)
    h, w = 70, 48   # not divisible by band_rows: exercises partial band
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dy = rng.uniform(-14, 14, size=(h, w)).astype(np.float32)
    dx = rng.uniform(-30, 30, size=(h, w)).astype(np.float32)
    px = xs + 0.5 + dx
    py = ys + 0.5 + dy
    z = -np.ones_like(px, np.float32)
    vx = -((px + 0.5) / w - 0.5) * 2.0
    vy = -((py + 0.5) / h - 0.5) * 2.0
    vm = np.eye(4, dtype=np.float32)
    vm[2, 2] = -1.0
    gb_c = {
        "position": jnp.asarray(np.stack([vx, vy, z], -1).astype(np.float32)),
        "normal": jnp.asarray(rng.normal(size=(h, w, 3)).astype(np.float32)),
        "geom_id": jnp.asarray(rng.integers(-1, 3, size=(h, w)).astype(np.int32)),
    }
    gb_p = {
        "position": gb_c["position"],
        "normal": jnp.asarray(np.asarray(gb_c["normal"])
                              + 0.01 * rng.normal(size=(h, w, 3)).astype(np.float32)),
        "geom_id": jnp.asarray(rng.integers(-1, 3, size=(h, w)).astype(np.int32)),
    }
    color = jnp.asarray(rng.uniform(size=(h, w, 3)).astype(np.float32))
    ch = jnp.asarray(rng.uniform(size=(h, w, 3)).astype(np.float32))
    mh = jnp.asarray(rng.uniform(size=(h, w, 2)).astype(np.float32))
    hl = jnp.asarray(rng.integers(0, 6, size=(h, w)).astype(np.int32))
    args = ((w, h), color, gb_c, gb_p, jnp.asarray(vm), ch, mh, hl,
            jnp.float32(0.2), jnp.float32(0.2))
    a = back_projection_window(*args)
    b = back_projection_banded(*args, band_rows=32, margin=16)
    for x, y, name in zip(a, b, ["var", "color", "moment", "hist"]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)


def _motion_args(h, w, dy, dx, seed=13):
    """Reprojection test inputs with prescribed per-pixel displacement
    (dy, dx) in pixels (same construction as the banded parity test)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px = xs + 0.5 + dx
    py = ys + 0.5 + dy
    z = -np.ones_like(px, np.float32)
    vx = -((px + 0.5) / w - 0.5) * 2.0
    vy = -((py + 0.5) / h - 0.5) * 2.0
    vm = np.eye(4, dtype=np.float32)
    vm[2, 2] = -1.0
    gb_c = {
        "position": jnp.asarray(np.stack([vx, vy, z], -1).astype(np.float32)),
        "normal": jnp.asarray(rng.normal(size=(h, w, 3)).astype(np.float32)),
        "geom_id": jnp.asarray(rng.integers(-1, 3, size=(h, w)).astype(np.int32)),
    }
    gb_p = {
        "position": gb_c["position"],
        "normal": jnp.asarray(np.asarray(gb_c["normal"])
                              + 0.01 * rng.normal(size=(h, w, 3)).astype(np.float32)),
        "geom_id": jnp.asarray(rng.integers(-1, 3, size=(h, w)).astype(np.int32)),
    }
    color = jnp.asarray(rng.uniform(size=(h, w, 3)).astype(np.float32))
    ch = jnp.asarray(rng.uniform(size=(h, w, 3)).astype(np.float32))
    mh = jnp.asarray(rng.uniform(size=(h, w, 2)).astype(np.float32))
    hl = jnp.asarray(rng.integers(0, 6, size=(h, w)).astype(np.int32))
    return ((w, h), color, gb_c, gb_p, jnp.asarray(vm), ch, mh, hl,
            jnp.float32(0.2), jnp.float32(0.2))


def test_backprojection_banded_fast_pan_exact():
    """Per-band shifts must make the banded path BIT-exact vs
    back_projection_window for motion FAR beyond the static margin —
    here a ~40 px/frame pan (2.5x margin) with +-8 px local scatter —
    so back_projection_auto needs no packed-window fallback branch (and
    its ~750 MB 1080p table never enters the animated program)."""
    from ptdn.denoise.reproject import (back_projection_auto,
                                        back_projection_banded,
                                        back_projection_window)

    rng = np.random.default_rng(17)
    h, w = 70, 48
    dy = (40.0 + rng.uniform(-8, 8, size=(h, w))).astype(np.float32)
    dx = (-25.0 + rng.uniform(-30, 30, size=(h, w))).astype(np.float32)
    args = _motion_args(h, w, dy, dx)
    a = back_projection_window(*args)
    b = back_projection_banded(*args, band_rows=32, margin=16)
    for x, y, name in zip(a, b, ["var", "color", "moment", "hist"]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)
    c = back_projection_auto(*args)
    for x, y, name in zip(a, c, ["var", "color", "moment", "hist"]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)


def test_backprojection_banded_residual_overflow_rejects():
    """A pixel whose vertical flow deviates from its band's mean by more
    than the slab tolerance must have its history REJECTED (restart:
    hist=1, variance=100), never silently read a clamped row."""
    from ptdn.denoise.reproject import back_projection_banded

    h, w = 64, 48
    dy = np.zeros((h, w), np.float32)
    dy[5, 7] = 30.0          # lone outlier vs band mean ~0
    dx = np.zeros((h, w), np.float32)
    args = _motion_args(h, w, dy, dx, seed=19)
    # force the outlier pixel to valid geometry so rejection can only
    # come from the slab bound
    gb_c = dict(args[2])
    geom = np.asarray(gb_c["geom_id"]).copy()
    geom[5, 7] = 1
    gb_c["geom_id"] = jnp.asarray(geom)
    args = (args[0], args[1], gb_c) + args[3:]
    var, color, mom, hist = back_projection_banded(
        *args, band_rows=32, margin=16)
    assert int(np.asarray(hist)[5, 7]) == 1
    assert float(np.asarray(var)[5, 7]) == 100.0
