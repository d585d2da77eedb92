"""Engine integration tests: trace correctness invariants, accumulation
semantics, determinism, config behavior. Small resolutions keep the CPU
suite fast."""

import numpy as np
import pytest

import jax.numpy as jnp

from ptdn.engine import Renderer
from ptdn.engine.wavefront import make_intersector, sample_texture
from ptdn.scene import Scene
from ptdn.utils.config import RenderConfig

from ptdn.utils.assets import scenes_dir

scene_path_str = str(scenes_dir())

RES = (96, 96)


@pytest.fixture(scope="module")
def cornell():
    return Scene(scene_path_str + "/cornell.txt")


def test_primary_intersection_gbuffer(cornell):
    cfg = RenderConfig()
    r = Renderer(cornell, cfg, resolution=RES)
    from ptdn.engine.wavefront import make_trace_fn

    trace = make_trace_fn(cornell, cfg, RES)
    cam = r.camera.frame().as_pytree()
    radiance, gb, _ = trace(r.ds, cam, r._params, jnp.uint32(0))
    geom = np.asarray(gb["geom_id"]).reshape(RES[1], RES[0])
    # central pixel sees the back wall (mesh, geom 3) or nearby objects
    assert geom[RES[1] // 2, RES[0] // 2] >= 0
    # the ceiling light (geom 0) is visible near the image top center
    assert (geom == 0).sum() > 0
    # most pixels hit something
    assert (geom >= 0).mean() > 0.7
    n = np.asarray(gb["normal"]).reshape(RES[1], RES[0], 3)
    hit = geom >= 0
    norms = np.linalg.norm(n[hit], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-3)


def test_light_pixels_emit(cornell):
    cfg = RenderConfig(denoise_enable=False)
    r = Renderer(cornell, cfg, resolution=RES)
    left, right = r.render(1)
    # emittance 5 -> light pixels are the brightest (value 5)
    assert left.max() == pytest.approx(5.0, rel=1e-5)
    assert left.mean() > 0.01
    assert not np.isnan(left).any()


def test_accumulation_running_mean(cornell):
    cfg = RenderConfig(denoise_enable=False)
    r = Renderer(cornell, cfg, resolution=RES)
    frames = []
    for _ in range(3):
        left, _ = r.render_frame()
        frames.append(np.asarray(left))
    # variance decreases with accumulation: frame-to-frame delta shrinks
    d01 = np.abs(frames[1] - frames[0]).mean()
    d12 = np.abs(frames[2] - frames[1]).mean()
    assert d12 < d01


def test_determinism_same_frame(cornell):
    cfg = RenderConfig(denoise_enable=False)
    r1 = Renderer(cornell, cfg, resolution=RES)
    r2 = Renderer(cornell, cfg, resolution=RES)
    a, _ = r1.render(2)
    b, _ = r2.render(2)
    np.testing.assert_array_equal(a, b)


def test_camera_change_resets_accumulation(cornell):
    cfg = RenderConfig(denoise_enable=False)
    r = Renderer(cornell, cfg, resolution=RES)
    r.render(2)
    assert r.frame == 2
    r.orbit(dphi=0.3)
    r.render_frame()
    assert r.frame == 1  # reset happened


def test_denoise_does_not_reset_on_camera_change(cornell):
    cfg = RenderConfig(denoise_enable=True, temporal_enable=True,
                       spatial_enable=True)
    r = Renderer(cornell, cfg, resolution=RES)
    r.render(2)
    r.orbit(dphi=0.05)
    r.render_frame()
    assert r.frame == 3  # temporal history survives (main.cpp:172)


def test_denoised_output_smoother(cornell):
    cfg = RenderConfig(denoise_enable=True, temporal_enable=True,
                       spatial_enable=True)
    r = Renderer(cornell, cfg, resolution=RES)
    left = right = None
    for _ in range(4):
        left, right = r.render_frame()
    left, right = np.asarray(left), np.asarray(right)

    def tv(img):  # total variation as noise proxy
        return (np.abs(np.diff(img, axis=0)).mean()
                + np.abs(np.diff(img, axis=1)).mean())

    # SVGF preserves real edges, so TV cannot go to zero; but it must
    # clearly beat the raw 1-spp image
    assert not np.isnan(right).any()
    assert tv(right) < 0.7 * tv(left)


def test_texture_sampling(cornell):
    ds = cornell.device()
    uv = jnp.asarray([[0.5, 0.5], [0.0, 1.0]], jnp.float32)
    texid = jnp.asarray([0, 0], jnp.int32)
    c = np.asarray(sample_texture(ds, texid, uv))
    assert c.shape == (2, 3)
    assert (c >= 0).all() and (c <= 1).all()
    # uv (0,1): V flip puts it at row 0, col 0
    w, h = int(ds.tex_wh[0, 0]), int(ds.tex_wh[0, 1])
    expect = np.asarray(ds.tex_atlas[0, 0, 0]) * 0.003921568627
    np.testing.assert_allclose(c[1], expect, atol=1e-6)


def test_intersector_tie_break_first_geom(cornell):
    """Strict-< update: earlier geom index wins exact ties."""
    cfg = RenderConfig()
    intersect = make_intersector(cornell, cfg)
    ds = cornell.device()
    # ray straight down onto a clear patch of floor (geom 1, thin cube y=0)
    o = jnp.asarray([[4.5, 5.0, 4.5]], jnp.float32)
    d = jnp.asarray([[0.0, -1.0, 0.0]], jnp.float32)
    out = intersect(ds, o, d)
    assert int(out["geom_id"][0]) == 1
    assert float(out["t"][0]) == pytest.approx(4.995, abs=1e-2)


def test_miss_semantics(cornell):
    cfg = RenderConfig()
    intersect = make_intersector(cornell, cfg)
    ds = cornell.device()
    o = jnp.asarray([[0.0, 5.0, 30.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)  # away from the scene
    out = intersect(ds, o, d)
    assert int(out["geom_id"][0]) == -1
    assert float(out["t"][0]) == -1.0


def test_refractive_scene_runs():
    s = Scene(scene_path_str + "/diamond.txt")
    r = Renderer(s, RenderConfig(denoise_enable=False), resolution=(64, 64))
    left, _ = r.render(2)
    assert not np.isnan(left).any()
    assert left.max() > 0


def test_compat_false_renders_and_differs(cornell):
    """cfg.compat=False (fixed barycentric normal weights) must work end
    to end; cornell has a mesh back wall with non-uniform vertex normals
    only after smoothing — the render stays finite and the two modes
    agree except where the quirk changes shading (the wall is flat, so
    images stay close). The flag must hold on both mesh routes: brute
    force (cornell's default) and the BVH traversal."""
    def render(compat, mesh_mode="auto"):
        cfg = RenderConfig(backend="xla", trace_depth=3,
                           denoise_enable=False, compat=compat,
                           mesh_mode=mesh_mode)
        r = Renderer(cornell, cfg, resolution=(64, 64))
        left, _ = r.render_frame()
        return np.asarray(left)

    a = render(True)
    b = render(False)
    assert np.isfinite(b).all()
    # cornell's mesh wall is flat (all vertex normals equal) so the
    # swapped weights are value-neutral there: fixed mode must match
    np.testing.assert_allclose(a, b, atol=1e-5)
    # the BVH route honors the flag too (boundary pixels may pick a
    # different winner on exact-tie triangles)
    c = render(False, "bvh")
    assert np.isfinite(c).all()
    diff = np.abs(b - c).max(axis=-1)
    assert (diff > 1e-3).mean() < 0.01


_TWO_LIGHT_HEAD = """\
MATERIAL 0
RGB         1 1 1
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   5

MATERIAL 1
RGB         .9 .9 .9
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   0

MATERIAL 2
RGB         {rgb2}
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   5

CAMERA
RES         48 48
FOVY        45
FILE        twolight
EYE         0 5 10
LOOKAT      0 5 0
UP          0 1 0

OBJECT 0
cube
material 0
TRANS       -3 10 0
ROTAT       0 0 0
SCALE       2 .3 2

OBJECT 1
cube
material 1
TRANS       0 0 0
ROTAT       0 0 0
SCALE       12 .01 12

OBJECT 2
cube
material 2
TRANS       3 10 0
ROTAT       0 0 0
SCALE       2 .3 2

OBJECT 3
cube
material 1
TRANS       0 5 -4
ROTAT       0 0 0
SCALE       12 10 .01
"""


def _two_light_scene(tmp_path, rgb2="1 1 1"):
    p = tmp_path / "twolight.txt"
    p.write_text(_TWO_LIGHT_HEAD.format(rgb2=rgb2))
    return Scene(str(p))


def test_uniform_light_selection_native_mode(tmp_path):
    """PARITY.md quirk #6: compat=True NEE-samples only geom 0
    (pathtrace.cu:359-361); compat=False picks uniformly among emissive
    geoms and weights by n_lights. With a second REAL light the native
    render must pick up its direct contribution (brighter right side);
    with a second BLACK-emissive light (color 0, emittance > 0 — still
    in the light list) the estimator's x2 weight and 1/2 selection odds
    cancel, so the native mean must equal the compat mean."""
    scene = _two_light_scene(tmp_path)
    assert len(scene.lights) == 2

    def render_mean(scene, compat, frames=48):
        cfg = RenderConfig(backend="xla", trace_depth=2,
                           denoise_enable=False, compat=compat)
        r = Renderer(scene, cfg, resolution=(48, 48))
        left = None
        for _ in range(frames):
            left, _ = r.render_frame()
        return np.asarray(left)

    a = render_mean(scene, True)
    b = render_mean(scene, False)
    assert np.isfinite(b).all() and (b >= 0).all()
    # the second light sits over the RIGHT half; only native lights it
    # directly, so the floor's right half must brighten vs compat
    right_gain = b[24:, 24:].mean() - a[24:, 24:].mean()
    assert right_gain > 0.02, f"second light not sampled ({right_gain=})"

    # normalization check: black second light => identical expectation
    dark = _two_light_scene(tmp_path, rgb2="0 0 0")
    c = render_mean(dark, True)
    d = render_mean(dark, False)
    # same estimator mean despite half the NEE draws hitting the black
    # light at double weight; 48 accumulated frames, loose tolerance
    assert abs(d.mean() - c.mean()) / c.mean() < 0.05


def test_sticky_diffuse_skips_emissive_hit_hand_computed(tmp_path):
    """PARITY.md quirk #5 at a hand-computed 3-bounce sequence.

    The reference never resets the `diffuse` path flag after a diffuse
    bounce (interactions.h:102 is commented out), and with
    shadow_ray+reduce_var on, an emissive hit adds NOTHING to a flagged
    path (pathtrace.cu:331-336) — even after intermediate SPECULAR
    bounces. Scene built so radiance is closed-form independent of the
    RNG stream:

      * geom 0: a giant emissive box ENCLOSING everything (every
        scattered ray terminates on it, and it is the NEE target),
      * geom 1: a thin diffuse plate the camera looks down at
        (EYE is given MIRRORED below the look-at: the replicated
        resetCamera quirk — acos(view.y) in main.cpp:77-101 measures
        theta from +y — rebuilds the eye at (0, 4, 0.5) ABOVE it),
      * geom 2: an off-axis mirror slab high above (+x side), so part
        of the cosine hemisphere takes plate -> MIRROR -> enclosure
        (3 bounces) and the rest plate -> enclosure (2 bounces).

    With the quirk, both path shapes contribute exactly the plate's
    one NEE term C1 (every later emissive hit is skipped). Without
    reduce_var the same paths also add throughput*E at the terminal
    hit, and throughput is the plate albedo A for BOTH shapes (the
    mirror's SPECRGB is 1), so:

        radiance(skip)             == C1            (plate pixels)
        radiance(noskip) - (skip)  == A * E         (plate pixels)
        enclosure-first pixels     == E, difference 0

    C1 = A * E * shadow_intensity / d^2 * lambert with the NEE sample
    pinned to the light CENTER by light_radius=0 (computeShadowRay,
    pathtrace.cu:284-297). The two runs share RNG streams, so the
    difference isolates exactly the add_emit gate."""
    scene_txt = """\
MATERIAL 0
RGB         1 .8 .6
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   5

MATERIAL 1
RGB         .5 .25 .8
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   0

MATERIAL 2
RGB         .9 .9 .9
SPECEX      5
SPECRGB     1 1 1
REFL        1
REFR        0
REFRIOR     0
EMITTANCE   0

CAMERA
RES         8 8
FOVY        45
FILE        sticky
EYE         0 -3.5 0.5
LOOKAT      0 0.25 0
UP          0 1 0

OBJECT 0
cube
material 0
TRANS       0 10 0
ROTAT       0 0 0
SCALE       100 100 100

OBJECT 1
cube
material 1
TRANS       0 0.24 0
ROTAT       0 0 0
SCALE       .5 .02 .5

OBJECT 2
cube
material 2
TRANS       30 5 0
ROTAT       0 0 0
SCALE       40 .2 80
"""
    path = tmp_path / "sticky.txt"
    path.write_text(scene_txt)
    scene = Scene(str(path))
    assert scene.geom_types[0] != 3  # light is analytic (cube)

    from ptdn.engine.wavefront import make_trace_fn
    from ptdn.ops.camera import generate_camera_rays

    res = (8, 8)

    def render(reduce_var):
        cfg = RenderConfig(backend="xla", trace_depth=8,
                           denoise_enable=False, shadow_ray=True,
                           reduce_var=reduce_var, light_radius=0.0,
                           shadow_intensity=2.7)
        r = Renderer(scene, cfg, resolution=res)
        trace = make_trace_fn(scene, cfg, res)
        cam = r.camera.frame().as_pytree()
        rad, _, _ = trace(r.ds, cam, r._params, jnp.uint32(0))
        return np.asarray(rad, np.float64), cam

    skip, cam = render(True)
    noskip, _ = render(False)

    # --- hand-computed expectation (float64 numpy, no engine code) ---
    o, d = generate_camera_rays(cam, res)
    o = np.asarray(o, np.float64)
    d = np.asarray(d, np.float64)
    bmin = np.array([-0.25, 0.23, -0.25])
    bmax = np.array([0.25, 0.25, 0.25])
    t0 = (bmin - o) / d
    t1 = (bmax - o) / d
    tlo, thi = np.minimum(t0, t1), np.maximum(t0, t1)
    tmin, tmax = tlo.max(-1), thi.min(-1)
    hit = (tmax >= tmin) & (tmin > 0)
    # geometry sanity: every plate hit is on the TOP face, comfortably
    # inside the edges (no engine-vs-numpy tie ambiguity)
    assert hit.any() and not hit.all()
    assert (np.argmax(tlo, -1)[hit] == 1).all() and (d[hit, 1] < 0).all()
    p = o + tmin[:, None] * d
    assert (np.abs(p[hit][:, [0, 2]]) < 0.25 - 1e-3).all()

    E = np.array([1.0, 0.8, 0.6]) * 5.0
    A = np.array([0.5, 0.25, 0.8])
    nrm = np.array([0.0, 1.0, 0.0])
    s_origin = p + 1e-4 * nrm
    delta = np.array([0.0, 10.0, 0.0]) - s_origin
    dist = np.linalg.norm(delta, axis=-1)
    lam = np.maximum(0.0, (delta / dist[:, None]) @ nrm)
    c1 = (A * E)[None] * (2.7 / dist**2 * lam)[:, None]

    expected_skip = np.where(hit[:, None], c1, E[None])
    np.testing.assert_allclose(skip, expected_skip, rtol=3e-5, atol=1e-6)
    # the difference isolates the skipped terminal emission: A*E on
    # plate paths (identical RNG streams -> identical geometry/paths)
    expected_diff = np.where(hit[:, None], (A * E)[None], 0.0)
    np.testing.assert_allclose(noskip - skip, expected_diff,
                               rtol=3e-5, atol=1e-6)
