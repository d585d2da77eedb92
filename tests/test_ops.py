"""Device-math unit tests: RNG bit-exactness, intersections vs closed form,
BVH traversal vs brute force, BSDF sampling invariants."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ptdn.ops import bsdf, intersect, rng
from ptdn.ops.bvh_traverse import mesh_brute_force, mesh_bvh_batched
from ptdn.ops.camera import OrbitCamera, generate_camera_rays, view_matrix

from ptdn.utils.assets import scenes_dir

scene_path_str = str(scenes_dir())


# ---------------- RNG ----------------

def _ref_init_rand(v0, v1, backoff=16):
    """Pure-python reimplementation of interactions.h:10-22 for oracle."""
    M = 0xFFFFFFFF
    s0 = 0
    for _ in range(backoff):
        s0 = (s0 + 0x9E3779B9) & M
        v0 = (v0 + ((((v1 << 4) & M) + 0xA341316C) & M ^ ((v1 + s0) & M)
                    ^ (((v1 >> 5) + 0xC8013EA4) & M))) & M
        v1 = (v1 + ((((v0 << 4) & M) + 0xAD90777D) & M ^ ((v0 + s0) & M)
                    ^ (((v0 >> 5) + 0x7E95761E) & M))) & M
    return v0


def _ref_next_rand(s):
    s = (1664525 * s + 1013904223) & 0xFFFFFFFF
    return s, float(s & 0x00FFFFFF) / float(0x01000000)


def test_init_rand_bit_exact():
    vals0 = np.array([0, 1, 12345, 640000 - 1, 2**31], np.uint32)
    vals1 = np.array([0, 1, 7, 99, 3], np.uint32)
    got = np.asarray(rng.init_rand(jnp.asarray(vals0), jnp.asarray(vals1)))
    want = np.array([_ref_init_rand(int(a), int(b)) for a, b in zip(vals0, vals1)],
                    np.uint32)
    np.testing.assert_array_equal(got, want)


def test_next_rand_bit_exact_stream():
    seed = rng.init_rand(jnp.asarray([42], np.uint32), jnp.asarray([7], np.uint32))
    s_ref = _ref_init_rand(42, 7)
    for _ in range(10):
        seed, val = rng.next_rand(seed)
        s_ref, v_ref = _ref_next_rand(s_ref)
        assert int(seed[0]) == s_ref
        assert float(val[0]) == pytest.approx(v_ref, abs=0)


def test_next_rand_masked_stream_position():
    seed0 = jnp.asarray([100, 100], np.uint32)
    mask = jnp.asarray([True, False])
    s1, _ = rng.next_rand_masked(seed0, mask)
    assert int(s1[0]) != 100 and int(s1[1]) == 100


# ---------------- intersections ----------------

def _id4():
    return jnp.eye(4, dtype=jnp.float32)


def test_sphere_closed_form():
    o = jnp.asarray([[0, 0, 5.0], [0, 0, 5.0], [0, 0, 0.0]], jnp.float32)
    d = jnp.asarray([[0, 0, -1.0], [0, 1, 0.0], [0, 0, -1.0]], jnp.float32)
    t, p, n, outside, hit = intersect.sphere_intersect(_id4(), _id4(), _id4(), o, d)
    assert bool(hit[0]) and not bool(hit[1]) and bool(hit[2])
    assert float(t[0]) == pytest.approx(4.5, abs=1e-3)
    np.testing.assert_allclose(np.asarray(n[0]), [0, 0, 1], atol=1e-4)
    # ray from inside: normal flipped, outside False
    assert not bool(outside[2])
    np.testing.assert_allclose(np.asarray(n[2]), [0, 0, 1], atol=1e-3)


def test_box_closed_form():
    o = jnp.asarray([[0, 0, 5.0], [2, 0, 5.0]], jnp.float32)
    d = jnp.asarray([[0, 0, -1.0], [0, 0, -1.0]], jnp.float32)
    t, p, n, outside, hit = intersect.box_intersect(_id4(), _id4(), o, d)
    assert bool(hit[0]) and not bool(hit[1])
    assert float(t[0]) == pytest.approx(4.5, abs=1e-3)
    np.testing.assert_allclose(np.asarray(n[0]), [0, 0, 1], atol=1e-5)


def test_box_transformed():
    from ptdn.utils import math3d

    m = math3d.build_transformation_matrix([0, 2, 0], [0, 0, 0], [4, 4, 4])
    inv = np.linalg.inv(m.astype(np.float64)).astype(np.float32)
    o = jnp.asarray([[0, 2, 10.0]], jnp.float32)
    d = jnp.asarray([[0, 0, -1.0]], jnp.float32)
    t, p, n, outside, hit = intersect.box_intersect(
        jnp.asarray(m), jnp.asarray(inv), o, d)
    assert bool(hit[0])
    assert float(t[0]) == pytest.approx(8.0, abs=1e-3)


def test_triangle_backface_culling():
    v0 = jnp.asarray([[-1, -1, 0.0]], jnp.float32)
    v1 = jnp.asarray([[1, -1, 0.0]], jnp.float32)
    v2 = jnp.asarray([[0, 1, 0.0]], jnp.float32)
    o = jnp.asarray([[0, 0, 5.0]], jnp.float32)
    d = jnp.asarray([[0, 0, -1.0]], jnp.float32)
    # front face (counter-clockwise from +z): e1 x e2 points +z -> a > 0
    t, u, v, hit = intersect.ray_triangle(o, d, v0, v1, v2)
    assert bool(hit[0]) and float(t[0]) == pytest.approx(5.0, abs=1e-5)
    # from behind: culled (glm intersect.inl:53-54)
    t2, _, _, hit2 = intersect.ray_triangle(-o, -d, v0, v1, v2)
    assert not bool(hit2[0])


# ---------------- BVH traversal vs brute force ----------------

MESH_SCENES = ["bunny.txt", "cornell.txt", "diamond.txt", "room.txt",
               "terrain30k.txt"]


def _mesh_rays(s, kind, n=256, seed=0):
    """Camera rays (16x16 through the scene camera) or scattered rays
    (random origins around the first mesh, aimed near its center)."""
    if kind == "camera":
        fr = OrbitCamera(s.camera, resolution=(16, 16)).frame()
        o, d = generate_camera_rays(fr.as_pytree(), (16, 16))
        return np.asarray(o), np.asarray(d)
    rng_np = np.random.default_rng(seed)
    center = (s.mesh_bb_min[0] + s.mesh_bb_max[0]) / 2
    o = (center + rng_np.normal(size=(n, 3)) * 8).astype(np.float32)
    d = (center - o) + rng_np.normal(size=(n, 3)) * 0.5
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("kind", ["camera", "scattered"])
@pytest.mark.parametrize("scene_name", MESH_SCENES)
def test_bvh_matches_brute_force(scenes_dir, scene_name, kind):
    from ptdn.scene import Scene

    s = Scene(str(scenes_dir / scene_name))
    ds = s.device()
    o, d = _mesh_rays(s, kind)
    tb, ub, vb, ib, hb = mesh_brute_force(ds, jnp.asarray(o), jnp.asarray(d),
                                          s.n_tris)
    max_prims = int(s.bvh.prim_count.max())
    tv, uv, vv, iv, hv = mesh_bvh_batched(ds, jnp.asarray(o), jnp.asarray(d),
                                          max_prims=max(max_prims, 1))
    m = np.asarray(hb)
    assert m.any()
    np.testing.assert_array_equal(m, np.asarray(hv))
    np.testing.assert_allclose(np.asarray(tb)[m], np.asarray(tv)[m], rtol=1e-5)
    # same triangle except exact-tie cases
    same = np.asarray(ib)[m] == np.asarray(iv)[m]
    assert same.mean() > 0.99


# ---------------- CUDA traversal wrapper ----------------

@pytest.fixture(scope="module")
def bunny(scenes_dir):
    from ptdn.scene import Scene

    return Scene(str(scenes_dir / "bunny.txt"))


@pytest.mark.parametrize("n", [1, 129, 1000])
def test_cuda_wrapper_pads_and_slices(bunny, n):
    """closest_hit pads the ray count to the kernel's block size, hands
    the kernel whole blocks, and slices its results back; with the plain
    traversal in the kernel's place it must reproduce mesh_bvh_batched."""
    from ptdn.ops import cuda_bvh

    ds = bunny.device()
    max_prims = int(bunny.bvh.prim_count.max())
    o, d = _mesh_rays(bunny, "scattered", n=n, seed=n)
    plain = cuda_bvh.plain_call(max_prims)
    sizes = []

    def spy(o_, d_, *scene):
        sizes.append(o_.shape[0])
        return plain(o_, d_, *scene)

    got = cuda_bvh.closest_hit(ds, jnp.asarray(o), jnp.asarray(d), call=spy)
    want = mesh_bvh_batched(ds, jnp.asarray(o), jnp.asarray(d),
                            max_prims=max_prims)
    assert sizes == [-(-n // cuda_bvh.BLOCK) * cuda_bvh.BLOCK]
    for g, w in zip(got, want):
        assert g.shape == (n,)
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6)


def test_cuda_wrapper_shard_map_rows(bunny):
    """On a device mesh the call runs under shard_map over rows: each of
    4 virtual CPU devices gets its own 200 rays (padded to a block), the
    scene replicated; results equal the unsharded traversal."""
    from ptdn.ops import cuda_bvh
    from ptdn.parallel.mesh import make_mesh

    mesh = make_mesh(4, devices=jax.devices("cpu")[:4])
    ds = bunny.device()
    max_prims = int(bunny.bvh.prim_count.max())
    o, d = _mesh_rays(bunny, "scattered", n=800, seed=4)
    plain = cuda_bvh.plain_call(max_prims)
    sizes = []

    def spy(o_, d_, *scene):
        sizes.append(o_.shape[0])
        return plain(o_, d_, *scene)

    got = jax.jit(lambda o_, d_: cuda_bvh.closest_hit(
        ds, o_, d_, mesh=mesh, call=spy))(jnp.asarray(o), jnp.asarray(d))
    want = mesh_bvh_batched(ds, jnp.asarray(o), jnp.asarray(d),
                            max_prims=max_prims)
    assert sizes == [256]           # traced once, on a 200-ray shard
    assert len(got[0].sharding.device_set) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["camera", "scattered"])
@pytest.mark.parametrize("scene_name", ["bunny.txt", "terrain30k.txt"])
def test_cuda_kernel_matches_plain(gpu, scenes_dir, scene_name, kind):
    """The CUDA kernel against the plain traversal on the card: the same
    triangle on >= 99.9% of rays; where it agrees, |dt| <= 1e-5 t and
    |du|, |dv| <= 1e-5 (float32, no matrix products involved)."""
    from ptdn.ops import cuda_bvh
    from ptdn.scene import Scene

    s = Scene(str(scenes_dir / scene_name))
    ds = s.device()
    o, d = (jnp.asarray(x) for x in _mesh_rays(s, kind, n=4096))
    cuda_bvh.load()
    t1, u1, v1, i1, h1 = map(np.asarray, cuda_bvh.closest_hit(ds, o, d))
    t0, u0, v0, i0, h0 = map(np.asarray, mesh_bvh_batched(
        ds, o, d, max_prims=int(s.bvh.prim_count.max())))
    same = i1 == i0
    assert same.mean() >= 0.999
    hit = same & h0
    assert (np.abs(t1 - t0)[hit] <= 1e-5 * np.abs(t0)[hit]).all()
    assert (np.abs(u1 - u0)[hit] <= 1e-5).all()
    assert (np.abs(v1 - v0)[hit] <= 1e-5).all()


# ---------------- BSDF ----------------

def test_cosine_hemisphere_distribution():
    n = jnp.broadcast_to(jnp.asarray([0.0, 0, 1]), (20000, 3))
    key_up = jnp.asarray(np.random.default_rng(1).uniform(size=20000), jnp.float32)
    key_ar = jnp.asarray(np.random.default_rng(2).uniform(size=20000), jnp.float32)
    d = np.asarray(bsdf.cosine_hemisphere(n, key_up, key_ar))
    assert (d[:, 2] > -1e-6).all()
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-4)
    # cosine-weighted: E[cos] = 2/3
    assert abs(d[:, 2].mean() - 2 / 3) < 0.01


def test_reflect_refract():
    i = jnp.asarray([[0.70710678, 0.0, -0.70710678]], jnp.float32)
    n = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    r = np.asarray(bsdf.reflect(i, n))
    np.testing.assert_allclose(r, [[0.70710678, 0, 0.70710678]], atol=1e-6)
    # refraction into denser medium bends toward normal
    t = np.asarray(bsdf.refract(i, n, jnp.asarray([1 / 1.5], jnp.float32)))
    assert abs(t[0, 0]) < abs(i[0, 0])
    # TIR returns zero vector
    t2 = np.asarray(bsdf.refract(
        jnp.asarray([[0.99, 0.0, -0.14106736]], jnp.float32), n,
        jnp.asarray([1.5], jnp.float32)))
    np.testing.assert_allclose(t2, 0.0, atol=1e-7)


def test_quat_rotate_from_z():
    dest = jnp.asarray([[0.0, 1.0, 0.0], [0, 0, 1], [0, 0, -1]], jnp.float32)
    p = jnp.asarray([[0.0, 0, 1], [0, 0, 1], [0, 0, 1]], jnp.float32)
    out = np.asarray(bsdf.quat_rotate_from_z(dest, p))
    np.testing.assert_allclose(out[0], [0, 1, 0], atol=1e-6)   # z -> y
    np.testing.assert_allclose(out[1], [0, 0, 1], atol=1e-6)   # identity
    np.testing.assert_allclose(out[2], [0, 0, -1], atol=1e-6)  # opposite


def test_scatter_rng_stream_parity():
    """Diffuse lanes must consume exactly 3 variates, specular exactly 1."""
    seed = jnp.asarray([123, 123], np.uint32)
    direction = jnp.asarray([[0, 0, -1.0]] * 2, jnp.float32)
    color = jnp.ones((2, 3), jnp.float32)
    pos = jnp.zeros((2, 3), jnp.float32)
    nrm = jnp.asarray([[0, 0, 1.0]] * 2, jnp.float32)
    refl = jnp.asarray([0.0, 1.0], jnp.float32)   # lane0 diffuse, lane1 mirror
    refr = jnp.zeros(2, jnp.float32)
    ior = jnp.ones(2, jnp.float32)
    spec = jnp.full((2, 3), 0.5, jnp.float32)
    active = jnp.asarray([True, True])
    out_seed, o, d, c, diff, specf = bsdf.scatter_ray(
        seed, direction, color, pos, nrm, refl, refr, ior, spec, active)
    s = 123
    for _ in range(3):
        s, _ = _ref_next_rand(s)
    assert int(out_seed[0]) == s                    # 3 draws
    s1, _ = _ref_next_rand(123)
    assert int(out_seed[1]) == s1                   # 1 draw
    assert bool(diff[0]) and not bool(diff[1])
    assert bool(specf[1]) and not bool(specf[0])
    np.testing.assert_allclose(np.asarray(c[1]), 0.5, atol=1e-6)


# ---------------- camera ----------------

def test_orbit_camera_cornell():
    from ptdn.scene import Scene

    s = Scene(scene_path_str + "/cornell.txt")
    cam = OrbitCamera(s.camera)
    fr = cam.frame()
    # cornell: EYE (0,5,10.5) LOOKAT (0,5,0) -> reconstruction is exact
    np.testing.assert_allclose(fr.position, [0, 5, 10.5], atol=1e-5)
    np.testing.assert_allclose(fr.view, [0, 0, -1], atol=1e-6)
    o, d = generate_camera_rays(fr.as_pytree(), s.resolution)
    w, h = s.resolution
    assert o.shape == (w * h, 3)
    center = np.asarray(d[(h // 2) * w + w // 2])
    # central pixel looks nearly along view
    assert center @ np.array([0, 0, -1]) > 0.999


def test_view_matrix_roundtrip():
    from ptdn.scene import Scene

    s = Scene(scene_path_str + "/cornell.txt")
    fr = OrbitCamera(s.camera).frame()
    vm = view_matrix(fr)
    p_world = np.array([1.0, 2.0, -3.0, 1.0], np.float32)
    p_view = vm @ p_world
    # camera position maps to origin
    pc = vm @ np.array([*fr.position, 1.0], np.float32)
    np.testing.assert_allclose(pc[:3], 0, atol=1e-5)
    # a point 1 unit along view maps to z = +1 (basis column convention)
    pv = vm @ np.array([*(fr.position + fr.view), 1.0], np.float32)
    np.testing.assert_allclose(pv[:3], [0, 0, 1], atol=1e-5)


def test_interpolate_compat_false_fixes_normal_weights():
    """compat=False uses TRUE barycentric weights for the smoothed
    normal; compat=True replicates the reference's swapped ones
    (sceneStructs.h:162-170). At a vertex, the fixed mode must return
    that vertex's normal; the compat mode returns a different one."""
    import jax.numpy as jnp

    from ptdn.ops.intersect import interpolate_tri_hit

    n0 = jnp.array([[1.0, 0, 0]]); n1 = jnp.array([[0, 1.0, 0]])
    n2 = jnp.array([[0, 0, 1.0]])
    uv0 = jnp.array([[0.0, 0]]); uv1 = jnp.array([[1.0, 0]])
    uv2 = jnp.array([[0.0, 1]])
    # hit exactly at vertex 1: u=1, v=0
    u = jnp.array([1.0]); v = jnp.array([0.0])
    n_fix, uv_fix = interpolate_tri_hit(u, v, n0, n1, n2, uv0, uv1, uv2,
                                        compat=False)
    n_ref, uv_ref = interpolate_tri_hit(u, v, n0, n1, n2, uv0, uv1, uv2,
                                        compat=True)
    np.testing.assert_allclose(np.asarray(n_fix[0]), [0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(n_ref[0]), [1, 0, 0], atol=1e-6)
    # uv interpolation is NOT part of the quirk: identical either way
    np.testing.assert_allclose(np.asarray(uv_fix), np.asarray(uv_ref))
