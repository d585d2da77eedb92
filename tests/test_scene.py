"""Scene layer tests: parser, OBJ loading, transforms, BVH, lights."""

import numpy as np
import pytest

from ptdn.scene import Scene
from ptdn.scene import parser as P
from ptdn.scene.bvh import build_bvh
from ptdn.utils import math3d


ALL_SCENES = ["cornell.txt", "bunny.txt", "diamond.txt", "room.txt"]


@pytest.mark.parametrize("name", ALL_SCENES)
def test_parse_all_shipped_scenes(scenes_dir, name):
    s = Scene(str(scenes_dir / name))
    assert len(s.materials) > 0
    assert len(s.geoms) > 0
    assert s.resolution[0] > 0 and s.resolution[1] > 0
    # every shipped scene's OBJECT 0 is the emissive ceiling light
    assert s.lights and s.lights[0].geom_idx == 0
    assert s.materials[s.geoms[0].material_id].emittance > 0


def test_cornell_structure(cornell_scene):
    s = cornell_scene
    assert s.resolution == (600, 600)
    assert len(s.geoms) == 10
    assert len(s.materials) == 9
    # back wall is a mesh (wall_x.obj)
    assert s.geoms[3].type == P.MESH
    assert s.n_tris > 0
    # material 8 is textured
    assert s.materials[8].texid == 0
    assert len(s.textures) == 1


def test_transform_matches_glm_semantics():
    # T * Rx * Ry * Rz * S, degrees (utilities.cpp:65-72)
    m = math3d.build_transformation_matrix(
        np.array([1.0, 2.0, 3.0]), np.array([0.0, 90.0, 0.0]), np.array([2.0, 2.0, 2.0]))
    # unit +x scaled by 2, rotated 90 deg about y (-> -z), translated
    p = math3d.transform_point(m, [1.0, 0.0, 0.0])
    np.testing.assert_allclose(p, [1.0, 2.0, 3.0 - 2.0], atol=1e-5)
    # inverse round-trips
    q = math3d.transform_point(np.linalg.inv(m), p)
    np.testing.assert_allclose(q, [1.0, 0.0, 0.0], atol=1e-5)


def test_world_space_pretransform(cornell_scene):
    s = cornell_scene
    g = s.geoms[3]  # back wall mesh: TRANS (0,3.9,-4.8), SCALE (12,1,12)
    tris = s.tri_v[s.tri_geom == 3]
    assert tris.shape[0] == g.tri_end - g.tri_start
    center = tris.reshape(-1, 3).mean(axis=0)
    assert abs(center[2] - (-4.8)) < 1.0  # near the back wall plane


def test_bvh_structure_and_coverage(scenes_dir):
    s = Scene(str(scenes_dir / "bunny.txt"))
    bvh = s.bvh
    assert bvh.n_nodes > 1
    leaves = bvh.prim_count > 0
    # leaf ranges exactly tile [0, T)
    covered = np.zeros(s.n_tris, bool)
    for off, cnt in zip(bvh.prim_offset[leaves], bvh.prim_count[leaves]):
        assert cnt <= 10 or cnt > 0
        assert not covered[off:off + cnt].any()
        covered[off:off + cnt] = True
    assert covered.all()
    # root bounds contain all triangles
    np.testing.assert_array_less(
        bvh.bounds_min[0] - 1e-4, s.tri_v.reshape(-1, 3).min(axis=0) + 1e-6)
    np.testing.assert_array_less(
        s.tri_v.reshape(-1, 3).max(axis=0) - 1e-6, bvh.bounds_max[0] + 1e-4)
    # interior nodes: left child = i+1, right child valid and disjoint
    interior = np.where(~leaves)[0]
    for i in interior:
        r = bvh.right_child[i]
        assert i + 1 < bvh.n_nodes and 0 < r < bvh.n_nodes
    # reorder permutation is a bijection
    assert np.array_equal(np.sort(s.tri_order), np.arange(s.n_tris))


def test_bvh_small_cases():
    # single triangle -> single leaf node
    bmin = np.array([[0, 0, 0]], np.float32)
    bmax = np.array([[1, 1, 1]], np.float32)
    bvh, order = build_bvh(bmin, bmax)
    assert bvh.n_nodes == 1 and bvh.prim_count[0] == 1
    assert order.tolist() == [0]

    # two triangles -> root + two leaves, ordered by centroid on longest axis
    bmin = np.array([[5, 0, 0], [0, 0, 0]], np.float32)
    bmax = np.array([[6, 1, 1], [1, 1, 1]], np.float32)
    bvh, order = build_bvh(bmin, bmax)
    assert bvh.n_nodes == 3
    assert order.tolist() == [1, 0]  # smaller x-centroid first


def test_parser_errors(tmp_path):
    bad = tmp_path / "bad.txt"
    bad.write_text("MATERIAL 5\nRGB 1 1 1\n")
    with pytest.raises(P.SceneParseError):
        P.parse_scene(str(bad))
    with pytest.raises(P.SceneParseError):
        P.parse_scene(str(tmp_path / "missing.txt"))


def test_obj_fan_triangulation(scenes_dir):
    from ptdn.scene.objloader import load_obj

    # wall_x.obj: one big n-gon face -> fan of (n-2) triangles
    mesh = load_obj(str(scenes_dir / "Models" / "wall_x.obj"))
    assert mesh.pos_idx.shape[0] >= 2
    # chair.obj mixes quads and n-gons
    chair = load_obj(str(scenes_dir / "Models" / "chair.obj"))
    assert chair.pos_idx.shape[0] > 430  # more tris than face lines
    assert chair.texcoords.shape[0] > 0


def test_device_scene_upload(cornell_scene):
    import jax

    ds = cornell_scene.device()
    leaves = jax.tree_util.tree_leaves(ds)
    assert all(hasattr(l, "shape") for l in leaves)
    # triangles are padded to a 128 multiple for aligned chunked slices
    assert ds.tri_v.shape[0] >= cornell_scene.n_tris
    assert ds.tri_v.shape[0] % 128 == 0
    # pytree round-trip
    flat, treedef = jax.tree_util.tree_flatten(ds)
    ds2 = jax.tree_util.tree_unflatten(treedef, flat)
    assert type(ds2) is type(ds)


def test_native_bvh_matches_python():
    """The C++ builder must produce byte-identical trees to the NumPy one."""
    from ptdn.native import get_library
    from ptdn.scene.bvh import build_bvh, build_bvh_native
    from ptdn.scene.objloader import load_obj
    from ptdn.scene.scene import Scene as _S

    if get_library() is None:
        pytest.skip("no C++ toolchain")
    rng = np.random.default_rng(7)
    for case in range(3):
        n = [1, 37, 4000][case]
        c = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
        e = rng.uniform(0.01, 1.0, size=(n, 3)).astype(np.float32)
        bmin, bmax = c - e, c + e
        py_bvh, py_order = build_bvh(bmin, bmax, native=False)
        nat = build_bvh_native(bmin, bmax)
        assert nat is not None
        nat_bvh, nat_order = nat
        assert nat_bvh.n_nodes == py_bvh.n_nodes
        np.testing.assert_array_equal(nat_order, py_order)
        np.testing.assert_array_equal(nat_bvh.prim_count, py_bvh.prim_count)
        np.testing.assert_array_equal(nat_bvh.prim_offset, py_bvh.prim_offset)
        np.testing.assert_array_equal(nat_bvh.right_child, py_bvh.right_child)
        np.testing.assert_allclose(nat_bvh.bounds_min, py_bvh.bounds_min)
        np.testing.assert_allclose(nat_bvh.bounds_max, py_bvh.bounds_max)


def test_native_obj_matches_python(scenes_dir):
    """C++ OBJ loader must produce byte-identical arrays to the Python one."""
    from ptdn.native import get_library
    from ptdn.scene.objloader import load_obj_native, load_obj_python

    if get_library() is None:
        pytest.skip("no C++ toolchain")
    for name in ["wall_x.obj", "bunny.obj", "chair.obj", "diamond.obj"]:
        path = str(scenes_dir / "Models" / name)
        a = load_obj_python(path)
        b = load_obj_native(path)
        assert b is not None
        np.testing.assert_array_equal(a.positions, b.positions, err_msg=name)
        np.testing.assert_array_equal(a.normals, b.normals, err_msg=name)
        np.testing.assert_array_equal(a.texcoords, b.texcoords, err_msg=name)
        np.testing.assert_array_equal(a.pos_idx, b.pos_idx, err_msg=name)
        np.testing.assert_array_equal(a.nrm_idx, b.nrm_idx, err_msg=name)
        np.testing.assert_array_equal(a.uv_idx, b.uv_idx, err_msg=name)


def test_terrain30k_scene_loads_and_regenerates(tmp_path):
    """Scale-benchmark scene (VERDICT r2 item 4): ~30k deterministic
    triangles. The generator is closed-form, so the committed OBJ must
    be byte-identical to a regeneration."""
    import pathlib
    import runpy

    root = pathlib.Path(__file__).resolve().parent.parent
    scene = Scene(str(root / "scenes" / "terrain30k.txt"))
    assert scene.n_tris == 29768                       # 122*122*2
    assert -(-scene.n_tris // 128) == 233              # chunk count

    gen = root / "scenes" / "gen_terrain30k.py"
    mod = runpy.run_path(str(gen))
    out = tmp_path / "terrain30k.obj"
    mod["main"](str(out))
    committed = (root / "scenes" / "Models" / "terrain30k.obj").read_bytes()
    assert out.read_bytes() == committed
