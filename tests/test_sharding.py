"""Multi-chip sharding tests on the virtual 8-device CPU mesh: the
sharded frame step must produce the SAME image as single-device, with
state/outputs actually row-sharded."""

import numpy as np
import pytest

# 8-device virtual mesh renders are the suite's slowest tests; the fast
# iteration path (-m 'not slow') skips them, full runs keep them
pytestmark = pytest.mark.slow

import jax
import jax.numpy as jnp

from ptdn.engine.step import init_frame_state, make_frame_step
from ptdn.ops.camera import OrbitCamera, view_matrix
from ptdn.parallel.mesh import ROW_AXIS, make_mesh
from ptdn.parallel.sharded import make_sharded_step
from ptdn.scene import Scene
from ptdn.utils.config import RenderConfig

from ptdn.utils.assets import scenes_dir

scene_path_str = str(scenes_dir())

RES = (48, 64)  # W x H ; H divides 8


@pytest.fixture(scope="module")
def cpu_mesh():
    cpus = jax.devices("cpu")
    if len(cpus) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return make_mesh(8, devices=cpus[:8])


@pytest.fixture(scope="module")
def scene():
    return Scene(scene_path_str + "/cornell.txt")


def _inputs(scene, cfg):
    fr = OrbitCamera(scene.camera, resolution=RES).frame()
    return (scene.device(), fr.as_pytree(), jnp.asarray(view_matrix(fr)),
            cfg.traced_params())


def test_sharded_step_matches_single_device(cpu_mesh, scene):
    cfg = RenderConfig(denoise_enable=True, temporal_enable=True,
                       spatial_enable=True, trace_depth=3, atrous_nlevel=3)
    ds, cam, vm, params = _inputs(scene, cfg)

    cpu0 = jax.devices("cpu")[0]
    with jax.default_device(cpu0):
        step1 = jax.jit(make_frame_step(scene, cfg, RES))
        st1 = init_frame_state(RES)
        for f in range(2):
            st1, l1, r1 = step1(st1, ds, cam, vm, params, jnp.uint32(f),
                                jnp.bool_(f == 0))

    stepN, stN, _ = make_sharded_step(scene, cfg, RES, mesh=cpu_mesh)
    for f in range(2):
        stN, lN, rN = stepN(stN, ds, cam, vm, params, jnp.uint32(f),
                            jnp.bool_(f == 0))

    np.testing.assert_allclose(np.asarray(r1), np.asarray(rN),
                               atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(l1), np.asarray(lN),
                               atol=2e-5, rtol=1e-5)


def test_output_is_row_sharded(cpu_mesh, scene):
    cfg = RenderConfig(denoise_enable=False, trace_depth=2)
    ds, cam, vm, params = _inputs(scene, cfg)
    stepN, stN, _ = make_sharded_step(scene, cfg, RES, mesh=cpu_mesh)
    stN, left, right = stepN(stN, ds, cam, vm, params, jnp.uint32(0),
                             jnp.bool_(True))
    spec = right.sharding.spec
    assert spec[0] == ROW_AXIS
    # 8 shards of 8 rows each
    assert len(right.sharding.device_set) == 8


def test_uneven_height_rejected(cpu_mesh, scene):
    cfg = RenderConfig()
    with pytest.raises(ValueError):
        make_sharded_step(scene, cfg, (48, 31), mesh=cpu_mesh)
