"""Edge-case scenes and configs: pure-analytic scenes (no mesh), depth 1,
atrous level 0, odd resolutions, empty-light handling."""

import jax
import numpy as np
import pytest

from ptdn.engine import Renderer
from ptdn.scene import Scene
from ptdn.utils.config import RenderConfig

PURE_ANALYTIC = """\
MATERIAL 0
RGB         1 1 1
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   5

MATERIAL 1
RGB         .8 .6 .6
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   0

CAMERA
RES         64 64
FOVY        45
FILE        mini
EYE         0.0 5 10.5
LOOKAT      0 5 0
UP          0 1 0

OBJECT 0
cube
material 0
TRANS       0 10 0
ROTAT       0 0 0
SCALE       3 .3 3

OBJECT 1
cube
material 1
TRANS       0 0 0
ROTAT       0 0 0
SCALE       10 .01 10

OBJECT 2
sphere
material 1
TRANS       0 3 0
ROTAT       0 0 0
SCALE       3 3 3
"""


@pytest.fixture(scope="module")
def analytic_scene(tmp_path_factory):
    p = tmp_path_factory.mktemp("scenes") / "mini.txt"
    p.write_text(PURE_ANALYTIC)
    return Scene(str(p))


@pytest.mark.parametrize("backend", ["xla", "gpu"])
def test_pure_analytic_scene(analytic_scene, backend):
    """No mesh at all: the tri arrays are padding-only; both backends must
    skip the mesh path cleanly. Off a GPU the production backend refuses
    to build instead of falling back to the oracle."""
    assert analytic_scene.n_tris == 0
    cfg = RenderConfig(backend=backend, denoise_enable=False, trace_depth=3)
    if backend == "gpu" and jax.devices()[0].platform != "gpu":
        with pytest.raises(RuntimeError, match='backend="gpu" needs a GPU'):
            Renderer(analytic_scene, cfg, resolution=(64, 64))
        return
    r = Renderer(analytic_scene, cfg, resolution=(64, 64))
    left, _ = r.render(2)
    left = np.asarray(left)
    assert not np.isnan(left).any()
    assert left.max() == pytest.approx(5.0, rel=1e-5)  # sees the light
    assert left.mean() > 0.005


def test_depth_one(analytic_scene):
    """trace_depth=1: only emissive primaries contribute (plus NEE)."""
    r = Renderer(analytic_scene,
                 RenderConfig(denoise_enable=False, trace_depth=1),
                 resolution=(64, 64))
    left, _ = r.render(1)
    assert not np.isnan(np.asarray(left)).any()


def test_atrous_zero_levels(analytic_scene):
    """atrous_nlevel=0 skips filtering (denoise.cu:380-383)."""
    cfg = RenderConfig(denoise_enable=True, temporal_enable=True,
                       spatial_enable=True, atrous_nlevel=0, trace_depth=2)
    r = Renderer(analytic_scene, cfg, resolution=(64, 64))
    left, right = r.render(2)
    # output == color history (temporal accumulation, unfiltered)
    assert not np.isnan(np.asarray(right)).any()


def test_spatial_only_without_temporal(analytic_scene):
    cfg = RenderConfig(denoise_enable=True, temporal_enable=False,
                       spatial_enable=True, trace_depth=2)
    r = Renderer(analytic_scene, cfg, resolution=(64, 64))
    _, right = r.render(2)
    assert not np.isnan(np.asarray(right)).any()


def test_reference_scene_depths(cornell_scene):
    """depth 10 (the reference GUI max) runs without blowing up."""
    r = Renderer(cornell_scene,
                 RenderConfig(denoise_enable=False, trace_depth=10),
                 resolution=(32, 32))
    left, _ = r.render(1)
    assert not np.isnan(np.asarray(left)).any()


def test_odd_resolution(analytic_scene):
    """Ray counts that are no multiple of anything render at their own
    shape."""
    r = Renderer(analytic_scene,
                 RenderConfig(denoise_enable=False, trace_depth=2),
                 resolution=(60, 52))
    left, _ = r.render(1)
    assert np.asarray(left).shape == (52, 60, 3)
    assert not np.isnan(np.asarray(left)).any()
