"""ptdn — a real-time path tracer + SVGF denoiser in JAX.

A JAX/XLA framework with the capabilities of the CUDA reference
(ZheyuanXie/CUDA-Path-Tracer-Denoising): a 1-spp Monte Carlo wavefront
path tracer (analytic cubes/spheres, OBJ meshes via a SAH BVH, texture
mapping, next-event-estimation shadow rays) feeding a Spatiotemporal
Variance-Guided Filtering (SVGF) denoiser (temporal reprojection +
accumulation, variance estimation, edge-stopping à-trous wavelet
filtering), with an interactive-style orbit camera and headless
rendering CLI.

Layout:
  scene/     host-side scene layer: scenes/*.txt parser, OBJ loader with
             world-space pre-transform, texture atlas, SAH BVH build+flatten
  ops/       device math: counter-based RNG, ray/primitive intersection,
             BVH traversal (plain JAX and a CUDA kernel), BSDF sampling,
             camera rays
  engine/    the jitted frame step: wavefront masked ray-batch tracer over
             a lax bounce loop, G-buffer, accumulation, frame-state pytree
  denoise/   SVGF: back-projection/temporal EWMA, variance, à-trous filter
  parallel/  multi-device: jax.sharding meshes, row-sharded frame step
  utils/     config system, image IO (PNG/HDR), glm-compatible host math
  app/       headless CLI, camera automation, debug views, stats

Reference parity: device math replicates the reference's behavior
(file:line cites in docstrings) including its quirks, behind cfg flags.
"""

__version__ = "0.3.0"

import os as _os

import jax as _jax

# Geometry needs full-f32 matrix products: on a GPU the DEFAULT precision
# runs f32 dots in TF32 (about three decimal digits), which skews the
# camera and transform math well past the backends' agreement bounds.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache. JAX reads JAX_COMPILATION_CACHE_DIR itself
# when it is set; otherwise the cache sits at one fixed path inside the
# checkout (listed in .gitignore), so every process of this checkout hits
# the same entries.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)

from ptdn.utils.config import RenderConfig  # noqa: E402,F401
