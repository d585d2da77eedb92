"""The jitted frame step: trace + denoise + accumulate, state-threaded.

This is the equivalent of the reference per-frame host path
(runCuda -> pathtrace -> denoise, main.cpp:154-209 / pathtrace.cu:404-452):
one `jax.jit`-compiled function

    step(state, ds, cam, view_mat, params, frame) -> (state', left, right)

with the whole mutable CUDA-side state (accumulation image + SVGF
temporal buffers) carried as a donated pytree, so every frame stays
in device memory with zero host round-trips. `left` is the raw
1-spp/accumulated image (dev_image) and `right` the denoised output
(dev_denoised_image), matching the side-by-side display contract
(sendTwoImagesToPBO, pathtrace.cu:46-78).
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax.numpy as jnp

from ptdn.denoise.svgf import init_denoise_state, make_denoise_fn
from ptdn.engine.wavefront import make_trace_fn


_PCACHE_KEYS = ("t", "normal", "uv", "mat_id", "geom_id", "hit", "albedo")


def init_frame_state(resolution) -> Dict[str, jnp.ndarray]:
    w, h = resolution
    n = w * h
    f = jnp.float32
    state = {"accum_image": jnp.zeros((h, w, 3), f)}
    state.update(init_denoise_state(resolution))
    # primary-visibility cache (recomputed whenever the camera changes)
    state.update({
        "pcache_t": jnp.zeros(n, f),
        "pcache_normal": jnp.zeros((n, 3), f),
        "pcache_uv": jnp.zeros((n, 2), f),
        "pcache_mat_id": jnp.zeros(n, jnp.int32),
        "pcache_geom_id": jnp.full(n, -1, jnp.int32),
        "pcache_hit": jnp.zeros(n, bool),
        "pcache_albedo": jnp.zeros((n, 3), f),
    })
    return state


def make_frame_step(scene, cfg, resolution=None, mesh=None,
                    traversal=None):
    """`mesh`: the device mesh of a row-sharded step
    (parallel/sharded.py); `traversal`: a stand-in for the CUDA mesh
    traversal (see engine.wavefront.make_intersector)."""
    res = tuple(resolution or scene.resolution)
    w, h = res
    trace = make_trace_fn(scene, cfg, res, mesh=mesh, traversal=traversal)
    denoise = make_denoise_fn(cfg, res)

    def step(state, ds, cam, view_mat, params, frame,
             cam_changed=jnp.bool_(True)
             ) -> Tuple[Dict, jnp.ndarray, jnp.ndarray]:
        pcache = {k: state["pcache_" + k] for k in _PCACHE_KEYS}
        radiance_flat, gb, primary = trace(ds, cam, params, frame,
                                           primary_cache=pcache,
                                           cam_changed=cam_changed)
        radiance = radiance_flat.reshape(h, w, 3)
        gbuffer = {
            "position": gb["position"].reshape(h, w, 3),
            "normal": gb["normal"].reshape(h, w, 3),
            "albedo": gb["albedo"].reshape(h, w, 3),
            "ialbedo": gb["ialbedo"].reshape(h, w, 3),
            "geom_id": gb["geom_id"].reshape(h, w),
        }

        if cfg.denoise_enable:
            # left = raw 1 spp (pathtrace.cu:395-396)
            left = radiance
            right, dstate = denoise(state, radiance, gbuffer, view_mat, params)
            new_state = dict(dstate)
            new_state["accum_image"] = radiance
        else:
            # running mean over frames (pathtrace.cu:398)
            f = frame.astype(jnp.float32)
            accum = (state["accum_image"] * (f / (f + 1.0))
                     + radiance / (f + 1.0))
            left = accum
            right = accum       # denoise-bypass copy (pathtrace.cu:440)
            new_state = {k: v for k, v in state.items()}
            new_state["accum_image"] = accum

        for k in _PCACHE_KEYS:
            new_state["pcache_" + k] = primary[k]
        return new_state, left, right

    return step
