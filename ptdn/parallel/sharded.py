"""Multi-device frame step: jit the full step over a device mesh with
row-sharded image state and replicated scene.

With in/out shardings pinned on the carried state and frame outputs, XLA
SPMD propagates the row partition through the whole program: ray
generation, tracing and shading stay local per device (rays never leave
their shard), and the only cross-device traffic is the halo exchange the
à-trous stencils / reprojection gathers need — exactly the communication
pattern hand-written in a CUDA multi-GPU port, derived automatically from
sharding annotations (SURVEY.md §2 parallelism table). The CUDA mesh
traversal has no partitioning rule of its own, so it runs under
shard_map over the same rows (ops/cuda_bvh.py).
"""

from __future__ import annotations

import jax

from ptdn.engine.step import init_frame_state, make_frame_step
from ptdn.parallel.mesh import (make_mesh, replicated, row_sharding,
                                shard_state)

# frame-state keys that are image-shaped (H, W, ...) or flat-ray-shaped
# (N = H*W, the same contiguous partition) and shard by rows
_IMAGE_KEYS = ("accum_image", "color_history", "moment_history",
               "history_length", "prev_position", "prev_normal",
               "prev_geom_id", "pcache_t", "pcache_normal", "pcache_uv",
               "pcache_mat_id", "pcache_geom_id", "pcache_hit",
               "pcache_albedo")


def state_shardings(mesh, state):
    out = {}
    for k, v in state.items():
        if k in _IMAGE_KEYS:
            out[k] = row_sharding(mesh, v.ndim)
        else:
            out[k] = replicated(mesh)
    return out


def make_sharded_step(scene, cfg, resolution=None, mesh=None, n_devices=None):
    """Build (jitted_step, initial_sharded_state, mesh)."""
    mesh = mesh or make_mesh(n_devices)
    res = tuple(resolution or scene.resolution)
    if res[1] % mesh.size != 0:
        raise ValueError(
            f"image height {res[1]} must divide across {mesh.size} devices")
    step = make_frame_step(scene, cfg, res, mesh=mesh)
    state0 = init_frame_state(res)
    st_shard = state_shardings(mesh, state0)
    rep = replicated(mesh)
    img_shard = row_sharding(mesh, 3)

    jitted = jax.jit(
        step,
        in_shardings=(st_shard, rep, rep, rep, rep, rep, rep),
        out_shardings=(st_shard, img_shard, img_shard),
        donate_argnums=(0,),
    )
    state0 = jax.device_put(state0, st_shard)
    return jitted, state0, mesh
