"""Device meshes and shardings for multi-device rendering.

The reference is single-GPU (SURVEY.md §2: the only parallelism is SIMT
over pixels). The multi-device scaling axis is the same one, made
explicit: the image's ROW axis is sharded across devices
(`jax.sharding.Mesh` + NamedSharding), scene data is replicated, and XLA's
SPMD partitioner inserts the halo exchanges (collective-permute) that the
5x5 dilated à-trous stencils and the reprojection gathers need at tile
edges (max halo = 2 * 2^5 = 64 rows at level 5).

The flat ray batch uses index = x + y*W (pathtrace.cu:193), so sharding
image rows and sharding the flat ray axis are the SAME contiguous
partition — the tracer needs no resharding between ray and image space.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROW_AXIS = "rows"


def get_devices(n_devices: Optional[int] = None, platform: Optional[str] = None):
    """The first `n_devices` devices of `platform` (default: the default
    backend). Raises when there are fewer; it never substitutes devices
    of another platform (tests pass virtual CPU devices explicitly)."""
    devs = jax.devices(platform) if platform is not None else jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devs)} ({devs})")
        devs = devs[:n_devices]
    return devs


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              platform: Optional[str] = None) -> Mesh:
    devs = list(devices) if devices is not None else get_devices(n_devices,
                                                                 platform)
    return Mesh(np.asarray(devs), (ROW_AXIS,))


def row_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard axis 0 (image rows / flat rays) across the mesh."""
    return NamedSharding(mesh, P(ROW_AXIS, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_state(state, mesh: Mesh):
    """Place a frame-state pytree with row sharding on image-like arrays
    (ndim >= 2 and leading dim == H) and replication elsewhere."""
    def place(x):
        if hasattr(x, "ndim") and x.ndim >= 2 and x.shape[0] % mesh.size == 0:
            return jax.device_put(x, row_sharding(mesh, x.ndim))
        return jax.device_put(x, replicated(mesh))
    return jax.tree_util.tree_map(place, state)
