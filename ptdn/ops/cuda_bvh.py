"""Mesh closest hit through the CUDA per-thread BVH traversal kernel.

`cuda/bvh_closest_hit.cu` runs the reference's own traversal design
(one thread per ray, private 64-entry stack, IntersectBVH at reference
src/intersections.h:265-329) and is called as a JAX operation through
`jax.ffi`. Its oracle is `bvh_traverse.mesh_bvh_batched`, which runs the
same rules as one lockstep `while_loop` over all rays.

The library is compiled with nvcc for sm_90a from the committed source on
first use, into a host-keyed directory under `_build/` (see
`ptdn.native.host_build_dir`); that build counts as set-up time.

`closest_hit` takes an injectable `call` with the kernel's signature so
the padding, slicing and sharding around it run in CPU tests with the
plain traversal in its place (`plain_call`).
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import types
from pathlib import Path

import jax
import jax.numpy as jnp

from ptdn.ops.bvh_traverse import mesh_bvh_batched

BLOCK = 128        # threads per block; kBlock in the .cu source
TARGET = "ptdn_bvh_closest_hit"
_SOURCE = Path(__file__).resolve().parent / "cuda" / "bvh_closest_hit.cu"
# --fmad=false: no mul+add contraction, which is how XLA evaluates the
# plain traversal; with contraction u and v of grazing hits drift by up
# to ~2e-4 from the oracle, without it by at most 1 ulp (H100, 640,000
# rays).
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


def require_gpu() -> None:
    """Raise unless the process's default device is a GPU."""
    dev = jax.config.jax_default_device or jax.devices()[0]
    platform = getattr(dev, "platform", dev)
    if platform != "gpu":
        raise RuntimeError(
            f'backend="gpu" needs a GPU as the default device, found '
            f'{platform!r}; use backend="xla" (the plain oracle) to render '
            "on this device")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); it builds the CUDA BVH "
                           "traversal kernel")
    return nvcc


def library_path() -> Path:
    from ptdn.native import host_build_dir

    return (host_build_dir("cuda", [_SOURCE], _NVCC_FLAGS)
            / "libptdn_cuda.so")


@functools.cache
def load() -> None:
    """Build (once per host and source) and register the FFI target."""
    from ptdn.native import compile_shared

    path = library_path()
    if not path.exists():
        cmd = [_nvcc(), *_NVCC_FLAGS, "-I", jax.ffi.include_dir(),
               str(_SOURCE)]
        compile_shared(cmd, path, timeout=600)
    lib = ctypes.cdll.LoadLibrary(str(path))
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(
        lib.PtdnBvhClosestHit), platform="CUDA")


def ffi_call(o, d, bmin, bmax, count, axis, prim_off, right, tri_v):
    """The kernel itself: (t, u, v, tri_idx) for o.shape[0] rays."""
    n = o.shape[0]
    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    out = (f32, f32, f32, jax.ShapeDtypeStruct((n,), jnp.int32))
    return jax.ffi.ffi_call(TARGET, out)(o, d, bmin, bmax, count, axis,
                                          prim_off, right, tri_v)


def plain_call(max_prims: int):
    """The plain traversal with the kernel's signature (the oracle that
    tests and measurements put in the kernel's place)."""
    def call(o, d, bmin, bmax, count, axis, prim_off, right, tri_v):
        ds = types.SimpleNamespace(
            bvh_min=bmin, bvh_max=bmax, bvh_count=count, bvh_axis=axis,
            bvh_prim_off=prim_off, bvh_right=right, tri_v=tri_v)
        t, u, v, idx, _ = mesh_bvh_batched(ds, o, d, max_prims=max_prims)
        return t, u, v, idx
    return call


def closest_hit(ds, o, d, mesh=None, call=None):
    """Closest mesh hit per ray: (t, u, v, tri_idx, hit), the contract of
    `mesh_bvh_batched`. Pads the ray count to BLOCK and slices it back.
    With a device `mesh` the call runs under shard_map over rows (rays
    stay on their device, the scene is replicated)."""
    call = call or ffi_call

    def local(o, d, *scene):
        n = o.shape[0]
        pad = (-n) % BLOCK
        if pad:
            o = jnp.pad(o, ((0, pad), (0, 0)), mode="edge")
            d = jnp.pad(d, ((0, pad), (0, 0)), mode="edge")
        return tuple(x[:n] for x in call(o, d, *scene))

    scene = (ds.bvh_min, ds.bvh_max, ds.bvh_count, ds.bvh_axis,
             ds.bvh_prim_off, ds.bvh_right, ds.tri_v)
    if mesh is not None:
        from jax.sharding import PartitionSpec as P

        from ptdn.parallel.mesh import ROW_AXIS

        local = jax.shard_map(
            local, mesh=mesh, in_specs=(P(ROW_AXIS), P(ROW_AXIS))
            + (P(),) * len(scene), out_specs=(P(ROW_AXIS),) * 4,
            check_vma=False)
    t, u, v, idx = local(o, d, *scene)
    return t, u, v, idx, idx >= 0
