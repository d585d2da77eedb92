"""Native (C++) runtime components, bound via ctypes.

The reference's host runtime is all C++ (scene load, BVH build); here the
performance-relevant host-side pieces get real native implementations:

* bvh_builder.cpp — the SAH BVH builder (the hot part of scene load for
  large meshes), byte-identical output to the NumPy builder.
* obj_loader.cpp — the tinyobjloader role: OBJ parsing with fan
  triangulation, byte-identical output to the Python loader.

The shared library is built on first use with g++ (plain C ABI + ctypes)
from the committed sources, into `_build/` at the checkout root, under a
directory keyed by host, machine and a hash of sources and flags
(`host_build_dir`): a library built on one machine is never loaded on
another. Falls back to the NumPy implementations when no compiler is
available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import re
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

_DIR = Path(__file__).resolve().parent
BUILD_ROOT = _DIR.parents[1] / "_build"
_SOURCES = ("bvh_builder.cpp", "obj_loader.cpp")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def host_build_dir(tag: str, sources: Sequence[Path],
                   flags: Sequence[str]) -> Path:
    """Build directory for `sources` compiled with `flags` on this host."""
    h = hashlib.sha256()
    for s in sources:
        h.update(Path(s).read_bytes())
    h.update("\0".join(flags).encode())
    host = re.sub(r"[^A-Za-z0-9_.-]", "_", platform.node() or "host")
    return BUILD_ROOT / f"{tag}-{host}-{platform.machine()}-{h.hexdigest()[:16]}"


def compile_shared(cmd: Sequence[str], out: Path, timeout: int) -> None:
    """Run `cmd` with the output path appended; the library appears at
    `out` only once complete, so a concurrent builder never loads half a
    file. Raises CalledProcessError / TimeoutExpired / OSError."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run([*cmd, "-o", tmp], check=True, capture_output=True,
                       text=True, timeout=timeout)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def library_path() -> Path:
    srcs = [_DIR / s for s in _SOURCES]
    return host_build_dir("native", srcs, _FLAGS) / "libptdn_native.so"


def build_library(path: Path) -> bool:
    try:
        compile_shared(["g++", *_FLAGS, *(str(_DIR / s) for s in _SOURCES)],
                       path, timeout=120)
        return True
    except (subprocess.CalledProcessError, OSError,
            subprocess.TimeoutExpired):
        return False


def get_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    if not path.exists() and not build_library(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    import numpy as np
    from numpy.ctypeslib import ndpointer

    f32p = ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.ptdn_build_bvh.restype = ctypes.c_int
    lib.ptdn_build_bvh.argtypes = [f32p, f32p, ctypes.c_int64,
                                   f32p, f32p, i32p, i32p, i32p, i32p, i64p]
    i64s = ctypes.POINTER(ctypes.c_int64)
    lib.ptdn_obj_parse.restype = ctypes.c_int
    lib.ptdn_obj_parse.argtypes = [ctypes.c_char_p]
    lib.ptdn_obj_counts.restype = None
    lib.ptdn_obj_counts.argtypes = [i64s, i64s, i64s, i64s]
    lib.ptdn_obj_fill.restype = None
    lib.ptdn_obj_fill.argtypes = [f32p, f32p, f32p, i32p, i32p, i32p]
    lib.ptdn_obj_free.restype = None
    lib.ptdn_obj_free.argtypes = []
    _lib = lib
    return _lib
