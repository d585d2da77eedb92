"""Where the program runs: backend and device selection, the compile
cache's placement, host-keyed native builds, and chip_smoke.py refusing
to run without an accelerator."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

from ptdn.utils.config import RenderConfig

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run(args, env_extra=None, env_drop=(), cwd=REPO, timeout=240):
    env = {k: v for k, v in os.environ.items() if k not in env_drop}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_get_devices_raises_without_fallback():
    from ptdn.parallel.mesh import get_devices

    n = len(jax.devices()) + 1
    with pytest.raises(ValueError, match=f"need {n} devices"):
        get_devices(n)
    # explicit platform still works and never mixes platforms
    assert all(d.platform == "cpu" for d in get_devices(2, platform="cpu"))


def test_unknown_backend_rejected(cornell_scene):
    from ptdn.engine.wavefront import make_intersector

    with pytest.raises(ValueError, match="unknown backend 'pallas'"):
        make_intersector(cornell_scene, RenderConfig(backend="pallas"))


@pytest.mark.parametrize("backend,n_tris,mesh_mode,want", [
    ("xla", 5000, "auto", "bvh"),
    ("gpu", 5000, "auto", "cuda"),
    ("gpu", 100, "auto", "cuda"),
    ("xla", 100, "auto", "brute"),
    ("xla", 100, "bvh", "bvh"),
    ("gpu", 5000, "brute", "brute"),
    ("xla", 0, "auto", "none"),
])
def test_mesh_mode_choice(backend, n_tris, mesh_mode, want):
    """Which mesh query each backend builds: the production backend takes
    the CUDA traversal for every mesh (it beats brute force even on
    small meshes); the oracle takes brute force for small meshes and the
    plain traversal otherwise."""
    import types

    from ptdn.engine.wavefront import _mesh_mode

    scene = types.SimpleNamespace(n_tris=n_tris)
    cfg = RenderConfig(backend=backend, mesh_mode=mesh_mode)
    assert _mesh_mode(scene, cfg) == want


_PRINT_CACHE = ("import ptdn, jax; "
                "print(jax.config.jax_compilation_cache_dir); "
                "jax.jit(lambda x: x * 2 + 1)(jax.numpy.ones(3))"
                ".block_until_ready()")


def test_compile_cache_honours_env(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the cache lands there and the
    package sets no other directory."""
    cache = tmp_path / "cache"
    out = _run(["-c", _PRINT_CACHE], {
        "JAX_COMPILATION_CACHE_DIR": str(cache),
        "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
        "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == str(cache)
    assert any(cache.iterdir())


def test_compile_cache_default_inside_checkout():
    """Unset, the cache sits at one fixed path inside the checkout (never
    /tmp), which .gitignore lists."""
    out = _run(["-c", _PRINT_CACHE], env_drop=("JAX_COMPILATION_CACHE_DIR",))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == str(REPO / ".jax_cache")
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_native_library_keyed_by_host(monkeypatch):
    """A library built on one host is never loaded on another: the build
    directory is keyed by host name and machine, so another host builds
    its own."""
    import platform

    from ptdn import native

    here = native.library_path()
    monkeypatch.setattr(platform, "node", lambda: "another-host")
    there = native.library_path()
    assert there != here and "another-host" in str(there.parent)
    assert not there.exists()
    try:
        if shutil.which("g++") is None:
            pytest.skip("no g++ to build the native library")
        assert native.build_library(there) and there.exists()
    finally:
        shutil.rmtree(there.parent, ignore_errors=True)


def test_chip_smoke_refuses_cpu():
    """Without an accelerator chip_smoke.py exits non-zero and prints no
    result line."""
    out = _run([str(REPO / "chip_smoke.py")])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the rest of the repository it
    fails the same way."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path,
               env_drop=("PYTHONPATH",))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
