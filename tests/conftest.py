"""Test harness.

By default every test runs on the host CPU, with 8 virtual CPU devices
for the sharding tests (--xla_force_host_platform_device_count=8); both
must be set before JAX initializes. With PTDN_TEST_GPU=1 the process
keeps its GPU, and the tests marked `gpu` run on it:

    PTDN_TEST_GPU=1 python -m pytest tests -m gpu

Whether a card exists is decided inside the `gpu` fixture, never while a
module is imported, so every xdist worker collects the same tests.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
ON_GPU = os.environ.get("PTDN_TEST_GPU", "0") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"

import pathlib

import jax
import pytest

if not ON_GPU:
    # pin default computations to the host CPU; sharding tests take the
    # 8 virtual CPU devices explicitly
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
jax.config.update("jax_default_matmul_precision", "highest")

REPO = pathlib.Path(__file__).resolve().parent.parent
# vendored fixtures (scenes/PROVENANCE.md) keep the suite self-contained;
# PTDN_SCENES_DIR points it at another copy (e.g. the upstream originals)
SCENES = pathlib.Path(os.environ.get("PTDN_SCENES_DIR", REPO / "scenes"))


@pytest.fixture
def gpu():
    """Skip unless the default device is a GPU (PTDN_TEST_GPU=1 on a
    machine with a card); CUDA kernels have no interpret mode."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run with PTDN_TEST_GPU=1 on a machine "
                    "with a card")


@pytest.fixture(scope="session")
def scenes_dir():
    return SCENES


@pytest.fixture(scope="session")
def cornell_scene():
    from ptdn.scene import Scene

    return Scene(str(SCENES / "cornell.txt"))
