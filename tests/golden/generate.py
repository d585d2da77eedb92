"""Regenerate the golden npz files from the CPU XLA oracle.

Run from the repo root (goldens are CPU oracle outputs, never a GPU's):

    JAX_PLATFORMS=cpu python tests/golden/generate.py [name ...]

Only regenerate a golden when an intentional math change invalidates it;
the diff must be reviewed against the reference semantics it encodes
(reference src/pathtrace.cu, src/denoise.cu)."""

import os
import sys

import jax

jax.config.update("jax_default_device", jax.devices("cpu")[0])
jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from tests.test_golden import CONFIGS, SCENES, _render  # noqa: E402

GOLDEN = os.path.dirname(os.path.abspath(__file__))


def main(names):
    for name in names or sorted(CONFIGS):
        left, right = _render("xla", CONFIGS[name], SCENES[name])
        path = os.path.join(GOLDEN, f"{name}.npz")
        np.savez_compressed(path, left=left, right=right)
        print(f"wrote {path}  left_mean={left.mean():.6f} "
              f"right_mean={right.mean():.6f}")


if __name__ == "__main__":
    main(sys.argv[1:])
