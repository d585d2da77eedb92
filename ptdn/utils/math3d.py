"""Host-side 3D math with glm-compatible semantics (NumPy, float32).

These run once at scene-load time; the device-side equivalents live in
ptdn.ops. Conventions follow glm (column-major matrices, vectors are
columns, M @ v applies M to v).

Reference parity: buildTransformationMatrix (reference src/utilities.cpp:65-72),
inverseTranspose, and the camera fov/pixelLength derivation
(reference src/scene.cpp:158-166).
"""

from __future__ import annotations

import numpy as np

F = np.float32


def translate(t) -> np.ndarray:
    m = np.eye(4, dtype=F)
    m[:3, 3] = np.asarray(t, dtype=F)
    return m


def scale(s) -> np.ndarray:
    m = np.eye(4, dtype=F)
    m[0, 0], m[1, 1], m[2, 2] = np.asarray(s, dtype=F)
    return m


def rotate_axis(angle_rad: float, axis) -> np.ndarray:
    """glm::rotate(mat4(1), angle, axis) — Rodrigues rotation, 4x4."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    x, y, z = a
    r = np.array(
        [
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
        ],
        dtype=np.float64,
    )
    m = np.eye(4, dtype=F)
    m[:3, :3] = r.astype(F)
    return m


def build_transformation_matrix(translation, rotation_deg, scale_vec) -> np.ndarray:
    """T * Rx * Ry * Rz * S, rotation in degrees (utilities.cpp:65-72)."""
    deg = np.pi / 180.0
    rx = rotate_axis(float(rotation_deg[0]) * deg, (1, 0, 0))
    ry = rotate_axis(float(rotation_deg[1]) * deg, (0, 1, 0))
    rz = rotate_axis(float(rotation_deg[2]) * deg, (0, 0, 1))
    return (
        translate(translation) @ rx @ ry @ rz @ scale(scale_vec)
    ).astype(F)


def inverse_transpose(m: np.ndarray) -> np.ndarray:
    """glm::inverseTranspose of a 4x4 (used to transform normals)."""
    return np.linalg.inv(m.astype(np.float64)).T.astype(F)


def normalize(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=F)
    return (v / np.linalg.norm(v)).astype(F)


def transform_point(m: np.ndarray, p) -> np.ndarray:
    q = m @ np.array([p[0], p[1], p[2], 1.0], dtype=F)
    return q[:3].astype(F)


def transform_dir(m: np.ndarray, d) -> np.ndarray:
    q = m @ np.array([d[0], d[1], d[2], 0.0], dtype=F)
    return q[:3].astype(F)
