"""Camera model: orbit state, ray generation, view matrices.

Replicates the reference's camera pipeline:
* fov/pixelLength derivation (scene.cpp:158-166) — note the reference
  uses tan(fovy_degrees * pi/180) with NO half-angle, so FOVY 45 means a
  90-degree vertical frustum; replicated as-is;
* resetCamera's orbit decomposition into (zoom, theta, phi) around the
  look-at point (main.cpp:77-101) — acos() drops the sign of the view's
  x component, replicated;
* the camchanged basis rebuild (main.cpp:171-190) — `right`/`up` are NOT
  normalized there, which slightly widens the frustum off-axis; replicated;
* pinhole ray generation through pixel centers (pathtrace.cu:187-208);
* GetViewMatrix (denoise.cu:342-347) for temporal reprojection.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

F = np.float32


def derive_pixel_length(resolution: Tuple[int, int], fovy_deg: float):
    """scene.cpp:158-166 (keeps the missing /2 quirk)."""
    w, h = resolution
    yscaled = math.tan(fovy_deg * (math.pi / 180.0))
    xscaled = (yscaled * w) / h
    fovx = math.degrees(math.atan(xscaled))
    return (np.array([2 * xscaled / w, 2 * yscaled / h], F),
            np.array([fovx, fovy_deg], F))


@dataclasses.dataclass
class CameraFrame:
    """One frame's camera basis — the traced pytree for the jitted step."""
    position: np.ndarray      # (3,)
    view: np.ndarray          # (3,)
    up: np.ndarray            # (3,) unnormalized (main.cpp:183 quirk)
    right: np.ndarray         # (3,) unnormalized
    look_at: np.ndarray       # (3,)
    pixel_length: np.ndarray  # (2,)

    def as_pytree(self):
        import jax.numpy as jnp

        return {
            "position": jnp.asarray(self.position, jnp.float32),
            "view": jnp.asarray(self.view, jnp.float32),
            "up": jnp.asarray(self.up, jnp.float32),
            "right": jnp.asarray(self.right, jnp.float32),
            "pixel_length": jnp.asarray(self.pixel_length, jnp.float32),
        }


class OrbitCamera:
    """Interactive orbit camera state (zoom/theta/phi around look_at)."""

    def __init__(self, camera_spec, resolution=None):
        spec = camera_spec
        self.resolution = tuple(resolution or spec.resolution)
        self.pixel_length, self.fov = derive_pixel_length(self.resolution, spec.fovy)
        self.look_at = np.array(spec.look_at, F)
        self.og_look_at = self.look_at.copy()
        self._default_eye = np.array(spec.eye, F)
        self._default_up = np.array(spec.up, F)
        self.reset()

    def reset(self):
        """resetCamera (main.cpp:77-101): derive zoom/theta/phi from the
        scene's EYE/LOOKAT; acos() loses the horizontal sign (quirk)."""
        eye = self._default_eye
        look = self.og_look_at
        view = look - eye
        view = view / np.linalg.norm(view)
        view_xz = np.array([view[0], 0.0, view[2]], F)
        view_zy = np.array([0.0, view[1], view[2]], F)
        nxz = np.linalg.norm(view_xz)
        nzy = np.linalg.norm(view_zy)
        self.phi = float(np.arccos(np.clip(
            np.dot(view_xz / (nxz if nxz else 1.0), [0, 0, -1]), -1, 1)))
        self.theta = float(np.arccos(np.clip(
            np.dot(view_zy / (nzy if nzy else 1.0), [0, 1, 0]), -1, 1)))
        self.look_at = self.og_look_at.copy()
        self.zoom = float(np.linalg.norm(eye - look))

    def frame(self) -> CameraFrame:
        """The camchanged basis rebuild (main.cpp:171-190)."""
        st, ct = math.sin(self.theta), math.cos(self.theta)
        sp, cp = math.sin(self.phi), math.cos(self.phi)
        pos = self.zoom * np.array([sp * st, ct, cp * st], F)
        view = -pos / np.linalg.norm(pos)
        u = np.array([0, 1, 0], F)
        r = np.cross(view, u)          # NOT normalized (quirk)
        up = np.cross(r, view)         # NOT normalized (quirk)
        position = pos + self.look_at
        return CameraFrame(position=position.astype(F), view=view.astype(F),
                           up=up.astype(F), right=r.astype(F),
                           look_at=self.look_at.copy(),
                           pixel_length=self.pixel_length)


def generate_camera_rays(cam_pytree, resolution: Tuple[int, int]):
    """generateRayFromCamera (pathtrace.cu:187-208), flattened to (N, 3)
    in index = x + y*W order."""
    import jax.numpy as jnp

    w, h = resolution
    x = jnp.arange(w, dtype=jnp.float32)[None, :]
    y = jnp.arange(h, dtype=jnp.float32)[:, None]
    plx, ply = cam_pytree["pixel_length"][0], cam_pytree["pixel_length"][1]
    dx = (x - (w * 0.5 - 0.5)) * plx
    dy = (y - (h * 0.5 - 0.5)) * ply
    d = (cam_pytree["view"][None, None, :]
         - cam_pytree["right"][None, None, :] * dx[..., None]
         - cam_pytree["up"][None, None, :] * dy[..., None])
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(cam_pytree["position"], d.shape)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def view_matrix(frame_or_pytree) -> np.ndarray:
    """GetViewMatrix (denoise.cu:342-347): inverse of the camera basis
    matrix whose COLUMNS are (right, up, view, position)."""
    get = (frame_or_pytree.get if isinstance(frame_or_pytree, dict)
           else lambda k: getattr(frame_or_pytree, k))
    m = np.eye(4, dtype=np.float64)
    m[:3, 0] = np.asarray(get("right"))
    m[:3, 1] = np.asarray(get("up"))
    m[:3, 2] = np.asarray(get("view"))
    m[:3, 3] = np.asarray(get("position"))
    return np.linalg.inv(m).astype(F)
