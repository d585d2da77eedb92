"""Host-side renderer: owns scene, config, camera and the carried state,
and drives the jitted frame step — the equivalent of the reference's app
control loop (main.cpp runCuda + reset logic), headless.

Reset semantics mirror runCuda (main.cpp:154-209): a camera change resets
the accumulation frame counter only when denoising is OFF; frame==0
forces a full tracer+denoiser state reset.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ptdn.engine.step import init_frame_state, make_frame_step
from ptdn.ops.camera import OrbitCamera, view_matrix
from ptdn.utils.config import RenderConfig


class Renderer:
    def __init__(self, scene, cfg: Optional[RenderConfig] = None,
                 resolution: Optional[Tuple[int, int]] = None):
        self.scene = scene
        self.cfg = cfg or RenderConfig()
        self.resolution = tuple(resolution or scene.resolution)
        self.camera = OrbitCamera(scene.camera, resolution=self.resolution)
        self.ds = scene.device()
        self.cam_changed = True
        self.frame = 0
        self._build()
        self.reset_state()

    def _build(self):
        step = make_frame_step(self.scene, self.cfg, self.resolution)
        self._step = jax.jit(step, donate_argnums=(0,))
        self._params = self.cfg.traced_params()

    def set_config(self, cfg: RenderConfig):
        """Swap config. Structural changes re-jit; continuous ones don't."""
        rebuild = cfg.static_key() != self.cfg.static_key()
        self.cfg = cfg
        self._params = cfg.traced_params()
        if rebuild:
            self._build()
            self.reset_state()

    def reset_state(self):
        """pathtraceFree/Init + denoiseFree/Init (main.cpp:194-201)."""
        self.state = init_frame_state(self.resolution)
        self.frame = 0

    def _step_args(self, changed):
        frame_cam = self.camera.frame()
        return (self.state, self.ds, frame_cam.as_pytree(),
                jnp.asarray(view_matrix(frame_cam)), self._params,
                jnp.uint32(self.frame), jnp.bool_(changed))

    def compile(self):
        """Compile the frame step ahead of the first frame (set-up time)
        and return the executable; its memory_analysis() gives the step's
        device memory. Later frames run this executable."""
        self._step = self._step.lower(*self._step_args(True)).compile()
        return self._step

    def render_frame(self):
        """Render one frame; returns (left, right) (H, W, 3) device arrays:
        left = raw/accumulated, right = denoised."""
        changed = self.cam_changed
        if changed:
            if not self.cfg.denoise_enable:
                self.frame = 0
            self.cam_changed = False
        if self.frame == 0:
            self.reset_state()
            changed = True      # fresh state: the primary cache is invalid

        self.state, left, right = self._step(*self._step_args(changed))
        self.frame += 1
        return left, right

    def render(self, n_frames: int):
        """Render n frames; returns the final (left, right) as numpy."""
        left = right = None
        for _ in range(n_frames):
            left, right = self.render_frame()
        return np.asarray(left), np.asarray(right)

    # -- interactive-style camera controls (main.cpp:231-304 semantics) --
    def orbit(self, dphi: float = 0.0, dtheta: float = 0.0):
        self.camera.phi += dphi
        self.camera.theta = float(np.clip(self.camera.theta + dtheta,
                                          0.001, np.pi))
        self.cam_changed = True

    def dolly(self, dzoom: float):
        self.camera.zoom = max(0.1, self.camera.zoom + dzoom)
        self.cam_changed = True

    def pan(self, delta):
        self.camera.look_at = self.camera.look_at + np.asarray(
            delta, np.float32)
        self.cam_changed = True

    def reset_camera(self):
        self.camera.reset()
        self.cam_changed = True
