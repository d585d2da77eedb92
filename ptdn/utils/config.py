"""Runtime configuration.

The reference exposes ~30 mutable ``ui_*`` globals bound to ImGui widgets
(reference src/main.cpp:37-75, src/preview.cpp:211-375). Here that becomes
one frozen dataclass split two ways for the jitted frame step:

* structural fields (depths, level counts, on/off toggles) are **static**:
  changing them triggers a re-jit, like recompiling a kernel;
* continuous fields (sigmas, alphas, intensities, radii) are threaded in as
  a **traced float pytree** (``RenderConfig.traced_params()``), so an
  interactive app can slide them every frame with zero recompiles.

Defaults match the reference exactly (src/main.cpp:42-62).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # -------- path tracer (main.cpp:39-47) --------
    trace_depth: int = 4            # ui_tracedepth (1..10)
    shadow_ray: bool = True         # ui_shadowray: NEE shadow ray to light 0
    reduce_var: bool = True         # ui_reducevar: skip emissive hit after diffuse
    shadow_intensity: float = 2.7   # ui_sintensity (traced)
    light_radius: float = 1.4       # ui_lightradius (traced)
    use_bvh: bool = True            # ui_usekdtree / USE_KDTREE
    show_texture: bool = True       # SHOW_TEXTURE compile flag (sceneStructs.h:16)

    # -------- denoiser (main.cpp:50-62) --------
    denoise_enable: bool = False    # ui_denoise_enable
    temporal_enable: bool = False   # ui_temporal_enable
    spatial_enable: bool = False    # ui_spatial_enable
    color_alpha: float = 0.2        # ui_color_alpha (traced)
    moment_alpha: float = 0.2       # ui_moment_alpha (traced)
    blur_variance: bool = True      # ui_blurvariance
    sigma_l: float = 0.45           # ui_sigmal (traced)
    sigma_x: float = 0.35           # ui_sigmax (traced)
    sigma_n: float = 0.2            # ui_sigman (traced)
    atrous_nlevel: int = 5          # ui_atrous_nlevel (0..7)
    history_level: int = 1          # ui_history_level
    sep_color: bool = False         # ui_sepcolor: demodulate first-hit albedo
    add_color: bool = False         # ui_addcolor: remodulate after last level

    # -------- camera automation (main.cpp:65-70) --------
    automate_camera: bool = False
    camera_speed_x: float = 0.0
    camera_speed_y: float = 0.0
    camera_speed_z: float = 0.0
    camera_speed_theta: float = 0.0
    camera_speed_phi: float = 0.0

    # -------- debug views (main.cpp:73-74) --------
    # 0 = filtered color, 1 = history length (/100), 2 = variance (/0.1)
    right_view_option: int = 0

    # -------- engine knobs (no reference equivalent) --------
    # "gpu" is the production path (plain XLA frame plus the CUDA BVH
    # traversal kernel, ops/cuda_bvh.py; needs a GPU as the default
    # device); "xla" is the plain-JAX oracle that runs anywhere. They
    # agree to float tolerance (tested on the card by chip_smoke.py).
    backend: str = "xla"
    # mesh intersection strategy: "auto", "bvh", "brute". On "xla" auto
    # is brute force for small meshes and the plain BVH traversal
    # otherwise; on "gpu" auto and "bvh" are the traversal kernel.
    mesh_mode: str = "auto"
    # replicate reference quirks bit-for-bit (stale-albedo on miss, no
    # tan(fov/2) in reprojection, inverted moment alpha, ...). Fixing them
    # is allowed per-quirk later; parity tests run with compat=True.
    compat: bool = True

    def traced_params(self) -> Dict[str, Any]:
        """Continuous parameters as a traced float32 pytree."""
        f = np.float32
        return {
            "shadow_intensity": f(self.shadow_intensity),
            "light_radius": f(self.light_radius),
            "color_alpha": f(self.color_alpha),
            "moment_alpha": f(self.moment_alpha),
            "sigma_l": f(self.sigma_l),
            "sigma_x": f(self.sigma_x),
            "sigma_n": f(self.sigma_n),
        }

    def static_key(self):
        """Hashable key of the structural (re-jit) fields."""
        return (
            self.trace_depth, self.shadow_ray, self.reduce_var, self.use_bvh,
            self.show_texture,
            self.denoise_enable, self.temporal_enable, self.spatial_enable,
            self.blur_variance, self.atrous_nlevel, self.history_level,
            self.sep_color, self.add_color, self.right_view_option,
            self.backend, self.mesh_mode, self.compat,
        )

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
