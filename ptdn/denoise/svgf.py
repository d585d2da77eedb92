"""SVGF orchestration: the reference's denoise() host routine as one
functional jit-traceable step over a carried state pytree.

Mirrors src/denoise.cu:349-402:
* temporal on  -> BackProjection, then color history <- accumulated color;
* temporal off -> EstimateVariance STUB writing 10.0 (denoise.cu:320-329,
  replicated) and color history <- raw input;
* debug views (history/100, variance/0.1) bypass filtering;
* else à-trous levels 1..nlevel ping-pong, feeding level
  `history_level`'s output back into the color history (SVGF's
  first-iteration-feeds-history trick, denoise.cu:386-392);
* end of frame: previous G-buffer / moments / history length / view
  matrix saved — here that's just returning the new state pytree
  (the reference's cudaMemcpy D2D copies become functional threading).
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax.numpy as jnp

from ptdn.denoise.atrous import atrous_level
from ptdn.denoise.reproject import back_projection, back_projection_auto


def init_denoise_state(resolution) -> Dict[str, jnp.ndarray]:
    """denoiseInit equivalents (denoise.cu:31-61), zero-initialized."""
    w, h = resolution
    f = jnp.float32
    return {
        "color_history": jnp.zeros((h, w, 3), f),
        "moment_history": jnp.zeros((h, w, 2), f),
        "history_length": jnp.zeros((h, w), jnp.int32),
        "prev_position": jnp.zeros((h, w, 3), f),
        "prev_normal": jnp.zeros((h, w, 3), f),
        "prev_geom_id": jnp.full((h, w), -1, jnp.int32),
        "prev_view": jnp.eye(4, dtype=f),
    }


def make_denoise_fn(cfg, resolution):
    """Build denoise(state, raw_color, gbuffer, view_mat, params)
    -> (output, new_state). Static structure from cfg; sigmas/alphas traced.
    The production backend reprojects with `back_projection_auto`
    (gather-free stencil for sub-pixel motion, banded slab gather
    otherwise); the oracle with the reference-shaped `back_projection`."""
    w, h = resolution

    def denoise(state, raw_color, gbuffer, view_mat, params
                ) -> Tuple[jnp.ndarray, Dict]:
        prev_gb = {
            "position": state["prev_position"],
            "normal": state["prev_normal"],
            "geom_id": state["prev_geom_id"],
        }
        # temporal off forces alpha = 1.0 (denoise.cu:360-361)
        if cfg.temporal_enable:
            bp = (back_projection_auto if cfg.backend == "gpu"
                  else back_projection)
            variance, color_acc, moment_acc, hist_up = bp(
                (w, h), raw_color, gbuffer, prev_gb, state["prev_view"],
                state["color_history"], state["moment_history"],
                state["history_length"],
                params["color_alpha"], params["moment_alpha"])
            color_history = color_acc
            if not cfg.compat:
                # native mode: short-history pixels (< 4 frames — fresh
                # starts, disocclusions) take the SVGF-paper spatial
                # moment estimate instead of 1-3-sample temporal moments
                from ptdn.denoise.variance import \
                    variance_with_spatial_fallback

                variance = variance_with_spatial_fallback(
                    variance, hist_up, color_acc, gbuffer,
                    params["sigma_n"], params["sigma_x"])
        else:
            color_history = raw_color
            moment_acc = state["moment_history"]
            hist_up = state["history_length"]
            if cfg.compat:
                # EstimateVariance stub = 10.0 (denoise.cu:320-329)
                variance = jnp.full((h, w), 10.0, jnp.float32)
            else:
                # native mode: the stub replaced by the SVGF-paper 7x7
                # bilateral spatial estimate (denoise/variance.py)
                from ptdn.denoise.variance import spatial_variance

                variance = spatial_variance(
                    raw_color, gbuffer, params["sigma_n"],
                    params["sigma_x"])

        if cfg.right_view_option == 1:
            output = jnp.broadcast_to(
                (hist_up.astype(jnp.float32) / 100.0)[..., None], (h, w, 3))
        elif cfg.right_view_option == 2:
            output = jnp.broadcast_to((variance / 0.1)[..., None], (h, w, 3))
        elif cfg.atrous_nlevel == 0 or not cfg.spatial_enable:
            output = color_history
        else:
            src = color_history
            var = variance
            for level in range(1, cfg.atrous_nlevel + 1):
                src, var = atrous_level(
                    src, var, gbuffer, level,
                    is_last=(level == cfg.atrous_nlevel),
                    sigma_l=params["sigma_l"], sigma_n=params["sigma_n"],
                    sigma_x=params["sigma_x"],
                    blur_variance=cfg.blur_variance,
                    add_color=(cfg.sep_color and cfg.add_color))
                if level == cfg.history_level:
                    color_history = src
            output = src

        new_state = {
            "color_history": color_history,
            "moment_history": moment_acc,
            "history_length": hist_up,
            "prev_position": gbuffer["position"],
            "prev_normal": gbuffer["normal"],
            "prev_geom_id": gbuffer["geom_id"],
            "prev_view": view_mat,
        }
        return output, new_state

    return denoise
