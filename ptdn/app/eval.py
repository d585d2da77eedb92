"""Quality evaluation harness: denoised RMSE vs accumulated reference.

This is the BASELINE.json metric: render a ground-truth image by
accumulating many unfiltered frames (the reference's converged mode,
pathtrace.cu:398), then render K 1-spp SVGF frames and report RMSE of the
denoised output against the ground truth. Also supports backend parity
checks (production backend vs the xla oracle, RMSE at float32 noise
level).

Usage:
  python -m ptdn.app.eval scenes/cornell.txt --gt-frames 2000 \
      --frames 32 --depth 8 [--width 800 --height 800]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64)
                                  - np.asarray(b, np.float64)) ** 2)))


def render_ground_truth(scene, resolution, frames: int, depth: int,
                        backend: str = "gpu"):
    from ptdn.engine import Renderer
    from ptdn.utils.config import RenderConfig

    cfg = RenderConfig(backend=backend, denoise_enable=False,
                       trace_depth=depth)
    r = Renderer(scene, cfg, resolution=resolution)
    left, _ = r.render(frames)
    return left


def render_denoised(scene, resolution, frames: int, depth: int,
                    backend: str = "gpu", **denoise_overrides):
    from ptdn.engine import Renderer
    from ptdn.utils.config import RenderConfig

    kw = dict(denoise_enable=True, temporal_enable=True, spatial_enable=True,
              atrous_nlevel=5)
    kw.update(denoise_overrides)
    cfg = RenderConfig(backend=backend, trace_depth=depth, **kw)
    r = Renderer(scene, cfg, resolution=resolution)
    left, right = r.render(frames)
    return left, right


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--gt-frames", type=int, default=2000)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--backend", choices=["gpu", "xla"], default="gpu")
    ap.add_argument("--compare-backends", action="store_true",
                    help="also report RMSE against the xla oracle")
    ap.add_argument("--save-prefix", default="")
    args = ap.parse_args(argv)

    from ptdn.scene import Scene
    from ptdn.utils.image_io import save_png

    scene = Scene(args.scene)
    res = ((args.width, args.height)
           if args.width and args.height else scene.resolution)

    gt = render_ground_truth(scene, res, args.gt_frames, args.depth,
                             args.backend)
    raw, dn = render_denoised(scene, res, args.frames, args.depth,
                              args.backend)
    gt_c = np.clip(np.asarray(gt), 0, 1)
    result = {
        "scene": args.scene,
        "resolution": list(res),
        "gt_frames": args.gt_frames,
        "svgf_frames": args.frames,
        "rmse_raw_1spp_vs_gt": rmse(np.clip(raw, 0, 1), gt_c),
        "rmse_denoised_vs_gt": rmse(np.clip(dn, 0, 1), gt_c),
    }
    if args.compare_backends:
        raw2, dn2 = render_denoised(scene, res, args.frames, args.depth,
                                    "xla")
        result["rmse_vs_xla_denoised"] = rmse(dn, dn2)
        result["rmse_vs_xla_raw"] = rmse(raw, raw2)
    if args.save_prefix:
        save_png(args.save_prefix + "_gt.png", gt_c)
        save_png(args.save_prefix + "_denoised.png", np.asarray(dn))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
