"""Headless CLI — the reference app (main.cpp + preview.cpp) without GL:
renders N frames, optionally saves PNG/HDR and side-by-side comparisons,
and emits structured per-frame stats.

Every interactive ImGui control (preview.cpp:211-375) is a flag here.

Usage:
  python -m ptdn.app.cli scenes/cornell.txt --frames 64 --denoise \
      --temporal --spatial --out out/cornell.png --stats
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ptdn", description="real-time path tracer + SVGF denoiser")
    p.add_argument("scene", help="scene .txt file (reference format)")
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--width", type=int, default=0, help="override RES width")
    p.add_argument("--height", type=int, default=0, help="override RES height")
    # tracer controls (main.cpp:39-47)
    p.add_argument("--depth", type=int, default=4, help="trace depth 1..10")
    p.add_argument("--no-shadowray", action="store_true")
    p.add_argument("--no-reducevar", action="store_true")
    p.add_argument("--sintensity", type=float, default=2.7)
    p.add_argument("--lightradius", type=float, default=1.4)
    p.add_argument("--no-bvh", action="store_true")
    p.add_argument("--mesh-mode", choices=["auto", "bvh", "brute"],
                   default="auto")
    # denoiser controls (main.cpp:50-62)
    p.add_argument("--denoise", action="store_true")
    p.add_argument("--temporal", action="store_true")
    p.add_argument("--spatial", action="store_true")
    p.add_argument("--color-alpha", type=float, default=0.2)
    p.add_argument("--moment-alpha", type=float, default=0.2)
    p.add_argument("--no-blur-variance", action="store_true")
    p.add_argument("--sigma-l", type=float, default=0.45)
    p.add_argument("--sigma-x", type=float, default=0.35)
    p.add_argument("--sigma-n", type=float, default=0.2)
    p.add_argument("--atrous-levels", type=int, default=5)
    p.add_argument("--history-level", type=int, default=1)
    p.add_argument("--sepcolor", action="store_true")
    p.add_argument("--addcolor", action="store_true")
    # camera automation (main.cpp:65-70)
    p.add_argument("--automate", action="store_true")
    p.add_argument("--cam-speed", type=float, nargs=5,
                   metavar=("X", "Y", "Z", "THETA", "PHI"),
                   default=[0.0, 0.0, 0.0, 0.0, 0.0])
    # debug views (preview.cpp:360-365)
    p.add_argument("--view", choices=["color", "history", "variance"],
                   default="color")
    # engine
    p.add_argument("--backend", choices=["gpu", "xla"], default="gpu",
                   help="gpu: production path (needs a GPU); xla: the "
                        "plain oracle, runs on any device")
    p.add_argument("--native", action="store_true",
                   help="compat=False: fix replicated reference quirks "
                        "where a fix exists (PARITY.md section 2 — true "
                        "barycentric normals, SVGF-paper spatial "
                        "variance instead of the 10.0 stub)")
    # output
    p.add_argument("--out", default="", help="save final denoised PNG here")
    p.add_argument("--out-raw", default="", help="save final raw/accum PNG")
    p.add_argument("--side-by-side", default="",
                   help="save raw|denoised side-by-side PNG (PBO layout)")
    p.add_argument("--hdr", default="", help="save final denoised HDR")
    p.add_argument("--save-like-reference", action="store_true",
                   help="flip + '<FILE>.<time>.<N>samp.png' naming "
                        "(main.cpp:131-152)")
    p.add_argument("--stats", action="store_true",
                   help="print one JSON line of stats per frame")
    return p


def config_from_args(args):
    from ptdn.utils.config import RenderConfig

    view = {"color": 0, "history": 1, "variance": 2}[args.view]
    return RenderConfig(
        trace_depth=args.depth,
        shadow_ray=not args.no_shadowray,
        reduce_var=not args.no_reducevar,
        shadow_intensity=args.sintensity,
        light_radius=args.lightradius,
        use_bvh=not args.no_bvh,
        mesh_mode=args.mesh_mode,
        denoise_enable=args.denoise,
        temporal_enable=args.temporal,
        spatial_enable=args.spatial,
        color_alpha=args.color_alpha,
        moment_alpha=args.moment_alpha,
        blur_variance=not args.no_blur_variance,
        sigma_l=args.sigma_l,
        sigma_x=args.sigma_x,
        sigma_n=args.sigma_n,
        atrous_nlevel=args.atrous_levels,
        history_level=args.history_level,
        sep_color=args.sepcolor,
        add_color=args.addcolor,
        automate_camera=args.automate,
        camera_speed_x=args.cam_speed[0],
        camera_speed_y=args.cam_speed[1],
        camera_speed_z=args.cam_speed[2],
        camera_speed_theta=args.cam_speed[3],
        camera_speed_phi=args.cam_speed[4],
        right_view_option=view,
        backend=args.backend,
        compat=not args.native,
    )


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    import jax

    from ptdn.app.automate import CameraAutomation
    from ptdn.engine import Renderer
    from ptdn.scene import Scene
    from ptdn.utils import image_io

    scene = Scene(args.scene)
    cfg = config_from_args(args)
    res = None
    if args.width and args.height:
        res = (args.width, args.height)
    renderer = Renderer(scene, cfg, resolution=res)
    auto = CameraAutomation(cfg)

    left = right = None
    t_all = time.time()
    for i in range(args.frames):
        if auto.step(renderer.camera):
            renderer.cam_changed = True
        t0 = time.time()
        left, right = renderer.render_frame()
        jax.block_until_ready(right)
        dt = time.time() - t0
        if args.stats:
            w, h = renderer.resolution
            print(json.dumps({
                "frame": i, "ms": round(dt * 1000, 3),
                "rays_per_s": round(w * h / dt),
                "accum_frame": renderer.frame - 1,
            }), flush=True)
    total = time.time() - t_all

    left = np.asarray(left)
    right = np.asarray(right)
    w, h = renderer.resolution
    print(f"rendered {args.frames} frames at {w}x{h} in {total:.2f}s "
          f"({total / max(args.frames, 1) * 1000:.1f} ms/frame avg incl. "
          f"compile)", file=sys.stderr)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        image_io.save_png(args.out, right)
    if args.out_raw:
        image_io.save_png(args.out_raw, left)
    if args.side_by_side:
        image_io.save_png(args.side_by_side,
                          np.concatenate([left, right], axis=1))
    if args.hdr:
        image_io.save_hdr(args.hdr, right)
    if args.save_like_reference:
        image_io.save_image_like_reference(right, scene.image_name,
                                           renderer.frame)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
