"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline: cornell.txt 800x800, 1 spp, 8 bounces, static camera, 5-level
à-trous SVGF, production backend ("gpu"), on one device. Times are host
wall-clock windows of `Renderer.render_frame` that end in
`block_until_ready`, after a warm-up that compiles every shape.

Extra configs (diamond/bunny/room/terrain30k/room-1080p-animated) run
with --all and are written to bench_results.json; the single stdout JSON
line stays the headline metric.

--quality additionally reports denoised RMSE vs a converged ground
truth per static config (5000-frame accumulated reference, the
reference's pathtrace.cu:398 running-mean mode). GT images are cached in
benchmarks/gt/*.npz and rendered once on first use. --stages emits an
ablation decomposition per config with keys full / trace / temporal /
atrous / nee_visibility / denoise_glue (see stage_breakdown for what
each bucket really contains — 'trace' still includes texture resolve and
NEE visibility).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GT_DIR = os.path.join(REPO, "benchmarks", "gt")


def run_config(scene_path, resolution, frames, warmup, cfg):
    import jax

    from ptdn.app.automate import CameraAutomation
    from ptdn.engine import Renderer
    from ptdn.scene import Scene

    scene = Scene(scene_path)
    r = Renderer(scene, cfg, resolution=resolution)
    auto = CameraAutomation(cfg)

    def run(n):
        right = None
        t0 = time.perf_counter()
        for _ in range(n):
            if auto.step(r.camera):
                r.cam_changed = True
            left, right = r.render_frame()
        jax.block_until_ready(right)
        return time.perf_counter() - t0, right

    run(max(warmup, 2))
    dt, right = run(frames)
    return dt / frames * 1000.0, np.asarray(right)


def rays_per_sec(resolution, depth, ms):
    """Bounce rays only (primary + depth-1 scatters), excluding NEE
    visibility rays — the conservative throughput figure."""
    w, h = resolution
    return w * h * depth * 1000.0 / ms if ms else 0.0


def _gt_path(name, resolution, depth):
    return os.path.join(GT_DIR, f"{name}_{resolution[0]}x{resolution[1]}"
                                f"_d{depth}.npz")


def _scene_sha(scene_path):
    """Content hash of the scene file + any OBJ models it references —
    a changed scene silently reusing a stale cached GT would corrupt
    every --quality RMSE (round-4 advisor)."""
    import hashlib

    h = hashlib.sha256(open(scene_path, "rb").read())
    sdir = os.path.dirname(os.path.abspath(scene_path))
    for line in open(scene_path):
        tok = line.split()
        # mesh objects name their .obj on a bare line (parser.py:20)
        if tok and tok[0].endswith(".obj"):
            mp = os.path.join(sdir, "Models", tok[0])
            if os.path.isfile(mp):
                h.update(open(mp, "rb").read())
    return h.hexdigest()[:16]


def ground_truth(scene_path, name, resolution, depth, gt_frames):
    """Converged accumulated reference (cached). Rendered with the
    production backend, denoise off — the reference's running-mean converged
    mode (pathtrace.cu:398). The cache stores a content hash of the
    scene (+ models); a mismatch forces a re-render. Legacy caches
    without the hash are trusted once and upgraded in place (the
    vendored scenes are byte-identical to the ones the committed GTs
    were rendered from)."""
    path = _gt_path(name, resolution, depth)
    sha = _scene_sha(scene_path)
    if os.path.exists(path):
        z = np.load(path, allow_pickle=False)
        stored = str(z["scene_sha"]) if "scene_sha" in z.files else None
        if stored == sha:
            return z["gt"]
        if stored is None:
            gt = z["gt"]
            np.savez_compressed(path, gt=gt,
                                gt_frames=z["gt_frames"], scene_sha=sha)
            return gt
        print(f"[bench] GT cache for {name} is stale "
              f"(scene hash {stored} != {sha}); re-rendering",
              file=sys.stderr, flush=True)
    from ptdn.engine import Renderer
    from ptdn.scene import Scene
    from ptdn.utils.config import RenderConfig

    print(f"[bench] rendering GT for {name} ({gt_frames} frames)...",
          file=sys.stderr, flush=True)
    cfg = RenderConfig(backend="gpu", denoise_enable=False,
                       trace_depth=depth)
    r = Renderer(Scene(scene_path), cfg, resolution=resolution)
    left, _ = r.render(gt_frames)
    gt = np.asarray(left, np.float32)
    os.makedirs(GT_DIR, exist_ok=True)
    np.savez_compressed(path, gt=gt, gt_frames=gt_frames, scene_sha=sha)
    return gt


def quality_rmse(scene_path, name, resolution, depth, cfg, gt_frames,
                 svgf_frames=32):
    """Denoised RMSE vs converged GT after
    svgf_frames 1-spp SVGF frames (temporal history warmed up)."""
    from ptdn.engine import Renderer
    from ptdn.scene import Scene

    gt = np.clip(ground_truth(scene_path, name, resolution, depth,
                              gt_frames), 0, 1)
    r = Renderer(Scene(scene_path), cfg, resolution=resolution)
    left, right = r.render(svgf_frames)
    raw = np.clip(np.asarray(left), 0, 1)
    dn = np.clip(np.asarray(right), 0, 1)
    e_raw = float(np.sqrt(np.mean((raw.astype(np.float64) - gt) ** 2)))
    e_dn = float(np.sqrt(np.mean((dn.astype(np.float64) - gt) ** 2)))
    return {"rmse_denoised": round(e_dn, 5), "rmse_raw_1spp": round(e_raw, 5),
            "gt_frames": gt_frames, "svgf_frames": svgf_frames}


def run_config_steady(scene_path, resolution, cfg, frames=20):
    """Steady-state ms/frame of the static-camera step: the frame state
    threads call to call, and the window ends in block_until_ready."""
    import jax
    import jax.numpy as jnp

    from ptdn.engine import Renderer
    from ptdn.ops.camera import view_matrix
    from ptdn.scene import Scene

    r = Renderer(Scene(scene_path), cfg, resolution=resolution)
    for _ in range(3):
        r.render_frame()                     # compile + warm the state
    fc = r.camera.frame()
    cam = fc.as_pytree()
    vm = jnp.asarray(view_matrix(fc))
    state = r.state
    f8 = jnp.uint32(8)
    fls = jnp.bool_(False)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(frames):
        state, _, right = r._step(state, r.ds, cam, vm, r._params, f8, fls)
    jax.block_until_ready(right)
    return (time.perf_counter() - t0) / frames * 1000.0


def stage_breakdown(scene_path, resolution, base_cfg):
    """Ablation decomposition. Keys (what they really are):

    * full           — the full config, steady state
    * trace          — denoise disabled entirely (this bucket still
                       includes texture resolve and NEE visibility)
    * temporal       — full minus temporal-off
    * atrous         — full minus atrous_nlevel=0
    * nee_visibility — full minus shadow_ray=False (the NEE shadow
                       rays AND their shading contribution)
    * denoise_glue   — full - trace - temporal - atrous (debug views,
                       buffer plumbing)
    """
    full = run_config_steady(scene_path, resolution, base_cfg)
    trace_only = run_config_steady(scene_path, resolution,
                                  base_cfg.replace(denoise_enable=False))
    no_temporal = run_config_steady(
        scene_path, resolution, base_cfg.replace(temporal_enable=False))
    no_atrous = run_config_steady(scene_path, resolution,
                                 base_cfg.replace(atrous_nlevel=0))
    no_nee = run_config_steady(scene_path, resolution,
                              base_cfg.replace(shadow_ray=False))
    d = {
        "full": round(full, 3),
        "trace": round(trace_only, 3),
        "temporal": round(max(full - no_temporal, 0.0), 3),
        "atrous": round(max(full - no_atrous, 0.0), 3),
        "nee_visibility": round(max(full - no_nee, 0.0), 3),
    }
    d["denoise_glue"] = round(
        max(full - trace_only - d["temporal"] - d["atrous"], 0.0), 3)
    return d


# (scene file, name, resolution override) for the extra configs;
# resolution None = the scene file's RES
def bench_configs(scenes_dir):
    repo_scenes = os.path.join(REPO, "scenes")
    return [
        (f"{scenes_dir}/diamond.txt", "diamond", None),
        (f"{scenes_dir}/bunny.txt", "bunny", None),
        (f"{scenes_dir}/room.txt", "room", None),
        # ~30k-tri scale benchmark (the reference demonstrated a
        # 30k-tri room as real-time, slides/MS3.pdf p.6)
        (os.path.join(repo_scenes, "terrain30k.txt"), "terrain30k", None),
    ]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--all", action="store_true",
                    help="also run the non-headline configs")
    ap.add_argument("--quality", action="store_true",
                    help="also report denoised RMSE vs cached converged GT")
    ap.add_argument("--stages", action="store_true",
                    help="also emit per-stage ms decomposition per config")
    ap.add_argument("--gt-frames", type=int, default=5000)
    ap.add_argument("--scenes-dir", default=None, help="scene dir (default: PTDN_SCENES_DIR or the vendored <repo>/scenes)")
    args = ap.parse_args()

    if args.scenes_dir is None:
        from ptdn.utils.assets import scenes_dir as _sd
        args.scenes_dir = str(_sd())

    from ptdn.utils.config import RenderConfig

    svgf = dict(denoise_enable=True, temporal_enable=True,
                spatial_enable=True, atrous_nlevel=5, backend="gpu")

    # headline: cornell 800x800 1spp 8 bounces + 5-iter SVGF
    cfg = RenderConfig(trace_depth=8, **svgf)
    cornell = f"{args.scenes_dir}/cornell.txt"
    ms, _ = run_config(cornell, (800, 800), args.frames, args.warmup, cfg)

    import jax

    dev = jax.devices()[0]
    result = {
        "metric": "ms/frame (cornell 800x800, 1spp, depth 8, SVGF 5-level)",
        "value": round(ms, 3),
        "unit": "ms",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }

    out = {"headline": result}
    quality = {}
    stages = {}
    rays = {"cornell": round(rays_per_sec((800, 800), 8, ms) / 1e6, 1)}

    if args.quality:
        quality["cornell"] = quality_rmse(cornell, "cornell", (800, 800), 8,
                                          cfg, args.gt_frames)
    if args.stages:
        stages["cornell"] = stage_breakdown(cornell, (800, 800), cfg)

    if args.all:
        extras = {}
        for path, name, res in bench_configs(args.scenes_dir):
            c = RenderConfig(trace_depth=8, **svgf)
            m, _ = run_config(path, res, args.frames, args.warmup, c)
            extras[name] = round(m, 3)
            from ptdn.scene import Scene
            r0 = res or Scene(path).resolution
            rays[name] = round(rays_per_sec(r0, 8, m) / 1e6, 1)
            if args.quality:
                quality[name] = quality_rmse(path, name, r0, 8, c,
                                             args.gt_frames)
            if args.stages:
                stages[name] = stage_breakdown(path, res, c)
        # room.txt, animated camera, 1080p: full temporal reprojection
        # loop (no GT/RMSE: the camera never converges on one view)
        c = RenderConfig(trace_depth=8, automate_camera=True,
                         camera_speed_x=0.02, camera_speed_theta=0.01,
                         camera_speed_phi=0.015, **svgf)
        m, _ = run_config(f"{args.scenes_dir}/room.txt", (1920, 1080),
                          args.frames, args.warmup, c)
        extras["room_1080p_animated"] = round(m, 3)
        rays["room_1080p_animated"] = round(
            rays_per_sec((1920, 1080), 8, m) / 1e6, 1)
        if args.stages:
            stages["room_1080p_animated"] = stage_breakdown(
                f"{args.scenes_dir}/room.txt", (1920, 1080), c)
        out["extra_ms"] = extras

    out["rays_per_sec_M"] = rays
    if quality:
        out["quality_rmse"] = quality
    if stages:
        out["stages_ms"] = stages
    if args.all or args.quality or args.stages:
        with open(os.path.join(REPO, "bench_results.json"), "w") as f:
            json.dump(out, f, indent=2)
        print(json.dumps(out), file=sys.stderr)

    print(json.dumps(result))


if __name__ == "__main__":
    main()
