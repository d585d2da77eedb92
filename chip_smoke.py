"""On-card smoke check of the path tracer on one NVIDIA GPU.

    python chip_smoke.py               # phases 1-4, one card
    python chip_smoke.py --multichip   # phase 5 only, four cards

Phases (any failure ends the run with a non-zero exit and no result):
  1. device: JAX's platform, kind and count, and the card's name and
     power limit from nvidia-smi; refuses anything but a GPU.
  2. the plain xla oracle on the card against the CPU goldens in
     tests/golden/ (64x64), within the cross-backend bounds.
  3. the CUDA BVH traversal kernel against the plain traversal on
     camera and first-bounce diffuse rays of bunny and terrain30k at
     800x800 (tri_idx agreement, t/u/v tolerances, median times), and
     the production frame of both scenes with the plain traversal in the
     kernel's place.
  4. the main path, Renderer.render_frame on the production backend:
     depth 8, 5-level SVGF, 9 frames each of cornell, bunny and
     terrain30k at 800x800 and room at 1920x1080 with a moving camera;
     per-step memory analysis, per-frame times, finite outputs; cornell
     and bunny against the oracle; cornell's denoised RMSE after 32
     frames against benchmarks/gt/.
  5. (--multichip) the row-sharded step on four cards against the same
     frames on one card, for cornell and bunny at 800x800.

Each phase compiles its frame steps concurrently up front (set-up time,
printed), then renders. The last line of standard output is one JSON
object: {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

import argparse
import json
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
RES = (800, 800)
SVGF = dict(denoise_enable=True, temporal_enable=True, spatial_enable=True,
            atrous_nlevel=5, trace_depth=8)
MOVING = dict(automate_camera=True, camera_speed_x=0.02,
              camera_speed_theta=0.01, camera_speed_phi=0.015)
# cross-backend bounds (tests/test_golden.py): panel RMSE, and the share
# of raw-panel pixels whose largest channel differs by more than 1e-3
CROSS_RMSE = 0.012
RAW_FRAC = 0.01
GT_RMSE = 0.03


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def phase_device():
    import jax

    devs = jax.devices()
    d = devs[0]
    log(f"device: platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    check(d.platform == "gpu", f"no GPU: JAX's default device is "
          f"{d.platform}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    log("nvidia-smi:", smi.stdout.strip())
    return d


def scene(name):
    from ptdn.scene import Scene
    from ptdn.utils.assets import scene_path

    return Scene(scene_path(name))


def renderer(s, res=None, traversal=None, **kw):
    """A Renderer at depth 8 with 5-level SVGF (unless `kw` overrides)
    on the production backend (unless backend= says otherwise).
    `traversal` puts a stand-in in the CUDA kernel's place."""
    import jax

    from ptdn.engine import Renderer
    from ptdn.engine.step import make_frame_step
    from ptdn.utils.config import RenderConfig

    res = res or RES
    cfg = RenderConfig(**{**SVGF, "backend": "gpu", **kw})
    r = Renderer(s, cfg, resolution=res)
    if traversal is not None:
        r._step = jax.jit(make_frame_step(s, cfg, res, traversal=traversal),
                          donate_argnums=(0,))
    return r


def compile_all(named):
    """Compile the frame steps of {name: Renderer} concurrently (XLA
    compiles outside the interpreter lock) and log each step's memory."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(named)) as ex:
        mems = dict(zip(named, ex.map(lambda r: r.compile().memory_analysis(),
                                      named.values())))
    log(f"  compiled {len(named)} frame steps in "
        f"{time.perf_counter() - t0:.1f} s (concurrently)")
    for name, mem in mems.items():
        log(f"  memory_analysis {name} (bytes): " + ", ".join(
            f"{k} {getattr(mem, k + '_size_in_bytes')}"
            for k in ("argument", "output", "alias", "temp",
                      "generated_code")))


def render(r, frames):
    """Render `frames` frames (moving the camera if r.cfg says so);
    returns the last (left, right) as numpy and the ms of each frame
    after the first."""
    import jax

    from ptdn.app.automate import CameraAutomation

    auto = CameraAutomation(r.cfg)
    ms = []
    for k in range(frames):
        if auto.step(r.camera):
            r.cam_changed = True
        t0 = time.perf_counter()
        left, right = r.render_frame()
        jax.block_until_ready(right)
        if k:
            ms.append((time.perf_counter() - t0) * 1e3)
    out = (np.asarray(left), np.asarray(right))
    check(np.isfinite(out[0]).all() and np.isfinite(out[1]).all(),
          "non-finite output")
    return out, ms


def panel_errors(a, b):
    """(rmse_left, rmse_right, raw_frac) of two (left, right) renders."""
    def rmse(x, y):
        return float(np.sqrt(np.mean((np.asarray(x, np.float64) - y) ** 2)))

    frac = float((np.abs(a[0] - b[0]).max(axis=-1) > 1e-3).mean())
    return rmse(a[0], b[0]), rmse(a[1], b[1]), frac


def check_cross(name, a, b):
    el, er, frac = panel_errors(a, b)
    log(f"  {name}: rmse left {el:.6f} right {er:.6f}, raw frac "
        f"{frac:.6f}")
    check(el < CROSS_RMSE and er < CROSS_RMSE and frac < RAW_FRAC,
          f"{name} outside the cross-backend bounds")


def phase_goldens():
    import importlib.util

    # by path: another installed package may own the name "tests"
    spec = importlib.util.spec_from_file_location(
        "golden_cases", os.path.join(REPO, "tests", "test_golden.py"))
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)

    from ptdn.engine import Renderer
    from ptdn.utils.config import RenderConfig

    named = {name: Renderer(scene(cases.SCENES[name]),
                            RenderConfig(backend="xla", **cases.CONFIGS[name]),
                            resolution=(64, 64))
             for name in sorted(cases.CONFIGS)}
    compile_all(named)
    for name, r in named.items():
        g = np.load(os.path.join(cases.GOLDEN, f"{name}.npz"))
        out, _ = render(r, 3)
        check_cross(f"oracle vs CPU golden {name}", out,
                    (g["left"], g["right"]))


def timed(fn, *args, reps=10):
    """Median and max ms of `reps` calls after a warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts)), float(np.max(ts))


def traversal_rays(s, ds):
    """Camera rays at RES, and first-bounce diffuse rays: a
    cosine-weighted direction about the mesh normal at each camera ray's
    mesh hit (rays that miss the mesh keep their camera ray)."""
    import jax.numpy as jnp

    from ptdn.ops import bsdf
    from ptdn.ops.bvh_traverse import mesh_bvh_batched, mesh_closest_hit_attrs
    from ptdn.ops.camera import OrbitCamera, generate_camera_rays

    fr = OrbitCamera(s.camera, resolution=RES).frame()
    o, d = generate_camera_rays(fr.as_pytree(), RES)
    t, u, v, i, h = mesh_bvh_batched(
        ds, o, d, max_prims=int(s.bvh.prim_count.max()))
    nrm, _, _, _ = mesh_closest_hit_attrs(ds, o, d, t, u, v, i, h)
    rng = np.random.default_rng(0)
    n = o.shape[0]
    r1 = jnp.asarray(rng.uniform(size=n).astype(np.float32))
    r2 = jnp.asarray(rng.uniform(size=n).astype(np.float32))
    dd = bsdf.cosine_hemisphere(nrm, r1, r2)
    p = o + t[:, None] * d + 1e-4 * nrm
    return {"camera": (o, d),
            "diffuse": (jnp.where(h[:, None], p, o),
                        jnp.where(h[:, None], dd, d))}


def phase_traversal(scenes):
    """Kernel against plain traversal; returns the median ms/frame of the
    production frame with the plain traversal, per scene."""
    import jax

    from ptdn.ops import cuda_bvh
    from ptdn.ops.bvh_traverse import mesh_bvh_batched

    cuda_bvh.load()
    kernel = jax.jit(lambda ds, o, d: cuda_bvh.closest_hit(ds, o, d))
    plain_frames = {}
    for name in ("bunny", "terrain30k"):
        s = scenes[name]
        ds = s.device()
        mp = int(s.bvh.prim_count.max())
        plain = jax.jit(lambda ds, o, d: mesh_bvh_batched(ds, o, d,
                                                          max_prims=mp))
        for kind, (o, d) in traversal_rays(s, ds).items():
            t1, u1, v1, i1, h1 = map(np.asarray, kernel(ds, o, d))
            t0, u0, v0, i0, h0 = map(np.asarray, plain(ds, o, d))
            same = i1 == i0
            hit = same & h0
            dt = float(np.max(np.abs(t1 - t0)[hit] / np.abs(t0)[hit]))
            du = float(np.max(np.abs(u1 - u0)[hit]))
            dv = float(np.max(np.abs(v1 - v0)[hit]))
            km, kx = timed(kernel, ds, o, d)
            pm, px = timed(plain, ds, o, d)
            log(f"  traversal {name} {kind} ({o.shape[0]} rays, hit "
                f"{h0.mean():.4f}): tri_idx agree {same.mean():.6f}, max "
                f"rel dt {dt:.3g}, du {du:.3g}, dv {dv:.3g}; kernel "
                f"median {km:.3f} ms (max {kx:.3f}), plain median "
                f"{pm:.3f} ms (max {px:.3f})")
            check(same.mean() >= 0.999, f"{name} {kind}: tri_idx agreement")
            check(dt <= 1e-5 and du <= 1e-5 and dv <= 1e-5,
                  f"{name} {kind}: t/u/v outside tolerance")
        plain_frames[name] = renderer(s, traversal=cuda_bvh.plain_call(mp))
    compile_all({f"{k} with plain traversal": r
                 for k, r in plain_frames.items()})
    out = {}
    for name, r in plain_frames.items():
        _, ms = render(r, 9)
        out[name] = float(np.median(ms))
        log(f"  {name} {RES[0]}x{RES[1]} production frame with the plain "
            f"traversal: median {out[name]:.3f} ms, max {np.max(ms):.3f} "
            f"ms ({len(ms)} frames after the first)")
    return out


def phase_main(scenes, plain_ms):
    import jax

    cells = {"cornell": (RES, {}), "bunny": (RES, {}),
             "terrain30k": (RES, {}), "room": ((1920, 1080), MOVING)}
    prod = {name: renderer(scenes[name], res, **kw)
            for name, (res, kw) in cells.items()}
    oracle = {name: renderer(scenes[name], backend="xla")
              for name in ("cornell", "bunny")}
    compile_all({**{f"{k} production": r for k, r in prod.items()},
                 **{f"{k} oracle": r for k, r in oracle.items()}})
    kind = jax.devices()[0].device_kind
    for name, r in prod.items():
        res = r.resolution
        out, ms = render(r, 9)
        med = float(np.median(ms))
        log(f"  {name} {res[0]}x{res[1]} production: median {med:.3f} "
            f"ms/frame, max {np.max(ms):.3f} ms ({len(ms)} frames after "
            f"the first; {kind})")
        if name in plain_ms:
            log(f"  {name}: frame with the kernel {med:.3f} ms vs with "
                f"the plain traversal {plain_ms[name]:.3f} ms "
                f"({plain_ms[name] / med:.1f}x)")
        if name in oracle:
            want, _ = render(oracle[name], 9)
            check_cross(f"{name} production vs oracle, 9 frames", out, want)
        if name == "cornell":
            check_gt(r)


def check_gt(r):
    """Cornell's denoised RMSE against the converged ground truth after
    32 frames."""
    for _ in range(32 - r.frame):
        _, right = r.render_frame()
    gt = np.load(os.path.join(REPO, "benchmarks", "gt",
                              "cornell_800x800_d8.npz"))["gt"]
    dn = np.clip(np.asarray(right, np.float64), 0, 1)
    e = float(np.sqrt(np.mean((dn - np.clip(gt, 0, 1)) ** 2)))
    log(f"  cornell denoised RMSE vs GT after {r.frame} frames: {e:.5f}")
    check(e < GT_RMSE, "cornell denoised RMSE vs GT")


def phase_multichip(scenes):
    import jax
    import jax.numpy as jnp

    from ptdn.engine.step import init_frame_state, make_frame_step
    from ptdn.ops.camera import OrbitCamera, view_matrix
    from ptdn.parallel.sharded import make_sharded_step
    from ptdn.utils.config import RenderConfig

    check(len(jax.devices()) >= 4, "--multichip needs four GPUs")
    cfg = RenderConfig(backend="gpu", **SVGF)
    for name in ("cornell", "bunny"):
        s = scenes[name]
        ds = s.device()
        fr = OrbitCamera(s.camera, resolution=RES).frame()
        args = (ds, fr.as_pytree(), jnp.asarray(view_matrix(fr)),
                cfg.traced_params())
        one = jax.jit(make_frame_step(s, cfg, RES))
        st1 = init_frame_state(RES)
        step4, st4, mesh = make_sharded_step(s, cfg, RES, n_devices=4)
        for f in range(3):
            fl = (jnp.uint32(f), jnp.bool_(f == 0))
            st1, l1, r1 = one(st1, *args, *fl)
            st4, l4, r4 = step4(st4, *args, *fl)
        a = [np.asarray(x) for x in (l1, r1)]
        b = [np.asarray(x) for x in (l4, r4)]
        check(len(r4.sharding.device_set) == 4, "output not sharded")
        el, er, frac = panel_errors(b, a)
        log(f"  {name} 4-card vs 1-card, 3 frames: rmse left {el:.3g} "
            f"right {er:.3g}, raw frac {frac:.3g}")
        check(el < 1e-3 and er < 1e-3 and frac < 1e-3,
              f"{name}: sharded step differs from one card")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-card sharded-step phase")
    args = ap.parse_args()
    t0 = time.perf_counter()
    dev = phase_device()
    import jax

    t1 = time.perf_counter()
    scenes = {n: scene(n) for n in (
        ("cornell", "bunny") if args.multichip
        else ("cornell", "bunny", "terrain30k", "room"))}
    log(f"scenes loaded in {time.perf_counter() - t1:.1f} s")
    state = {}
    phases = ([("multichip", lambda: phase_multichip(scenes))]
              if args.multichip else
              [("goldens", phase_goldens),
               ("traversal", lambda: state.update(
                   plain=phase_traversal(scenes))),
               ("main path", lambda: phase_main(scenes, state["plain"]))])
    for name, fn in phases:
        t1 = time.perf_counter()
        log(f"== phase {name}")
        fn()
        log(f"== phase {name} passed in {time.perf_counter() - t1:.1f} s")
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
