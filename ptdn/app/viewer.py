"""Interactive viewer — the reference's GLFW/ImGui control surface
(reference src/preview.cpp, src/main.cpp callbacks) as a terminal REPL
that works headless: every keystroke command maps to the same camera /
pipeline mutation, frames render continuously, and the current
side-by-side view (left raw | right denoised, the PBO layout) is written
to a PNG after each command (and displayed via matplotlib when a GUI is
available).

Commands (reference bindings in parentheses):
  , / .        orbit phi -/+ (main.cpp:249-256)
  [ / ]        orbit theta -/+        (mouse-drag equivalent)
  + / -        dolly in/out           (scroll equivalent)
  w a s d      pan look-at            (arrow keys, main.cpp:233-247)
  r            reset look-at to scene LOOKAT (R key, main.cpp:222-226)
  reset        full resetCamera() (main.cpp:77-101)
  D T F        toggle denoise / temporal / spatial (hotkeys D/T/F)
  v            cycle debug view (color -> history -> variance)
  depth N, sigma_l X, ... set any config field
  step         render one frame while paused (Step button)
  run / pause  toggle continuous rendering (Run checkbox)
  save         saveImage() naming + flip (S key, main.cpp:131-152)
  q            save + quit (Esc)

In tty watch mode, word commands are typed with a ':' prefix
(``:reset``, ``:sigma_l 0.7``, ``:save`` + Enter) so hotkeys keep
firing on the bare keypress; over a pipe, plain lines work as-is.
"""

from __future__ import annotations

import sys

import numpy as np


# single-key commands dispatched immediately in tty cbreak mode (the
# reference's GLFW key bindings, main.cpp:211-260)
_SINGLE_KEYS = set(",.[]+-wasdrDTFvq")


def _stdin_poll_factory():
    """Non-blocking stdin poll for watch mode. Returns (poll, restore).

    On a real tty, the terminal is switched to cbreak so single
    keypresses (orbit/pan/toggles) act immediately without Enter —
    matching the reference's key-repeat steering (main.cpp:231-257);
    typed word commands open with ':' (e.g. ``:sigma_l 0.7``,
    ``:reset``) and are accumulated until Enter — the ':' prefix keeps
    them reachable even when their first char is a hotkey. On
    pipes/files the poll stays line-based (no prefix needed)."""
    import select

    if not sys.stdin.isatty():
        def poll():
            ready, _, _ = select.select([sys.stdin], [], [], 0.0)
            return sys.stdin.readline() if ready else None

        return poll, None

    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    buf = []

    def poll():
        ready, _, _ = select.select([sys.stdin], [], [], 0.0)
        if not ready:
            return None
        ch = sys.stdin.read(1)
        if not buf:
            # ':' opens a typed command (vim-style) so word commands
            # whose first char is also a hotkey ('reset'/'r',
            # 'sigma_l'/'s', 'depth'/'d', 'save', 'step', 'run') stay
            # reachable in cbreak mode; bare hotkeys act immediately
            if ch == ":":
                buf.append(ch)
                return None
            if ch in _SINGLE_KEYS:
                return ch
        if ch in ("\n", "\r"):
            s = "".join(buf).lstrip(":")
            buf.clear()
            return s
        buf.append(ch)
        return None

    def restore():
        termios.tcsetattr(fd, termios.TCSADRAIN, old)

    return poll, restore


class Viewer:
    def __init__(self, renderer, out_path: str = "viewer.png",
                 frames_per_command: int = 8, display: str = "auto",
                 term_width: int = 100):
        """display: 'png' (write out_path only), 'ansi' (live truecolor
        half-block frames in the terminal, utils/termview.py — the
        reference's per-frame window blit, preview.cpp:377-413, without
        a GL surface), or 'auto' (ansi when stdout is a tty)."""
        self.r = renderer
        self.out_path = out_path
        self.frames_per_command = frames_per_command
        self.running = True
        self._mpl = None
        if display == "auto":
            display = "ansi" if sys.stdout.isatty() else "png"
        self.display = display
        self.term_width = term_width
        self._ansi_first = True

    def _render(self, n=None):
        left = right = None
        for _ in range(n or self.frames_per_command):
            left, right = self.r.render_frame()
        return np.asarray(left), np.asarray(right)

    def _show(self, left, right):
        from ptdn.utils.image_io import save_png

        side = np.concatenate([left, right], axis=1)
        save_png(self.out_path, side)
        if self.display == "ansi":
            from ptdn.utils.termview import ansi_halfblocks

            if self._ansi_first:
                sys.stdout.write("\x1b[2J")     # clear once, then overdraw
                self._ansi_first = False
            sys.stdout.write(ansi_halfblocks(side, self.term_width,
                                             home=True))
            sys.stdout.flush()
        if self._mpl is None:
            try:
                import matplotlib
                import matplotlib.pyplot as plt

                if matplotlib.get_backend().lower() != "agg":
                    self._mpl = plt
            except Exception:
                self._mpl = False
        if self._mpl:
            self._mpl.clf()
            self._mpl.imshow(np.clip(side, 0, 1))
            self._mpl.pause(0.01)

    def handle(self, cmd: str) -> bool:
        """Apply one command; returns False to quit."""
        from ptdn.utils.image_io import save_image_like_reference

        r = self.r
        tok = cmd.strip().split()
        if not tok:
            return True
        c = tok[0]
        if c == ",":
            r.orbit(dphi=-0.1)
        elif c == ".":
            r.orbit(dphi=0.1)
        elif c == "[":
            r.orbit(dtheta=-0.1)
        elif c == "]":
            r.orbit(dtheta=0.1)
        elif c == "+":
            r.dolly(-0.5)
        elif c == "-":
            r.dolly(0.5)
        elif c in ("w", "a", "s", "d"):
            fr = r.camera.frame()
            delta = {"w": fr.view * 0.5, "s": -fr.view * 0.5,
                     "a": -fr.right * 0.5, "d": fr.right * 0.5}[c]
            r.pan(delta)
        elif c == "r":
            # GLFW_KEY_R resets ONLY lookAt to ogLookAt (main.cpp:222-226)
            # — zoom/theta/phi keep their steered values
            r.camera.look_at = r.camera.og_look_at.copy()
            r.cam_changed = True
        elif c == "reset":
            # full resetCamera() (main.cpp:77-101): re-derive
            # zoom/theta/phi from the scene's EYE/LOOKAT
            r.reset_camera()
        elif c in ("D", "T", "F"):
            field = {"D": "denoise_enable", "T": "temporal_enable",
                     "F": "spatial_enable"}[c]
            r.set_config(r.cfg.replace(**{field: not getattr(r.cfg, field)}))
        elif c == "v":
            r.set_config(r.cfg.replace(
                right_view_option=(r.cfg.right_view_option + 1) % 3))
        elif c == "run":
            self.running = True
        elif c == "pause":
            self.running = False
        elif c == "step":
            self._show(*self._render(1))
            return True
        elif c == "save":
            _, right = self._render(1)
            save_image_like_reference(right, r.scene.image_name, r.frame)
        elif c == "q":
            _, right = self._render(1)
            save_image_like_reference(right, r.scene.image_name, r.frame)
            return False
        elif len(tok) == 2 and hasattr(r.cfg, c):
            val = type(getattr(r.cfg, c))(
                float(tok[1]) if "." in tok[1] else int(tok[1]))
            r.set_config(r.cfg.replace(**{c: val}))
        else:
            print(f"? unknown command {cmd!r}", file=sys.stderr)
            return True
        if self.running:
            self._show(*self._render())
        return True

    def loop(self):
        self._show(*self._render())
        print(f"viewer: writing {self.out_path}; type commands "
              f"(q to quit, see module docstring)", file=sys.stderr)
        for line in sys.stdin:
            if not self.handle(line):
                break

    def watch(self, max_frames=None, input_poll=None, show_every=8,
              report=True):
        """Continuous live render loop — the reference's vsync'd
        mainLoop (preview.cpp:377-413): render every iteration, poll
        input WITHOUT blocking, apply commands as they arrive. Traced
        config changes (sigmas, alphas, toggles, camera) re-use the
        jitted step — no recompile mid-loop; only structural changes
        (trace_depth, backend) re-jit, exactly like the reference
        rebuilding its CUDA state on reset (main.cpp:194-201).

        input_poll: callable returning one command string or None
        (default: select() on stdin; on a real tty, cbreak mode so
        single keypresses steer IMMEDIATELY without Enter — the
        reference's keys act on press, main.cpp:211-304). Returns
        frames rendered."""
        import time

        restore = None
        if input_poll is None:
            input_poll, restore = _stdin_poll_factory()

        frames = 0
        t0 = time.time()
        last_report = t0
        left = right = None
        try:
            while max_frames is None or frames < max_frames:
                cmd = input_poll()
                if cmd is not None and not self.handle_nodraw(cmd):
                    break
                left, right = self.r.render_frame()
                frames += 1
                if frames % show_every == 0:
                    self._show(np.asarray(left), np.asarray(right))
                now = time.time()
                if report and now - last_report >= 2.0:
                    # the reference's window-title frame counter
                    # (preview.cpp:388), as a periodic status line
                    print(f"watch: {frames} frames, "
                          f"{frames / (now - t0):.1f} fps "
                          f"(frame {self.r.frame})", file=sys.stderr)
                    last_report = now
        finally:
            if restore is not None:
                restore()
        if left is not None:
            self._show(np.asarray(left), np.asarray(right))
        return frames

    def handle_nodraw(self, cmd: str) -> bool:
        """handle() without the per-command render/PNG (watch mode owns
        the render cadence)."""
        was_running, self.running = self.running, False
        try:
            return self.handle(cmd)
        finally:
            self.running = was_running


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--out", default="viewer.png")
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--denoise", action="store_true")
    ap.add_argument("--watch", action="store_true",
                    help="continuous live render loop (non-blocking "
                         "input) instead of render-per-command")
    ap.add_argument("--frames", type=int, default=None,
                    help="with --watch: stop after N frames")
    ap.add_argument("--display", choices=["auto", "ansi", "png"],
                    default="auto",
                    help="live frame sink: ANSI truecolor half-blocks "
                         "in the terminal (auto when stdout is a tty) "
                         "or PNG-only")
    ap.add_argument("--term-width", type=int, default=100,
                    help="ANSI display width in character cells")
    ap.add_argument("--backend", choices=["gpu", "xla"], default="gpu",
                    help="gpu: production path (needs a GPU); xla: the "
                         "plain oracle, runs on any device")
    args = ap.parse_args(argv)

    from ptdn.engine import Renderer
    from ptdn.scene import Scene
    from ptdn.utils.config import RenderConfig

    cfg = RenderConfig(backend=args.backend, trace_depth=args.depth,
                       denoise_enable=args.denoise,
                       temporal_enable=args.denoise,
                       spatial_enable=args.denoise)
    v = Viewer(Renderer(Scene(args.scene), cfg), out_path=args.out,
               display=args.display, term_width=args.term_width)
    if args.watch:
        v.watch(max_frames=args.frames)
    else:
        v.loop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
