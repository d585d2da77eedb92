"""Scripted tests for the interactive viewer's command dispatcher
(`app/viewer.py:Viewer.handle`) — the headless stand-in for the
reference's GLFW key/mouse callbacks (main.cpp:211-304) and ImGui
controls (preview.cpp:211-375). Drives every command branch headlessly;
a typo in any branch fails here instead of shipping."""

import os

import numpy as np
import pytest

from ptdn.app.viewer import Viewer
from ptdn.engine import Renderer
from ptdn.scene import Scene
from ptdn.utils.config import RenderConfig

from ptdn.utils.assets import scenes_dir

scene_path_str = str(scenes_dir())


@pytest.fixture(scope="module")
def viewer_factory(tmp_path_factory):
    scene = Scene(scene_path_str + "/cornell.txt")

    def make():
        cfg = RenderConfig(backend="xla", trace_depth=2,
                           denoise_enable=False, shadow_ray=False)
        r = Renderer(scene, cfg, resolution=(32, 32))
        out = tmp_path_factory.mktemp("viewer") / "view.png"
        v = Viewer(r, out_path=str(out), frames_per_command=1)
        return v, r, out

    return make


def test_camera_commands(viewer_factory):
    v, r, _ = viewer_factory()
    v.running = False  # mutation-only: no renders, keeps the test fast
    phi0, th0, z0 = r.camera.phi, r.camera.theta, r.camera.zoom
    la0 = np.array(r.camera.look_at, np.float32)

    assert v.handle(".")
    assert r.camera.phi == pytest.approx(phi0 + 0.1)
    assert v.handle(",")
    assert r.camera.phi == pytest.approx(phi0)
    assert v.handle("]")
    assert r.camera.theta == pytest.approx(th0 + 0.1)
    assert v.handle("[")
    assert r.camera.theta == pytest.approx(th0)
    assert v.handle("+")
    assert r.camera.zoom == pytest.approx(z0 - 0.5)
    assert v.handle("-")
    assert r.camera.zoom == pytest.approx(z0)
    for key in "wasd":
        assert v.handle(key)
    # w/s and a/d cancel pairwise
    np.testing.assert_allclose(np.asarray(r.camera.look_at), la0,
                               atol=1e-5)
    # 'r' = GLFW_KEY_R: resets ONLY lookAt to ogLookAt (main.cpp:222-226),
    # steered phi is kept
    v.handle(".")
    v.handle("w")
    assert v.handle("r")
    assert r.camera.phi == pytest.approx(phi0 + 0.1)
    np.testing.assert_allclose(np.asarray(r.camera.look_at), la0, atol=1e-6)
    assert r.cam_changed
    # 'reset' = full resetCamera() (main.cpp:77-101): phi re-derived
    assert v.handle("reset")
    assert r.camera.phi == pytest.approx(phi0)


def test_stdin_poll_factory_line_mode(monkeypatch, tmp_path):
    """Non-tty stdin (pipe/file): poll stays line-based and returns one
    command per ready line — the mode every scripted/CI session uses."""
    import sys as _sys

    from ptdn.app.viewer import _stdin_poll_factory

    p = tmp_path / "cmds.txt"
    p.write_text("sigma_l 0.7\n.\n")
    with open(p) as fh:
        monkeypatch.setattr(_sys, "stdin", fh)
        poll, restore = _stdin_poll_factory()
        assert restore is None  # nothing to undo in line mode
        assert poll() == "sigma_l 0.7\n"
        assert poll() == ".\n"


def test_stdin_poll_factory_cbreak_colon_commands(monkeypatch):
    """tty cbreak mode: bare hotkeys dispatch on keypress, and ':'
    opens a typed command so words whose first char is a hotkey
    ('reset', 'sigma_l', 'save') stay reachable (round-4 advisor:
    'r'/'s'/'d' shadowed every such command)."""
    import os as _os
    import pty as _pty
    import sys as _sys

    from ptdn.app.viewer import _stdin_poll_factory

    master, slave = _pty.openpty()
    try:
        with _os.fdopen(slave, "r+b", buffering=0) as raw:
            import io as _io

            fh = _io.TextIOWrapper(raw, encoding="ascii",
                                   write_through=True)
            monkeypatch.setattr(_sys, "stdin", fh)
            poll, restore = _stdin_poll_factory()
            assert restore is not None
            try:
                def feed(s):
                    # one char per write+poll: keystrokes arrive one at
                    # a time (bulk writes sit in the TextIOWrapper's
                    # readahead where select can't see them)
                    out = []
                    for ch in s:
                        _os.write(master, ch.encode())
                        got = poll()
                        if got is not None:
                            out.append(got)
                    return out

                assert feed("r") == ["r"]          # hotkey: immediate
                assert feed(".") == ["."]
                # ':'-prefixed words accumulate until Enter and come
                # back stripped of the prefix
                assert feed(":reset\n") == ["reset"]
                assert feed(":sigma_l 0.7\n") == ["sigma_l 0.7"]
                # non-hotkey first chars still work without ':'
                assert feed("orbit 1\n") == ["orbit 1"]
            finally:
                restore()
    finally:
        _os.close(master)


def test_ansi_halfblocks_renderer():
    """utils/termview.py: truecolor half-block frames — the headless
    stand-in for the reference's per-frame window blit
    (preview.cpp:377-413)."""
    from ptdn.utils.termview import _downsample, ansi_halfblocks

    # box-average downsample is exact on aligned blocks
    img = np.zeros((4, 4, 3), np.float32)
    img[:2, :2] = 1.0
    small = _downsample(img, 2, 2)
    np.testing.assert_allclose(small[0, 0], [1, 1, 1], atol=1e-6)
    np.testing.assert_allclose(small[0, 1], [0, 0, 0], atol=1e-6)

    # a solid red frame: every cell fg AND bg = (255,0,0), one '▀' per
    # (cell column x row pair), SGR only emitted on color changes
    red = np.zeros((8, 8, 3), np.float32)
    red[..., 0] = 1.0
    s = ansi_halfblocks(red, max_width=8)
    assert "\x1b[38;2;255;0;0m" in s and "\x1b[48;2;255;0;0m" in s
    assert s.count("▀") == 8 * 4
    assert not s.startswith("\x1b[H")
    assert ansi_halfblocks(red, max_width=8, home=True).startswith("\x1b[H")
    # run-length SGR: a solid frame needs exactly one fg+bg pair per line
    assert s.count("\x1b[38;2;") == 4

    # top/bottom split maps to fg vs bg of the same cell
    split = np.zeros((2, 2, 3), np.float32)
    split[0] = [1, 0, 0]
    split[1] = [0, 0, 1]
    s2 = ansi_halfblocks(split, max_width=2)
    assert "\x1b[38;2;255;0;0m\x1b[48;2;0;0;255m" in s2


def test_viewer_ansi_display_sink(viewer_factory, capsys):
    """display='ansi' streams frames to stdout as half-block art while
    still writing the PNG."""
    v, r, out = viewer_factory()
    v.display = "ansi"
    v._show(*v._render(1))
    cap = capsys.readouterr().out
    assert "▀" in cap and "\x1b[38;2;" in cap
    assert out.exists()


def test_toggles_and_debug_view(viewer_factory):
    v, r, _ = viewer_factory()
    v.running = False
    assert not r.cfg.denoise_enable
    v.handle("D")
    assert r.cfg.denoise_enable
    t0, f0 = r.cfg.temporal_enable, r.cfg.spatial_enable
    v.handle("T")
    assert r.cfg.temporal_enable is (not t0)
    v.handle("F")
    assert r.cfg.spatial_enable is (not f0)
    # v cycles right_view_option 0 -> 1 -> 2 -> 0 (denoise.cu:373-378)
    opts = []
    for _ in range(3):
        v.handle("v")
        opts.append(r.cfg.right_view_option)
    assert opts == [1, 2, 0]


def test_config_field_set(viewer_factory):
    v, r, _ = viewer_factory()
    v.running = False
    v.handle("trace_depth 3")
    assert r.cfg.trace_depth == 3
    v.handle("sigma_l 0.9")
    assert r.cfg.sigma_l == pytest.approx(0.9)
    # float-typed field set from an int token coerces to the field type
    v.handle("color_alpha 1")
    assert r.cfg.color_alpha == pytest.approx(1.0)
    assert isinstance(r.cfg.color_alpha, float)


def test_unknown_command_is_ignored(viewer_factory, capsys):
    v, r, _ = viewer_factory()
    v.running = False
    cfg_before = r.cfg
    assert v.handle("bogus 12")
    assert v.handle("zzz")
    assert r.cfg is cfg_before
    assert "unknown command" in capsys.readouterr().err
    # blank input is a no-op
    assert v.handle("   ")


def test_run_pause_step_render(viewer_factory):
    v, r, out = viewer_factory()
    v.handle("pause")
    assert not v.running
    assert not out.exists()  # paused commands don't render
    v.handle("step")         # Step button renders exactly one frame
    assert out.exists()
    assert r.frame == 1
    v.handle("run")
    assert v.running
    assert r.frame == 2      # 'run' itself rendered frames_per_command=1
    side = np.asarray(__import__("PIL.Image", fromlist=["Image"])
                      .open(str(out)))
    # side-by-side PBO layout: width is 2x the render width
    assert side.shape[1] == 64 and side.shape[0] == 32


def test_watch_loop_no_rejit(viewer_factory, tmp_path, monkeypatch):
    """watch mode: continuous rendering with live input, and traced
    config changes (sigmas/toggles/camera) must NOT re-jit the frame
    step — the property the static/traced config split exists for
    (reference: ImGui sliders mutate ui_* globals mid-loop with no
    CUDA rebuild, preview.cpp:211-375)."""
    monkeypatch.chdir(tmp_path)  # 'q' saves an image into cwd
    v, r, out = viewer_factory()
    step_before = r._step
    script = iter([None, "sigma_l 0.7", None, ".", None,
                   "moment_alpha 0.3", None])

    def poll():
        return next(script, None)

    frames = v.watch(max_frames=7, input_poll=poll, report=False)
    assert frames == 7
    assert r.cfg.sigma_l == pytest.approx(0.7)
    assert r.cfg.moment_alpha == pytest.approx(0.3)
    assert r._step is step_before  # traced-only changes: same jit step
    assert out.exists()

    # a STRUCTURAL change (trace_depth) does re-jit
    v.watch(max_frames=1, input_poll=iter(["trace_depth 3"]).__next__,
            report=False)
    assert r._step is not step_before

    # quit command ends the loop early
    n = v.watch(max_frames=100, input_poll=iter(["q"]).__next__,
                report=False)
    assert n == 0


def test_save_and_quit(viewer_factory, tmp_path, monkeypatch):
    v, r, _ = viewer_factory()
    v.running = False
    monkeypatch.chdir(tmp_path)
    v.handle("save")
    files = os.listdir(tmp_path)
    assert len(files) == 1
    # saveImage naming: '<FILE>.<timestamp>.<frame>samp.png' (main.cpp:144)
    assert files[0].startswith(r.scene.image_name)
    assert files[0].endswith("samp.png")
    assert not v.handle("q")  # Esc: save + quit
    assert len(os.listdir(tmp_path)) == 2
