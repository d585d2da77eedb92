"""Auxiliary subsystems: checkpoint/resume, stats, image IO, config."""

import numpy as np
import pytest

from ptdn.engine import Renderer
from ptdn.scene import Scene
from ptdn.utils.checkpoint import load_state, restore_renderer, save_state
from ptdn.utils.config import RenderConfig
from ptdn.utils.stats import StatsCollector

from ptdn.utils.assets import scenes_dir

scene_path_str = str(scenes_dir())

RES = (64, 64)


@pytest.fixture(scope="module")
def cornell():
    return Scene(scene_path_str + "/cornell.txt")


def test_checkpoint_resume_bitexact(cornell, tmp_path):
    """Resuming from a checkpoint must continue the exact accumulation."""
    cfg = RenderConfig(denoise_enable=False, trace_depth=3)
    r1 = Renderer(cornell, cfg, resolution=RES)
    r1.render(3)
    ckpt = str(tmp_path / "state")
    save_state(ckpt, r1.state, r1.frame, r1.camera)
    a, _ = r1.render(2)

    r2 = Renderer(cornell, cfg, resolution=RES)
    restore_renderer(r2, ckpt)
    assert r2.frame == 3
    b, _ = r2.render(2)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_roundtrip_types(cornell, tmp_path):
    cfg = RenderConfig(denoise_enable=True, temporal_enable=True,
                       spatial_enable=True, trace_depth=2)
    r = Renderer(cornell, cfg, resolution=RES)
    r.render(2)
    p = save_state(str(tmp_path / "st"), r.state, r.frame, r.camera)
    state, frame, cam = load_state(p)
    assert frame == 2 and cam is not None
    assert set(state.keys()) == set(r.state.keys())
    for k in state:
        assert state[k].shape == r.state[k].shape


def test_stats_collector(cornell):
    cfg = RenderConfig(denoise_enable=True, temporal_enable=True,
                       spatial_enable=True, trace_depth=2)
    sc = StatsCollector(Renderer(cornell, cfg, resolution=RES),
                        collect_denoiser_stats=True)
    sc.render_frame()
    sc.render_frame()
    st = sc.frames[-1]
    assert st.ms > 0 and st.rays_per_s > 0
    assert 0.0 <= st.history_rejection_rate <= 1.0
    assert st.mean_variance >= 0
    assert "rays_per_s" in st.json()


def _read_png(path):
    """Minimal decoder for the RGB8 PNGs image_io writes (one IDAT
    stream, every scanline with filter 0)."""
    import struct
    import zlib

    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = hdr[:4]
    assert (depth, ctype) == (8, 2)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_png_writer_roundtrip(tmp_path):
    """save_png (zlib + struct only) writes clamp(int(x*255)) RGB8."""
    from ptdn.utils.image_io import save_png, to_uint8

    img = np.random.default_rng(1).uniform(-0.2, 1.2, (5, 7, 3))
    p = save_png(str(tmp_path / "rt"), img)
    assert p.endswith(".png")
    np.testing.assert_array_equal(_read_png(p), to_uint8(img))


def test_png_writer_readable_by_pillow(tmp_path):
    """Any PNG reader takes the file: Pillow decodes the same pixels."""
    Image = pytest.importorskip("PIL.Image")
    from ptdn.utils.image_io import save_png, to_uint8

    img = np.random.default_rng(2).uniform(0, 1, (9, 4, 3))
    p = save_png(str(tmp_path / "pil"), img)
    with Image.open(p) as im:
        assert im.mode == "RGB" and im.size == (4, 9)
        np.testing.assert_array_equal(np.asarray(im), to_uint8(img))


@pytest.mark.parametrize("name", ["chair.jpg", "wallpaper.jpg"])
def test_decoded_texture_matches_jpeg(name):
    """The vendored decoded pixels the renderer loads equal Pillow's
    decode of the JPEG (scenes/decode_textures.py made them), so texel
    values and the goldens stay where they were."""
    Image = pytest.importorskip("PIL.Image")
    from ptdn.utils.image_io import load_texture_rgb

    path = str(scenes_dir() / "Textures" / name)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"), np.uint8)
    got = load_texture_rgb(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_missing_decoded_texture_is_an_error(tmp_path):
    from ptdn.utils.image_io import load_texture_rgb

    with pytest.raises(FileNotFoundError, match="decode_textures.py"):
        load_texture_rgb(str(tmp_path / "nope.jpg"))


def test_save_image_like_reference(tmp_path):
    from ptdn.utils import image_io

    img = np.zeros((4, 6, 3), np.float32)
    img[:, 0] = [1, 0, 0]  # leftmost column red
    path = image_io.save_image_like_reference(
        img, "testimg", 7, out_dir=str(tmp_path))
    assert "testimg." in path and path.endswith("samp.png")
    back = _read_png(path)
    # horizontal flip (main.cpp:140): red ends up rightmost
    assert (back[:, -1] == [255, 0, 0]).all()


def test_hdr_writer_roundtrip(tmp_path):
    from ptdn.utils.image_io import save_hdr

    img = np.random.default_rng(0).uniform(0, 4, (8, 8, 3)).astype(np.float32)
    p = save_hdr(str(tmp_path / "x"), img)
    data = open(p, "rb").read()
    assert data.startswith(b"#?RADIANCE")
    assert b"-Y 8 +X 8" in data


def test_config_static_vs_traced():
    a = RenderConfig()
    b = a.replace(sigma_l=0.9)          # traced param: same static key
    assert a.static_key() == b.static_key()
    c = a.replace(trace_depth=6)        # structural: different key
    assert a.static_key() != c.static_key()
    tp = a.traced_params()
    assert set(tp) == {"shadow_intensity", "light_radius", "color_alpha",
                       "moment_alpha", "sigma_l", "sigma_x", "sigma_n"}


def test_cli_config_mapping():
    """Every reference ui_* control is reachable from the CLI."""
    from ptdn.app.cli import build_arg_parser, config_from_args

    args = build_arg_parser().parse_args([
        "scene.txt", "--depth", "7", "--denoise", "--temporal", "--spatial",
        "--sigma-l", "0.5", "--atrous-levels", "4", "--history-level", "2",
        "--sepcolor", "--addcolor", "--no-reducevar", "--sintensity", "3.5",
        "--lightradius", "2.0", "--view", "variance", "--automate",
        "--cam-speed", "0.1", "0", "0", "0.02", "0.03",
    ])
    cfg = config_from_args(args)
    assert cfg.trace_depth == 7 and cfg.denoise_enable
    assert cfg.temporal_enable and cfg.spatial_enable
    assert cfg.sigma_l == pytest.approx(0.5)
    assert cfg.atrous_nlevel == 4 and cfg.history_level == 2
    assert cfg.sep_color and cfg.add_color and not cfg.reduce_var
    assert cfg.shadow_intensity == pytest.approx(3.5)
    assert cfg.light_radius == pytest.approx(2.0)
    assert cfg.right_view_option == 2
    assert cfg.automate_camera and cfg.camera_speed_theta == pytest.approx(0.02)


def test_show_texture_flag(cornell):
    """SHOW_TEXTURE=0 equivalent: textured materials fall back to RGB."""
    import jax.numpy as jnp

    from ptdn.engine.wavefront import albedo_from, read_mat, sample_texture

    ds = cornell.device()

    mat = jnp.full(4, 8, jnp.int32)  # textured wall material
    uv = jnp.full((4, 2), 0.5, jnp.float32)
    mv = read_mat(ds, mat)
    with_tex = np.asarray(albedo_from(ds, mv, uv, True))
    without = np.asarray(albedo_from(ds, mv, uv, False))
    np.testing.assert_allclose(
        without, np.broadcast_to(np.asarray(ds.mat_color[8]), (4, 3)),
        atol=1e-6)
    expect = np.asarray(sample_texture(ds, jnp.zeros(4, jnp.int32), uv))
    np.testing.assert_allclose(with_tex, expect, atol=1e-6)
