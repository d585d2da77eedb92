"""Image IO: PNG + Radiance HDR writers, texture loading, and the
reference-compatible save naming. Standard library and NumPy only.

Mirrors the reference image writer (src/image.cpp:22-45) and the app save
path (src/main.cpp:131-152): PNG is clamp(x*255), the saved file is
horizontally flipped, and the filename is "<FILE>.<timestamp>.<N>samp.png".
"""

from __future__ import annotations

import os
import struct
import time
import zlib

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """clamp(int(x*255), 0, 255) per channel (image.cpp:26-31)."""
    return np.clip((np.asarray(img, dtype=np.float64) * 255.0).astype(np.int64), 0, 255).astype(np.uint8)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def save_png(path: str, img: np.ndarray) -> str:
    """Save an (H, W, 3) float image in [0,1] as an RGB8 PNG."""
    if not path.endswith(".png"):
        path = path + ".png"
    px = to_uint8(img)
    h, w, _ = px.shape
    # each scanline: filter type 0 (None) then the raw RGB bytes
    raw = np.concatenate([np.zeros((h, 1), np.uint8), px.reshape(h, w * 3)],
                         axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))
    return path


def save_hdr(path: str, img: np.ndarray) -> str:
    """Save an (H, W, 3) float image as a Radiance RGBE .hdr file
    (stbi_write_hdr equivalent, image.cpp:41-45)."""
    if not path.endswith(".hdr"):
        path = path + ".hdr"
    img = np.asarray(img, dtype=np.float32)
    h, w, _ = img.shape
    maxc = img.max(axis=-1)
    exp = np.zeros((h, w), dtype=np.int32)
    mant = np.zeros((h, w), dtype=np.float32)
    nz = maxc >= 1e-32
    mant[nz], exp[nz] = np.frexp(maxc[nz])
    scale = np.where(nz, mant * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
    return path


def decoded_texture_path(path: str) -> str:
    """Where the decoded pixels of texture image `path` live."""
    return os.path.splitext(path)[0] + ".rgb.npz"


def load_texture_rgb(path: str) -> np.ndarray:
    """A texture's pixels as (H, W, 3) uint8 (the stb_image role,
    sceneStructs.h:198-206), read from the decoded file beside the image
    (`scenes/decode_textures.py` makes it)."""
    dec = decoded_texture_path(path)
    if not os.path.exists(dec):
        raise FileNotFoundError(
            f"no decoded pixels for texture {path}: expected {dec}; make it "
            "with `python scenes/decode_textures.py " + path + "`")
    with np.load(dec, allow_pickle=False) as z:
        rgb = z["rgb"]
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"{dec}: expected (H, W, 3) uint8, got "
                         f"{rgb.shape} {rgb.dtype}")
    return rgb


def current_time_string() -> str:
    """Timestamp used in saved filenames (preview.cpp:19-27 semantics)."""
    return time.strftime("%Y-%m-%d_%H-%M-%Sz", time.gmtime())


def save_image_like_reference(img: np.ndarray, image_name: str, frame: int,
                              out_dir: str = ".", flip: bool = True) -> str:
    """saveImage() semantics (main.cpp:131-152): horizontal flip +
    '<FILE>.<timestamp>.<frame>samp.png' naming."""
    import os

    out = img[:, ::-1, :] if flip else img
    fname = f"{image_name}.{current_time_string()}.{float(frame)}samp"
    return save_png(os.path.join(out_dir, fname), out)
