"""Decode scene textures into the NumPy files the renderer loads.

The renderer reads each texture's pixels from `<stem>.rgb.npz` beside the
image file (key "rgb", (H, W, 3) uint8), so no image library is imported
on the render path. This script makes those files with Pillow, decoding
exactly as the earlier in-renderer loader did (`Image.convert("RGB")`):

    python scenes/decode_textures.py [scenes/Textures/*.jpg ...]

With no arguments it decodes every .jpg/.png under scenes/Textures/.
"""

import glob
import os
import sys

import numpy as np
from PIL import Image


def decode(path: str) -> str:
    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"), dtype=np.uint8)
    out = os.path.splitext(path)[0] + ".rgb.npz"
    np.savez_compressed(out, rgb=rgb)
    return out


def main(paths):
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "Textures")
    paths = paths or sorted(glob.glob(os.path.join(here, "*.jpg"))
                            + glob.glob(os.path.join(here, "*.png")))
    for p in paths:
        print("wrote", decode(p))


if __name__ == "__main__":
    main(sys.argv[1:])
