"""Writes this folder's fixtures with cv2 and their cv2 decodes.

    python tests/data/torch_jpeg/make.py    (from the repository root)

JPEGs (64x48, cv2's encoder): baseline 4:4:4, 4:2:2, 4:2:0, 4:1:1 and
grey, progressive 4:2:0, restart interval 4, and a 4:2:0 file with an EXIF
orientation of 6; their decodes are cv2.imread(path) ("color": EXIF
applied). PNGs written by hand: palette with tRNS, Adam7 RGB, 1-bit grey,
16-bit RGBA; their decodes are cv2.imread(path, IMREAD_UNCHANGED)
("unchanged"). Decodes are RGB(A) order, reshaped to (H, W * C) and
written by utils/png.py::write_png; manifest.json lists shape and dtype.
tests/test_torch_native.py checks that they still equal cv2's decodes,
chip_smoke.py that the native decoders give them on the card.
"""

import json
import os
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.abspath(os.path.join(HERE, "..", "..", "..")))

from tests.test_torch_native import (  # noqa: E402
    cv2_unchanged, encode_png_raw, jpeg_params, write_oriented)
from wildgs_slam_tpu_torch.utils.png import write_png  # noqa: E402


def scene(h=48, w=64):
    """Smooth colour ramps and two discs: sharp edges for the IDCT and
    the upsampling, small files."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([4 * xx, 200 - 3 * yy, 60 + 2 * (xx + yy)], -1)
    img[(xx - 20) ** 2 + (yy - 18) ** 2 < 120] = (250, 40, 30)
    img[(xx - 46) ** 2 + (yy - 30) ** 2 < 80] = (20, 90, 240)
    return np.clip(img, 0, 255).astype(np.uint8)


def main():
    for f in os.listdir(HERE):
        if f.endswith((".jpg", ".png", ".json")):
            os.remove(os.path.join(HERE, f))
    rgb = scene()
    entries = []

    def add(name, mode):
        path = os.path.join(HERE, name)
        ref = (cv2.imread(path)[..., ::-1] if mode == "color"
               else cv2_unchanged(path))
        ref = np.ascontiguousarray(ref)
        stem = os.path.splitext(name)[0]
        decode = f"{stem}.{name.rsplit('.', 1)[1]}.decode.png"
        write_png(os.path.join(HERE, decode),
                  ref.reshape(ref.shape[0], -1), (0, 1, 2, 3, 4))
        entries.append({"file": name, "decode": decode, "mode": mode,
                        "shape": list(ref.shape), "dtype": str(ref.dtype)})

    bgr = rgb[..., ::-1]
    for mode in ("baseline_444", "baseline_422", "baseline_420",
                 "baseline_411", "progressive_420"):
        cv2.imwrite(os.path.join(HERE, f"{mode}.jpg"), bgr,
                    jpeg_params(mode, 90))
        add(f"{mode}.jpg", "color")
    cv2.imwrite(os.path.join(HERE, "grey.jpg"), rgb[..., 1],
                jpeg_params("grey", 90))
    add("grey.jpg", "color")
    cv2.imwrite(os.path.join(HERE, "restart_4.jpg"), bgr,
                jpeg_params("baseline_420", 90)
                + [cv2.IMWRITE_JPEG_RST_INTERVAL, 4])
    add("restart_4.jpg", "color")
    write_oriented(os.path.join(HERE, "exif_6.jpg"), rgb, 6, True)
    add("exif_6.jpg", "color")

    rng = np.random.RandomState(0)
    palette = rng.randint(0, 256, (16, 3))
    index = (rgb[..., 0] // 16).astype(np.int64)
    pngs = {
        "palette_trns.png": encode_png_raw(
            index, 3, 4, palette=palette,
            trns=bytes(range(0, 160, 20))),
        "adam7_rgb.png": encode_png_raw(rgb, 2, 8, interlace=1),
        "grey_1bit.png": encode_png_raw(rgb[..., 1] > 100, 0, 1),
        "rgba_16bit.png": encode_png_raw(np.concatenate(
            [rgb.astype(np.int64) * 257, 40000 + 100 * (
                np.arange(48)[:, None, None] + np.zeros((48, 64, 1), int))],
            -1), 6, 16),
    }
    for name, data in pngs.items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        add(name, "unchanged")
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(entries, f, indent=1)
        f.write("\n")
    print(len(entries), "fixtures,",
          sum(os.path.getsize(os.path.join(HERE, f))
              for f in os.listdir(HERE)), "bytes")


if __name__ == "__main__":
    main()
