"""Visualisation files: the keyframe figure and GIFs; torch port of
``wildgs_slam_tpu/utils/plot_utils.py``, with neither PIL nor matplotlib.

- ``create_gif_from_directory`` writes its own GIF89a: one local colour
  table per frame, LZW-coded, a looping NETSCAPE2.0 block and the frame
  duration. A frame of at most 256 colours is written exactly; a frame of
  more is quantized by median cut (the RGB box of its colours split at the
  count-weighted median of its widest channel until there are 256 boxes;
  each pixel takes its box's count-weighted mean colour), so each channel
  of a pixel moves by at most its box's extent along that channel.
  Frames are read by the native decoder (``native.read_color``).
- ``save_keyframe_figure`` writes the JAX figure's 2 x n grid of panels (GT,
  the render, the uncertainty in jet; the prior and the rendered depth in
  plasma) as a PNG, each panel the bytes imshow would draw
  (``gui/file_gui.py::colour_bytes`` / ``colormap_bytes``). There is no
  font renderer: the panel titles, the render's with its PSNR, are the
  PNG's ``tEXt`` entries ``title r,c``.
"""

from __future__ import annotations

import glob
import os
import struct
import zlib

import numpy as np

from ..gui.file_gui import colormap_bytes, colour_bytes
from .png import encode_png

GAP = 8              # white pixels between the figure's panels
GIF_COLOURS = 256


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def psnr(a, b):
    mse = float(np.mean((_np(a) - _np(b)) ** 2))
    return -10.0 * np.log10(mse + 1e-12)


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------

def median_cut(rgb: np.ndarray, n_colours: int = GIF_COLOURS):
    """(H, W, 3) uint8 -> (palette (P, 3) uint8, indices (H, W) uint8), P <=
    n_colours. Exact (the distinct colours) when there are at most
    n_colours of them; else median cut."""
    flat = rgb.reshape(-1, 3).astype(np.int64)
    keys = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    uniq, inv, cnt = np.unique(keys, return_inverse=True, return_counts=True)
    cols = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], 1)
    if len(uniq) <= n_colours:
        return cols.astype(np.uint8), inv.reshape(rgb.shape[:2]).astype(
            np.uint8)
    boxes = [np.arange(len(uniq))]
    while len(boxes) < n_colours:
        spans = [int(np.ptp(cols[b], axis=0).max()) for b in boxes]
        i = int(np.argmax(spans))
        if spans[i] == 0:
            break
        b = boxes.pop(i)
        ch = int(np.argmax(np.ptp(cols[b], axis=0)))
        order = b[np.argsort(cols[b, ch], kind="stable")]
        c = np.cumsum(cnt[order])
        k = int(np.clip(np.searchsorted(c, c[-1] / 2) + 1, 1, len(order) - 1))
        boxes += [order[:k], order[k:]]
    palette = np.zeros((len(boxes), 3), np.uint8)
    box_of = np.zeros(len(uniq), np.int64)
    for j, b in enumerate(boxes):
        w = cnt[b][:, None]
        palette[j] = np.round((cols[b] * w).sum(0) / w.sum())
        box_of[b] = j
    return palette, box_of[inv].reshape(rgb.shape[:2]).astype(np.uint8)


def lzw_encode(indices: bytes, min_code_size: int) -> bytes:
    """GIF LZW: codes LSB first, widths from min_code_size + 1 to 12, a clear
    code first and whenever the table is full, the end code last."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = nbits = 0

    def emit(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    table, nxt, width = {}, eoi + 1, min_code_size + 1
    emit(clear, width)
    it = iter(indices)
    w = next(it, None)
    if w is not None:
        for k in it:
            wk = table.get((w, k))
            if wk is not None:
                w = wk
                continue
            emit(w, width)
            if nxt < 4096:
                table[(w, k)] = nxt
                nxt += 1
                if nxt > (1 << width) and width < 12:
                    width += 1
            else:
                emit(clear, width)
                table, nxt, width = {}, eoi + 1, min_code_size + 1
            w = k
        emit(w, width)
    emit(eoi, width)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def encode_gif(frames, duration=100, loop=0) -> bytes:
    """(H, W, 3) uint8 frames of one size -> GIF89a bytes; `duration` ms per
    frame (stored in hundredths), `loop` 0 for ever."""
    h, w = frames[0].shape[:2]
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", w, h, 0, 0, 0))
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\0"
    delay = int(round(duration / 10))
    for f in frames:
        if f.shape[:2] != (h, w):
            raise ValueError(f"frame of {f.shape[:2]}, not {(h, w)}")
        palette, idx = median_cut(f)
        bits = max(2, int(np.ceil(np.log2(max(len(palette), 2)))))
        table = np.zeros((1 << bits, 3), np.uint8)
        table[:len(palette)] = palette
        out += b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\0\0"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x80 | (bits - 1))
        out += table.tobytes() + bytes([bits])
        data = lzw_encode(idx.tobytes(), bits)
        for s in range(0, len(data), 255):
            block = data[s:s + 255]
            out += bytes([len(block)]) + block
        out += b"\0"
    return bytes(out + b"\x3b")


def create_gif_from_directory(directory, output_path, duration=100,
                              online_plotting=False):
    """Assemble <directory>/*.png into a looping GIF; None when there is no
    PNG."""
    from ..native import read_color

    files = sorted(glob.glob(os.path.join(directory, "*.png")))
    if not files:
        return None
    with open(output_path, "wb") as f:
        f.write(encode_gif([read_color(p) for p in files], duration))
    return output_path


# ---------------------------------------------------------------------------
# the keyframe figure
# ---------------------------------------------------------------------------

def keyframe_panels(gt_color, rendered_color, gt_depth, rendered_depth,
                    uncertainty=None, psnr=None):
    """{(row, col): (title, (h, w, 3) uint8)}: the figure's panels as imshow
    draws them."""
    title = "render" if psnr is None else f"render (PSNR {psnr:.1f})"
    panels = {
        (0, 0): ("GT", colour_bytes(_np(gt_color))),
        (0, 1): (title, colour_bytes(_np(rendered_color))),
        (1, 0): ("prior depth", colormap_bytes(_np(gt_depth), "plasma")),
        (1, 1): ("rendered depth",
                 colormap_bytes(_np(rendered_depth), "plasma")),
    }
    if uncertainty is not None:
        panels[(0, 2)] = ("uncertainty", colormap_bytes(_np(uncertainty),
                                                        "jet"))
    return panels


def save_keyframe_figure(path, gt_color, rendered_color, gt_depth,
                         rendered_depth, uncertainty=None, psnr=None):
    """The 2 x 2 (2 x 3 with uncertainty) grid as a PNG: each panel top left
    in a cell of the largest panel's size, GAP white pixels apart."""
    panels = keyframe_panels(gt_color, rendered_color, gt_depth,
                             rendered_depth, uncertainty, psnr)
    n_cols = 3 if uncertainty is not None else 2
    ch = max(p.shape[0] for _, p in panels.values())
    cw = max(p.shape[1] for _, p in panels.values())
    img = np.full((2 * ch + GAP, n_cols * cw + (n_cols - 1) * GAP, 3), 255,
                  np.uint8)
    for (r, c), (_, p) in panels.items():
        y, x = r * (ch + GAP), c * (cw + GAP)
        img[y:y + p.shape[0], x:x + p.shape[1]] = p
    text = b"".join(_chunk(b"tEXt", f"title {r},{c}".encode("latin-1")
                           + b"\0" + t.encode("latin-1"))
                    for (r, c), (t, _) in sorted(panels.items()))
    png = encode_png(img)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png[:33] + text + png[33:])   # after the signature and IHDR


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))
