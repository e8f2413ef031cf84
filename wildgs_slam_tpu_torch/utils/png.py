"""PNG decoding with the standard library and numpy (no cv2, no PIL).

``read_png(path)`` returns the samples as stored: (H, W) for grey, (H, W, 3)
RGB, (H, W, 4) RGBA; uint8 for 8-bit files, uint16 for 16-bit ones (PNG
stores them big-endian). Supported: colour types 0, 2 and 6 at bit depths
8 and 16, no interlace; anything else raises ``ValueError`` naming the file.

None, Sub and Up rows are undone a row at a time (Sub is a running sum
modulo 256). Avg and Paeth read both the reconstructed pixel to the left
and the one above, so the rows from the first to the last Avg or Paeth row
are undone in one pass over their anti-diagonals: every pixel of an
anti-diagonal (row + column constant) depends only on earlier ones. With
each row shifted by its index ("skewed"), an anti-diagonal is one
contiguous slice, and k rows take k + W - 1 vectorized steps.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 6: 4}   # colour type -> samples per pixel


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    return decode_png(data, name=path)


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{name}: no IHDR or no IDAT chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in CHANNELS or depth not in (8, 16) or interlace != 0:
        raise ValueError(f"{name}: colour type {ctype}, bit depth {depth}, "
                         f"interlace {interlace} is not supported (colour "
                         f"types 0/2/6 at 8 or 16 bits, not interlaced)")
    ch = CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{name}: {raw.size} bytes of image data for "
                         f"{w}x{h} at {bpp} bytes per pixel")
    raw = raw.reshape(h, w * bpp + 1)
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{name}: row filter {int(ftype.max())}")
    px = unfilter(raw[:, 1:].reshape(h, w, bpp), ftype)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    px = px.reshape(h, w, ch)
    return px[..., 0] if ch == 1 else px


def unfilter(filt: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """(H, W, bpp) filtered bytes and (H,) filter types -> the
    reconstructed bytes."""
    h = filt.shape[0]
    deep = np.flatnonzero(ftype >= 3)
    lo, hi = (deep[0], deep[-1] + 1) if deep.size else (h, h)
    out = np.empty_like(filt)
    zero = np.zeros_like(filt[0])
    for r in range(h):
        prev = out[r - 1] if r else zero
        if r == lo:
            out[lo:hi] = _unfilter_diagonals(filt[lo:hi], ftype[lo:hi], prev)
        elif lo < r < hi:
            continue
        elif ftype[r] == 0:
            out[r] = filt[r]
        elif ftype[r] == 1:
            out[r] = np.cumsum(filt[r], axis=0, dtype=np.uint8)  # mod 256
        else:
            out[r] = filt[r] + prev
    return out


def _unfilter_diagonals(filt, ftype, prev):
    """Rows of any filters below the reconstructed row `prev`. Skewed and
    transposed: pixel (r, p) lives at S[r + p + 1, r + 1], the row above the
    block in S[:, 0], so anti-diagonal d is S[d + 1]."""
    h, w, bpp = filt.shape
    S = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    F = np.zeros_like(S)
    S[:w, 0] = prev
    for r in range(h):
        F[r + 1:r + 1 + w, r + 1] = filt[r]
    t = ftype[:, None]
    for d in range(h + w - 1):
        r0, r1 = max(0, d - w + 1), min(h - 1, d) + 1
        a = S[d, r0 + 1:r1 + 1]          # left
        b = S[d, r0:r1]                  # above
        c = S[d - 1, r0:r1]              # above left
        tt = t[r0:r1]
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        pred = np.where(
            tt == 4, np.where((pa <= pb) & (pa <= pc), a,
                              np.where(pb <= pc, b, c)),
            np.where(tt == 3, (a + b) >> 1,
                     np.where(tt == 2, b, np.where(tt == 1, a, 0))))
        S[d + 1, r0 + 1:r1 + 1] = (F[d + 1, r0 + 1:r1 + 1] + pred) & 255
    out = np.empty((h, w, bpp), np.uint8)
    for r in range(h):
        out[r] = S[r + 1:r + 1 + w, r + 1]
    return out
