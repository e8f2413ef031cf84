"""Image resampling with the semantics of the calls the JAX package makes
to cv2 and jax.image (the port has neither):

- ``resize(x, (h, w), mode)``: separable resizes of (H, W) or (H, W, C)
  float tensors on any device. Modes: ``"linear"`` (cv2 INTER_LINEAR: half-
  pixel centres, edges clamped), ``"area"`` (cv2 INTER_AREA: the box average
  when neither side grows, else cv2's own two-tap variant), ``"cubic"``
  (cv2 INTER_CUBIC: Keys a = -0.75, clamped borders) and ``"jax_cubic"``
  (``jax.image.resize(method="bicubic")``: Keys a = -0.5, the kernel widened
  by the scale when shrinking, weights renormalised at the edges);
- ``resize_nearest(x, (h, w))``: cv2 INTER_NEAREST, which samples
  ``floor(i * src / dst)``;
- ``undistort(img, K, dist)``: cv2.undistort of a uint8 image: its
  ``initUndistortRectifyMap`` (k1, k2, p1, p2[, k3[, k4, k5, k6]]; the new
  camera is K) with the map rounded to 1/32 pixel as cv2's fixed-point map,
  then a bilinear remap with zeros outside.

cv2 computes its uint8 resizes and remaps in fixed point; here they run in
float32 and round, at most one level from cv2. Each axis is a (dst, taps)
table of source indices and weights built with numpy in float32 as cv2 and
XLA build theirs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MODES = ("linear", "area", "cubic", "jax_cubic")


def _cubic_cv(x: np.float32) -> np.ndarray:
    A = np.float32(-0.75)
    one = np.float32(1.0)
    c0 = ((A * (x + one) - 5 * A) * (x + one) + 8 * A) * (x + one) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + one
    c2 = ((A + 2) * (one - x) - (A + 3)) * (one - x) * (one - x) + one
    return np.array([c0, c1, c2, one - c0 - c1 - c2], np.float32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys kernel with a = -0.5, as jax.image's."""
    x = np.abs(x)
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def axis_weights(n_in: int, n_out: int, mode: str,
                 area_shrink: bool = True) -> np.ndarray:
    """(n_out, n_in) float32 weights of one axis. `area_shrink`: whether
    cv2 takes its box-average path, which it does only when no axis of the
    image grows."""
    if mode not in MODES:
        raise ValueError(f"resize mode {mode!r}: one of {MODES}")
    W = np.zeros((n_out, n_in), np.float32)
    if mode == "jax_cubic":
        if n_in == n_out:
            return np.eye(n_in, dtype=np.float32)
        inv_scale = np.float32(1.0 / (n_out / n_in))
        kernel_scale = max(inv_scale, np.float32(1.0))
        sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                    * inv_scale - np.float32(0.5))
        x = (np.abs(sample_f[np.newaxis, :]
                    - np.arange(n_in, dtype=np.float32)[:, np.newaxis])
             / kernel_scale)
        w = _keys_cubic(x)
        total = w.sum(0, keepdims=True, dtype=np.float32)
        w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                     w / np.where(total != 0, total, 1), 0)
        inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
        return np.where(inside[np.newaxis, :], w, 0).T.astype(np.float32)
    inv_scale = n_out / n_in
    scale = 1.0 / inv_scale
    if mode == "area" and area_shrink:
        for dx in range(n_out):
            fsx1 = dx * scale
            fsx2 = fsx1 + scale
            cell = min(scale, n_in - fsx1)
            sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
            sx2 = min(sx2, n_in - 1)
            sx1 = min(sx1, sx2)
            if sx1 - fsx1 > 1e-3:
                W[dx, sx1 - 1] += np.float32((sx1 - fsx1) / cell)
            for sx in range(sx1, sx2):
                W[dx, sx] += np.float32(1.0 / cell)
            if fsx2 - sx2 > 1e-3:
                W[dx, sx2] += np.float32(min(min(fsx2 - sx2, 1.0), cell)
                                         / cell)
        return W
    for dx in range(n_out):
        if mode == "area":
            sx = math.floor(dx * scale)
            fx = np.float32((dx + 1) - (sx + 1) * inv_scale)
            fx = np.float32(0.0) if fx <= 0 else fx - np.float32(
                math.floor(fx))
        else:
            fx = np.float32((dx + 0.5) * scale - 0.5)
            sx = math.floor(fx)
            fx = fx - np.float32(sx)
        if mode == "cubic":
            for k, c in enumerate(_cubic_cv(fx)):
                W[dx, min(max(sx - 1 + k, 0), n_in - 1)] += c
            continue
        if sx < 0:
            fx, sx = np.float32(0.0), 0
        if sx >= n_in - 1:
            fx, sx = np.float32(0.0), n_in - 1
        W[dx, sx] += np.float32(1.0) - fx
        W[dx, min(sx + 1, n_in - 1)] += fx
    return W


def _taps(W: np.ndarray, device):
    """Dense (n_out, n_in) weights -> (n_out, k) source indices and
    weights, k the most nonzeros of a row."""
    k = max(int((W != 0).sum(1).max(initial=1)), 1)
    idx = np.argsort(W == 0, axis=1, kind="stable")[:, :k]
    w = np.take_along_axis(W, idx, 1)
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(w, device=device))


def _apply(x: torch.Tensor, W: np.ndarray, dim: int) -> torch.Tensor:
    idx, w = _taps(W, x.device)
    g = x.index_select(dim, idx.reshape(-1))
    shape = list(x.shape)
    shape[dim:dim + 1] = list(idx.shape)
    g = g.reshape(shape)
    wshape = [1] * g.dim()
    wshape[dim], wshape[dim + 1] = idx.shape
    return (g * w.reshape(wshape)).sum(dim + 1)


def resize(x: torch.Tensor, size, mode: str) -> torch.Tensor:
    """(H, W) or (H, W, C) -> (h, w) or (h, w, C), float32."""
    H, W = x.shape[:2]
    h, w = int(size[0]), int(size[1])
    shrink = h <= H and w <= W
    x = x.to(torch.float32)
    if h != H or mode == "area":
        x = _apply(x, axis_weights(H, h, mode, shrink), 0)
    if w != W or mode == "area":
        x = _apply(x, axis_weights(W, w, mode, shrink), 1)
    return x


def resize_nearest(x: np.ndarray, size) -> np.ndarray:
    h, w = int(size[0]), int(size[1])
    H, W = x.shape[:2]
    iy = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H))).astype(int),
                    H - 1)
    ix = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W))).astype(int),
                    W - 1)
    return x[iy][:, ix]


def resize_u8(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, (w, h)) of a uint8 image (INTER_LINEAR)."""
    out = resize(torch.from_numpy(np.ascontiguousarray(img)), size, "linear")
    return torch.round(out).clamp_(0, 255).to(torch.uint8).numpy()


def undistort_maps(K, dist, h: int, w: int):
    """cv2's undistortion map for a (h, w) image, new camera = K: the
    source (x, y) of every pixel, rounded to 1/32 pixel."""
    K = np.asarray(K, np.float64)
    d = np.zeros(8)
    d[:len(dist)] = np.asarray(dist, np.float64)
    k1, k2, p1, p2, k3, k4, k5, k6 = d
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    iK = np.linalg.inv(K)
    jj, ii = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    _x = jj * iK[0, 0] + ii * iK[0, 1] + iK[0, 2]
    _y = jj * iK[1, 0] + ii * iK[1, 1] + iK[1, 2]
    _w = jj * iK[2, 0] + ii * iK[2, 1] + iK[2, 2]
    x, y = _x / _w, _y / _w
    x2, y2 = x * x, y * y
    r2, _2xy = x2 + y2, 2 * x * y
    kr = ((1 + ((k3 * r2 + k2) * r2 + k1) * r2)
          / (1 + ((k6 * r2 + k5) * r2 + k4) * r2))
    u = fx * (x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)) + u0
    v = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy) + v0
    return np.rint(u * 32) / 32, np.rint(v * 32) / 32


def remap_u8(img: np.ndarray, map_x: np.ndarray,
             map_y: np.ndarray) -> np.ndarray:
    """Bilinear remap of a uint8 (H, W[, C]) image, zeros outside."""
    H, W = img.shape[:2]
    pad = np.zeros((H + 2, W + 2) + img.shape[2:], np.float32)
    pad[1:-1, 1:-1] = img
    x0 = np.floor(map_x)
    y0 = np.floor(map_y)
    ax = (map_x - x0).astype(np.float32)
    ay = (map_y - y0).astype(np.float32)
    if img.ndim == 3:
        ax, ay = ax[..., None], ay[..., None]

    def tap(y, x):
        # outside the image (one pixel of zeros around it, then clamped)
        return pad[np.clip(y + 1, 0, H + 1).astype(int),
                   np.clip(x + 1, 0, W + 1).astype(int)]
    out = ((1 - ay) * ((1 - ax) * tap(y0, x0) + ax * tap(y0, x0 + 1))
           + ay * ((1 - ax) * tap(y0 + 1, x0) + ax * tap(y0 + 1, x0 + 1)))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def undistort(img: np.ndarray, K, dist) -> np.ndarray:
    mx, my = undistort_maps(K, dist, *img.shape[:2])
    return remap_u8(img, mx, my)
