"""Correlation volumes and their windowed lookup; torch port of
``wildgs_slam_tpu/ops/correlation.py`` (the frontend's stored-volume form).

``corr_pyramid`` builds the 4-level all-pairs pyramid of two feature maps;
``corr_lookup`` samples a (2r+1)^2 bilinear window around each pixel's
target coordinates on every level with a direct gather (the semantics of
the JAX ``_bilinear_window_gather``, which its tests pin equal to the
default one-hot form), out-of-bounds samples reading zero. Channel order is
level-major, then the x offset, then the y offset.

The frontend stores each edge's four levels side by side in one row of a
(E, H*W, sum of level sizes) tensor; ``pyramid_levels`` and
``corr_lookup_packed`` read that layout.
"""

from __future__ import annotations

import torch

NUM_LEVELS = 4
RADIUS = 3


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 average pooling on the last two dims (odd trailing
    rows and columns dropped)."""
    *lead, H, W = x.shape
    H2, W2 = H // 2, W // 2
    x = x[..., :H2 * 2, :W2 * 2].reshape(*lead, H2, 2, W2, 2)
    return x.mean(dim=(-3, -1))


def compute_corr(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """All-pairs correlation: (E, H, W, C) twice -> (E, H*W, H, W), scaled
    by 1/16."""
    E, H, W, C = fmap1.shape
    a = fmap1.reshape(E, H * W, C) / 4.0
    b = fmap2.reshape(E, H * W, C) / 4.0
    return torch.bmm(a, b.transpose(1, 2)).reshape(E, H * W, H, W)


def corr_pyramid(fmap1, fmap2, num_levels: int = NUM_LEVELS) -> list:
    """Level i is (E, H*W, H/2^i, W/2^i)."""
    corr = compute_corr(fmap1, fmap2)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        corr = avg_pool2(corr)
        pyramid.append(corr)
    return pyramid


def level_shapes(h: int, w: int, num_levels: int = NUM_LEVELS) -> list:
    shapes = [(h, w)]
    for _ in range(num_levels - 1):
        h, w = h // 2, w // 2
        shapes.append((h, w))
    return shapes


def pack_pyramid(pyramid: list) -> torch.Tensor:
    """[(E, P, h_i, w_i)] -> (E, P, sum h_i w_i): the levels side by side."""
    E, P = pyramid[0].shape[:2]
    return torch.cat([v.reshape(E, P, -1) for v in pyramid], dim=-1)


def pyramid_levels(packed: torch.Tensor, h: int, w: int) -> list:
    """Views of the levels of a packed (E, P, sum) pyramid."""
    out, off = [], 0
    for (h2, w2) in level_shapes(h, w):
        out.append(packed[..., off:off + h2 * w2].unflatten(-1, (h2, w2)))
        off += h2 * w2
    return out


def _bilinear_window_gather(volume, coords, radius: int):
    """volume (E, P, h2, w2), coords (E, P, 2) -> (E, P, (2r+1)^2), x offset
    major. Non-finite coordinates land out of bounds and read zero."""
    E, P, h2, w2 = volume.shape
    rd = 2 * radius + 1
    if h2 * w2 == 0:        # a level pooled away (tiny inputs): all zeros
        return torch.zeros(E, P, rd * rd, device=coords.device)
    x0, y0 = coords[..., 0], coords[..., 1]
    fx, fy = torch.floor(x0), torch.floor(y0)
    dx = (x0 - fx)[..., None]
    dy = (y0 - fy)[..., None]
    offs = torch.arange(rd + 1, dtype=coords.dtype, device=coords.device) - radius

    def grid(f, size):
        g = torch.nan_to_num(f[..., None] + offs, nan=-1.0, posinf=2.0 * size,
                             neginf=-1.0)
        g = torch.clamp(g, -1.0, 2.0 * size).to(torch.int64)
        return g, (g >= 0) & (g < size), torch.clamp(g, 0, size - 1)

    _, inb_x, gxc = grid(fx, w2)
    _, inb_y, gyc = grid(fy, h2)
    flat = gyc[:, :, None, :] * w2 + gxc[:, :, :, None]     # (E, P, i, j)
    vals = torch.gather(volume.reshape(E, P, h2 * w2), 2,
                        flat.reshape(E, P, -1)).reshape(E, P, rd + 1, rd + 1)
    vals = vals.to(torch.float32) * (inb_x[:, :, :, None]
                                     & inb_y[:, :, None, :])
    out = (vals[:, :, :rd, :rd] * ((1 - dx) * (1 - dy))[..., None]
           + vals[:, :, 1:, :rd] * (dx * (1 - dy))[..., None]
           + vals[:, :, :rd, 1:] * ((1 - dx) * dy)[..., None]
           + vals[:, :, 1:, 1:] * (dx * dy)[..., None])
    return out.reshape(E, P, rd * rd)


def corr_lookup(pyramid: list, coords: torch.Tensor,
                radius: int = RADIUS) -> torch.Tensor:
    """coords (E, H, W, 2) at level-0 resolution -> (E, H, W, L (2r+1)^2)."""
    E, H, W, _ = coords.shape
    c = coords.reshape(E, H * W, 2)
    outs = [_bilinear_window_gather(vol, c / (2 ** i), radius)
            for i, vol in enumerate(pyramid)]
    return torch.cat(outs, dim=-1).reshape(E, H, W, -1)


def corr_lookup_packed(packed: torch.Tensor, coords: torch.Tensor,
                       radius: int = RADIUS) -> torch.Tensor:
    """corr_lookup on a packed (E, H*W, sum) pyramid."""
    H, W = coords.shape[1:3]
    return corr_lookup(pyramid_levels(packed, H, W), coords, radius)


def fmap_pyramid(fmaps: torch.Tensor, num_levels: int = NUM_LEVELS) -> list:
    """fmaps (F, H, W, C) -> [(F, H/2^i, W/2^i, C)], pre-scaled by 1/4."""
    x = fmaps / 4.0
    pyr = [x]
    for _ in range(num_levels - 1):
        F_, H, W, C = x.shape
        H2, W2 = H // 2, W // 2
        x = x[:, :H2 * 2, :W2 * 2].reshape(F_, H2, 2, W2, 2, C).mean(
            dim=(2, 4))
        pyr.append(x)
    return pyr


ALT_SUB = 8   # edges per transient correlation volume in alt_corr


def alt_corr(pyramid: list, coords: torch.Tensor, ii: torch.Tensor,
             jj: torch.Tensor, radius: int = RADIUS) -> torch.Tensor:
    """Correlation features without stored volumes (global BA): for each
    edge the level-0 features of frame ii and the level-l features of frame
    jj form a transient volume (one ``torch.bmm``), sampled by the (2r+1)^2
    bilinear window as ``corr_lookup`` does; ALT_SUB edges at a time bound
    the volume. `pyramid` is ``fmap_pyramid``'s output (frames indexed
    absolutely by ii, jj), coords (E, H, W, 2) at level 0.
    Returns (E, H, W, L (2r+1)^2)."""
    E, H, W, _ = coords.shape
    c = coords.reshape(E, H * W, 2)
    out = torch.empty(E, H * W, len(pyramid) * (2 * radius + 1) ** 2,
                      dtype=torch.float32, device=coords.device)
    for s in range(0, E, ALT_SUB):
        sl = slice(s, s + ALT_SUB)
        n = ii[sl].shape[0]
        f1 = pyramid[0][ii[sl]].reshape(n, H * W, -1)
        outs = []
        for lvl, fm in enumerate(pyramid):
            h2, w2, C = fm.shape[1:]
            f2 = fm[jj[sl]].reshape(n, h2 * w2, C)
            vol = torch.bmm(f1, f2.transpose(1, 2)).reshape(n, H * W, h2, w2)
            outs.append(_bilinear_window_gather(vol, c[sl] / (2 ** lvl),
                                                radius))
        out[sl] = torch.cat(outs, dim=-1)
    return out.reshape(E, H, W, -1)
