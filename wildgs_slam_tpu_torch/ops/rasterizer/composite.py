"""Front-to-back alpha compositing over all tiles at once (plain torch).

Port of ``wildgs_slam_tpu/ops/rasterizer/composite.py``, the JAX package's
XLA compositing path: every tile's pixels are processed together as a
(T, 256) array and the per-tile Gaussian lists are walked in chunks, with
the transmittance chain as a cumulative product along the chunk axis. It
serves ``render``, which also returns ``n_touched`` (contributing pixels
per Gaussian) for the mapper's covisibility queries. The fused CUDA path
(``composite_cuda.py``) does not produce ``n_touched``.

Blending semantics: skip thresholds 1/255 and power > 0, the 0.99 alpha
clamp, the 1e-4 termination transmittance, and the background blended with
the last committed transmittance.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .binning import TILE, TileBins, num_tiles

ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


class RenderOutput(NamedTuple):
    color: torch.Tensor      # (H, W, 3)
    depth: torch.Tensor      # (H, W) alpha-weighted depth (not normalized)
    alpha: torch.Tensor      # (H, W) accumulated opacity
    n_touched: torch.Tensor  # (N,) int32 contributing-pixel counts
    radii: torch.Tensor      # (N,) int32 screen radii (0 = culled)
    overflow: torch.Tensor   # () dropped tile-list entries
    tile_counts: Optional[torch.Tensor] = None   # (T,) live entries per
                                                 # tile, where binned


def tile_pixel_coords(tile_ids: torch.Tensor, tw: int):
    """Pixel (x, y) float coords of the given tiles, each (T, 256)."""
    lin = torch.arange(TILE * TILE, device=tile_ids.device)
    ty = (tile_ids // tw).long()[:, None]
    tx = (tile_ids % tw).long()[:, None]
    px = (tx * TILE + lin % TILE).to(torch.float32)
    py = (ty * TILE + lin // TILE).to(torch.float32)
    return px, py


def composite(bins: TileBins, mean2d, conic, color, opacity, depth,
              image_size, bg, chunk=64):
    """Composite binned Gaussians into (T, P, 3) colour, (T, P) depth and
    alpha tiles; also returns n_touched (N,) and T_final (T, P)."""
    n_tiles, capacity = bins.ids.shape
    N = mean2d.shape[0]
    dev = mean2d.device
    _, tw = num_tiles(image_size)
    px, py = tile_pixel_coords(torch.arange(n_tiles, device=dev), tw)
    px, py = px[:, None, :], py[:, None, :]

    live_ids = bins.ids >= 0
    safe = torch.clamp(bins.ids, min=0)
    n_chunks = capacity // chunk
    if n_chunks * chunk != capacity:
        raise ValueError("capacity must be a multiple of chunk")

    P = TILE * TILE
    T_run = torch.ones(n_tiles, P, device=dev)
    T_comm = torch.full((n_tiles, P), float("inf"), device=dev)
    acc_rgb = torch.zeros(n_tiles, P, 3, device=dev)
    acc_d = torch.zeros(n_tiles, P, device=dev)
    acc_a = torch.zeros(n_tiles, P, device=dev)
    touched = torch.zeros(N + 1, dtype=torch.int32, device=dev)

    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        cids = safe[:, sl]
        clive = live_ids[:, sl]
        cm = mean2d[cids]                                # (T, ck, 2)
        cc = conic[cids]
        dx = cm[..., 0:1] - px                           # (T, ck, P)
        dy = cm[..., 1:2] - py
        power = (-0.5 * (cc[..., 0:1] * dx * dx + cc[..., 2:3] * dy * dy)
                 - cc[..., 1:2] * dx * dy)
        alpha = torch.clamp(opacity[cids][..., None] * torch.exp(power),
                            max=0.99)
        dead = (power > 0) | (alpha < ALPHA_MIN) | ~clive[..., None]
        alpha = torch.where(dead, torch.zeros_like(alpha), alpha)

        t_incl = torch.cumprod(1.0 - alpha, dim=1)
        t_before = T_run[:, None, :] * torch.cat(
            [torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
        t_after = T_run[:, None, :] * t_incl
        contrib = t_after >= T_EPS
        w = alpha * t_before * contrib

        acc_rgb = acc_rgb + torch.einsum("tkp,tkc->tpc", w, color[cids])
        acc_d = acc_d + (w * depth[cids][..., None]).sum(1)
        acc_a = acc_a + w.sum(1)

        cand = torch.where(contrib, t_after, torch.full_like(t_after,
                                                             float("inf")))
        T_comm = torch.minimum(T_comm, cand.amin(1))

        with torch.no_grad():
            hits = (w > 0).sum(2).to(torch.int32)           # (T, ck)
            tgt = torch.where(clive, bins.ids[:, sl], torch.full_like(cids, N))
            touched.index_add_(0, tgt.reshape(-1), hits.reshape(-1))
        T_run = t_after[:, -1, :]

    T_final = torch.where(torch.isinf(T_comm), T_run, T_comm)
    tiles_color = acc_rgb + T_final[..., None] * bg[None, None, :]
    return tiles_color, acc_d, acc_a, touched[:N], T_final


def untile(tiles: torch.Tensor, image_size) -> torch.Tensor:
    """(T, TILE*TILE, ...) tile pixels -> (H, W, ...) image (crop padding)."""
    H, W = image_size
    th, tw = num_tiles(image_size)
    chans = tuple(tiles.shape[2:])
    img = tiles.reshape((th, tw, TILE, TILE) + chans)
    img = img.movedim(2, 1).reshape((th * TILE, tw * TILE) + chans)
    return img[:H, :W]
