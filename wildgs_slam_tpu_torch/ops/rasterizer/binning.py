"""Tile binning: duplicate + sort into per-tile, depth-ordered id tables.

Port of the ``sort`` method of ``wildgs_slam_tpu/ops/rasterizer/binning.py``
without the reverse index (the mapper's ``sort_norev``). Each Gaussian emits
up to kw×kw (tile, depth) entries over its tile bounding-box window; the
entries are sorted by (tile, depth) with ties broken by entry id, and each
tile keeps its nearest ``capacity`` entries. Gaussians wider than the window
are truncated, and ``overflow`` counts both that truncation and the capacity
drops. Integer outputs equal the JAX package's exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TILE = 16  # tile side in pixels; 16x16 = 256 px


class TileBins(NamedTuple):
    ids: torch.Tensor       # (num_tiles, capacity) int64 Gaussian ids, -1 pad
    counts: torch.Tensor    # (num_tiles,) int32 live entries per tile
    overflow: torch.Tensor  # () int64 dropped entries


def num_tiles(image_size) -> tuple[int, int]:
    H, W = image_size
    return -(-H // TILE), -(-W // TILE)


@torch.no_grad()
def bin_gaussians(mean2d, radius, depth, valid, image_size, capacity=512,
                  kw=4) -> TileBins:
    """Per-tile front-to-back id lists from screen-space means (N, 2),
    int radii (N,), camera depths (N,) and the valid mask (N,)."""
    th, tw = num_tiles(image_size)
    n_tiles = th * tw
    N = mean2d.shape[0]
    dev = mean2d.device
    K = kw * kw
    M = N * K

    radf = radius.to(torch.float32)
    x0 = torch.floor((mean2d[:, 0] - radf) / TILE)
    x1 = torch.floor((mean2d[:, 0] + radf) / TILE)
    y0 = torch.floor((mean2d[:, 1] - radf) / TILE)
    y1 = torch.floor((mean2d[:, 1] + radf) / TILE)

    win = torch.arange(kw, device=dev)
    dy = win.repeat_interleave(kw)[None, :]          # (1, K) row-major window
    dx = win.repeat(kw)[None, :]
    ty = y0.long()[:, None] + dy                     # (N, K)
    tx = x0.long()[:, None] + dx
    in_bbox = (tx <= x1.long()[:, None]) & (ty <= y1.long()[:, None])
    in_img = (tx >= 0) & (tx < tw) & (ty >= 0) & (ty < th)
    ventry = valid[:, None] & in_bbox & in_img

    tile_flat = torch.where(ventry, ty * tw + tx,
                            torch.full_like(tx, n_tiles)).reshape(-1)
    dep_flat = torch.where(ventry, depth[:, None].to(torch.float32),
                           torch.full((1, 1), float("inf"), device=dev)
                           ).reshape(-1)
    # (tile, depth, entry id) order: a stable sort by depth over entries in
    # id order, then a stable sort by tile
    _, by_depth = torch.sort(dep_flat, stable=True)
    _, by_tile = torch.sort(tile_flat[by_depth], stable=True)
    ent = by_depth[by_tile]
    sk_tile = tile_flat[ent]

    bounds = torch.searchsorted(
        sk_tile, torch.arange(n_tiles + 1, device=dev, dtype=sk_tile.dtype))
    starts, ends = bounds[:-1], bounds[1:]
    counts_raw = ends - starts
    counts = torch.clamp(counts_raw, max=capacity)

    slot = torch.arange(capacity, device=dev)[None, :]
    live = starts[:, None] + slot < ends[:, None]
    # the JAX read-back is a dynamic_slice, whose start is clamped so the
    # slice fits; the same clamp keeps the gather in bounds
    first = torch.clamp(starts, max=max(M - capacity, 0))[:, None]
    rows = ent[torch.clamp(first + slot, max=M - 1)]
    ids = torch.where(live, rows // K, torch.full_like(rows, -1))

    bw = (x1 - x0 + 1).long()
    bh = (y1 - y0 + 1).long()
    zero = torch.zeros_like(bw)
    n_true = torch.where(valid, bw * bh, zero)
    n_win = torch.where(valid, torch.clamp(bw, max=kw) * torch.clamp(bh, max=kw),
                        zero)
    overflow = (torch.clamp(counts_raw - capacity, min=0).sum()
                + (n_true - n_win).sum())
    return TileBins(ids=ids, counts=counts.to(torch.int32), overflow=overflow)
