"""Differentiable tiled Gaussian rasterizer (torch + CUDA).

Port of ``wildgs_slam_tpu/ops/rasterizer/__init__.py``. Three phases:

1. projection (``projection.py``): 3D -> 2D with EWA covariances and SH
   colours; the camera-pose gradient comes from autograd through
   ``lie.se3_retr``;
2. binning (``binning.py``): duplicate + sort into per-tile depth-ordered
   id tables of fixed capacity;
3. compositing: ``render`` uses the plain all-tiles path (``composite.py``,
   which also gives ``n_touched``); ``render_fused`` gathers one packed
   (N, 16) attribute table into per-tile tables with the CUDA kernel K3 (its
   backward K4, ``table_gather.py``) and composites them with the CUDA
   kernels K1/K2 (``composite_cuda.py``).

Screen-space mean gradients for densification flow through the
``mean2d_offset`` input (evaluate at zeros), as in the JAX package.
"""

from __future__ import annotations

import torch

from . import composite_cuda
from .binning import TILE, bin_gaussians, num_tiles
from .composite import RenderOutput, composite, untile
from .projection import ProjectedGaussians, project_gaussians
from .table_gather import TableGather

__all__ = ["render", "render_fused", "render_reference", "RenderOutput",
           "ProjectedGaussians", "project_gaussians", "bin_gaussians",
           "gather_table", "pack_attrs", "num_tiles", "TILE"]


def gather_table(attrs: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(N, 16) rows gathered into a (T, K, 16) table by K3, its backward a
    scatter-add by K4 (``table_gather.py``); ids of -1 read row 0 (their
    slots lie past the tile's count and get zero gradient)."""
    return TableGather.apply(attrs.contiguous(),
                             ids.to(torch.int32).contiguous())


def pack_attrs(mean2d: torch.Tensor, proj: ProjectedGaussians):
    """The (N, 16) rows K3 gathers: mean, conic, colour, opacity, depth and
    6 zero lanes."""
    zc = torch.zeros_like(proj.depth)
    return torch.stack(
        [mean2d[:, 0], mean2d[:, 1], proj.conic[:, 0], proj.conic[:, 1],
         proj.conic[:, 2], proj.color[:, 0], proj.color[:, 1],
         proj.color[:, 2], proj.opacity, proj.depth]
        + [zc] * (composite_cuda.ATTR_F - 10), dim=1)


def _project_and_bin(means3d, scales, rotations, opacities, sh_coeffs, w2c,
                     intrinsics, image_size, sh_degree, pose_delta,
                     scale_modifier, mean2d_offset, alive, capacity, bin_kw):
    proj = project_gaussians(
        means3d, scales, rotations, opacities, sh_coeffs, w2c, intrinsics,
        image_size, sh_degree=sh_degree, pose_delta=pose_delta,
        scale_modifier=scale_modifier)
    valid = proj.valid if alive is None else proj.valid & alive
    mean2d = proj.mean2d if mean2d_offset is None else (proj.mean2d
                                                        + mean2d_offset)
    bins = bin_gaussians(mean2d.detach(), proj.radius, proj.depth.detach(),
                         valid, image_size, capacity=capacity, kw=bin_kw)
    return proj, valid, mean2d, bins


def render(means3d, scales, rotations, opacities, sh_coeffs, w2c, intrinsics,
           image_size, sh_degree=0, pose_delta=None, bg=None, capacity=1024,
           chunk=64, scale_modifier=1.0, mean2d_offset=None, alive=None,
           bin_kw=4) -> RenderOutput:
    """Render Gaussians (post-activation inputs) into a pinhole camera with
    the plain all-tiles composite; gives ``n_touched``. Differentiable in
    every float input, including ``pose_delta`` and ``mean2d_offset``."""
    if bg is None:
        bg = torch.zeros(3, dtype=means3d.dtype, device=means3d.device)
    proj, valid, mean2d, bins = _project_and_bin(
        means3d, scales, rotations, opacities, sh_coeffs, w2c, intrinsics,
        image_size, sh_degree, pose_delta, scale_modifier, mean2d_offset,
        alive, capacity, bin_kw)
    tc, td, ta, n_touched, _ = composite(
        bins, mean2d, proj.conic, proj.color, proj.opacity, proj.depth,
        image_size, bg, chunk=chunk)
    return RenderOutput(
        color=untile(tc, image_size), depth=untile(td, image_size),
        alpha=untile(ta, image_size), n_touched=n_touched,
        radii=torch.where(valid, proj.radius, torch.zeros_like(proj.radius)),
        overflow=bins.overflow)


def render_fused(means3d, scales, rotations, opacities, sh_coeffs, w2c,
                 intrinsics, image_size, sh_degree=0, pose_delta=None, bg=None,
                 capacity=512, chunk=64, scale_modifier=1.0,
                 mean2d_offset=None, alive=None, bin_kw=4) -> RenderOutput:
    """The mapping hot path, counterpart of ``render_pallas``: one packed
    (N, 16) attribute table gathered into per-tile tables by K3 (backward
    K4), composited by K1/K2 on a CUDA tensor (the plain versions on the
    CPU).
    Gives no ``n_touched`` (zeros); use ``render`` for covisibility."""
    if bg is None:
        bg = torch.zeros(3, dtype=means3d.dtype, device=means3d.device)
    proj, valid, mean2d, bins = _project_and_bin(
        means3d, scales, rotations, opacities, sh_coeffs, w2c, intrinsics,
        image_size, sh_degree, pose_delta, scale_modifier, mean2d_offset,
        alive, capacity, bin_kw)
    attrs = pack_attrs(mean2d, proj)
    tiles = composite_cuda.composite_tiles(
        bins.counts, gather_table(attrs, bins.ids), bg,
        num_tiles(image_size)[1], chunk)
    color, depth, alpha, _ = tiles
    return RenderOutput(
        color=untile(color, image_size), depth=untile(depth, image_size),
        alpha=untile(alpha, image_size),
        n_touched=torch.zeros(means3d.shape[0], dtype=torch.int32,
                              device=means3d.device),
        radii=torch.where(valid, proj.radius, torch.zeros_like(proj.radius)),
        overflow=bins.overflow)


def render_reference(means3d, scales, rotations, opacities, sh_coeffs, w2c,
                     intrinsics, image_size, sh_degree=0, pose_delta=None,
                     bg=None, alive=None) -> RenderOutput:
    """Slow per-pixel oracle: every Gaussian against every pixel, no tiling
    beyond the tile-granular bbox truncation. O(H·W·N) memory."""
    H, W = image_size
    dev = means3d.device
    if bg is None:
        bg = torch.zeros(3, dtype=means3d.dtype, device=dev)
    proj = project_gaussians(
        means3d, scales, rotations, opacities, sh_coeffs, w2c, intrinsics,
        image_size, sh_degree=sh_degree, pose_delta=pose_delta)
    valid = proj.valid if alive is None else proj.valid & alive

    key = torch.where(valid, proj.depth.detach(),
                      torch.full_like(proj.depth, float("inf")))
    order = torch.sort(key, stable=True).indices
    m = proj.mean2d[order]
    c = proj.conic[order]
    col = proj.color[order]
    op = torch.where(valid, proj.opacity, torch.zeros_like(proj.opacity))[order]
    dep = proj.depth[order]
    rad = proj.radius[order].to(torch.float32)

    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    px = x.reshape(-1)[:, None]
    py = y.reshape(-1)[:, None]
    dx = m[None, :, 0] - px
    dy = m[None, :, 1] - py
    power = (-0.5 * (c[None, :, 0] * dx * dx + c[None, :, 2] * dy * dy)
             - c[None, :, 1] * dx * dy)
    alpha = torch.clamp(op[None, :] * torch.exp(power), max=0.99)
    alpha = torch.where((power > 0) | (alpha < 1.0 / 255.0),
                        torch.zeros_like(alpha), alpha)
    tx = torch.floor(px / TILE)
    ty = torch.floor(py / TILE)
    md = m.detach()
    in_bbox = ((torch.floor((md[None, :, 0] - rad[None, :]) / TILE) <= tx)
               & (torch.floor((md[None, :, 0] + rad[None, :]) / TILE) >= tx)
               & (torch.floor((md[None, :, 1] - rad[None, :]) / TILE) <= ty)
               & (torch.floor((md[None, :, 1] + rad[None, :]) / TILE) >= ty))
    alpha = torch.where(in_bbox, alpha, torch.zeros_like(alpha))

    t_incl = torch.cumprod(1.0 - alpha, dim=1)
    t_before = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], 1)
    contrib = t_incl >= 1e-4
    w = alpha * t_before * contrib

    rgb = w @ col
    depth_img = (w * dep[None, :]).sum(1)
    alpha_img = w.sum(1)
    cand = torch.where(contrib, t_incl, torch.full_like(t_incl, float("inf")))
    T_final = torch.clamp(cand.amin(1), max=1.0)
    T_final = torch.where(torch.isinf(T_final), t_incl[:, -1], T_final)
    rgb = rgb + T_final[:, None] * bg[None, :]

    touched = (w.detach() > 0).sum(0).to(torch.int32)
    n_touched = torch.zeros(means3d.shape[0], dtype=torch.int32, device=dev)
    n_touched[order] = touched
    return RenderOutput(
        color=rgb.reshape(H, W, 3), depth=depth_img.reshape(H, W),
        alpha=alpha_img.reshape(H, W), n_touched=n_touched,
        radii=torch.where(valid, proj.radius, torch.zeros_like(proj.radius)),
        overflow=torch.zeros((), dtype=torch.int64, device=dev))
