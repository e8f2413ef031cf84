"""Gaussian/tile-sharded differentiable rasterizer; torch port of
``wildgs_slam_tpu/parallel/sharded_raster.py``.

Phases over the D shards of a mesh:

  1. PROJECT + BIN, sharded by Gaussians: shard d projects its N/D
     Gaussians (culling against the true image size) and bins them into
     per-tile depth-sorted lists of ``capacity_local`` slots, then gathers
     its packed (N/D, 16) rows into (T, capacity_local, 16) tables with K3
     (``gather_table``; its backward is K4).
  2. ALL_TO_ALL, Gaussians -> tiles: shard d receives every shard's tables,
     keys and counts for its block of T/D tiles.
  3. MERGE + COMPOSITE, sharded by tiles: one stable argsort per tile over
     the D·capacity_local keys (depth, inf for an empty slot) merges the D
     sorted lists, and K1 (backward K2) composites the block with its
     global tile ids ``d·T/D + arange(T/D)``.
  4. ALL_GATHER colour, depth and alpha; psum the overflow; radii stay
     per shard (concatenated in shard order on the output).

The backward runs the same route in reverse through autograd (see
``collectives.py``): the gradients of the Gaussians, of ``pose_delta`` and
of ``mean2d_offset`` flow as in ``render_fused``. The result equals the
single-device ``render_fused`` when no shard's tile list overflows:
merging D depth-sorted sublists by key is the global depth sort restricted
to the tile.
"""

from __future__ import annotations

import torch

from ..ops.rasterizer import (bin_gaussians, gather_table, num_tiles,
                              pack_attrs, project_gaussians)
from ..ops.rasterizer import composite_cuda
from ..ops.rasterizer.composite import RenderOutput, untile
from . import collectives as col


def make_sharded_render(mesh, image_size, *, capacity_local: int = 128,
                        chunk: int = 64, sh_degree: int = 0,
                        cull_size: tuple | None = None, bin_kw: int = 4):
    """Build fn(means3d, scales, rotations, opacities, sh, w2c, intrinsics,
    pose_delta=None, mean2d_offset=None, alive=None, bg=None) ->
    RenderOutput, differentiable in the Gaussians' inputs, pose_delta and
    mean2d_offset; outputs on the device of means3d.

    The Gaussian count N must divide by D, and so must the tile count
    (``mesh.pad_image_size_for_mesh`` pads the image)."""
    D = mesh.size
    devs = mesh.devices
    th, tw = num_tiles(image_size)
    T = th * tw
    if T % D:
        raise ValueError(f"tile count {T} not divisible by {D} shards")
    T_loc = T // D
    K = D * capacity_local
    if K % chunk:
        raise ValueError(f"merged capacity {K} not divisible by chunk "
                         f"{chunk}")
    cull = cull_size or image_size

    def render_fn(means3d, scales, rotations, opacities, sh_coeffs, w2c,
                  intrinsics, pose_delta=None, mean2d_offset=None, alive=None,
                  bg=None):
        N = means3d.shape[0]
        out_dev = means3d.device
        if N % D:
            raise ValueError(f"{N} Gaussians not divisible by {D} shards")
        z = dict(dtype=means3d.dtype, device=out_dev)
        if pose_delta is None:
            pose_delta = torch.zeros(6, **z)
        if mean2d_offset is None:
            mean2d_offset = torch.zeros(N, 2, **z)
        if alive is None:
            alive = torch.ones(N, dtype=torch.bool, device=out_dev)
        if bg is None:
            bg = torch.zeros(3, **z)
        sharded = [col.shard_rows(x, devs) for x in (
            means3d, scales, rotations, opacities, sh_coeffs, mean2d_offset,
            alive)]
        reps = [col.replicate(x, devs) for x in (w2c, intrinsics,
                                                 pose_delta, bg)]

        # phase 1: project, bin and gather each shard's Gaussians
        tables, keys, cnts, ovfs, radii = [], [], [], [], []
        for d in range(D):
            m3, sc, ro, op, sh, m2o, al = (s[d] for s in sharded)
            w2c_d, intr_d, pd_d, _ = (r[d] for r in reps)
            proj = project_gaussians(m3, sc, ro, op, sh, w2c_d, intr_d, cull,
                                     sh_degree=sh_degree, pose_delta=pd_d)
            valid = proj.valid & al
            mean2d = proj.mean2d + m2o
            bins = bin_gaussians(mean2d.detach(), proj.radius,
                                 proj.depth.detach(), valid, image_size,
                                 capacity=capacity_local, kw=bin_kw)
            table = gather_table(pack_attrs(mean2d, proj), bins.ids)
            slot = torch.arange(capacity_local, device=devs[d])
            live = slot[None, :] < bins.counts[:, None]
            key = torch.where(live, table[..., composite_cuda.A_D].detach(),
                              torch.full_like(live, float("inf"),
                                              dtype=table.dtype))
            tables.append(table.reshape(D, T_loc, capacity_local, -1))
            keys.append(key.reshape(D, T_loc, capacity_local))
            cnts.append(bins.counts.reshape(D, T_loc))
            ovfs.append(bins.overflow)
            radii.append(torch.where(valid, proj.radius,
                                     torch.zeros_like(proj.radius)))

        # phase 2: Gaussians -> tiles
        tables = col.all_to_all(tables, devs)
        keys = col.all_to_all(keys, devs)
        cnts = col.all_to_all(cnts, devs)

        # phase 3: merge each tile's D sorted sublists, composite the block
        colors, depths, alphas = [], [], []
        for d in range(D):
            tbl = tables[d].movedim(0, 1).reshape(T_loc, K, -1)
            kys = keys[d].movedim(0, 1).reshape(T_loc, K)
            order = torch.argsort(kys, dim=1, stable=True)
            merged = torch.take_along_dim(tbl, order[..., None], dim=1)
            counts = cnts[d].sum(0).to(torch.int32)
            tile_ids = (d * T_loc + torch.arange(
                T_loc, dtype=torch.int32, device=devs[d]))
            c, dp, a, _ = composite_cuda.composite_tiles(
                counts, merged, reps[3][d], tw, chunk, tile_ids=tile_ids)
            colors.append(c)
            depths.append(dp)
            alphas.append(a)

        # phase 4: tiles back to every shard; the output is shard 0's copy
        color, depth, alpha = (col.move(col.all_gather(x, devs)[0], out_dev)
                               for x in (colors, depths, alphas))
        overflow = col.move(col.psum(ovfs, devs)[0], out_dev)
        return RenderOutput(
            color=untile(color, image_size), depth=untile(depth, image_size),
            alpha=untile(alpha, image_size),
            n_touched=torch.zeros(N, dtype=torch.int32, device=out_dev),
            radii=col.unshard_rows(radii, out_dev), overflow=overflow)

    return render_fn
