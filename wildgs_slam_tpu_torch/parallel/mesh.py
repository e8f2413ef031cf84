"""Device mesh and the sharded mapping step; torch port of
``wildgs_slam_tpu/parallel/mesh.py``.

The JAX mesh mode runs under one controller: one SLAM process whose inner
functions go through ``shard_map`` over ``jax.devices()[:n]``. The port
keeps that process model. A ``Mesh`` is an ordered list of torch devices;
each ``shard_map`` body becomes a loop over the shards, and the JAX
collectives become the tensor moves and sums of ``collectives.py``. A list
may name one card several times, so one card runs a 2- or 8-shard mesh
(as the JAX tests run an 8-device virtual CPU mesh); ``make_mesh`` never
falls back to the CPU on its own.

The Gaussian map's leaves stay whole on the mapper's device, so Adam,
densification and pruning run unchanged; the sharded functions split the
map into shards at their boundary, differentiably. (The JAX package
commits every leaf to the mesh sharded by slot, so there the map's memory
scales with the mesh; here it does not.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..ops.rasterizer import TILE, num_tiles, render
from ..ops.rasterizer.composite import RenderOutput
from ..slam import gaussian_map as gm
from ..slam import losses
from . import collectives as col
from .sharded_raster import make_sharded_render


@dataclass(frozen=True)
class Mesh:
    devices: tuple        # torch.device per shard, in shard order
    axis_names: tuple     # one name: the mesh has one axis

    @property
    def size(self) -> int:
        return len(self.devices)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: int | None = None, axis: str = "view",
              devices: Sequence | None = None) -> Mesh:
    """The first `n_devices` CUDA cards (default: all of them) as a mesh
    with one axis, or the explicit `devices` list (a card may repeat, e.g.
    ``["cuda:0"] * 2``, or ``["cpu"] * 8`` for tests). Raises when fewer
    cards are visible than asked for."""
    if devices is None:
        have = torch.cuda.device_count()
        n = have if n_devices is None else n_devices
        if have < max(n, 1):
            raise ValueError(f"parallel.n_devices={n} but only {have} "
                             f"devices visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(tuple(_device(d) for d in devices), (axis,))


def multiview_loss(params, aux, views_w2c, gt_colors, gt_depths, intrinsics,
                   image_size, capacity, chunk, *, mesh: Mesh):
    """Mean mapping loss over a batch of views (leading axis = view), plus
    the isotropic term. The views are split into equal blocks over the
    mesh, shard d rendering block d on its device from its copy of the map
    (the JAX batch is sharded by view)."""
    V = views_w2c.shape[0]
    devices = mesh.devices
    dev0 = params.xyz.device
    blocks = zip(col.shard_rows(views_w2c, devices),
                 col.shard_rows(gt_colors, devices),
                 col.shard_rows(gt_depths, devices))
    parts = []
    for dev, (w2cs, gcs, gds) in zip(devices, blocks):
        p = gm.GaussianParams(*[col.move(t, dev) for t in params.tensors()])
        alive = col.move(aux.alive, dev)
        intr = col.move(intrinsics, dev)
        for w2c, gt_c, gt_d in zip(w2cs, gcs, gds):
            out = render(p.xyz, gm.get_scaling(p), gm.get_rotation_xyzw(p),
                         gm.get_opacity(p), gm.get_sh(p), w2c, intr,
                         image_size, alive=alive, capacity=capacity,
                         chunk=chunk)
            zero = torch.zeros((), device=dev)
            parts.append(col.move(losses.mapping_loss_rgbd(
                out.color, out.depth, gt_c, gt_d, zero, zero, cfg_alpha=0.95,
                rgb_boundary_threshold=0.01, use_ssim=False,
                lambda_dssim=0.2, initialization=True), dev0))
    return torch.stack(parts).sum() / V + 10.0 * losses.isotropic_loss(
        params.scaling, aux.alive)


def pad_image_size_for_mesh(image_size, n_devices: int):
    """Smallest (H', W') >= image_size whose 16 px tile count divides
    n_devices (the sharded rasterizer's T % D constraint). Pads rows of
    tiles (H) first. Render at the padded size, then crop the outputs back
    to image_size: padded tiles composite pure background."""
    th, tw = num_tiles(image_size)
    while (th * tw) % n_devices:
        th += 1
    return th * TILE, tw * TILE


def pad_gaussian_capacity(n: int, n_devices: int) -> int:
    """Smallest capacity >= n divisible by n_devices (the sharded
    rasterizer's N % D constraint; pad slots are dead)."""
    return -(-n // n_devices) * n_devices


def shard_gaussian_map(gmap: gm.GaussianMap, mesh: Mesh) -> gm.GaussianMap:
    """A map ready for the mesh: its capacity must divide into the shards.
    The leaves stay whole where they are (see the module's docstring); the
    sharded functions split them per call."""
    C = gmap.capacity
    if C % mesh.size:
        raise ValueError(f"capacity {C} % {mesh.size} != 0; use "
                         f"pad_gaussian_capacity")
    return gmap


def make_gsharded_render_fn(mesh: Mesh, image_size, capacity_local=128,
                            chunk=64, sh_degree: int = 0, bin_kw: int = 4):
    """The Gaussian/tile-sharded rasterizer as a (params, alive, w2c,
    intrinsics, mean2d_offset) -> RenderOutput function (the render hook of
    ``Mapper._opt_segment``). Renders at a mesh-padded size and crops back,
    so any image size works on any D."""
    padded = pad_image_size_for_mesh(image_size, mesh.size)
    rf = make_sharded_render(mesh, padded, capacity_local=capacity_local,
                             chunk=chunk, sh_degree=sh_degree,
                             cull_size=image_size, bin_kw=bin_kw)
    H, W = image_size

    def render_fn(params, alive, w2c, intrinsics, mean2d_offset=None):
        out = rf(params.xyz, gm.get_scaling(params),
                 gm.get_rotation_xyzw(params), gm.get_opacity(params),
                 gm.get_sh(params), w2c, intrinsics,
                 mean2d_offset=mean2d_offset, alive=alive)
        return RenderOutput(
            color=out.color[:H, :W], depth=out.depth[:H, :W],
            alpha=out.alpha[:H, :W], n_touched=out.n_touched,
            radii=out.radii, overflow=out.overflow)

    return render_fn


def make_sharded_train_step(mesh: Mesh, intrinsics, image_size, lrs: dict,
                            capacity=256, chunk=64):
    """A mapping train step: each shard renders its own block of views from
    its copy of the map, the gradients are summed over the shards (autograd
    through the copies), and one Adam step updates the map (replicated in
    JAX; here the one map on its device). Returns step(gmap, views_w2c,
    gt_colors, gt_depths) -> (gmap, loss), the map updated in place."""

    def train_step(gmap, views_w2c, gt_colors, gt_depths):
        leaves = gm.GaussianParams(*[t.detach().requires_grad_(True)
                                     for t in gmap.params.tensors()])
        loss = multiview_loss(leaves, gmap.aux, views_w2c, gt_colors,
                              gt_depths, intrinsics, image_size, capacity,
                              chunk, mesh=mesh)
        grads = torch.autograd.grad(loss, leaves.tensors(), allow_unused=True)
        grads = gm.GaussianParams(*[torch.zeros_like(x) if g is None else g
                                    for x, g in zip(leaves.tensors(), grads)])
        gm.adam_step(gmap, grads, lrs)
        return gmap, loss.detach()

    return train_step
