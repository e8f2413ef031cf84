"""The mapping render's projection as one CUDA kernel pair: P1/P2, the
plain projection they replace, and the autograd wiring.

On the card the plain projection (``project_gaussians`` then
``pack_attrs``) is ~250 elementwise launches forward and ~330 backward,
each a few microseconds of device work behind a host launch. The kernels
(``csrc/project_fused.cu``) do it in one launch each:

- P1 ``project_fwd``: post-activation Gaussians and the camera -> the
  (N, 16) rows K3 gathers (``pack_attrs``' columns, ``mean2d_offset``
  added), ``radius`` (int32, 0 where the row is not valid), ``valid``
  (``alive`` folded in) and the binning's ``mean2d`` and ``depth``;
- P2 ``project_bwd``: the rows' cotangent -> the gradients of means3d,
  scales, rotations, opacities, the SH coefficients and ``mean2d_offset``;
  rows that are not valid get zeros (no tile slot reads them, so their
  cotangent is zero on the render path). When the camera takes a gradient
  (``pose_delta``), it also gives that of the w2c 7-vector, summed over
  the blocks in a fixed order by a second launch; autograd carries it
  through ``lie.se3_retr``.

``project_fwd_plain`` is ``project_gaussians`` + ``pack_attrs``: the
function P1 computes, which P2 differentiates. The wrappers and
``ProjectRows`` take CUDA tensors only; each wrapper counts its calls in
``<wrapper>.launches``.

``project_rows`` is what ``render_fused`` calls: on a CUDA tensor
``ProjectRows`` (counted in ``TIMER`` as ``map.proj.kernel``), at SH degree
0 only (every configuration; a higher degree raises); on the CPU the plain
projection under autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ... import kernels
from ...kernels import check as _check, opt_ptr as _opt_ptr, ptr as _ptr
from ...kernels import stream as _stream
from ...utils.profiling import TIMER
from .. import lie
from .projection import ATTR_F, pack_attrs, project_gaussians

NEAR = 0.2     # project_gaussians' near plane
THREADS = 256  # P2's block: one float64 pose partial sum per block


class ProjectedRows(NamedTuple):
    attrs: torch.Tensor   # (N, 16) K3's rows
    radius: torch.Tensor  # (N,) int32, 0 where not valid
    valid: torch.Tensor   # (N,) bool, alive folded in
    mean2d: torch.Tensor  # (N, 2) detached, offset added: the binning's
    depth: torch.Tensor   # (N,) detached camera z


# ---------------------------------------------------------------------------
# the plain projection (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------

def project_fwd_plain(means3d, scales, rotations, opacities, sh_coeffs, w2c,
                      intrinsics, image_size, mean2d_offset=None, alive=None,
                      scale_modifier=1.0, sh_degree=0,
                      pose_delta=None) -> ProjectedRows:
    """P1's function (at SH degree 0, no pose_delta): project_gaussians +
    pack_attrs. Under autograd, render_fused's plain path (attrs
    differentiable)."""
    proj = project_gaussians(means3d, scales, rotations, opacities,
                             sh_coeffs, w2c, intrinsics, image_size,
                             sh_degree=sh_degree, pose_delta=pose_delta,
                             scale_modifier=scale_modifier, near=NEAR)
    valid = proj.valid if alive is None else proj.valid & alive
    mean2d = proj.mean2d if mean2d_offset is None else (proj.mean2d
                                                        + mean2d_offset)
    return ProjectedRows(
        attrs=pack_attrs(mean2d, proj),
        radius=torch.where(valid, proj.radius, torch.zeros_like(proj.radius)),
        valid=valid, mean2d=mean2d.detach(), depth=proj.depth.detach())


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check_in(name, x, dtype, shape, dev):
    _check(name, x, dtype, shape, dev, align=x.element_size())


def project_fwd(means3d, scales, rotations, opacities, sh_coeffs, w2c,
                intrinsics, image_size, mean2d_offset=None, alive=None,
                scale_modifier=1.0) -> ProjectedRows:
    """P1. means3d, scales (N, 3), rotations (N, 4) xyzw, opacities (N,),
    sh_coeffs (N, K, 3) (degree 0: the first coefficient), w2c (7,),
    intrinsics (4,), mean2d_offset (N, 2) or None, alive (N,) bool or None
    -> ProjectedRows."""
    if means3d.device.type != "cuda":
        raise ValueError(f"project_fwd: unsupported device {means3d.device}")
    dev = means3d.device
    N, K = means3d.shape[0], sh_coeffs.shape[1]
    H, W = image_size
    f32 = torch.float32
    for name, x, shape in (("means3d", means3d, (N, 3)),
                           ("scales", scales, (N, 3)),
                           ("rotations", rotations, (N, 4)),
                           ("opacities", opacities, (N,)),
                           ("sh_coeffs", sh_coeffs, (N, K, 3)),
                           ("w2c", w2c, (7,)),
                           ("intrinsics", intrinsics, (4,))):
        _check_in(name, x, f32, shape, dev)
    if mean2d_offset is not None:
        _check_in("mean2d_offset", mean2d_offset, f32, (N, 2), dev)
    if alive is not None:
        _check_in("alive", alive, torch.bool, (N,), dev)
    attrs = torch.empty(N, ATTR_F, device=dev)
    _check("attrs", attrs, f32, (N, ATTR_F), dev)
    radius = torch.empty(N, dtype=torch.int32, device=dev)
    valid = torch.empty(N, dtype=torch.bool, device=dev)
    mean2d = torch.empty(N, 2, device=dev)
    depth = torch.empty(N, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        err = lib.project_fwd(
            _ptr(means3d), _ptr(scales), _ptr(rotations), _ptr(opacities),
            _ptr(sh_coeffs), _opt_ptr(alive), _opt_ptr(mean2d_offset),
            _ptr(w2c), _ptr(intrinsics), _ptr(attrs), _ptr(radius),
            _ptr(valid), _ptr(mean2d), _ptr(depth), N, K, H, W,
            float(scale_modifier), NEAR, _stream(dev))
    if err:
        raise RuntimeError(f"project_fwd launch failed: CUDA error {err}")
    project_fwd.launches += 1
    return ProjectedRows(attrs, radius, valid, mean2d, depth)


def project_bwd(means3d, scales, rotations, sh_coeffs, valid, w2c,
                intrinsics, image_size, g_attrs, scale_modifier=1.0,
                need=(True,) * 6, pose=False):
    """P2. The forward's inputs, its valid mask and the rows' cotangent
    g_attrs (N, 16) -> (means3d, scales, rotations, opacities, sh_coeffs,
    mean2d_offset, w2c) gradients; `need` says which of the first six to
    write (None for the others), `pose` whether to give the w2c one (a
    second launch)."""
    if means3d.device.type != "cuda":
        raise ValueError(f"project_bwd: unsupported device {means3d.device}")
    dev = means3d.device
    N, K = means3d.shape[0], sh_coeffs.shape[1]
    H, W = image_size
    f32 = torch.float32
    for name, x, shape in (("means3d", means3d, (N, 3)),
                           ("scales", scales, (N, 3)),
                           ("rotations", rotations, (N, 4)),
                           ("sh_coeffs", sh_coeffs, (N, K, 3)),
                           ("valid", valid, (N,)),
                           ("w2c", w2c, (7,)),
                           ("intrinsics", intrinsics, (4,))):
        _check_in(name, x, torch.bool if name == "valid" else f32, shape,
                  dev)
    _check("g_attrs", g_attrs, f32, (N, ATTR_F), dev)
    shapes = ((N, 3), (N, 3), (N, 4), (N,), (N, K, 3), (N, 2))
    out = [torch.empty(s, device=dev) if n else None
           for s, n in zip(shapes, need)]
    n_blocks = -(-N // THREADS)
    part = (torch.empty(max(n_blocks, 1), 7, dtype=torch.float64,
                        device=dev) if pose else None)
    g_w2c = torch.empty(7, device=dev) if pose else None
    lib = kernels.library()
    with torch.cuda.device(dev):
        err = lib.project_bwd(
            _ptr(means3d), _ptr(scales), _ptr(rotations), _ptr(sh_coeffs),
            _ptr(valid), _ptr(w2c), _ptr(intrinsics), _ptr(g_attrs),
            *(_opt_ptr(x) for x in out), _opt_ptr(part), _opt_ptr(g_w2c),
            N, K, H, W, float(scale_modifier), _stream(dev))
    if err:
        raise RuntimeError(f"project_bwd launch failed: CUDA error {err}")
    project_bwd.launches += 1
    return tuple(out) + (g_w2c,)


project_fwd.launches = 0
project_bwd.launches = 0


class ProjectRows(torch.autograd.Function):
    """P1 forward, P2 backward, on CUDA tensors. Inputs
    (means3d, scales, rotations, opacities, sh_coeffs, w2c, intrinsics,
    mean2d_offset, alive, image_size, scale_modifier); outputs those of
    ProjectedRows, only attrs differentiable. The w2c gradient is computed
    only when w2c takes one."""

    @staticmethod
    def forward(ctx, means3d, scales, rotations, opacities, sh_coeffs, w2c,
                intrinsics, mean2d_offset, alive, image_size, scale_modifier):
        rows = project_fwd(means3d, scales, rotations, opacities, sh_coeffs,
                           w2c, intrinsics, image_size, mean2d_offset, alive,
                           scale_modifier)
        ctx.save_for_backward(means3d, scales, rotations, sh_coeffs,
                              rows.valid, w2c, intrinsics)
        ctx.image_size = image_size
        ctx.scale_modifier = scale_modifier
        ctx.mark_non_differentiable(rows.radius, rows.valid, rows.mean2d,
                                    rows.depth)
        return tuple(rows)

    @staticmethod
    def backward(ctx, g_attrs, *_):
        means3d, scales, rotations, sh, valid, w2c, intr = ctx.saved_tensors
        ng = ctx.needs_input_grad
        g = project_bwd(means3d, scales, rotations, sh, valid, w2c, intr,
                        ctx.image_size, g_attrs.contiguous(),
                        ctx.scale_modifier,
                        need=(ng[0], ng[1], ng[2], ng[3], ng[4], ng[7]),
                        pose=ng[5])
        return (g[0], g[1], g[2], g[3], g[4], g[6], None, g[5], None, None,
                None)


def project_rows(means3d, scales, rotations, opacities, sh_coeffs, w2c,
                 intrinsics, image_size, sh_degree=0, pose_delta=None,
                 scale_modifier=1.0, mean2d_offset=None,
                 alive=None) -> ProjectedRows:
    """render_fused's projection: the rows K3 gathers and the binning's
    inputs, differentiable through attrs in every float input (pose_delta
    through lie.se3_retr). P1/P2 on a CUDA tensor, at SH degree 0 only,
    counted in map.proj.kernel; on the CPU the plain projection under
    autograd."""
    if means3d.device.type == "cuda":
        if sh_degree != 0:
            raise NotImplementedError(
                f"render_fused on the card evaluates SH degree 0 only, not "
                f"{sh_degree}")
        TIMER.count("map.proj.kernel")
        if pose_delta is not None:
            w2c = lie.se3_retr(w2c, pose_delta)
        rows = ProjectRows.apply(
            means3d.contiguous(), scales.contiguous(), rotations.contiguous(),
            opacities.contiguous(), sh_coeffs.contiguous(), w2c.contiguous(),
            intrinsics.contiguous(),
            None if mean2d_offset is None else mean2d_offset.contiguous(),
            alive, image_size, scale_modifier)
        return ProjectedRows(*rows)
    return project_fwd_plain(means3d, scales, rotations, opacities, sh_coeffs,
                             w2c, intrinsics, image_size, mean2d_offset,
                             alive, scale_modifier, sh_degree, pose_delta)
