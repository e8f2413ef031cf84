"""Projective geometry with analytic Jacobians; torch port of
``wildgs_slam_tpu/ops/projective.py``.

Conventions as there: ``disps`` are inverse depths at 1/8 resolution,
``poses`` are world->camera SE3 7-vectors, frame-i pixels reproject into
frame j through Gij = poses[j] ∘ poses[i]^-1, homogeneous points are
(X, Y, 1, d), self-edges (i == j) get the fixed baseline (-0.1, 0, 0), and
points closer than MIN_DEPTH are invalid.
"""

from __future__ import annotations

import torch

from . import lie

MIN_DEPTH = 0.2
_SELF_EDGE = (-0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0)


def coords_grid(ht: int, wd: int, dtype=torch.float32,
                device="cuda") -> torch.Tensor:
    """Pixel grid (ht, wd, 2), (x, y) last."""
    y, x = torch.meshgrid(torch.arange(ht, dtype=dtype, device=device),
                          torch.arange(wd, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([x, y], dim=-1)


def _intr(intrinsics):
    return intrinsics[..., None, None, :].unbind(-1)


def iproj(disps: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """disps (..., H, W), intrinsics (..., 4) -> points (..., H, W, 4)."""
    ht, wd = disps.shape[-2:]
    fx, fy, cx, cy = _intr(intrinsics)
    grid = coords_grid(ht, wd, disps.dtype, disps.device)
    X, Y, D = torch.broadcast_tensors((grid[..., 0] - cx) / fx,
                                      (grid[..., 1] - cy) / fy, disps)
    return torch.stack([X, Y, torch.ones_like(D), D], dim=-1)


def proj(Xs: torch.Tensor, intrinsics: torch.Tensor, jacobian: bool = False,
         return_depth: bool = False):
    """Pinhole projection of (..., 4) points -> coords (..., 2) (or (..., 3)
    with the inverse depth) and, if asked, the (..., 2, 4) Jacobian."""
    fx, fy, cx, cy = _intr(intrinsics)
    X, Y, Z, D = Xs.unbind(-1)
    Z = torch.where(Z < 0.5 * MIN_DEPTH, torch.ones_like(Z), Z)
    d = 1.0 / Z
    x = fx * (X * d) + cx
    y = fy * (Y * d) + cy
    coords = torch.stack([x, y, D * d] if return_depth else [x, y], dim=-1)
    if not jacobian:
        return coords, None
    o = torch.zeros_like(d)
    Jp = torch.stack([fx * d, o, -fx * X * d * d, o,
                      o, fy * d, -fy * Y * d * d, o], dim=-1)
    return coords, Jp.reshape(d.shape + (2, 4))


def actp(Gij: torch.Tensor, X0: torch.Tensor, jacobian: bool = False):
    """SE3 action of Gij (..., 7) on points X0 (..., H, W, 4), with the
    (..., H, W, 4, 6) left-perturbation Jacobian at the output point."""
    X1 = lie.se3_act4(Gij[..., None, None, :], X0)
    if not jacobian:
        return X1, None
    X, Y, Z, d = X1.unbind(-1)
    o = torch.zeros_like(d)
    Ja = torch.stack([d, o, o, o, Z, -Y,
                      o, d, o, -Z, o, X,
                      o, o, d, Y, -X, o,
                      o, o, o, o, o, o], dim=-1)
    return X1, Ja.reshape(d.shape + (4, 6))


def relative_poses(poses, ii, jj):
    """Gij = poses[jj] ∘ poses[ii]^-1, the self-edge baseline where ii ==
    jj."""
    Gij = lie.se3_mul(poses[jj], lie.se3_inv(poses[ii]))
    self_edge = torch.tensor(_SELF_EDGE, dtype=Gij.dtype, device=Gij.device)
    return torch.where((ii == jj)[..., None], self_edge.expand_as(Gij), Gij)


def projective_transform(poses, disps, intrinsics, ii, jj,
                         jacobian: bool = False, return_depth: bool = False):
    """Reproject frame-ii pixels into frame jj.

    poses (P, 7), disps (P, H, W), intrinsics (4,) or (P, 4), ii/jj (N,) ->
    coords (N, H, W, 2[+1]), valid (N, H, W, 1) and, with ``jacobian``,
    (Ji, Jj, Jz): (N, H, W, 2, 6) twice and (N, H, W, 2, 1)."""
    if intrinsics.dim() == 1:
        intr_i = intr_j = intrinsics.expand(ii.shape + (4,))
    else:
        intr_i, intr_j = intrinsics[ii], intrinsics[jj]
    X0 = iproj(disps[ii], intr_i)
    Gij = relative_poses(poses, ii, jj)
    X1, Ja = actp(Gij, X0, jacobian=jacobian)
    coords, Jp = proj(X1, intr_j, jacobian=jacobian,
                      return_depth=return_depth)
    valid = ((X1[..., 2] > MIN_DEPTH) & (X0[..., 2] > MIN_DEPTH)).to(
        disps.dtype)[..., None]
    if not jacobian:
        return coords, valid
    Jj = Jp @ Ja
    Ji = -torch.einsum("nhwkj,nji->nhwki", Jj, lie.se3_adj_matrix(Gij))
    tvec = Gij[..., :3]
    dX1_dd = torch.cat([tvec, torch.ones_like(tvec[..., :1])], dim=-1)
    Jz = torch.einsum("nhwkj,nj->nhwk", Jp, dX1_dd)[..., None]
    return coords, valid, (Ji, Jj, Jz)


def induced_flow(poses, disps, intrinsics, ii, jj):
    """Optical flow induced by camera motion, and its validity."""
    ht, wd = disps.shape[-2:]
    coords0 = coords_grid(ht, wd, disps.dtype, disps.device)
    coords1, valid = projective_transform(poses, disps, intrinsics, ii, jj)
    return coords1[..., :2] - coords0, valid
