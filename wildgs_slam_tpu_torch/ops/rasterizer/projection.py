"""Gaussian projection: 3D -> screen space (torch, differentiable).

Port of ``wildgs_slam_tpu/ops/rasterizer/projection.py``. It keeps the
preprocess conventions of the Inria rasterizer: the ``ndc2Pix`` -0.5 pixel
offset, the 1.3·tan-fov clamp of the EWA Jacobian, the 0.3 low-pass
dilation, the integer radius ``ceil(3·sqrt(λ1))`` and the near-0.2, det>0
and in-image culling. The camera-pose gradient comes from autograd through
``lie.se3_retr`` applied to ``pose_delta``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import lie
from .. import sh as sh_utils


ATTR_F = 16  # floats in a packed row: K3's row, K1/K2's table lane count


class ProjectedGaussians(NamedTuple):
    mean2d: torch.Tensor   # (N, 2) pixel coords
    depth: torch.Tensor    # (N,) camera-space z
    conic: torch.Tensor    # (N, 3) upper-triangular inverse 2D covariance
    color: torch.Tensor    # (N, 3) view-dependent RGB
    opacity: torch.Tensor  # (N,) post-activation opacity
    radius: torch.Tensor   # (N,) int32 3-sigma screen radius (0 = culled)
    valid: torch.Tensor    # (N,) bool


def project_gaussians(means3d, scales, rotations, opacities, sh_coeffs, w2c,
                      intrinsics, image_size, sh_degree=0, pose_delta=None,
                      scale_modifier=1.0, near=0.2) -> ProjectedGaussians:
    """Project Gaussians into a pinhole camera.

    means3d (N, 3), scales (N, 3) post-activation, rotations (N, 4) unit
    quaternions (x, y, z, w), opacities (N,), sh_coeffs (N, K, 3), w2c (7,),
    intrinsics (4,) = (fx, fy, cx, cy), image_size (H, W); pose_delta an
    optional (6,) twist retracted onto w2c.
    """
    H, W = image_size
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    if pose_delta is not None:
        w2c = lie.se3_retr(w2c, pose_delta)

    t = lie.se3_act(w2c[None, :], means3d)
    tz = t[..., 2]

    limx = 1.3 * ((0.5 * W) / fx)
    limy = 1.3 * ((0.5 * H) / fy)
    tz_safe = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    txz = torch.maximum(torch.minimum(t[..., 0] / tz_safe, limx), -limx) * tz_safe
    tyz = torch.maximum(torch.minimum(t[..., 1] / tz_safe, limy), -limy) * tz_safe

    # 2D covariance JW Σ JWᵀ channelwise, as in the JAX package: with
    # p = Mᵀu, q = Mᵀv (u, v the rows of J·Rcw, M = R·diag(s)),
    # cov2d = [[p·p, p·q], [p·q, q·q]]
    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * txz * inv_z2
    j11 = fy * inv_z
    j12 = -fy * tyz * inv_z2

    Rcw = lie.quat_to_matrix(w2c[3:7])
    u = [j00 * Rcw[0, k] + j02 * Rcw[2, k] for k in range(3)]
    v = [j11 * Rcw[1, k] + j12 * Rcw[2, k] for k in range(3)]

    qx, qy, qz, qw = rotations.unbind(-1)
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    R = [[1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
         [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
         [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)]]
    s = [scales[:, k] * scale_modifier for k in range(3)]
    p = [s[j] * (R[0][j] * u[0] + R[1][j] * u[1] + R[2][j] * u[2])
         for j in range(3)]
    q = [s[j] * (R[0][j] * v[0] + R[1][j] * v[1] + R[2][j] * v[2])
         for j in range(3)]

    a = p[0] * p[0] + p[1] * p[1] + p[2] * p[2] + 0.3
    b = p[0] * q[0] + p[1] * q[1] + p[2] * q[2]
    c = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + 0.3

    det = a * c - b * b
    det_safe = torch.where(det <= 0, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    with torch.no_grad():
        mid = 0.5 * (a + c)
        lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        radius = torch.ceil(3.0 * torch.sqrt(lam1)).to(torch.int32)

    mean2d = torch.stack([fx * t[..., 0] * inv_z + cx - 0.5,
                          fy * t[..., 1] * inv_z + cy - 0.5], dim=-1)

    cam_center = lie.se3_inv(w2c)[:3]
    dirs = means3d - cam_center[None, :]
    color = torch.clamp(sh_utils.eval_sh(sh_degree, sh_coeffs, dirs) + 0.5,
                        min=0.0)

    with torch.no_grad():
        m2 = mean2d.detach()
        in_image = ((m2[..., 0] + radius > 0) & (m2[..., 0] - radius < W)
                    & (m2[..., 1] + radius > 0) & (m2[..., 1] - radius < H))
        valid = (tz.detach() > near) & (det.detach() > 0) & in_image
        radius = torch.where(valid, radius, torch.zeros_like(radius))

    return ProjectedGaussians(mean2d=mean2d, depth=tz, conic=conic,
                              color=color, opacity=opacities, radius=radius,
                              valid=valid)


def pack_attrs(mean2d: torch.Tensor, proj: ProjectedGaussians):
    """The (N, 16) rows K3 gathers: mean, conic, colour, opacity, depth and
    6 zero lanes."""
    zc = torch.zeros_like(proj.depth)
    return torch.stack(
        [mean2d[:, 0], mean2d[:, 1], proj.conic[:, 0], proj.conic[:, 1],
         proj.conic[:, 2], proj.color[:, 0], proj.color[:, 1],
         proj.color[:, 2], proj.opacity, proj.depth]
        + [zc] * (ATTR_F - 10), dim=1)
