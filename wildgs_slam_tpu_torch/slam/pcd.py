"""Keyframe -> Gaussian seeding; torch port of ``wildgs_slam_tpu/slam/pcd.py``.

Back-projects a fixed budget M = ceil(H*W / factor) of randomly chosen
valid-depth pixels (the M smallest random priorities, invalid pixels pushed
back by +10) and initializes their scales from the 3-NN distances.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import knn, lie, sh
from ..ops.ssim import median
from .gaussian_map import GaussianParams, inverse_sigmoid


def seed_gaussians_from_depth(color, depth, w2c, intrinsics,
                              downsample_factor: int, point_size: float,
                              num_sh_rest: int, isotropic: bool,
                              adaptive_pointsize: bool = True,
                              max_depth: float = 100.0,
                              draws: Optional[torch.Tensor] = None,
                              generator: Optional[torch.Generator] = None):
    """color (H, W, 3) in [0, 1], depth (H, W) (0/neg = invalid), w2c (7,),
    intrinsics (4,). draws: optional (H*W,) uniforms in [0, 1) for the
    subsample priority (a test feeds the JAX draws); else drawn from
    `generator`. Returns (params with M rows, valid mask (M,))."""
    H, W = depth.shape
    dev = depth.device
    M = -(-(H * W) // downsample_factor)
    valid = (depth > 0) & (depth < max_depth) & torch.isfinite(depth)

    if draws is None:
        draws = torch.rand(H * W, generator=generator, device=dev)
    pri = draws + torch.where(valid.reshape(-1), 0.0, 10.0)
    # the M smallest priorities, ties by pixel index (lax.top_k of -pri)
    top, idx = torch.sort(pri, stable=True)
    top, idx = top[:M], idx[:M]
    sel_valid = top < 1.0

    ys = (idx // W).to(torch.float32)
    xs = (idx % W).to(torch.float32)
    d = depth.reshape(-1)[idx]
    rgb = color.reshape(-1, 3)[idx]
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    pts_cam = torch.stack([(xs - cx) / fx * d, (ys - cy) / fy * d, d], dim=-1)
    pts_world = lie.se3_act(lie.se3_inv(w2c)[None], pts_cam)

    if adaptive_pointsize:
        # as in JAX: the median is NaN as soon as one pixel is invalid, and
        # nan_to_num then makes it 1.0 (recorded as a fault against the
        # reference in ROADMAP Queue 3)
        med = median(torch.where(valid, depth, torch.full_like(depth,
                                                               float("nan"))))
        med = torch.nan_to_num(med, nan=1.0)
        ps = torch.clamp(point_size * med, max=0.05)
    else:
        ps = torch.tensor(point_size, dtype=torch.float32, device=dev)

    dist2 = torch.clamp(knn.knn_dist2(pts_world, sel_valid), min=1e-7) * ps
    log_scale = 0.5 * torch.log(dist2)[:, None]
    scaling = log_scale if isotropic else log_scale.repeat(1, 3)

    rot = torch.zeros(M, 4, device=dev)
    rot[:, 0] = 1.0
    params = GaussianParams(
        xyz=pts_world, f_dc=sh.rgb_to_sh(rgb)[:, None, :],
        f_rest=torch.zeros(M, num_sh_rest, 3, device=dev),
        opacity=torch.full((M, 1), inverse_sigmoid(0.5), device=dev),
        scaling=scaling, rotation=rot)
    return params, sel_valid
