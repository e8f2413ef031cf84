"""Keyframe store, the mapper's subset; torch port of
``wildgs_slam_tpu/slam/keyframe_store.py``.

The JAX ``KeyframeStore`` is an immutable pytree; here it is a dataclass of
the same tensors that ``append`` updates in place. Only the fields the
mapper reads are kept (poses, timestamps, the full-resolution frontend and
metric-prior disparities, the multiview valid mask and the intrinsics).
Bundle adjustment, reprojection and depth filtering wait for the tracking
slice, as do the 1/8-resolution and DROID feature fields.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import lie


@dataclass
class KeyframeStore:
    """H, W full resolution."""

    timestamp: torch.Tensor         # (B,)
    poses: torch.Tensor             # (B, 7) world->camera SE3
    disps_up: torch.Tensor          # (B, H, W) frontend inverse depths
    mono_disps_up: torch.Tensor     # (B, H, W) metric-prior inverse depths
    valid_depth_mask: torch.Tensor  # (B, H, W) bool (multiview filter)
    intrinsics: torch.Tensor        # (4,) at 1/8 resolution (fx fy cx cy)


def create(buffer: int, ht: int, wd: int, intrinsics_full, down_scale: int = 8,
           device="cuda") -> KeyframeStore:
    def z(*s):
        return torch.zeros(s, dtype=torch.float32, device=device)
    poses = z(buffer, 7)
    poses[:, 6] = 1.0
    intr = torch.as_tensor(intrinsics_full, dtype=torch.float32,
                           device=device) / down_scale
    return KeyframeStore(
        timestamp=z(buffer), poses=poses, disps_up=z(buffer, ht, wd),
        mono_disps_up=z(buffer, ht, wd),
        valid_depth_mask=torch.zeros(buffer, ht, wd, dtype=torch.bool,
                                     device=device),
        intrinsics=intr)


def _inv_pos(x):
    return torch.where(x > 0, 1.0 / torch.where(x > 0, x, torch.ones_like(x)),
                       torch.zeros_like(x))


@torch.no_grad()
def append(store: KeyframeStore, index: int, timestamp, pose=None,
           mono_depth_up=None) -> KeyframeStore:
    """Write keyframe `index`; mono_depth_up is a full-resolution metric
    DEPTH map (stored inverted)."""
    store.timestamp[index] = timestamp
    if pose is not None:
        store.poses[index] = torch.as_tensor(pose, dtype=torch.float32)
    if mono_depth_up is not None:
        store.mono_disps_up[index] = _inv_pos(torch.as_tensor(
            mono_depth_up, dtype=torch.float32, device=store.poses.device))
    return store


def get_depth_and_pose(store: KeyframeStore, index: int,
                       metric_depth_reg: bool = True):
    """Mapper-side view: (depth (H, W), mask (H, W), c2w (7,))."""
    if metric_depth_reg:
        disp = store.mono_disps_up[index]
        depth = _inv_pos(disp)
        mask = torch.ones_like(disp, dtype=torch.bool)
    else:
        disp = store.disps_up[index]
        depth = 1.0 / torch.clamp(disp, min=1e-8)
        mask = store.valid_depth_mask[index]
    return depth, mask, lie.se3_inv(store.poses[index])
