"""Depth-L1 evaluation (the Splat-SLAM protocol); the port's own copy of
``wildgs_slam_tpu/utils/eval_depth.py``.

Per keyframe, the BA's full-resolution depth is aligned in scale and shift
to the stream's ground-truth depth over the multiview-valid mask; the mean
L1 is averaged over keyframes, also restricted to ground truth under 4 m,
with the mean mask coverage.
"""

from __future__ import annotations

import numpy as np

from .common import align_scale_and_shift


def eval_depth_l1(store, n_frames, stream, global_scale=None,
                  timestamps=None):
    """Returns (depth_l1, depth_l1_max_4m, mean_mask_coverage).

    store: the port's KeyframeStore (disps_up and valid_depth_mask);
    stream[t] -> (timestamp, image, depth_gt, pose)."""
    depth_l1_list = []
    depth_l1_max4_list = []
    mask_list = []

    ts = (store.timestamp[:n_frames].cpu().numpy().astype(int)
          if timestamps is None else np.asarray(timestamps).astype(int))
    disps_up = store.disps_up[:n_frames].cpu().numpy()
    valid_mask = store.valid_depth_mask[:n_frames].cpu().numpy()

    def aligned_l1(depth, depth_gt, mask):
        if mask.sum() == 0:
            return None
        d = np.where(mask, depth, 0.0)
        if global_scale is None:
            scale, shift, _ = align_scale_and_shift(
                d, depth_gt, mask.astype(np.float32))
            d = float(scale) * d + float(shift)
        else:
            d = global_scale * d
        return float(np.abs(d[mask] - depth_gt[mask]).mean())

    for i in range(len(ts)):
        mask = valid_mask[i]
        if mask.sum() == 0:
            print("WARNING: mask is empty!")
        mask_list.append(mask.mean())

        depth_gt = np.asarray(stream[int(ts[i])][2], np.float32)
        depth = 1.0 / np.clip(disps_up[i], 1e-8, None)

        m = (depth_gt > 0) & mask
        l1 = aligned_l1(depth, depth_gt, m)
        if l1 is not None:
            depth_l1_list.append(l1)

        m4 = (depth_gt < 4) & m
        l14 = aligned_l1(depth, depth_gt, m4)
        if l14 is not None:
            depth_l1_max4_list.append(l14)

    return (float(np.mean(depth_l1_list)) if depth_l1_list else np.nan,
            float(np.mean(depth_l1_max4_list)) if depth_l1_max4_list
            else np.nan,
            float(np.mean(mask_list)))
