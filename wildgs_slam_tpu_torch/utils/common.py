"""Depth alignment and intrinsics helpers; the port's own copy of
``wildgs_slam_tpu/utils/common.py``."""

from __future__ import annotations

import numpy as np
import torch


def align_scale_and_shift(prediction, target, weights=None):
    """Weighted 2x2 least squares for a depth scale and shift,
    min sum w (s * pred + q - target)^2, in float32.

    prediction / target / weights: (H, W) or (B, H, W), tensors or numpy.
    Returns (scale, shift, avg_error), batched if the input was."""
    prediction = torch.as_tensor(prediction, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=prediction.device)
    weights = (torch.ones_like(prediction) if weights is None else
               torch.as_tensor(weights, dtype=torch.float32,
                               device=prediction.device))
    squeeze = prediction.dim() < 3
    if squeeze:
        prediction, target, weights = (prediction[None], target[None],
                                       weights[None])
    dims = (1, 2)
    a00 = torch.sum(weights * prediction * prediction, dims)
    a01 = torch.sum(weights * prediction, dims)
    a11 = torch.sum(weights, dims)
    b0 = torch.sum(weights * prediction * target, dims)
    b1 = torch.sum(weights * target, dims)
    det = a00 * a11 - a01 * a01
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12),
                      det)
    scale = (a11 * b0 - a01 * b1) / det
    shift = (-a01 * b0 + a00 * b1) / det
    err = torch.abs(scale[:, None, None] * prediction
                    + shift[:, None, None] - target)
    avg_error = torch.sum(err * weights, dims) / torch.clamp(
        torch.sum(weights, dims), min=1e-8)
    if squeeze:
        return scale[0], shift[0], avg_error[0]
    return scale, shift, avg_error


def as_intrinsics_matrix(intrinsics):
    K = np.eye(3)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = intrinsics
    return K
