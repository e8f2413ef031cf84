"""Trajectory accuracy: Sim3 Umeyama alignment and absolute position error
(numpy); the port's own copy of the alignment in
``wildgs_slam_tpu/utils/eval_traj.py`` (the method evo uses).
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale=True):
    """Least-squares similarity transform aligning x -> y, both (3, N).
    Returns (R, t, s) with y ≈ s R x + t."""
    mx = x.mean(axis=1, keepdims=True)
    my = y.mean(axis=1, keepdims=True)
    xc, yc = x - mx, y - my
    n = x.shape[1]
    U, D, Vt = np.linalg.svd(yc @ xc.T / n)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = 1.0
    if with_scale:
        var_x = (xc ** 2).sum() / n
        # all points coincident: the scale is unobservable
        s = np.trace(np.diag(D) @ S) / var_x if var_x > 1e-12 else 1.0
    return R, my[:, 0] - s * R @ mx[:, 0], s


def ape_statistics(est_xyz: np.ndarray, gt_xyz: np.ndarray,
                   with_scale=True) -> dict:
    """Position error statistics (N, 3) after Sim3 alignment, in the
    trajectory's units."""
    R, t, s = umeyama_alignment(est_xyz.T, gt_xyz.T, with_scale)
    err = np.linalg.norm((s * (R @ est_xyz.T)).T + t - gt_xyz, axis=1)
    return dict(rmse=float(np.sqrt((err ** 2).mean())), mean=float(err.mean()),
                median=float(np.median(err)), max=float(err.max()),
                scale=float(s), n=int(err.shape[0]))
