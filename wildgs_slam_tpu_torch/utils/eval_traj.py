"""Trajectory evaluation: Sim3 Umeyama alignment, absolute position error,
the TUM trajectory writer, the error plot and the metrics file (numpy);
the port's own copy of ``wildgs_slam_tpu/utils/eval_traj.py`` (the
alignment is the method evo uses).
"""

from __future__ import annotations

import os
from typing import Optional

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


def align_trajectories(est_xyz: np.ndarray, gt_xyz: np.ndarray,
                       with_scale=True):
    """est, gt (N, 3) -> aligned est (N, 3) and (R, t, s)."""
    R, t, s = umeyama_alignment(est_xyz.T, gt_xyz.T, with_scale)
    return (s * (R @ est_xyz.T)).T + t, (R, t, s)


def ape_statistics(est_xyz: np.ndarray, gt_xyz: np.ndarray,
                   with_scale=True) -> dict:
    """Position error statistics (N, 3) after Sim3 alignment, in the
    trajectory's units."""
    aligned, (_, _, s) = align_trajectories(est_xyz, gt_xyz, with_scale)
    err = np.linalg.norm(aligned - gt_xyz, axis=1)
    return dict(rmse=float(np.sqrt((err ** 2).mean())), mean=float(err.mean()),
                median=float(np.median(err)), std=float(err.std()),
                min=float(err.min()), max=float(err.max()), scale=float(s),
                n=int(err.shape[0]))


def poses_c2w_to_xyz(poses_c2w: np.ndarray) -> np.ndarray:
    return poses_c2w[:, :3, 3]


def evaluate_ate(est_c2w: np.ndarray, gt_c2w: np.ndarray, valid=None,
                 with_scale=True) -> dict:
    """est, gt (N, 4, 4) camera-to-world matrices; rows whose ground truth
    is not finite are skipped."""
    good = np.isfinite(gt_c2w.reshape(len(gt_c2w), -1)).all(axis=1)
    if valid is not None:
        good &= valid
    return ape_statistics(poses_c2w_to_xyz(est_c2w[good]),
                          poses_c2w_to_xyz(gt_c2w[good]), with_scale)


def save_traj_tum(path: str, timestamps, poses_c2w):
    """TUM format, one line per pose: t tx ty tz qx qy qz qw."""
    from scipy.spatial.transform import Rotation

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for t, T in zip(timestamps, poses_c2w):
            q = Rotation.from_matrix(T[:3, :3]).as_quat()
            tx, ty, tz = T[:3, 3]
            f.write(f"{t} {tx} {ty} {tz} {q[0]} {q[1]} {q[2]} {q[3]}\n")


def plot_trajectory(path: str, est_xyz, gt_xyz, stats: Optional[dict] = None):
    """Top-down plot of the aligned trajectory coloured by its error."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    aligned, _ = align_trajectories(est_xyz, gt_xyz)
    err = np.linalg.norm(aligned - gt_xyz, axis=1)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(gt_xyz[:, 0], gt_xyz[:, 1], "k--", alpha=0.5, label="GT")
    sc = ax.scatter(aligned[:, 0], aligned[:, 1], c=err, cmap="jet", s=4)
    plt.colorbar(sc, label="APE [m]")
    if stats:
        ax.set_title(f"ATE-RMSE {stats['rmse']*100:.2f} cm")
    ax.set_aspect("equal")
    ax.legend()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def write_metrics(path: str, stats: dict, label: str = ""):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{label}\n" if label else "")
        for k, v in stats.items():
            f.write(f"{k}: {v}\n")


def read_metric(path: str, key: str = "rmse") -> float:
    """One value from a file written by write_metrics."""
    with open(path) as f:
        for line in f:
            if line.startswith(f"{key}:"):
                return float(line.split(":", 1)[1])
    raise KeyError(f"{key} not in {path}")
