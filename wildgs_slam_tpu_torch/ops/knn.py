"""Brute-force 3-NN mean squared distance (the distCUDA2 replacement).

Port of ``wildgs_slam_tpu/ops/knn.py``: an exact (M, M) distance matrix
and the k smallest entries per row.
"""

from __future__ import annotations

import torch


def knn_dist2(points: torch.Tensor, valid: torch.Tensor | None = None,
              k: int = 3) -> torch.Tensor:
    """Mean squared distance of each of points (M, 3) to its k nearest
    neighbours; invalid points are no one's neighbour and get 0."""
    M = points.shape[0]
    sq = (points * points).sum(-1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * points @ points.T,
                     min=0.0)
    big = torch.finfo(torch.float32).max
    eye = torch.eye(M, dtype=torch.bool, device=points.device)
    d2 = d2.masked_fill(eye, big)
    if valid is not None:
        d2 = d2.masked_fill(~valid[None, :], big)
    mean_d2 = torch.topk(d2, k, dim=-1, largest=False).values.mean(-1)
    if valid is not None:
        mean_d2 = torch.where(valid, mean_d2, torch.zeros_like(mean_d2))
    return mean_d2
