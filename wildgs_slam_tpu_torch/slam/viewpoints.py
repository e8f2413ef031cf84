"""Per-keyframe camera and image state; torch port of
``wildgs_slam_tpu/slam/viewpoints.py``.

The JAX ``ViewpointStore`` is an immutable pytree of capacity-B arrays;
here it is a dataclass of the same tensors, updated in place by
``set_view``, ``reset_exposure_adam``, ``exposure_adam_step`` and
``update_pose``. Colours and DINO features are stored in bfloat16 as there.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.ssim import median
from . import losses


@dataclass
class ViewpointStore:
    w2c: torch.Tensor           # (B, 7) current absolute pose estimate
    colors: torch.Tensor        # (B, H, W, 3) bf16 ground-truth images
    depths: torch.Tensor        # (B, H, W) prior depth
    features: torch.Tensor      # (B, h14, w14, D) bf16 DINO features
    grad_mask: torch.Tensor     # (B, H, W) 0/1
    exposure: torch.Tensor      # (B, 2) learnable (a, b)
    exposure_mu: torch.Tensor   # (B, 2) Adam m
    exposure_nu: torch.Tensor   # (B, 2) Adam v
    exposure_count: torch.Tensor  # (B,) int32 per-view Adam step
    valid: torch.Tensor         # (B,) bool
    depth_med: torch.Tensor     # (B,) median of `depths`, set at set_view


def create(capacity: int, ht: int, wd: int, feat_hw=(0, 0), feat_dim=384,
           device="cuda") -> ViewpointStore:
    fh, fw = feat_hw
    w2c = torch.zeros(capacity, 7, device=device)
    w2c[:, 6] = 1.0

    def z(*s, dtype=torch.float32):
        return torch.zeros(s, dtype=dtype, device=device)
    return ViewpointStore(
        w2c=w2c, colors=z(capacity, ht, wd, 3, dtype=torch.bfloat16),
        depths=z(capacity, ht, wd),
        features=z(capacity, fh, fw, feat_dim, dtype=torch.bfloat16),
        grad_mask=z(capacity, ht, wd), exposure=z(capacity, 2),
        exposure_mu=z(capacity, 2), exposure_nu=z(capacity, 2),
        exposure_count=z(capacity, dtype=torch.int32),
        valid=z(capacity, dtype=torch.bool), depth_med=z(capacity))


@torch.no_grad()
def set_view(vs: ViewpointStore, idx: int, color, depth, w2c, features=None,
             edge_threshold: float = 4.0) -> ViewpointStore:
    """Create or overwrite viewpoint `idx`, with its grad mask and depth
    median."""
    vs.w2c[idx] = w2c
    vs.colors[idx] = color.to(torch.bfloat16)
    vs.depths[idx] = depth
    vs.depth_med[idx] = median(depth)
    vs.grad_mask[idx] = losses.compute_grad_mask(color, edge_threshold)
    vs.valid[idx] = True
    if features is not None:
        vs.features[idx] = features.to(torch.bfloat16)
    return vs


@torch.no_grad()
def reset_exposure_adam(vs: ViewpointStore, idx: int) -> ViewpointStore:
    """Fresh exposure optimizer state for view idx."""
    vs.exposure_mu[idx] = 0.0
    vs.exposure_nu[idx] = 0.0
    vs.exposure_count[idx] = 0
    return vs


@torch.no_grad()
def exposure_adam_step(vs: ViewpointStore, idx: int, grad: torch.Tensor,
                       lr=0.01, b1=0.9, b2=0.999, eps=1e-8) -> ViewpointStore:
    """Adam on view idx's (a, b) only."""
    vs.exposure_count[idx] += 1
    cntf = vs.exposure_count[idx].to(torch.float32)
    mu = b1 * vs.exposure_mu[idx] + (1 - b1) * grad
    nu = b2 * vs.exposure_nu[idx] + (1 - b2) * grad * grad
    mu_hat = mu / (1 - torch.tensor(b1, device=cntf.device) ** cntf)
    nu_hat = nu / (1 - torch.tensor(b2, device=cntf.device) ** cntf)
    vs.exposure[idx] -= lr * mu_hat / (torch.sqrt(nu_hat) + eps)
    vs.exposure_mu[idx] = mu
    vs.exposure_nu[idx] = nu
    return vs


@torch.no_grad()
def update_pose(vs: ViewpointStore, idx: int, w2c) -> ViewpointStore:
    vs.w2c[idx] = w2c
    return vs
