"""Tracking, mapping and uncertainty losses; torch port of
``wildgs_slam_tpu/slam/losses.py``.

Images are (H, W, 3), depths (H, W); uncertainties live on the DINO patch
grid (H/14, W/14) and are resampled to pixels. ``.detach()`` stands where
the JAX code has ``stop_gradient``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops import ssim as ssim_ops
from ..utils.precision import float32_convs

DEPTH_MAX_CLIP = 5.0
EPSILON = ssim_ops.EPSILON

_SCHARR_Y = [[3, 0, -3], [10, 0, -10], [3, 0, -3]]
_SCHARR_X = [[3, 10, 3], [0, 0, 0], [-3, -10, -3]]


@float32_convs()
def image_gradient(gray: torch.Tensor):
    """Scharr gradients of an (H, W) image -> (grad_v, grad_h)."""
    p = F.pad(gray[None, None], (1, 1, 1, 1), mode="reflect")
    kx = torch.tensor(_SCHARR_X, dtype=torch.float32, device=gray.device)
    ky = torch.tensor(_SCHARR_Y, dtype=torch.float32, device=gray.device)
    norm = 1.0 / ky.abs().sum()
    gv = F.conv2d(p, kx[None, None])[0, 0]
    gh = F.conv2d(p, ky[None, None])[0, 0]
    return norm * gv, norm * gh


@float32_convs()
def image_gradient_mask(gray: torch.Tensor, eps: float = 0.01):
    """3x3 all-valid masks."""
    p = (F.pad(gray[None, None], (1, 1, 1, 1), mode="reflect").abs()
         > eps).to(torch.float32)
    s = F.conv2d(p, torch.ones(1, 1, 3, 3, device=gray.device))[0, 0]
    return s == 9.0, s == 9.0


def compute_grad_mask(image: torch.Tensor, edge_threshold: float,
                      blocks: int = 32) -> torch.Tensor:
    """Per-block median-thresholded Scharr edge mask; image (H, W, 3) ->
    (H, W) 0/1. The remainder past a multiple of `blocks` is left at 0."""
    gray = image.mean(-1)
    gv, gh = image_gradient(gray)
    mv, mh = image_gradient_mask(gray)
    intensity = torch.sqrt((gv * mv) ** 2 + (gh * mh) ** 2)
    H, W = intensity.shape
    bh, bw = H // blocks, W // blocks
    core = intensity[:bh * blocks, :bw * blocks]
    tiles = core.reshape(blocks, bh, blocks, bw).permute(0, 2, 1, 3)
    med = ssim_ops.median(tiles.reshape(blocks, blocks, -1), dim=-1)
    mask_tiles = (tiles > med[..., None, None] * edge_threshold).to(
        torch.float32)
    out = torch.zeros_like(intensity)
    out[:bh * blocks, :bw * blocks] = mask_tiles.permute(0, 2, 1, 3).reshape(
        bh * blocks, bw * blocks)
    return out


def tracking_loss_rgb(image, gt_image, opacity, grad_mask, exposure_a,
                      exposure_b, rgb_boundary_threshold: float,
                      uncertainty_pix=None) -> torch.Tensor:
    """Opacity-weighted masked L1 of the exposure-compensated render,
    optionally weighted by 0.5 / sigma^2 (weights below 0.1 set to 0)."""
    image_ab = torch.exp(exposure_a) * image + exposure_b
    rgb_mask = (gt_image.sum(-1) > rgb_boundary_threshold).to(image.dtype)
    mask = (rgb_mask * grad_mask)[..., None]
    l1 = opacity[..., None] * (image_ab * mask - gt_image * mask).abs()
    if uncertainty_pix is not None:
        w = 0.5 / uncertainty_pix ** 2
        w = torch.where(w < 0.1, torch.zeros_like(w), w)
        l1 = l1 * w[..., None]
    return l1.mean()


def mapping_loss_rgbd(image, depth, gt_image, gt_depth, exposure_a,
                      exposure_b, cfg_alpha, rgb_boundary_threshold,
                      use_ssim, lambda_dssim, initialization=False):
    """Plain RGB-D mapping loss (the no-uncertainty branch)."""
    image_ab = image if initialization else (
        torch.exp(exposure_a) * image + exposure_b)
    rgb_mask = (gt_image.sum(-1) > rgb_boundary_threshold)[..., None]
    l1_rgb = (image_ab * rgb_mask - gt_image * rgb_mask).abs()
    if use_ssim:
        ssim_loss = 1.0 - ssim_ops.ssim(image_ab, gt_image)
        rgb_term = (1.0 - lambda_dssim) * l1_rgb + lambda_dssim * ssim_loss
    else:
        rgb_term = l1_rgb
    depth_mask = gt_depth > 0.01
    l1_depth = (depth * depth_mask - gt_depth * depth_mask).abs()
    return cfg_alpha * rgb_term.mean() + (1 - cfg_alpha) * l1_depth.mean()


def compute_bias_factor(x, s):
    """NeRF-on-the-go adaptive weighting."""
    return x / (1 + (1 - x) * (1 / s - 2))


class UncertaintyLossOut(NamedTuple):
    total: torch.Tensor
    uncer_loss: torch.Tensor
    weights_pix: torch.Tensor
    l1_rgb: torch.Tensor
    l1_depth: torch.Tensor


def mapping_loss_uncertainty(rendered_img, rendered_depth, gt_img, ref_depth,
                             uncertainty, opacity, exposure_a, exposure_b,
                             train_frac, ssim_frac, cfg, initialization=False,
                             freeze_uncertainty_loss=False,
                             ref_depth_median=None) -> UncertaintyLossOut:
    """Uncertainty-aware mapping loss; uncertainty is the MLP's σ on the
    DINO grid (h', w')."""
    up = cfg["uncertainty_params"]
    alpha = cfg.get("alpha", 0.95)
    H, W = gt_img.shape[:2]
    small_hw = tuple(uncertainty.shape)

    img_ab = rendered_img if initialization else (
        torch.exp(exposure_a) * rendered_img + exposure_b)
    rgb_mask = (gt_img.sum(-1) > cfg["rgb_boundary_threshold"])[..., None]
    l1_rgb = (img_ab * rgb_mask - gt_img * rgb_mask).abs()

    med = (ssim_ops.median(ref_depth) if ref_depth_median is None
           else ref_depth_median)
    depth_threshold = torch.clamp(10 * med, max=50.0)
    depth_mask = (ref_depth > 0.01) & (ref_depth < depth_threshold)
    l1_depth = (rendered_depth * depth_mask - ref_depth * depth_mask).abs()

    proc_unc = torch.clamp(uncertainty, min=0.1) + 1e-3
    resized_unc = ssim_ops.resample_bilinear(proc_unc.detach(), (H, W))
    data_rate = 1 + 1 * compute_bias_factor(train_frac, 0.8)
    resized_unc = (resized_unc - 0.1) * data_rate + 0.1

    op_det = opacity.detach()
    small_opacity = ssim_ops.resample_bilinear(op_det, small_hw)

    ssim_weight = 100 + 900 * compute_bias_factor(ssim_frac, 0.8)
    lum, con, struc = ssim_ops.ssim_components(
        gt_img, img_ab, window_size=up["ssim_window_size"])
    ssim_loss_map = torch.clamp(
        op_det * ssim_weight * (1 - lum) * (1 - struc) * (1 - con), max=5.0)
    small_ssim = ssim_ops.resample_bilinear(ssim_loss_map.detach(), small_hw)
    filtered_ssim = ssim_ops.median_pool2d(small_ssim,
                                           up["ssim_median_filter_size"])

    small_depth_loss = ssim_ops.resample_bicubic(
        torch.clamp(l1_depth, max=DEPTH_MAX_CLIP).detach(), small_hw)
    small_depth = ssim_ops.resample_bicubic(ref_depth.detach(), small_hw)
    small_depth_loss = torch.where(small_depth > depth_threshold,
                                   torch.zeros_like(small_depth_loss),
                                   small_depth_loss)

    uncer_loss = (filtered_ssim / proc_unc ** 2
                  + 0.5 * torch.log(proc_unc)
                  + up["uncer_depth_mult"] * small_depth_loss / proc_unc ** 2)
    uncer_loss = torch.where(small_opacity < up["opacity_th_for_uncer_loss"],
                             torch.zeros_like(uncer_loss), uncer_loss)
    if freeze_uncertainty_loss:
        uncer_loss = uncer_loss.detach()

    if cfg.get("ssim_loss", False):
        ssim_term = 1.0 - ssim_ops.ssim(img_ab, gt_img)
        rgb_loss = ((1.0 - cfg["lambda_dssim"]) * l1_rgb
                    + cfg["lambda_dssim"] * ssim_term)
    else:
        rgb_loss = l1_rgb

    weights = 0.5 / resized_unc ** 2
    weights = torch.where(weights < 0.1, torch.zeros_like(weights), weights)
    rgb_loss = weights[..., None] * rgb_loss

    uncer_depth_mask = ref_depth < rendered_depth.detach() + 1.0
    l1_depth_w = torch.where(uncer_depth_mask, weights * l1_depth, l1_depth)

    total = (alpha * rgb_loss.mean() + (1 - alpha) * l1_depth_w.mean()
             + up["ssim_mult"] * uncer_loss.mean())
    return UncertaintyLossOut(total, uncer_loss, weights, l1_rgb, l1_depth)


def dino_regularization_loss(uncertainties, features, top_k=128,
                             sim_threshold=0.75):
    """Variance of σ among the top-k cosine-similar DINO features."""
    u = uncertainties.reshape(-1, 1)
    f = features.reshape(-1, features.shape[-1])
    f = f / torch.clamp(torch.linalg.norm(f, dim=-1, keepdim=True),
                        min=EPSILON)
    sim = f @ f.T
    k = min(top_k, sim.shape[-1])
    top_sim, top_idx = torch.topk(sim, k, dim=-1)
    mask = (top_sim > sim_threshold).to(torch.float32)
    neigh = u[top_idx, 0] * mask
    counts = mask.sum(-1, keepdim=True) + EPSILON
    means = neigh.sum(-1, keepdim=True) / counts
    var = (((neigh - means) ** 2) * mask).sum(-1, keepdim=True) / counts
    return var.mean()


def isotropic_loss(scaling: torch.Tensor, alive: torch.Tensor):
    """|s - mean(s)| per Gaussian, dead slots masked."""
    dev = (scaling - scaling.mean(dim=1, keepdim=True)).abs()
    dev = dev * alive[:, None]
    denom = torch.clamp(alive.sum() * scaling.shape[1], min=1)
    return dev.sum() / denom
