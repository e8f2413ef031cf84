"""SSIM (standard + decomposed), median pooling, resampling and a median
that matches ``jnp.median``; torch port of ``wildgs_slam_tpu/ops/ssim.py``.

Images are (H, W, C) float32. The Gaussian window is separable, so the blur
is two 1-D depthwise convolutions with zero padding (as torch's
``F.conv2d(padding=ws//2)`` in the original code). The resamples use
``F.interpolate(..., align_corners=False, antialias=True)``, which is what
``jax.image.resize`` computes in both directions; without antialiasing the
two differ by up to 2.7 when downsampling 384x512 to 27x36.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

EPSILON = float(np.finfo(np.float32).eps)
SSIM_C1 = 0.01 ** 2
SSIM_C2 = 0.03 ** 2
SSIM_C3 = SSIM_C2 / 2
GAUSSIAN_SIGMA = 1.5
SSIM_MAX_CLIP = 0.98


@functools.lru_cache(maxsize=None)
def _gaussian_kernel(window_size: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(img: torch.Tensor, window_size: int, sigma: float = GAUSSIAN_SIGMA):
    """Separable Gaussian blur of (H, W, C) with 'same' zero padding."""
    k = torch.from_numpy(_gaussian_kernel(window_size, sigma)).to(img.device)
    C = img.shape[-1]
    x = img.permute(2, 0, 1)[None]                      # (1, C, H, W)
    r = window_size // 2
    x = F.conv2d(x, k.view(1, 1, -1, 1).expand(C, 1, -1, 1), padding=(r, 0),
                 groups=C)
    x = F.conv2d(x, k.view(1, 1, 1, -1).expand(C, 1, 1, -1), padding=(0, r),
                 groups=C)
    return x[0].permute(1, 2, 0)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11):
    """Standard SSIM, mean over pixels and channels."""
    mu1 = _blur(img1, window_size)
    mu2 = _blur(img2, window_size)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window_size) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window_size) - mu2_sq
    sigma12 = _blur(img1 * img2, window_size) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + SSIM_C1) * (2 * sigma12 + SSIM_C2)) / (
        (mu1_sq + mu2_sq + SSIM_C1) * (sigma1_sq + sigma2_sq + SSIM_C2))
    return ssim_map.mean()


def ssim_components(img1: torch.Tensor, img2: torch.Tensor,
                    window_size: int = 11):
    """Clipped (luminance, contrast, structure), each (H, W), mean over C."""
    mu1 = _blur(img1, window_size)
    mu2 = _blur(img2, window_size)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = torch.clamp(_blur(img1 * img1, window_size) - mu1_sq,
                            min=EPSILON)
    sigma2_sq = torch.clamp(_blur(img2 * img2, window_size) - mu2_sq,
                            min=EPSILON)
    sigma12 = _blur(img1 * img2, window_size) - mu1_mu2
    sigma12 = torch.sign(sigma12) * torch.minimum(
        torch.sqrt(sigma1_sq * sigma2_sq), sigma12.abs())
    s1, s2 = torch.sqrt(sigma1_sq), torch.sqrt(sigma2_sq)
    luminance = (2 * mu1_mu2 + SSIM_C1) / (mu1_sq + mu2_sq + SSIM_C1)
    contrast = (2 * s1 * s2 + SSIM_C2) / (sigma1_sq + sigma2_sq + SSIM_C2)
    structure = (sigma12 + SSIM_C3) / (s1 * s2 + SSIM_C3)
    contrast = torch.clamp(contrast, max=SSIM_MAX_CLIP)
    structure = torch.clamp(structure, max=SSIM_MAX_CLIP)
    return luminance.mean(-1), contrast.mean(-1), structure.mean(-1)


def median(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``jnp.median`` semantics: the mean of the two middle values for an
    even count, and NaN wherever the reduced values hold a NaN.
    (``torch.median`` returns the lower middle value instead.)"""
    if dim is None:
        x, dim = x.reshape(-1), 0
    n = x.shape[dim]
    s = torch.sort(x, dim=dim).values
    lo = s.select(dim, (n - 1) // 2)
    hi = s.select(dim, n // 2)
    out = (lo + hi) * 0.5
    return torch.where(torch.isnan(x).any(dim), torch.full_like(out, np.nan),
                       out)


def median_pool2d(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Stride-1 median pooling of (H, W) with torch-style 'same' zero
    padding (MedianPool2d(same=True))."""
    k = kernel_size
    pl = (k - 1) // 2
    pr = k - 1 - pl
    xp = F.pad(x, (pl, pr, pl, pr))
    H, W = x.shape
    stack = torch.stack([xp[i:i + H, j:j + W] for i in range(k)
                         for j in range(k)], dim=-1)
    return median(stack, dim=-1)


def _resize(x: torch.Tensor, shape, mode: str) -> torch.Tensor:
    y = F.interpolate(x[None, None], size=tuple(shape), mode=mode,
                      align_corners=False, antialias=True)
    return y[0, 0]


def resample_bilinear(x: torch.Tensor, shape) -> torch.Tensor:
    """Bilinear resize of (H, W) to `shape` (jax.image.resize semantics)."""
    return _resize(x, shape, "bilinear")


def resample_bicubic(x: torch.Tensor, shape) -> torch.Tensor:
    """Bicubic resize of (H, W) to `shape` (jax.image.resize semantics)."""
    return _resize(x, shape, "bicubic")
