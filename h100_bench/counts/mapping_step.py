"""fp32 operations one mapping iteration's mathematics needs, frozen here:
the numerator of ``map.step_mfu``.

Counted from the formulas of the step, per element, forward and backward
(autograd's backward of an elementwise chain costs about twice its
forward), for the alive Gaussians and the image's pixels; integer work
(binning's sorts, gathers, scatters) counts nothing:

- projection: ~215 fp32 operations per alive Gaussian forward (pose
  transform 18, the EWA Jacobian and its two 2x3 products 70, the
  quaternion's matrix and scales 54, the 2D covariance, determinant and
  conic 24, radius 10, mean, colour and culling 27, sigmoid 4, clamps 8),
  twice that backward;
- compositing: K1's and K2's counts (``rasterizer.py``), read from the
  launch's own table;
- the loss per pixel: the standard SSIM at window 11 (five maps, three
  channels, two separable passes of 11 taps, two operations a tap: 660,
  plus 60 for its formula), the decomposed SSIM at window 7 (420 + 90),
  exposure, L1, masks, weights and the depth terms (~80); backward through
  the standard SSIM's three image maps (396 + 120) and the L1 and depth
  terms (~90);
- the uncertainty MLP (384 -> 64 -> 64 -> 1) on every DINO cell: two
  operations per weight forward, four backward; in a step that is not
  frozen also on the DINO regulariser's samples, with their cosine
  similarity matrix;
- Adam: 15 operations per element of the alive Gaussians' 14 parameters,
  and of the MLP's weights; the isotropy loss and the densification
  statistics ~38 per alive Gaussian.
"""

from __future__ import annotations

PROJECTION_PER_GAUSSIAN = 215 * 3        # forward and backward
LOSS_PER_PIXEL = 660 + 60 + 420 + 90 + 80 + 396 + 120 + 90
MLP_WEIGHTS = 384 * 64 + 64 * 64 + 64 * 1 + 64 + 64 + 1
ADAM_PER_ELEMENT = 15
GAUSSIAN_ELEMENTS = 3 + 3 + 1 + 3 + 4    # xyz, f_dc, opacity, scaling, rot
OTHER_PER_GAUSSIAN = 38


def step_ops(n_alive: int, k1: int, k2: int, hw, feat_hw, n_reg: int,
             frozen: bool, feat_dim: int = 384) -> int:
    """fp32 operations of one mapping iteration: n_alive Gaussians, k1 and
    k2 the compositing kernels' counts, hw the image, feat_hw the DINO
    grid, n_reg the regulariser's samples, frozen whether the step left
    the uncertainty loss out of the MLP's gradient."""
    H, W = hw
    cells = feat_hw[0] * feat_hw[1]
    mlp_fwd = 2 * MLP_WEIGHTS
    if frozen:
        mlp = cells * mlp_fwd
    else:
        mlp = (cells + n_reg) * 3 * mlp_fwd + 2 * n_reg * n_reg * feat_dim
    return (n_alive * (PROJECTION_PER_GAUSSIAN + OTHER_PER_GAUSSIAN
                       + ADAM_PER_ELEMENT * GAUSSIAN_ELEMENTS)
            + k1 + k2 + H * W * LOSS_PER_PIXEL + mlp
            + ADAM_PER_ELEMENT * MLP_WEIGHTS)
