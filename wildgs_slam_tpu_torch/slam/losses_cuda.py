"""The uncertainty-aware mapping loss as CUDA kernels: M1/M2, the weight
tables they read, and the autograd wiring.

On the card the plain ``losses.mapping_loss_uncertainty`` is ~160 device
operations forward and ~90 backward, each behind a host launch, in a
mapping step that is bound by the host. The kernels
(``csrc/mapping_loss.cu``) compute the same loss in three launches forward
(``mapping_loss_fwd``: the pixel pass, the four downsamples to the DINO
grid, one block for the median pool, ``uncer_loss`` and the sums) and two
backward (``mapping_loss_bwd``: the pixel pass with the SSIM gradient's
blur, one block for the exposure's and sigma's gradients). Each wrapper
counts its calls in ``<wrapper>.launches``; both take CUDA tensors only.

The resamples read per-axis weight tables (``axis_table``): an identity
basis put through the antialiased ``F.interpolate`` call of
``ops/ssim.py``, built once per (n_in, n_out, mode, device) and kept on the
device, so the weights are the plain path's at any ratio (384 -> 27, 360 ->
25, 27 -> 384 ...).

``MappingLoss`` returns what ``UncertaintyLossOut`` holds: ``total``
differentiable in the render's colour and depth, the two exposure scalars
and sigma, ``uncer_loss`` in sigma; ``weights_pix``, ``l1_rgb`` and
``l1_depth`` carry no gradient.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..kernels import check as _check, opt_ptr as _opt_ptr, ptr as _ptr
from ..kernels import stream as _stream
from ..ops import ssim as ssim_ops

TX, TY = 32, 16     # the pixel passes' tiles
MAX_W = 2048        # the downsample's row buffer
SSIM_WINDOW = 11    # the standard SSIM's window; the tile's halo
MAX_MEDIAN = 7      # the median pool's largest window side
_RESAMPLE = {"bilinear": ssim_ops.resample_bilinear,
             "bicubic": ssim_ops.resample_bicubic}


class AxisTable(NamedTuple):
    start: torch.Tensor    # (n_out,) int32: first input read
    weights: torch.Tensor  # (n_out, taps) float32, zeros past the span
    taps: int


class LossParams(NamedTuple):
    window: int          # the components' SSIM window (odd, <= 11)
    median: int          # the median pool's side
    init: bool           # img_ab is the render itself
    use_ssim: bool       # the standard SSIM term
    thr_rgb: float
    data_rate: float
    ssim_weight: float
    alpha: float
    lambda_dssim: float
    ssim_mult: float
    depth_mult: float
    opacity_th: float


def axis_weights(n_in: int, n_out: int, mode: str, device) -> torch.Tensor:
    """(n_out, n_in): the weights of ``ops/ssim.py``'s antialiased resample
    from n_in to n_out samples along one axis, read off an identity basis
    put through the same call."""
    eye = torch.eye(n_in, dtype=torch.float32, device=device)
    return _RESAMPLE[mode](eye, (n_out, n_in))


@functools.lru_cache(maxsize=None)
def axis_table(n_in: int, n_out: int, mode: str, device) -> AxisTable:
    """``axis_weights`` kept as each output's contiguous span of nonzero
    weights, padded to the widest (the span's start moved back where it
    would pass the end, with zero weights)."""
    dense = axis_weights(n_in, n_out, mode, device).cpu()
    nz = (dense != 0).to(torch.int8)
    first = nz.argmax(1)
    last = n_in - 1 - nz.flip(1).argmax(1)
    taps = int((last - first + 1).max())
    start = torch.clamp(first, max=n_in - taps)
    weights = torch.gather(dense, 1, start[:, None] + torch.arange(taps))
    return AxisTable(start.to(torch.int32).to(device),
                     weights.contiguous().to(device), taps)


@functools.lru_cache(maxsize=None)
def gauss_taps(window: int, device) -> torch.Tensor:
    """The standard SSIM's 11 Gaussian taps, then the components' window's,
    as ``ops/ssim.py`` makes them."""
    g = np.concatenate([
        ssim_ops._gaussian_kernel(SSIM_WINDOW, ssim_ops.GAUSSIAN_SIGMA),
        ssim_ops._gaussian_kernel(window, ssim_ops.GAUSSIAN_SIGMA)])
    return torch.from_numpy(g).to(device)


def _blocks(H, W):
    return -(-W // TX) * -(-H // TY)


def _check_in(name, x, shape, dev):
    _check(name, x, torch.float32, shape, dev, align=4)


def mapping_loss_fwd(img, depth, gt, ref, sigma, opac, exp_a, exp_b, med,
                     p: LossParams):
    """M1. img, gt (H, W, 3), depth, ref, opac (H, W), sigma (h, w), exp_a,
    exp_b, med () (exp_* None at initialization) -> (total (), uncer (h, w),
    weights (H, W), l1_rgb (H, W, 3), l1_depth (H, W), coef (9, H, W) or
    None, sums (1,), du (h, w)): the loss, its outputs, and what M2
    reads."""
    if img.device.type != "cuda":
        raise ValueError(f"mapping_loss_fwd: unsupported device {img.device}")
    dev = img.device
    H, W = img.shape[:2]
    h, w = sigma.shape
    for name, x, shape in (("img", img, (H, W, 3)), ("depth", depth, (H, W)),
                           ("gt", gt, (H, W, 3)), ("ref", ref, (H, W)),
                           ("sigma", sigma, (h, w)), ("opac", opac, (H, W)),
                           ("med", med, ())):
        _check_in(name, x, shape, dev)
    if not p.init:
        _check_in("exp_a", exp_a, (), dev)
        _check_in("exp_b", exp_b, (), dev)
    if W > MAX_W:
        raise ValueError(f"mapping_loss_fwd: width {W} > {MAX_W}")
    if p.window % 2 == 0 or not 0 < p.window <= SSIM_WINDOW:
        raise ValueError(f"mapping_loss_fwd: SSIM window {p.window} is not "
                         f"odd and at most {SSIM_WINDOW}")
    if not 0 < p.median <= MAX_MEDIAN:
        raise ValueError(f"mapping_loss_fwd: median window {p.median} > "
                         f"{MAX_MEDIAN}")
    # the upsample of sigma, the bilinear and the bicubic downsamples
    tabs = [axis_table(n_in, n_out, mode, dev) for n_in, n_out, mode in (
        (h, H, "bilinear"), (w, W, "bilinear"), (H, h, "bilinear"),
        (W, w, "bilinear"), (H, h, "bicubic"), (W, w, "bicubic"))]
    f32 = dict(dtype=torch.float32, device=dev)
    total = torch.empty((), **f32)
    uncer = torch.empty(h, w, **f32)
    weights = torch.empty(H, W, **f32)
    l1_rgb = torch.empty(H, W, 3, **f32)
    l1_depth = torch.empty(H, W, **f32)
    coef = torch.empty(9, H, W, **f32) if p.use_ssim else None
    sums = torch.empty(1, **f32)
    du = torch.empty(h, w, **f32)
    slm = torch.empty(H, W, **f32)
    part = torch.empty(_blocks(H, W), 4, **f32)
    small = torch.empty(4, h, w, **f32)
    lib = kernels.library()
    with torch.cuda.device(dev):
        err = lib.mapping_loss_fwd(
            _ptr(img), _ptr(depth), _ptr(gt), _ptr(ref), _ptr(sigma),
            _ptr(opac), _opt_ptr(exp_a), _opt_ptr(exp_b), _ptr(med),
            _ptr(gauss_taps(p.window, dev)),
            *(q for t in tabs for q in (_ptr(t.start), _ptr(t.weights))),
            _ptr(l1_rgb), _ptr(l1_depth), _ptr(weights), _ptr(uncer),
            _ptr(du), _ptr(total), _ptr(sums), _ptr(slm), _opt_ptr(coef),
            _ptr(part), _ptr(small), H, W, h, w, p.window, p.median,
            int(p.init), int(p.use_ssim), *(t.taps for t in tabs),
            p.thr_rgb, p.data_rate, p.ssim_weight, p.alpha, 1.0 - p.alpha,
            p.lambda_dssim, p.ssim_mult, p.depth_mult, p.opacity_th,
            _stream(dev))
    if err:
        raise RuntimeError(f"mapping_loss_fwd launch failed: CUDA error {err}")
    mapping_loss_fwd.launches += 1
    return total, uncer, weights, l1_rgb, l1_depth, coef, sums, du


def mapping_loss_bwd(img, depth, gt, ref, exp_a, exp_b, med, weights, coef,
                     sums, du, g_total, g_uncer, p: LossParams,
                     need_exp=True, need_sigma=True):
    """M2. M1's inputs and what it kept, the incoming gradients g_total ()
    and g_uncer (h, w) or None -> (g_img (H, W, 3), g_depth (H, W), g_exp
    (2,) or None, g_sigma (h, w) or None)."""
    if img.device.type != "cuda":
        raise ValueError(f"mapping_loss_bwd: unsupported device {img.device}")
    dev = img.device
    H, W = img.shape[:2]
    h, w = du.shape
    for name, x, shape in (("img", img, (H, W, 3)), ("depth", depth, (H, W)),
                           ("gt", gt, (H, W, 3)), ("ref", ref, (H, W)),
                           ("med", med, ()), ("weights", weights, (H, W)),
                           ("sums", sums, (1,)), ("du", du, (h, w)),
                           ("g_total", g_total, ())):
        _check_in(name, x, shape, dev)
    if p.use_ssim:
        _check_in("coef", coef, (9, H, W), dev)
    if g_uncer is not None:
        _check_in("g_uncer", g_uncer, (h, w), dev)
    need_exp = need_exp and not p.init
    if need_exp:
        _check_in("exp_a", exp_a, (), dev)
        _check_in("exp_b", exp_b, (), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    g_img = torch.empty(H, W, 3, **f32)
    g_depth = torch.empty(H, W, **f32)
    g_exp = torch.empty(2, **f32) if need_exp else None
    g_sigma = torch.empty(h, w, **f32) if need_sigma else None
    part = torch.empty(_blocks(H, W), 2, **f32)
    lib = kernels.library()
    with torch.cuda.device(dev):
        err = lib.mapping_loss_bwd(
            _ptr(img), _ptr(depth), _ptr(gt), _ptr(ref), _opt_ptr(exp_a),
            _opt_ptr(exp_b), _ptr(med), _ptr(gauss_taps(p.window, dev)),
            _ptr(weights), _opt_ptr(coef), _ptr(sums), _ptr(du),
            _ptr(g_total), _opt_ptr(g_uncer), _ptr(g_img), _ptr(g_depth),
            _opt_ptr(g_exp), _opt_ptr(g_sigma), _ptr(part), H, W, h, w,
            int(p.init), int(p.use_ssim), p.thr_rgb, p.alpha, 1.0 - p.alpha,
            p.lambda_dssim, p.ssim_mult, _stream(dev))
    if err:
        raise RuntimeError(f"mapping_loss_bwd launch failed: CUDA error {err}")
    mapping_loss_bwd.launches += 1
    return g_img, g_depth, g_exp, g_sigma


mapping_loss_fwd.launches = 0
mapping_loss_bwd.launches = 0


class MappingLoss(torch.autograd.Function):
    """M1 forward, M2 backward, on CUDA tensors. Inputs (img, depth, sigma,
    exp_a, exp_b, gt, ref, opac, med, params); outputs (total, uncer_loss,
    weights_pix, l1_rgb, l1_depth), the last three not differentiable."""

    @staticmethod
    def forward(ctx, img, depth, sigma, exp_a, exp_b, gt, ref, opac, med,
                params):
        total, uncer, weights, l1_rgb, l1_depth, coef, sums, du = (
            mapping_loss_fwd(img, depth, gt, ref, sigma, opac, exp_a, exp_b,
                             med, params))
        ctx.save_for_backward(img, depth, gt, ref, exp_a, exp_b, med, weights,
                              coef, sums, du)
        ctx.params = params
        ctx.mark_non_differentiable(weights, l1_rgb, l1_depth)
        ctx.set_materialize_grads(False)
        return total, uncer, weights, l1_rgb, l1_depth

    @staticmethod
    def backward(ctx, g_total, g_uncer, *_):
        (img, depth, gt, ref, exp_a, exp_b, med, weights, coef, sums,
         du) = ctx.saved_tensors
        ng = ctx.needs_input_grad
        if g_total is None:
            g_total = torch.zeros((), device=img.device)
        g_img, g_depth, g_exp, g_sigma = mapping_loss_bwd(
            img, depth, gt, ref, exp_a, exp_b, med, weights, coef, sums, du,
            g_total.contiguous(),
            None if g_uncer is None else g_uncer.contiguous(), ctx.params,
            need_exp=ng[3] or ng[4], need_sigma=ng[2])
        g_a, g_b = (None, None) if g_exp is None else (g_exp[0], g_exp[1])
        return (g_img if ng[0] else None, g_depth if ng[1] else None, g_sigma,
                g_a, g_b, None, None, None, None, None)
