"""Keyframe store; torch port of ``wildgs_slam_tpu/slam/keyframe_store.py``.

The JAX ``KeyframeStore`` is an immutable pytree; here it is a dataclass of
the same tensors, updated in place. One store is shared by the frontend
(poses, disparities, DROID features, BA weights, depth masks) and the
mapper (poses, full-resolution disparities, metric-prior depths, masks).
Large per-keyframe payloads the mapper reads on the host (images, DINO
features) live in ``SlamState``, as there.

The geometry helpers wrap ``ops/projective.py``, ``ops/dba.py`` and
``models/droid_net.py``. The JAX package pads frame lists to compile-size
buckets; here they are plain index tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch
import torch.nn.functional as F

from ..models import droid_net
from ..ops import dba, lie, projective


@dataclass
class KeyframeStore:
    """h, w are 1/8 resolution; H, W full resolution; B the buffer."""

    timestamp: torch.Tensor         # (B,)
    poses: torch.Tensor             # (B, 7) world->camera SE3
    disps: torch.Tensor             # (B, h, w) inverse depths (init 1.0)
    disps_up: torch.Tensor          # (B, H, W) frontend inverse depths
    mono_disps: torch.Tensor        # (B, h, w) metric-prior inverse depths
    mono_disps_up: torch.Tensor     # (B, H, W)
    mono_mask_up: torch.Tensor      # (B, H, W) bool: mono depth consistent
    valid_depth_mask: torch.Tensor  # (B, H, W) bool (multiview filter)
    valid_depth_mask_small: torch.Tensor  # (B, h, w) bool
    depth_scale: torch.Tensor       # (B,)
    depth_shift: torch.Tensor       # (B,)
    intrinsics: torch.Tensor        # (4,) at 1/8 resolution (fx fy cx cy)
    fmaps: torch.Tensor             # (B, h, w, 128) matching features
    nets: torch.Tensor              # (B, h, w, 128) GRU hidden states
    inps: torch.Tensor              # (B, h, w, 128) context features
    uncertainties_inv: torch.Tensor  # (B, h, w) BA weights in [0, 1]
    dirty: torch.Tensor             # (B,) bool: valid_depth_mask stale


PER_FRAME = tuple(f.name for f in fields(KeyframeStore)
                  if f.name != "intrinsics")


def create(buffer: int, ht: int, wd: int, intrinsics_full, down_scale: int = 8,
           device="cuda") -> KeyframeStore:
    h, w = ht // down_scale, wd // down_scale

    def z(*s, dtype=torch.float32):
        return torch.zeros(s, dtype=dtype, device=device)

    def o(*s, dtype=torch.float32):
        return torch.ones(s, dtype=dtype, device=device)
    poses = z(buffer, 7)
    poses[:, 6] = 1.0
    intr = torch.as_tensor(np.asarray(intrinsics_full, np.float32),
                           device=device) / down_scale
    return KeyframeStore(
        timestamp=z(buffer), poses=poses, disps=o(buffer, h, w),
        disps_up=z(buffer, ht, wd), mono_disps=z(buffer, h, w),
        mono_disps_up=z(buffer, ht, wd),
        mono_mask_up=o(buffer, ht, wd, dtype=torch.bool),
        valid_depth_mask=z(buffer, ht, wd, dtype=torch.bool),
        valid_depth_mask_small=z(buffer, h, w, dtype=torch.bool),
        depth_scale=z(buffer), depth_shift=z(buffer), intrinsics=intr,
        fmaps=z(buffer, h, w, 128), nets=z(buffer, h, w, 128),
        inps=z(buffer, h, w, 128), uncertainties_inv=o(buffer, h, w),
        dirty=z(buffer, dtype=torch.bool))


def slice_hw(ht: int, wd: int, down_scale: int = 8):
    """The pixel-centre subsampling that takes full-resolution maps to 1/8
    resolution."""
    s = down_scale
    return (slice(s // 2 - 1, ht // s * s + 1, s),
            slice(s // 2 - 1, wd // s * s + 1, s))


def _inv_pos(x):
    return torch.where(x > 0, 1.0 / torch.where(x > 0, x, torch.ones_like(x)),
                       torch.zeros_like(x))


@torch.no_grad()
def append(store: KeyframeStore, index: int, timestamp, pose=None, disp=None,
           mono_depth_up=None, fmap=None, net=None, inp=None,
           down_scale: int = 8) -> KeyframeStore:
    """Write keyframe `index`; mono_depth_up is a full-resolution metric
    DEPTH map (stored inverted, also at 1/8 resolution)."""
    dev = store.poses.device

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)
    store.timestamp[index] = timestamp
    if pose is not None:
        store.poses[index] = t(pose)
    if disp is not None:
        store.disps[index] = t(disp)
    if mono_depth_up is not None:
        d = t(mono_depth_up)
        sh, sw = slice_hw(*d.shape, down_scale)
        store.mono_disps[index] = _inv_pos(d[sh, sw])
        store.mono_disps_up[index] = _inv_pos(d)
    for name, x in (("fmaps", fmap), ("nets", net), ("inps", inp)):
        if x is not None:
            getattr(store, name)[index] = t(x)
    return store


@torch.no_grad()
def remove_keyframe(store: KeyframeStore, ix: int) -> KeyframeStore:
    """Shift every per-frame buffer down over slot ix (the last slot takes
    slot 0's contents, as the JAX roll does)."""
    for name in PER_FRAME:
        a = getattr(store, name)
        a[ix:] = torch.cat([a[ix + 1:], a[:1]])
    return store


def reproject(store: KeyframeStore, ii, jj):
    return projective.projective_transform(store.poses, store.disps,
                                           store.intrinsics, ii, jj)


def distance(store: KeyframeStore, ii, jj, beta=0.3, bidirectional=True):
    fn = (dba.frame_distance_bidirectional if bidirectional
          else dba.frame_distance)
    return fn(store.poses, store.disps, store.intrinsics, ii, jj, beta)


@torch.no_grad()
def ba(store: KeyframeStore, target, weight, eta, ii, jj, t0, t1, iters=2,
       lm=1e-4, ep=0.1, motion_only=False, metric_depth_reg=True,
       uncertainty_aware=True, alpha=0.05) -> KeyframeStore:
    """Uncertainty-weighted DBA over the store, in place."""
    if uncertainty_aware:
        weight = weight * store.uncertainties_inv[ii][..., None]
    sensor = sensor_valid = None
    if metric_depth_reg:
        sh, sw = slice_hw(*store.mono_disps_up.shape[-2:])
        sensor = store.mono_disps
        sensor_valid = store.mono_mask_up[:, sh, sw]
    poses, disps = dba.ba(
        store.poses, store.disps, store.intrinsics, target, weight, eta, ii,
        jj, t0, t1, iters=iters, cfg=dba.BAConfig(lm=lm, ep=ep, alpha=alpha),
        sensor_disps=sensor, sensor_valid=sensor_valid,
        motion_only=motion_only)
    store.poses.copy_(poses)
    store.disps.copy_(disps)
    return store


@torch.no_grad()
def upsample(store: KeyframeStore, ix, upmask) -> KeyframeStore:
    """Convex-upsample the disparities of frames ix (upmask (n, h, w,
    576))."""
    store.disps_up[ix] = droid_net.upsample_disp(store.disps[ix], upmask)
    return store


def resize_bilinear(x: torch.Tensor, shape) -> torch.Tensor:
    """(N, h, w) or (N, h, w, C) -> the same at `shape` (H, W), with
    ``jax.image.resize(..., "bilinear")`` semantics (half-pixel centres,
    antialiased when shrinking)."""
    chan = x.dim() == 4
    y = x.permute(0, 3, 1, 2) if chan else x[:, None]
    y = F.interpolate(y, size=tuple(shape), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1) if chan else y[:, 0]


@torch.no_grad()
def update_valid_depth_mask(store: KeyframeStore, n_frames: int,
                            multiview_thresh: float, visible_num: int,
                            up=True, frames=None) -> KeyframeStore:
    """Two-view consistency depth filter over `frames` (default: every
    live frame): a pixel is valid when at least `visible_num` of its six
    temporal neighbours agree on its depth and it is nearer than three
    times the frame's median valid depth. Refreshed frames are no longer
    dirty."""
    F_ = store.poses.shape[0]
    if frames is None:
        frames = np.arange(min(F_, max(n_frames, 1)))
    frames = np.asarray(frames, np.int64)
    frames = frames[(frames < n_frames) & (frames < F_)]
    if len(frames) == 0:
        return store
    dev = store.poses.device
    idx = torch.as_tensor(frames, device=dev)
    disps = store.disps_up if up else store.disps
    intr = store.intrinsics * (8.0 if up else 1.0)
    depths = 1.0 / torch.clamp(disps[idx], min=1e-8)
    thresh = multiview_thresh * depths.mean(dim=(1, 2))
    count = dba.depth_filter_count(store.poses, disps, intr, idx, thresh)
    multiview = count >= visible_num
    d_nan = torch.where(multiview, depths, torch.full_like(depths, np.nan))
    med = torch.nanquantile(d_nan.reshape(len(frames), -1), 0.5, dim=1,
                            interpolation="midpoint")
    med = torch.nan_to_num(med, nan=float("inf"))
    masks = multiview & (depths < 3 * med[:, None, None])
    if up:
        store.valid_depth_mask[idx] = masks
        store.dirty[idx] = False
    else:
        store.valid_depth_mask_small[idx] = masks
    return store


@torch.no_grad()
def update_uncertainties(store: KeyframeStore, uncer_apply, dino_feats, idx,
                         train_frac_fix: float) -> KeyframeStore:
    """Run the uncertainty MLP over the DINO features of frames `idx` and
    refresh the BA weights: uncertainties_inv = clamp(0.5 / σ'^2, 0, 1),
    σ' the annealed uncertainty resampled to pixels and subsampled to 1/8
    resolution."""
    from .losses import compute_bias_factor

    sigma = uncer_apply(dino_feats)                        # (n, h14, w14)
    ht, wd = store.mono_disps_up.shape[-2:]
    sigma = torch.clamp(sigma, min=0.1) + 1e-3
    big = resize_bilinear(sigma, (ht, wd))
    sh, sw = slice_hw(ht, wd)
    small = big[:, sh, sw]
    data_rate = 1 + 1 * compute_bias_factor(train_frac_fix, 0.8)
    small = (small - 0.1) * data_rate + 0.1
    store.uncertainties_inv[idx] = torch.clamp(0.5 / small ** 2, 0.0, 1.0)
    return store


@torch.no_grad()
def filter_high_err_mono_depth(store: KeyframeStore, idx: int, ref_frames,
                               dino_feats_idx, dino_feats_refs,
                               sim_threshold: float = 0.9,
                               rel_err_threshold: float = 0.02
                               ) -> KeyframeStore:
    """Cross-view mono-depth vote: each reference frame's mono depth is
    reprojected into frame `idx`; where the DINO features match (cosine >
    0.9) the reprojected and local inverse depths are compared, and pixels
    with at most one accurate and at least one inaccurate vote lose their
    mono prior. dino_feats_idx (H, W, D) and dino_feats_refs (R, H, W, D)
    are upsampled to pixels."""
    ht, wd = store.mono_disps_up.shape[-2:]
    intr_full = store.intrinsics * 8.0
    jj = torch.as_tensor(ref_frames, device=store.poses.device)
    R = jj.shape[0]
    intr = intr_full.expand(R, 4)
    X0 = projective.iproj(store.mono_disps_up[jj], intr)
    Gji = lie.se3_mul(store.poses[idx][None], lie.se3_inv(store.poses[jj]))
    X1 = lie.se3_act4(Gji[:, None, None, :], X0)
    x1, _ = projective.proj(X1, intr, return_depth=True)
    xi = torch.round(x1[..., 0]).to(torch.int64)
    yi = torch.round(x1[..., 1]).to(torch.int64)
    valid = ((xi >= 0) & (xi < wd) & (yi >= 0) & (yi < ht)
             & (X1[..., 2] > 0) & (store.mono_disps_up[jj] > 0))
    xi = torch.clamp(xi, 0, wd - 1)
    yi = torch.clamp(yi, 0, ht - 1)

    def unit(f):
        return f / torch.clamp(torch.linalg.norm(f, dim=-1, keepdim=True),
                               min=1e-8)
    fi = unit(dino_feats_idx)
    # one reference frame at a time bounds the (H, W, D) temporaries
    sim = torch.stack([(unit(dino_feats_refs[r]) * fi[yi[r], xi[r]]).sum(-1)
                       for r in range(R)])                 # (R, H, W)
    match = valid & (sim > sim_threshold)
    proj_disp = x1[..., 2]
    i_disp = store.mono_disps_up[idx][yi, xi]
    err = (1.0 / torch.clamp(proj_disp, min=1e-8)
           - 1.0 / torch.clamp(i_disp, min=1e-8)).abs() * proj_disp
    correct = match & (err < rel_err_threshold)
    incorrect = match & ~(err < rel_err_threshold)
    flat = (yi * wd + xi).reshape(-1)
    acc = torch.zeros(ht * wd, device=flat.device).index_add_(
        0, flat, correct.reshape(-1).to(torch.float32)).reshape(ht, wd)
    inacc = torch.zeros(ht * wd, device=flat.device).index_add_(
        0, flat, incorrect.reshape(-1).to(torch.float32)).reshape(ht, wd)
    bad = (acc <= 1) & (inacc > 0) & (store.mono_disps_up[idx] > 0)
    store.mono_mask_up[idx] &= ~bad
    return store


@torch.no_grad()
def normalize(store: KeyframeStore, n_frames: int) -> KeyframeStore:
    """Scale the first n_frames so their mean disparity is 1: disparities
    divided by it, pose translations multiplied by it, in place."""
    n = max(1, n_frames)
    s = store.disps[:n_frames].sum() / (n * store.disps.shape[1]
                                        * store.disps.shape[2])
    store.disps[:n_frames] /= s
    store.poses[:n_frames, :3] *= s
    return store


def get_depth_and_pose(store: KeyframeStore, index: int,
                       metric_depth_reg: bool = True):
    """Mapper-side view: (depth (H, W), mask (H, W), c2w (7,))."""
    if metric_depth_reg:
        disp = store.mono_disps_up[index]
        depth = _inv_pos(disp)
        mask = torch.ones_like(disp, dtype=torch.bool)
    else:
        disp = store.disps_up[index]
        depth = 1.0 / torch.clamp(disp, min=1e-8)
        mask = store.valid_depth_mask[index]
    return depth, mask, lie.se3_inv(store.poses[index])
