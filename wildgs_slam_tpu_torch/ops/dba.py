"""Dense bundle adjustment; torch port of ``wildgs_slam_tpu/ops/dba.py``.

One Gauss-Newton iteration over poses and per-pixel inverse depths, with
the semantics of the JAX ``ba_iteration``: residual weights
0.001 · valid · weight, depth damping C += eta (or, with a metric-depth
prior, m·alpha + (1-m)·eta and w -= m·alpha·(disps - sensor_disps)), pose
damping diag·(1 + lm) + ep, depth updates only for frames that are the
source of an edge, left-multiplied pose retraction and the disparity clamp
at 1e-5.

The pose window is [t0, t1): slot p is frame t0 + p; edges whose end lies
outside it do not enter the pose system. The Schur complement is taken
directly: per source frame k, the edges' depth-coupling blocks are summed
into a (P, 6, H*W) matrix E_k by pose slot, and S = H - Σ_k E_k Q_k E_kᵀ
(Q = 1/C), one batched product; it equals the JAX per-frame group scan,
which sums the same outer products pair by pair. The solve is a Cholesky;
a system that is not positive definite yields a zero pose step, as the
JAX ``cho_solve`` NaNs do after ``nan_to_num``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie, projective


class BAConfig(NamedTuple):
    lm: float = 1e-4
    ep: float = 0.1
    alpha: float = 0.05       # metric-depth prior mixing
    min_disp: float = 1e-5


def _build_per_edge(poses, disps, intrinsics, target, weight, ii, jj):
    """Per-edge Hessian blocks, gradients and depth couplings."""
    E = ii.shape[0]
    H, W = disps.shape[-2:]
    HW = H * W
    coords, valid, (Ji, Jj, Jz) = projective.projective_transform(
        poses, disps, intrinsics, ii, jj, jacobian=True)
    r = (target - coords).reshape(E, HW * 2)
    w = 0.001 * (valid * weight).reshape(E, HW * 2)
    Ji = Ji.reshape(E, HW * 2, 6)
    Jj = Jj.reshape(E, HW * 2, 6)
    wJi = w[..., None] * Ji
    wJj = w[..., None] * Jj
    blocks = dict(
        Hii=torch.einsum("epd,epf->edf", wJi, Ji),
        Hij=torch.einsum("epd,epf->edf", wJi, Jj),
        Hji=torch.einsum("epd,epf->edf", wJj, Ji),
        Hjj=torch.einsum("epd,epf->edf", wJj, Jj),
        vi=torch.einsum("epd,ep->ed", wJi, r),
        vj=torch.einsum("epd,ep->ed", wJj, r))
    Jz2 = Jz.reshape(E, HW, 2)
    w2 = w.reshape(E, HW, 2)
    r2 = r.reshape(E, HW, 2)
    blocks["Ei"] = torch.einsum("ehc,ehcd->edh", w2 * Jz2,
                                Ji.reshape(E, HW, 2, 6))
    blocks["Ej"] = torch.einsum("ehc,ehcd->edh", w2 * Jz2,
                                Jj.reshape(E, HW, 2, 6))
    blocks["wk"] = (w2 * r2 * Jz2).sum(-1)
    blocks["Ck"] = (w2 * Jz2 * Jz2).sum(-1)
    return blocks


def _cho_solve(S, b):
    """Solve S x = b by Cholesky; zero where S is not positive definite."""
    L, info = torch.linalg.cholesky_ex(S)
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(info == 0, torch.nan_to_num(x), torch.zeros_like(x))


def _retract_poses(poses, dx, t0, t1):
    xi = torch.zeros(poses.shape[0], 6, dtype=poses.dtype,
                     device=poses.device)
    xi[t0:t1] = dx
    return lie.se3_retr(poses, xi)


def ba_iteration(poses, disps, intrinsics, target, weight, eta, ii, jj, t0,
                 t1, cfg: BAConfig = BAConfig(), sensor_disps=None,
                 sensor_valid=None, motion_only=False):
    """One Gauss-Newton iteration. poses (F, 7), disps (F, H, W),
    intrinsics (4,), target/weight (E, H, W, 2), eta (F, H, W), ii/jj (E,)
    int64, pose window [t0, t1). Returns (poses, disps)."""
    F_, H, W = disps.shape
    HW = H * W
    E = ii.shape[0]
    P = t1 - t0
    dev, dt = disps.device, disps.dtype
    b = _build_per_edge(poses, disps, intrinsics,
                        target.reshape(E, H, W, 2),
                        weight.reshape(E, H, W, 2), ii, jj)

    # pose slots; slot P collects the edge ends outside the window
    pi, pj = ii - t0, jj - t0
    pi = torch.where((pi >= 0) & (pi < P), pi, P)
    pj = torch.where((pj >= 0) & (pj < P), pj, P)

    Hmat = torch.zeros((P + 1) * (P + 1), 6, 6, dtype=dt, device=dev)
    for a, c, blk in ((pi, pi, "Hii"), (pi, pj, "Hij"), (pj, pi, "Hji"),
                      (pj, pj, "Hjj")):
        Hmat.index_add_(0, a * (P + 1) + c, b[blk])
    Hmat = Hmat.reshape(P + 1, P + 1, 6, 6)[:P, :P]
    vvec = torch.zeros(P + 1, 6, dtype=dt, device=dev)
    vvec.index_add_(0, pi, b["vi"]).index_add_(0, pj, b["vj"])
    vvec = vvec[:P]

    diag = torch.arange(P, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    Hmat[diag, diag] += cfg.ep * eye6 + cfg.lm * Hmat[diag, diag] * eye6

    if motion_only:
        S = Hmat.transpose(1, 2).reshape(P * 6, P * 6)
        dx = _cho_solve(S, vvec.reshape(P * 6)).reshape(P, 6)
        return _retract_poses(poses, dx, t0, t1), disps

    # depth diagonal and right-hand side, summed over each source frame
    Csum = torch.zeros(F_, HW, dtype=dt, device=dev).index_add_(0, ii, b["Ck"])
    wsum = torch.zeros(F_, HW, dtype=dt, device=dev).index_add_(0, ii, b["wk"])
    has_edge = torch.zeros(F_, dtype=torch.bool, device=dev)
    has_edge[ii] = True
    eta_flat = eta.reshape(F_, HW)
    if sensor_disps is None:
        C = Csum + eta_flat
        wd = wsum
    else:
        m = (sensor_valid & (sensor_disps > 0)).reshape(F_, HW).to(dt)
        C = Csum + m * cfg.alpha + (1 - m) * eta_flat
        wd = wsum - m * cfg.alpha * (disps.reshape(F_, HW)
                                     - sensor_disps.reshape(F_, HW))
    Q = 1.0 / C

    # Schur complement over the source frames
    frames, inv = torch.unique(ii, return_inverse=True)
    U = frames.shape[0]
    Eblk = torch.zeros(U * (P + 1), 6, HW, dtype=dt, device=dev)
    Eblk.index_add_(0, inv * (P + 1) + pi, b["Ei"])
    Eblk.index_add_(0, inv * (P + 1) + pj, b["Ej"])
    Eblk = Eblk.reshape(U, P + 1, 6, HW)[:, :P].reshape(U, P * 6, HW)
    Qf = Q[frames]
    S = (Hmat.transpose(1, 2).reshape(P * 6, P * 6)
         - torch.einsum("kah,kbh->ab", Eblk * Qf[:, None, :], Eblk))
    rhs = vvec.reshape(P * 6) - torch.einsum("kah,kh->a", Eblk,
                                             Qf * wd[frames])
    dx = _cho_solve(S, rhs).reshape(P, 6)

    # depth back-substitution: dz = Q (wd - Eᵀ dx)
    dx_pad = torch.cat([dx, torch.zeros(1, 6, dtype=dt, device=dev)])
    Et_dx_e = (torch.einsum("edh,ed->eh", b["Ei"], dx_pad[pi])
               + torch.einsum("edh,ed->eh", b["Ej"], dx_pad[pj]))
    Et_dx = torch.zeros(F_, HW, dtype=dt, device=dev).index_add_(0, ii,
                                                                 Et_dx_e)
    dz = Q * (wd - Et_dx)
    dz = torch.nan_to_num(torch.where(has_edge[:, None], dz,
                                      torch.zeros_like(dz)))
    poses = _retract_poses(poses, dx, t0, t1)
    disps = torch.clamp(disps + dz.reshape(F_, H, W), min=cfg.min_disp)
    return poses, disps


def ba(poses, disps, intrinsics, target, weight, eta, ii, jj, t0, t1,
       iters: int = 2, cfg: BAConfig = BAConfig(), sensor_disps=None,
       sensor_valid=None, motion_only=False):
    """`iters` Gauss-Newton iterations."""
    for _ in range(iters):
        poses, disps = ba_iteration(poses, disps, intrinsics, target, weight,
                                    eta, ii, jj, t0, t1, cfg, sensor_disps,
                                    sensor_valid, motion_only)
    return poses, disps


# ---------------------------------------------------------------------------
# frame distance and the multiview depth filter
# ---------------------------------------------------------------------------

def frame_distance(poses, disps, intrinsics, ii, jj, beta: float = 0.3):
    """Mean induced flow from frame ii to jj, blending the full SE3 flow
    (weight beta) with the translation-only flow (1 - beta); 1000 where
    fewer than 75% of the pixels are valid."""
    H, W = disps.shape[-2:]
    grid = projective.coords_grid(H, W, disps.dtype, disps.device)
    intr = intrinsics.expand(ii.shape + (4,))
    Gij = lie.se3_mul(poses[jj], lie.se3_inv(poses[ii]))
    X0 = projective.iproj(disps[ii], intr)
    X1 = lie.se3_act4(Gij[:, None, None, :], X0)
    c1, _ = projective.proj(X1, intr)
    d1 = torch.linalg.norm(c1 - grid, dim=-1)
    v1 = X1[..., 2] > projective.MIN_DEPTH
    Xt = torch.cat([X0[..., :3] + X0[..., 3:4] * Gij[:, None, None, :3],
                    X0[..., 3:]], dim=-1)
    c2, _ = projective.proj(Xt, intr)
    d2 = torch.linalg.norm(c2 - grid, dim=-1)
    v2 = Xt[..., 2] > projective.MIN_DEPTH
    zero = torch.zeros((), dtype=disps.dtype, device=disps.device)
    accum = (beta * torch.where(v1, d1, zero).sum((1, 2))
             + (1 - beta) * torch.where(v2, d2, zero).sum((1, 2)))
    valid = (beta * v1.sum((1, 2)).to(disps.dtype)
             + (1 - beta) * v2.sum((1, 2)).to(disps.dtype))
    frac = valid / (H * W + 1e-8)
    return torch.where(frac < 0.75, torch.full_like(accum, 1000.0),
                       accum / torch.clamp(valid, min=1e-8))


def frame_distance_bidirectional(poses, disps, intrinsics, ii, jj,
                                 beta: float = 0.3):
    """0.5 (d(i -> j) + d(j -> i))."""
    return 0.5 * (frame_distance(poses, disps, intrinsics, ii, jj, beta)
                  + frame_distance(poses, disps, intrinsics, jj, ii, beta))


NEIGHBOUR_OFFSETS = (-1, -2, -3, 3, 4, 5)


def depth_filter_count(poses, disps, intrinsics, index, thresh):
    """For each pixel of each frame in `index` (n,), count how many of its
    six temporal neighbours {i-3, i-2, i-1, i+3, i+4, i+5} see a consistent
    depth (|1/reprojected disparity - 1/observed| < thresh (n,), in front of
    the camera, in bounds). Returns (n, H, W) int64."""
    F_, H, W = disps.shape
    offs = torch.tensor(NEIGHBOUR_OFFSETS, device=disps.device)
    js = index[:, None] + offs[None]                       # (n, 6)
    j_ok = (js >= 0) & (js < F_)
    jsc = torch.clamp(js, 0, F_ - 1)
    X0 = projective.iproj(disps[index], intrinsics)        # (n, H, W, 4)
    Gij = lie.se3_mul(poses[jsc], lie.se3_inv(poses[index])[:, None])
    X1 = lie.se3_act4(Gij[:, :, None, None, :], X0[:, None])
    coords, _ = projective.proj(X1, intrinsics)
    x1, y1, z1 = coords[..., 0], coords[..., 1], X1[..., 2]
    d1 = X1[..., 3] / torch.where(z1 < 1e-6, torch.full_like(z1, 1e-6), z1)
    xi = torch.clamp(torch.round(x1).to(torch.int64), 0, W - 1)
    yi = torch.clamp(torch.round(y1).to(torch.int64), 0, H - 1)
    inb = (x1 >= 0) & (x1 < W) & (y1 >= 0) & (y1 < H) & (z1 > 0)
    dj = disps.reshape(F_, H * W)[jsc[..., None, None], yi * W + xi]
    consistent = inb & ((1.0 / torch.clamp(d1, min=1e-8)
                         - 1.0 / torch.clamp(dj, min=1e-8)).abs()
                        < thresh[:, None, None, None])
    return (consistent & j_ok[..., None, None]).sum(1)
