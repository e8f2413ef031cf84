"""Plain PyTorch reference of the mapper's optimisation step and of its
keyframe seeding.

Written for the benchmark from the published WildGS-SLAM mapping step (the
Inria 3DGS rasterizer's conventions, the uncertainty-aware loss of
WildGS-SLAM, Adam) with the semantics the configuration states: tiles of
16x16 pixels, per-tile lists of ``render_list_capacity`` entries in depth
order with a ``bin_kw`` x ``bin_kw`` tile window per Gaussian, alpha
clamped at 0.99 and skipped under 1/255, termination at transmittance
1e-4, colours and DINO features held in bfloat16, SH degree 0. It
imports nothing of the program: the arithmetic below is written out here,
one plain tensor expression after another, with autograd for the
backward pass, no tiles kept between steps and no kernels.

Everything runs in the precision that the torch flags of the caller give:
the benchmark runs it with TF32 off (float32), and the control runs it with
TF32 on.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

TILE = 16
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
SH_C0 = 0.28209479177387814
EPS32 = float(np.finfo(np.float32).eps)


# --------------------------------------------------------------------------
# rigid motions: (tx, ty, tz, qx, qy, qz, qw) world -> camera
# --------------------------------------------------------------------------

def quat_to_matrix(q):
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def transform(pose, pts):
    """pose (7,) acting on points (N, 3)."""
    return pts @ quat_to_matrix(pose[3:7]).T + pose[:3]


def invert(pose):
    R = quat_to_matrix(pose[3:7])
    q = torch.cat([-pose[3:6], pose[6:7]])
    return torch.cat([-(R.T @ pose[:3]), q])


# --------------------------------------------------------------------------
# the renderer
# --------------------------------------------------------------------------

class Projected(NamedTuple):
    mean2d: torch.Tensor
    depth: torch.Tensor
    conic: torch.Tensor
    color: torch.Tensor
    opacity: torch.Tensor
    radius: torch.Tensor
    valid: torch.Tensor


def project(xyz, scales, quat_xyzw, opacity, f_dc, w2c, intr, hw,
            near=0.2):
    """EWA projection with the Inria conventions: the -0.5 pixel offset,
    the 1.3 tan-fov clamp, the 0.3 dilation, radius ceil(3 sqrt(l1))."""
    H, W = hw
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    t = transform(w2c, xyz)
    tz = t[:, 2]
    tz_safe = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    limx, limy = 1.3 * (0.5 * W / fx), 1.3 * (0.5 * H / fy)
    txz = torch.clamp(t[:, 0] / tz_safe, -limx, limx) * tz_safe
    tyz = torch.clamp(t[:, 1] / tz_safe, -limy, limy) * tz_safe
    zero = torch.zeros_like(tz)
    J = torch.stack([
        torch.stack([fx / tz_safe, zero, -fx * txz / tz_safe ** 2], -1),
        torch.stack([zero, fy / tz_safe, -fy * tyz / tz_safe ** 2], -1)], 1)
    Rcw = quat_to_matrix(w2c[3:7])
    M = quat_to_matrix(quat_xyzw) * scales[:, None, :]        # R diag(s)
    JW = J @ Rcw                                              # (N, 2, 3)
    A = JW @ M                                                # (N, 2, 3)
    cov = A @ A.transpose(1, 2)
    a = cov[:, 0, 0] + 0.3
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + 0.3
    det = a * c - b * b
    det_safe = torch.where(det <= 0, torch.ones_like(det), det)
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], -1)
    with torch.no_grad():
        mid = 0.5 * (a + c)
        lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        radius = torch.ceil(3.0 * torch.sqrt(lam1)).to(torch.int32)
    mean2d = torch.stack([fx * t[:, 0] / tz_safe + cx - 0.5,
                          fy * t[:, 1] / tz_safe + cy - 0.5], -1)
    color = torch.clamp(SH_C0 * f_dc[:, 0, :] + 0.5, min=0.0)
    with torch.no_grad():
        m = mean2d.detach()
        inside = ((m[:, 0] + radius > 0) & (m[:, 0] - radius < W)
                  & (m[:, 1] + radius > 0) & (m[:, 1] - radius < H))
        valid = (tz.detach() > near) & (det.detach() > 0) & inside
        radius = torch.where(valid, radius, torch.zeros_like(radius))
    return Projected(mean2d, tz, conic, color, opacity, radius, valid)


@torch.no_grad()
def tile_lists(mean2d, radius, depth, valid, hw, capacity, kw):
    """Per-tile Gaussian ids, nearest first (ties by id), at most
    `capacity` per tile; each Gaussian enters the tiles of the first kw x
    kw window of its tile bounding box. Returns (ids (T, capacity) with -1
    past the count, counts (T,))."""
    H, W = hw
    th, tw = -(-H // TILE), -(-W // TILE)
    n_tiles = th * tw
    r = radius.to(torch.float32)
    x0 = torch.floor((mean2d[:, 0] - r) / TILE).long()
    x1 = torch.floor((mean2d[:, 0] + r) / TILE).long()
    y0 = torch.floor((mean2d[:, 1] - r) / TILE).long()
    y1 = torch.floor((mean2d[:, 1] + r) / TILE).long()
    gid, tile, dep = [], [], []
    ids_all = torch.arange(mean2d.shape[0], device=mean2d.device)
    for dy in range(kw):
        for dx in range(kw):
            tx, ty = x0 + dx, y0 + dy
            ok = (valid & (tx <= x1) & (ty <= y1) & (tx >= 0) & (tx < tw)
                  & (ty >= 0) & (ty < th))
            gid.append(ids_all[ok])
            tile.append((ty * tw + tx)[ok])
            dep.append(depth[ok])
    gid, tile, dep = torch.cat(gid), torch.cat(tile), torch.cat(dep)
    # order by (tile, depth, id): lexicographic through three stable sorts
    o = torch.argsort(gid, stable=True)
    o = o[torch.argsort(dep[o], stable=True)]
    o = o[torch.argsort(tile[o], stable=True)]
    gid, tile = gid[o], tile[o]
    counts_raw = torch.bincount(tile, minlength=n_tiles)
    starts = torch.cumsum(counts_raw, 0) - counts_raw
    rank = torch.arange(tile.numel(), device=tile.device) - starts[tile]
    keep = rank < capacity
    ids = torch.full((n_tiles, capacity), -1, dtype=torch.long,
                     device=mean2d.device)
    ids[tile[keep], rank[keep]] = gid[keep]
    return ids, torch.clamp(counts_raw, max=capacity)


def composite(ids, proj: Projected, mean2d, hw, chunk=64):
    """Front-to-back blending of every tile's list over its 256 pixels;
    returns colour (H, W, 3), depth (H, W) and alpha (H, W), black
    background."""
    H, W = hw
    th, tw = -(-H // TILE), -(-W // TILE)
    T, K = ids.shape
    dev = mean2d.device
    lin = torch.arange(TILE * TILE, device=dev)
    tiles = torch.arange(T, device=dev)
    px = ((tiles % tw)[:, None] * TILE + lin % TILE).to(torch.float32)
    py = ((tiles // tw)[:, None] * TILE + lin // TILE).to(torch.float32)
    live = ids >= 0
    safe = torch.clamp(ids, min=0)
    T_run = torch.ones(T, TILE * TILE, device=dev)
    rgb = torch.zeros(T, TILE * TILE, 3, device=dev)
    dep = torch.zeros(T, TILE * TILE, device=dev)
    acc = torch.zeros(T, TILE * TILE, device=dev)
    for c0 in range(0, K, chunk):
        cid = safe[:, c0:c0 + chunk]
        clive = live[:, c0:c0 + chunk, None]
        m = mean2d[cid]
        q = proj.conic[cid]
        dx = m[..., 0:1] - px[:, None, :]
        dy = m[..., 1:2] - py[:, None, :]
        power = (-0.5 * (q[..., 0:1] * dx * dx + q[..., 2:3] * dy * dy)
                 - q[..., 1:2] * dx * dy)
        alpha = torch.clamp(proj.opacity[cid][..., None] * torch.exp(power),
                            max=0.99)
        skip = (power > 0) | (alpha < ALPHA_MIN) | ~clive
        alpha = torch.where(skip, torch.zeros_like(alpha), alpha)
        t_after = T_run[:, None, :] * torch.cumprod(1.0 - alpha, 1)
        t_before = torch.cat([T_run[:, None, :], t_after[:, :-1]], 1)
        w = alpha * t_before * (t_after >= T_EPS)
        rgb = rgb + torch.einsum("tkp,tkc->tpc", w, proj.color[cid])
        dep = dep + (w * proj.depth[cid][..., None]).sum(1)
        acc = acc + w.sum(1)
        T_run = t_after[:, -1, :]

    def image(x):
        x = x.reshape((th, tw, TILE, TILE) + tuple(x.shape[2:]))
        x = x.movedim(2, 1).reshape((th * TILE, tw * TILE)
                                    + tuple(x.shape[4:]))
        return x[:H, :W]
    return image(rgb), image(dep), image(acc)


def render(params: Dict[str, torch.Tensor], alive, w2c, intr, hw, capacity,
           kw):
    """(colour, depth, alpha) of the alive Gaussians, differentiable in
    every parameter."""
    q = params["rotation"]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    proj = project(params["xyz"], torch.exp(params["scaling"]),
                   torch.cat([q[:, 1:4], q[:, 0:1]], -1),
                   torch.sigmoid(params["opacity"])[:, 0], params["f_dc"],
                   w2c, intr, hw)
    valid = proj.valid & alive
    ids, _ = tile_lists(proj.mean2d.detach(), proj.radius,
                        proj.depth.detach(), valid, hw, capacity, kw)
    return composite(ids, proj, proj.mean2d, hw)


# --------------------------------------------------------------------------
# image statistics and the losses
# --------------------------------------------------------------------------

def _window(size, sigma=1.5, device="cpu"):
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma ** 2))
    return torch.tensor(g / g.sum(), dtype=torch.float32, device=device)


def blur(img, size):
    """Gaussian window (sigma 1.5) over (H, W, C), zero padding, as one
    2-D convolution per channel."""
    g = _window(size, device=img.device)
    k2 = (g[:, None] * g[None, :])[None, None].repeat(img.shape[-1], 1, 1, 1)
    out = F.conv2d(img.permute(2, 0, 1)[None], k2, padding=size // 2,
                   groups=img.shape[-1])
    return out[0].permute(1, 2, 0)


def ssim_mean(x, y, size=11):
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mx, my = blur(x, size), blur(y, size)
    sxx = blur(x * x, size) - mx * mx
    syy = blur(y * y, size) - my * my
    sxy = blur(x * y, size) - mx * my
    return (((2 * mx * my + c1) * (2 * sxy + c2))
            / ((mx * mx + my * my + c1) * (sxx + syy + c2))).mean()


def ssim_parts(x, y, size):
    """Clipped luminance, contrast and structure, each channel-averaged."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    c3 = c2 / 2
    mx, my = blur(x, size), blur(y, size)
    sxx = torch.clamp(blur(x * x, size) - mx * mx, min=EPS32)
    syy = torch.clamp(blur(y * y, size) - my * my, min=EPS32)
    sxy = blur(x * y, size) - mx * my
    sxy = torch.sign(sxy) * torch.minimum(torch.sqrt(sxx * syy), sxy.abs())
    sx, sy = torch.sqrt(sxx), torch.sqrt(syy)
    lum = (2 * mx * my + c1) / (mx * mx + my * my + c1)
    con = torch.clamp((2 * sx * sy + c2) / (sxx + syy + c2), max=0.98)
    struc = torch.clamp((sxy + c3) / (sx * sy + c3), max=0.98)
    return lum.mean(-1), con.mean(-1), struc.mean(-1)


def median(x, dim=None):
    """Mean of the two middle values for an even count; NaN if any NaN."""
    if dim is None:
        x, dim = x.reshape(-1), 0
    n = x.shape[dim]
    s = torch.sort(x, dim=dim).values
    out = 0.5 * (s.select(dim, (n - 1) // 2) + s.select(dim, n // 2))
    return torch.where(torch.isnan(x).any(dim), torch.full_like(out, np.nan),
                       out)


def median_filter(x, k):
    pl = (k - 1) // 2
    xp = F.pad(x, (pl, k - 1 - pl, pl, k - 1 - pl))
    H, W = x.shape
    return median(torch.stack([xp[i:i + H, j:j + W] for i in range(k)
                               for j in range(k)], -1), dim=-1)


def resize(x, hw, mode):
    return F.interpolate(x[None, None], size=tuple(hw), mode=mode,
                         align_corners=False, antialias=True)[0, 0]


def bias_factor(x, s):
    return x / (1 + (1 - x) * (1 / s - 2))


def mlp(weights, x):
    """The uncertainty MLP: 384 -> 64 -> 64 -> 1, ReLU, softplus."""
    h = F.relu(x @ weights["fc1.weight"].T + weights["fc1.bias"])
    h = F.relu(h @ weights["fc2.weight"].T + weights["fc2.bias"])
    return F.softplus(h @ weights["fc3.weight"].T + weights["fc3.bias"])[..., 0]


def mapping_loss(color, depth, alpha, gt, ref_depth, depth_med, sigma, ea,
                 eb, lc):
    """The uncertainty-aware mapping loss of a non-initial step; returns
    (total, the uncertainty term per DINO cell)."""
    up = lc["uncertainty_params"]
    H, W = gt.shape[:2]
    small = tuple(sigma.shape)
    frac = up["train_frac_fix"]
    img = torch.exp(ea) * color + eb
    mask = (gt.sum(-1) > lc["rgb_boundary_threshold"])[..., None]
    l1_rgb = (img * mask - gt * mask).abs()
    thresh = torch.clamp(10 * depth_med, max=50.0)
    dmask = (ref_depth > 0.01) & (ref_depth < thresh)
    l1_depth = (depth * dmask - ref_depth * dmask).abs()
    unc = torch.clamp(sigma, min=0.1) + 1e-3
    unc_px = (resize(unc.detach(), (H, W), "bilinear") - 0.1) * (
        1 + bias_factor(frac, 0.8)) + 0.1
    small_alpha = resize(alpha.detach(), small, "bilinear")
    lum, con, struc = ssim_parts(gt, img, up["ssim_window_size"])
    ssim_map = torch.clamp(alpha.detach() * (100 + 900 * bias_factor(frac, 0.8))
                           * (1 - lum) * (1 - struc) * (1 - con), max=5.0)
    ssim_small = median_filter(resize(ssim_map.detach(), small, "bilinear"),
                               up["ssim_median_filter_size"])
    dl_small = resize(torch.clamp(l1_depth, max=5.0).detach(), small,
                      "bicubic")
    d_small = resize(ref_depth.detach(), small, "bicubic")
    dl_small = torch.where(d_small > thresh, torch.zeros_like(dl_small),
                           dl_small)
    uncer = (ssim_small / unc ** 2 + 0.5 * torch.log(unc)
             + up["uncer_depth_mult"] * dl_small / unc ** 2)
    uncer = torch.where(small_alpha < up["opacity_th_for_uncer_loss"],
                        torch.zeros_like(uncer), uncer)
    rgb = (((1 - lc["lambda_dssim"]) * l1_rgb
            + lc["lambda_dssim"] * (1 - ssim_mean(img, gt)))
           if lc["ssim_loss"] else l1_rgb)
    w = 0.5 / unc_px ** 2
    w = torch.where(w < 0.1, torch.zeros_like(w), w)
    rgb = w[..., None] * rgb
    l1_depth_w = torch.where(ref_depth < depth.detach() + 1.0, w * l1_depth,
                             l1_depth)
    a = lc["alpha"]
    total = (a * rgb.mean() + (1 - a) * l1_depth_w.mean()
             + up["ssim_mult"] * uncer.mean())
    return total, uncer


def dino_variance(sig, feats, top_k=128, sim_threshold=0.75):
    """Variance of sigma over each feature's top-k cosine neighbours."""
    f = feats / torch.clamp(torch.linalg.norm(feats, dim=-1, keepdim=True),
                            min=EPS32)
    sim = f @ f.T
    top, idx = torch.topk(sim, min(top_k, sim.shape[-1]), dim=-1)
    m = (top > sim_threshold).to(torch.float32)
    nb = sig[idx] * m
    n = m.sum(-1, keepdim=True) + EPS32
    mean = nb.sum(-1, keepdim=True) / n
    return ((((nb - mean) ** 2) * m).sum(-1, keepdim=True) / n).mean()


def isotropy(scaling, alive):
    dev = (scaling - scaling.mean(1, keepdim=True)).abs() * alive[:, None]
    return dev.sum() / torch.clamp(alive.sum() * scaling.shape[1], min=1)


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------

def f32(x):
    return float(torch.tensor(x, dtype=torch.float32))


def position_lr(step, opt):
    """The xyz group's log-lerp schedule, evaluated in float32."""
    t = min(max(f32(step) / f32(opt["position_lr_max_steps"]), 0.0), 1.0)
    a, b = f32(opt["position_lr_init"] * 6.0), f32(opt["position_lr_final"]
                                                    * 6.0)
    return f32(math.exp(math.log(a) * (1 - t) + math.log(b) * t))


def adam(p, g, mu, nu, count, lr, b1, b2, eps):
    mu.mul_(b1).add_((1 - b1) * g)
    nu.mul_(b2).add_((1 - b2) * g * g)
    c1 = f32(1 - f32(b1) ** count)
    c2 = f32(1 - f32(b2) ** count)
    p.sub_(f32(lr) * (mu / c1) / (torch.sqrt(nu / c2) + eps))


def step(state: dict, view: dict, args: dict, cfg: dict):
    """One mapping iteration on `view`, in place on `state`; returns the
    loss. state: params / mu / nu (dicts by name), count, alive, exposure,
    exp_mu, exp_nu, exp_count (per view), mlp / mlp_mu / mlp_nu, mlp_count.
    view: colour, depth, depth_med, features, w2c, intr. args: idx,
    freeze, d_base, d_samples, it_count."""
    mc = cfg["mapping"]
    tr = mc["Training"]
    up = mc["uncertainty_params"]
    opt = mc["opt_params"]
    hw = tuple(view["colour"].shape[1:3])
    idx = args["idx"]
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in state["params"].items() if v.numel()}
    expo = state["exposure"][idx].detach().clone().requires_grad_(True)
    mlp_w = {k: v.detach().clone().requires_grad_(True)
             for k, v in state["mlp"].items()}
    color, depth, alpha = render(leaves, state["alive"], view["w2c"][idx],
                                 view["intr"], hw, mc["render_list_capacity"],
                                 mc.get("bin_kw", 4))
    if not up["activate"] or args["initialization"]:
        raise ValueError("the reference covers the uncertainty-aware step "
                         "after initialisation only")
    lc = dict(alpha=tr["alpha"], rgb_boundary_threshold=tr[
        "rgb_boundary_threshold"], lambda_dssim=opt["lambda_dssim"],
        ssim_loss=tr["ssim_loss"], uncertainty_params=up)
    sigma = mlp(mlp_w, view["features"][idx])
    total, uncer = mapping_loss(color, depth, alpha, view["colour"][idx],
                                view["depth"][idx], view["depth_med"][idx],
                                sigma, expo[0], expo[1], lc)
    if args["freeze"]:
        u = uncer.mean()
        total = total - up["ssim_mult"] * u + up["ssim_mult"] * u.detach()
    else:
        fh, fw, fd = view["features"].shape[1:]
        d0 = args["d_base"]
        samp = view["features"][d0:d0 + 5].reshape(5 * fh * fw, fd)[
            args["d_samples"]]
        total = total + up["reg_mult"] * dino_variance(mlp(mlp_w, samp), samp)
    total = total + 10.0 * isotropy(leaves["scaling"],
                                    state["alive"].to(torch.float32))
    names = list(leaves)
    mnames = list(mlp_w)
    grads = torch.autograd.grad(
        total, [leaves[k] for k in names] + [expo]
        + [mlp_w[k] for k in mnames], allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
        [leaves[k] for k in names] + [expo] + [mlp_w[k] for k in mnames],
        grads)]
    with torch.no_grad():
        state["count"] += 1
        lrs = dict(xyz=position_lr(args["it_count"], opt),
                   f_dc=opt["feature_lr"], f_rest=opt["feature_lr"] / 20.0,
                   opacity=opt["opacity_lr"], scaling=opt["scaling_lr"] * 6.0,
                   rotation=opt["rotation_lr"])
        alive = state["alive"].to(torch.float32)
        for k, g in zip(names, grads):
            g = g * alive.reshape((-1,) + (1,) * (g.dim() - 1))
            adam(state["params"][k], g, state["mu"][k], state["nu"][k],
                 state["count"], lrs[k], 0.9, 0.999, 1e-15)
        if idx != 0:   # frame 0's exposure stays fixed
            state["exp_count"][idx] += 1
            n = int(state["exp_count"][idx])
            e = state["exposure"][idx].clone()
            mu = state["exp_mu"][idx].clone()
            nu = state["exp_nu"][idx].clone()
            adam(e, grads[len(names)], mu, nu, n, 0.01, 0.9, 0.999, 1e-8)
            state["exposure"][idx] = e
            state["exp_mu"][idx] = mu
            state["exp_nu"][idx] = nu
        state["mlp_count"] += 1
        for k, g in zip(mnames, grads[len(names) + 1:]):
            p = state["mlp"][k]
            adam(p, g + up["weight_decay"] * p, state["mlp_mu"][k],
                 state["mlp_nu"][k], state["mlp_count"], up["lr"], 0.9, 0.999,
                 1e-8)
    return float(total.detach())


# --------------------------------------------------------------------------
# keyframe seeding
# --------------------------------------------------------------------------

def seed_gaussians(colour, depth, w2c, intr, factor, point_size, draws):
    """Back-project the ceil(H W / factor) pixels of smallest priority
    (draws, +10 where the depth is invalid, ties by pixel) with 3-NN scales
    (point size times the median depth, at most 0.05), opacity 0.5, identity
    rotation. Returns (params (M, ...) as a dict, valid (M,))."""
    H, W = depth.shape
    n = -(-(H * W) // factor)
    ok = (depth > 0) & (depth < 100.0) & torch.isfinite(depth)
    pri = draws + torch.where(ok.reshape(-1), 0.0, 10.0)
    top, idx = torch.sort(pri, stable=True)
    top, idx = top[:n], idx[:n]
    sel = top < 1.0
    ys, xs = (idx // W).to(torch.float32), (idx % W).to(torch.float32)
    d = depth.reshape(-1)[idx]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    cam = torch.stack([(xs - cx) / fx * d, (ys - cy) / fy * d, d], -1)
    pts = transform(invert(w2c), cam)
    med = torch.nan_to_num(median(torch.where(ok, depth, torch.full_like(
        depth, float("nan")))), nan=1.0)
    ps = torch.clamp(point_size * med, max=0.05)
    sq = (pts * pts).sum(-1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * pts @ pts.T, min=0.0)
    big = torch.finfo(torch.float32).max
    d2 = d2.fill_diagonal_(big).masked_fill(~sel[None, :], big)
    nn3 = torch.topk(d2, 3, dim=-1, largest=False).values.mean(-1)
    nn3 = torch.where(sel, nn3, torch.zeros_like(nn3))
    log_s = 0.5 * torch.log(torch.clamp(nn3, min=1e-7) * ps)
    rgb = colour.reshape(-1, 3)[idx]
    rot = torch.zeros(n, 4, device=depth.device)
    rot[:, 0] = 1.0
    return dict(xyz=pts, f_dc=((rgb - 0.5) / SH_C0)[:, None, :],
                opacity=torch.full((n, 1), f32(math.log(0.5 / 0.5)),
                                   device=depth.device),
                scaling=log_s[:, None].repeat(1, 3), rotation=rot), sel

