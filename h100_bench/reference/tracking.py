"""Plain PyTorch reference of the tracker's network and of one iteration of
a frontend graph update.

Written for the benchmark from DROID-SLAM (Teed and Deng, NeurIPS 2021) as
WildGS-SLAM runs it, with the semantics the configuration states: the
1/8-resolution feature (instance norm, 128 channels) and context (no norm,
256 channels, tanh / relu halves) encoders; the 4-level all-pairs
correlation pyramid scaled by 1/16, sampled in a 7x7 bilinear window per
level (x offset major, zero outside); the update operator (correlation and
flow encoders, the ConvGRU with its global gate, the 2-channel delta and
weight heads, the per-source-frame damping head); and dense bundle
adjustment: residual weights 0.001 * valid * weight, depth damping mixed
with the metric-depth prior (alpha 0.05), pose damping diag * (1 + 1e-4) +
0.1, the Schur complement over the poses of the window with, per source
frame, the products of its first 16 edges only, a Cholesky solve (a zero
step where it fails), left-multiplied retraction, disparities clamped at
1e-5. Weights come in as a dict of tensors by upstream's ``droid.pth``
names. It imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MIN_DEPTH = 0.2
SELF_EDGE = (-0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0)
RADIUS = 3
LEVELS = 4
GROUP_DEGREE = 16


# --------------------------------------------------------------------------
# the network
# --------------------------------------------------------------------------

def conv(w, name, x, stride=1):
    k = w[f"{name}.weight"]
    return F.conv2d(x, k, w[f"{name}.bias"], stride=stride,
                    padding=k.shape[-1] // 2)


def encoder(w, prefix, image_norm, instance_norm):
    """(H, W, 3) normalised image -> (H/8, W/8, C)."""
    def norm(y):
        return F.instance_norm(y, eps=1e-5) if instance_norm else y

    x = image_norm.permute(2, 0, 1)[None]
    x = F.relu(norm(conv(w, f"{prefix}.conv1", x, 2)))
    for layer, stride in ((1, 1), (2, 2), (3, 2)):
        for block in (0, 1):
            p = f"{prefix}.layer{layer}.{block}"
            s = stride if block == 0 else 1
            y = F.relu(norm(conv(w, f"{p}.conv1", x, s)))
            y = F.relu(norm(conv(w, f"{p}.conv2", y)))
            if s > 1:
                x = norm(conv(w, f"{p}.downsample.0", x, s))
            x = F.relu(x + y)
    return conv(w, f"{prefix}.conv2", x)[0].permute(1, 2, 0)


def context(w, image_norm):
    c = encoder(w, "cnet", image_norm, False)
    return torch.tanh(c[..., :128]), F.relu(c[..., 128:])


def update_operator(w, net, inp, corr, flow, ii):
    """NHWC net / inp (E, h, w, 128), corr (E, h, w, 196), flow (E, h, w,
    4) -> net, delta, weight (E, h, w, 2), frames, eta (U, h, w)."""
    def nchw(x):
        return x.permute(0, 3, 1, 2)
    p = "update"
    c = F.relu(conv(w, f"{p}.corr_encoder.2",
                    F.relu(conv(w, f"{p}.corr_encoder.0", nchw(corr)))))
    f = F.relu(conv(w, f"{p}.flow_encoder.2",
                    F.relu(conv(w, f"{p}.flow_encoder.0", nchw(flow)))))
    h = nchw(net)
    x = torch.cat([nchw(inp), c, f], 1)
    hx = torch.cat([h, x], 1)
    glo = (torch.sigmoid(conv(w, f"{p}.gru.w", h)) * h).mean((2, 3),
                                                             keepdim=True)
    z = torch.sigmoid(conv(w, f"{p}.gru.convz", hx)
                      + conv(w, f"{p}.gru.convz_glo", glo))
    r = torch.sigmoid(conv(w, f"{p}.gru.convr", hx)
                      + conv(w, f"{p}.gru.convr_glo", glo))
    q = torch.tanh(conv(w, f"{p}.gru.convq", torch.cat([r * h, x], 1))
                   + conv(w, f"{p}.gru.convq_glo", glo))
    h = (1 - z) * h + z * q
    delta = conv(w, f"{p}.delta.2", F.relu(conv(w, f"{p}.delta.0", h)))
    weight = torch.sigmoid(conv(w, f"{p}.weight.2",
                                F.relu(conv(w, f"{p}.weight.0", h))))
    frames, inv = torch.unique(ii, return_inverse=True)
    a = F.relu(conv(w, f"{p}.agg.conv1", h))
    mean = torch.stack([a[inv == k].mean(0) for k in range(len(frames))])
    a = F.relu(conv(w, f"{p}.agg.conv2", mean))
    eta = 0.01 * F.softplus(conv(w, f"{p}.agg.eta.0", a))[:, 0]

    def nhwc(x):
        return x.permute(0, 2, 3, 1)
    return nhwc(h), nhwc(delta), nhwc(weight), frames, eta


# --------------------------------------------------------------------------
# correlation
# --------------------------------------------------------------------------

def corr_levels(fmap_i, fmap_j):
    """All-pairs correlation of (E, h, w, C) feature maps, /16, and its
    2x2-average pooled levels: [(E, h w, h / 2^l, w / 2^l)]."""
    E, h, w, C = fmap_i.shape
    v = torch.einsum("epc,eqc->epq", fmap_i.reshape(E, h * w, C),
                     fmap_j.reshape(E, h * w, C)) / 16.0
    v = v.reshape(E, h * w, h, w)
    out = [v]
    for _ in range(LEVELS - 1):
        v = F.avg_pool2d(v, 2)
        out.append(v)
    return out


def lookup(levels, coords):
    """Bilinear samples of every level in a 7x7 window around coords (E,
    h, w, 2) / 2^l; outside the level: zero. -> (E, h, w, 196)."""
    E, h, w, _ = coords.shape
    c = coords.reshape(E, h * w, 2)
    r = torch.arange(-RADIUS, RADIUS + 1, dtype=c.dtype, device=c.device)
    outs = []
    for lvl, vol in enumerate(levels):
        h2, w2 = vol.shape[-2:]
        x = c[..., 0:1] / 2 ** lvl
        y = c[..., 1:2] / 2 ** lvl
        xs = x[..., :, None] + r[:, None]          # (E, P, 7, 1): x offset
        ys = y[..., :, None] + r[None, :]          # (E, P, 1, 7)
        xs, ys = torch.broadcast_tensors(xs, ys)
        x0, y0 = torch.floor(xs), torch.floor(ys)
        acc = 0.0
        for dx in (0, 1):
            for dy in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                wgt = ((1 - (xs - x0)) if dx == 0 else (xs - x0)) * (
                    (1 - (ys - y0)) if dy == 0 else (ys - y0))
                inside = (xi >= 0) & (xi < w2) & (yi >= 0) & (yi < h2)
                idx = (torch.clamp(yi, 0, h2 - 1) * w2
                       + torch.clamp(xi, 0, w2 - 1)).long()
                val = torch.gather(vol.reshape(E, h * w, h2 * w2), 2,
                                   idx.reshape(E, h * w, -1)).reshape(
                    idx.shape)
                acc = acc + torch.where(inside & torch.isfinite(wgt),
                                        val * wgt, torch.zeros_like(val))
        outs.append(acc.reshape(E, h * w, 49))
    return torch.cat(outs, -1).reshape(E, h, w, 49 * LEVELS)


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------

def rot(q):
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def qmul(a, b):
    x1, y1, z1, w1 = a.unbind(-1)
    x2, y2, z2, w2 = b.unbind(-1)
    return torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)


def inverse(g):
    q = torch.cat([-g[..., 3:6], g[..., 6:7]], -1)
    return torch.cat([-(rot(q) @ g[..., :3, None])[..., 0], q], -1)


def compose(a, b):
    return torch.cat([a[..., :3] + (rot(a[..., 3:7]) @ b[..., :3, None])[
        ..., 0], qmul(a[..., 3:7], b[..., 3:7])], -1)


def exp_se3(xi):
    """(tau, phi) -> pose, t = V(phi) tau."""
    tau, phi = xi[..., :3], xi[..., 3:6]
    th2 = (phi * phi).sum(-1, keepdim=True)
    th = torch.sqrt(th2)
    small = th2 < 1e-8
    ths = torch.where(small, torch.ones_like(th), th)
    s = torch.where(small, 0.5 - th2 / 48.0, torch.sin(0.5 * ths) / ths)
    q = torch.cat([phi * s, torch.where(small, 1.0 - th2 / 8.0,
                                        torch.cos(0.5 * ths))], -1)
    x, y, z = phi.unbind(-1)
    o = torch.zeros_like(x)
    K = torch.stack([o, -z, y, z, o, -x, -y, x, o], -1).reshape(
        phi.shape[:-1] + (3, 3))
    t2 = th2[..., 0]
    tsafe = torch.where(small[..., 0], torch.ones_like(t2), t2)
    B = torch.where(small[..., 0], 0.5 - t2 / 24.0,
                    (1 - torch.cos(torch.sqrt(tsafe))) / tsafe)
    C = torch.where(small[..., 0], 1 / 6.0 - t2 / 120.0,
                    (1 - torch.sin(torch.sqrt(tsafe)) / torch.sqrt(tsafe))
                    / tsafe)
    V = (torch.eye(3, dtype=xi.dtype, device=xi.device) + B[..., None, None]
         * K + C[..., None, None] * (K @ K))
    return torch.cat([(V @ tau[..., None])[..., 0], q], -1)


def adjoint(g):
    R = rot(g[..., 3:7])
    x, y, z = g[..., :3].unbind(-1)
    o = torch.zeros_like(x)
    T = torch.stack([o, -z, y, z, o, -x, -y, x, o], -1).reshape(
        g.shape[:-1] + (3, 3))
    top = torch.cat([R, T @ R], -1)
    return torch.cat([top, torch.cat([torch.zeros_like(R), R], -1)], -2)


def reproject(poses, disps, intr, ii, jj, jacobian=False):
    """Frame-ii pixels (inverse depths disps) into frame jj: coords (E, h,
    w, 2), valid (E, h, w, 1), and the Jacobians in pose i, pose j (E, h,
    w, 2, 6) and the inverse depth (E, h, w, 2, 1)."""
    h, w = disps.shape[-2:]
    fx, fy, cx, cy = intr.unbind()
    yy, xx = torch.meshgrid(torch.arange(h, dtype=disps.dtype,
                                         device=disps.device),
                            torch.arange(w, dtype=disps.dtype,
                                         device=disps.device), indexing="ij")
    d = disps[ii]
    X0 = torch.stack(torch.broadcast_tensors((xx - cx) / fx, (yy - cy) / fy,
                                             torch.ones_like(d), d), -1)
    G = compose(poses[jj], inverse(poses[ii]))
    self_edge = torch.tensor(SELF_EDGE, dtype=G.dtype, device=G.device)
    G = torch.where((ii == jj)[:, None], self_edge.expand_as(G), G)
    R, t = rot(G[:, 3:7]), G[:, :3]
    xyz = torch.einsum("eab,ehwb->ehwa", R, X0[..., :3]) + X0[..., 3:4] * t[
        :, None, None, :]
    X, Y, Z = xyz.unbind(-1)
    Dd = X0[..., 3]
    Zs = torch.where(Z < 0.5 * MIN_DEPTH, torch.ones_like(Z), Z)
    inv = 1.0 / Zs
    coords = torch.stack([fx * (X * inv) + cx, fy * (Y * inv) + cy], -1)
    valid = ((Z > MIN_DEPTH) & (X0[..., 2] > MIN_DEPTH)).to(disps.dtype)[
        ..., None]
    if not jacobian:
        return coords, valid
    o = torch.zeros_like(inv)
    Jp = torch.stack([fx * inv, o, -fx * X * inv * inv, o,
                      o, fy * inv, -fy * Y * inv * inv, o], -1).reshape(
        inv.shape + (2, 4))
    Ja = torch.stack([Dd, o, o, o, Z, -Y, o, Dd, o, -Z, o, X,
                      o, o, Dd, Y, -X, o, o, o, o, o, o, o], -1).reshape(
        inv.shape + (4, 6))
    Jj = Jp @ Ja
    Ji = -torch.einsum("ehwkj,eji->ehwki", Jj, adjoint(G))
    Jz = torch.einsum("ehwkj,ej->ehwk", Jp, torch.cat(
        [t, torch.ones_like(t[:, :1])], -1))[..., None]
    return coords, valid, (Ji, Jj, Jz)


# --------------------------------------------------------------------------
# bundle adjustment
# --------------------------------------------------------------------------

def ba_iteration(poses, disps, intr, target, weight, eta, ii, jj, t0, t1,
                 sensor_disps, sensor_valid, alpha=0.05, lm=1e-4, ep=0.1):
    """One Gauss-Newton step on the poses of [t0, t1) and the inverse
    depths of the edges' source frames."""
    Fn, h, w = disps.shape
    HW = h * w
    E = ii.shape[0]
    P = t1 - t0
    dev, dt = disps.device, disps.dtype
    coords, valid, (Ji, Jj, Jz) = reproject(poses, disps, intr, ii, jj, True)
    r = (target - coords).reshape(E, HW, 2)
    wt = (0.001 * valid * weight).reshape(E, HW, 2)
    Ji, Jj, Jz = Ji.reshape(E, HW, 2, 6), Jj.reshape(E, HW, 2, 6), Jz.reshape(
        E, HW, 2)
    # the first GROUP_DEGREE edges of each source frame, in edge order
    rank = torch.zeros(E, dtype=torch.long, device=dev)
    seen = {}
    for e, i in enumerate(ii.tolist()):
        rank[e] = seen.get(i, 0)
        seen[i] = rank[e].item() + 1
    listed = rank < GROUP_DEGREE

    Hm = torch.zeros(P * 6, P * 6, dtype=dt, device=dev)
    v = torch.zeros(P * 6, dtype=dt, device=dev)
    C = torch.zeros(Fn, HW, dtype=dt, device=dev)
    wd = torch.zeros(Fn, HW, dtype=dt, device=dev)
    Eb = torch.zeros(Fn, P * 6, HW, dtype=dt, device=dev)
    Eall = []
    for e in range(E):
        i, j = int(ii[e]), int(jj[e])
        slots = []
        for s, J in ((i - t0, Ji[e]), (j - t0, Jj[e])):
            slots.append((s if 0 <= s < P else None, J))
        eblocks = []
        for sa, Ja in slots:
            if sa is None:
                eblocks.append(None)
                continue
            v[sa * 6:sa * 6 + 6] += torch.einsum("pc,pcd->d",
                                                 wt[e] * r[e], Ja)
            for sb, Jb in slots:
                if sb is not None:
                    Hm[sa * 6:sa * 6 + 6, sb * 6:sb * 6 + 6] += torch.einsum(
                        "pc,pcd,pcf->df", wt[e], Ja, Jb)
            eblocks.append(torch.einsum("pc,pcd->dp", wt[e] * Jz[e], Ja))
        C[i] += (wt[e] * Jz[e] * Jz[e]).sum(-1)
        wd[i] += (wt[e] * r[e] * Jz[e]).sum(-1)
        for (sa, _), blk in zip(slots, eblocks):
            if sa is not None and listed[e]:
                Eb[i, sa * 6:sa * 6 + 6] += blk
        Eall.append((i, slots, eblocks))
    d = torch.arange(P * 6, device=dev)
    Hm[d, d] += ep + lm * Hm[d, d]
    m = (sensor_valid & (sensor_disps > 0)).reshape(Fn, HW).to(dt)
    C = C + m * alpha + (1 - m) * eta.reshape(Fn, HW)
    wd = wd - m * alpha * (disps.reshape(Fn, HW)
                           - sensor_disps.reshape(Fn, HW))
    Q = 1.0 / C
    src = torch.unique(ii)
    S = Hm - torch.einsum("kah,kbh->ab", Eb[src] * Q[src][:, None, :],
                          Eb[src])
    rhs = v - torch.einsum("kah,kh->a", Eb[src], Q[src] * wd[src])
    L, info = torch.linalg.cholesky_ex(S)
    dx = torch.cholesky_solve(rhs[:, None], L)[:, 0]
    dx = torch.where(info == 0, torch.nan_to_num(dx), torch.zeros_like(dx))
    dx = dx.reshape(P, 6)
    Etdx = torch.zeros(Fn, HW, dtype=dt, device=dev)
    for i, slots, eblocks in Eall:
        for (sa, _), blk in zip(slots, eblocks):
            if sa is not None:
                Etdx[i] += torch.einsum("dp,d->p", blk, dx[sa])
    dz = Q * (wd - Etdx)
    has = torch.zeros(Fn, dtype=torch.bool, device=dev)
    has[ii] = True
    dz = torch.nan_to_num(torch.where(has[:, None], dz, torch.zeros_like(dz)))
    xi = torch.zeros(Fn, 6, dtype=dt, device=dev)
    xi[t0:t1] = dx
    return (compose(exp_se3(xi), poses),
            torch.clamp(disps + dz.reshape(Fn, h, w), min=1e-5))
