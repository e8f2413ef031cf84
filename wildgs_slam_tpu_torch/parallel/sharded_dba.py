"""Edge-sharded dense bundle adjustment over a mesh; torch port of
``wildgs_slam_tpu/parallel/sharded_dba.py``.

Edges are assigned to shards by source frame (``shard_edges_by_frame``):
every edge with ii == k lives on the shard that owns frame k, so each
frame-local product (the depth diagonal C_k and rhs w_k, the Schur
outer products, the depth back-substitution) stays on one shard. Each
shard builds its partial pose system over its edges with the port's
``ops/dba.py`` (``_build_per_edge``; the Schur products in its direct
form, over the edges the shard's group table lists); one psum gives the
(pmax·6)² system, which is solved on every card (``_cho_solve``); a second
psum combines the owned frames' depth updates.

A sharded argument is a list of per-shard tensors, each on its shard's
device (``collectives.shard_rows`` splits a device-major array); a
replicated argument is one tensor. Equal to ``dba.ba`` up to float32
summation order when both take the group table of ``degree`` (each
frame's first ``degree`` edges: a shard keeps a frame's edges in their
global order); ``motion_only`` is not taken, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import dba
from . import collectives as col


def shard_edges_by_frame(ii, jj, n_devices, max_frames, degree,
                         e_cap=None):
    """Host-side partition: frames round-robin over the shards; edges follow
    their source frame. Returns a dict of numpy arrays:
      perm   (D, E_cap) indices into the edge arrays (0 for pads)
      valid  (D, E_cap) bool
      groups (D, F, degree) per-shard local edge indices of each frame, -1
      owner  (D, F) bool: shard d owns frame f
    and e_cap."""
    ii = np.asarray(ii)
    jj = np.asarray(jj)
    frame_dev = np.arange(max_frames) % n_devices
    edge_dev = frame_dev[np.clip(ii, 0, max_frames - 1)]

    per_dev = [np.where(edge_dev == d)[0] for d in range(n_devices)]
    if e_cap is None:
        e_cap = max(1, max(len(p) for p in per_dev))

    perm = np.zeros((n_devices, e_cap), np.int32)
    valid = np.zeros((n_devices, e_cap), bool)
    groups = np.full((n_devices, max_frames, degree), -1, np.int32)
    owner = np.zeros((n_devices, max_frames), bool)
    owner[frame_dev, np.arange(max_frames)] = True

    for d in range(n_devices):
        sel = per_dev[d][:e_cap]
        perm[d, : len(sel)] = sel
        valid[d, : len(sel)] = True
        fill = np.zeros(max_frames, np.int32)
        for e_loc, e_glob in enumerate(sel):
            f = ii[e_glob]
            if 0 <= f < max_frames and fill[f] < degree:
                groups[d, f, fill[f]] = e_loc
                fill[f] += 1
    return dict(perm=perm, valid=valid, groups=groups, owner=owner,
                e_cap=e_cap)


def shard_tables(groups, owner, devices):
    """``shard_edges_by_frame``'s groups (D, F, degree) and owner (D, F)
    as per-shard tensors on their devices."""
    return ([col.move(torch.as_tensor(np.asarray(t)[d]), dev)
             for d, dev in enumerate(devices)] for t in (groups, owner))


def gather_edges(arrs, perm):
    """Reorder edge arrays into device-major (D·E_cap, ...) order."""
    idx = np.asarray(perm).reshape(-1)
    return [a[torch.as_tensor(idx, dtype=torch.int64, device=a.device)]
            for a in arrs]


def _local_partials(poses, disps, intrinsics, target, weight, eta, ii, jj,
                    edge_valid, groups, owner, t0, cfg, sensor_disps,
                    sensor_valid, pmax):
    """One shard: its partial pose system (H - Σ E Q Eᵀ over its owned
    frames, and the rhs), the diagonal of its H, and its owned frames' depth
    blocks. The caller psums the first three."""
    F, H, W = disps.shape
    HW = H * W
    Pm = pmax
    dev, dt = disps.device, disps.dtype
    ev = edge_valid.to(dt)
    b = dba._build_per_edge(poses, disps, intrinsics, target,
                            weight * ev[:, None, None, None], ii, jj)

    pi, pj = ii - t0, jj - t0
    pi_c = torch.where((pi >= 0) & (pi < Pm) & edge_valid, pi, Pm)
    pj_c = torch.where((pj >= 0) & (pj < Pm) & edge_valid, pj, Pm)

    Hmat = torch.zeros((Pm + 1) * (Pm + 1), 6, 6, dtype=dt, device=dev)
    for a, c, blk in ((pi_c, pi_c, "Hii"), (pi_c, pj_c, "Hij"),
                      (pj_c, pi_c, "Hji"), (pj_c, pj_c, "Hjj")):
        Hmat.index_add_(0, a * (Pm + 1) + c, b[blk])
    Hmat = Hmat.reshape(Pm + 1, Pm + 1, 6, 6)[:Pm, :Pm]
    vvec = torch.zeros(Pm + 1, 6, dtype=dt, device=dev)
    vvec.index_add_(0, pi_c, b["vi"]).index_add_(0, pj_c, b["vj"])
    diag = torch.arange(Pm, device=dev)
    Hdiag = Hmat[diag, diag]

    # owned frames' depth diagonal and rhs (complete: their edges are here)
    iic = torch.where(edge_valid, ii, F)
    Csum = torch.zeros(F + 1, HW, dtype=dt, device=dev).index_add_(
        0, iic, b["Ck"])[:F]
    wsum = torch.zeros(F + 1, HW, dtype=dt, device=dev).index_add_(
        0, iic, b["wk"])[:F]
    has_edge = torch.zeros(F + 1, dtype=torch.bool, device=dev)
    has_edge[iic] = True
    has_edge = has_edge[:F] & owner
    eta_flat = eta.reshape(F, HW)
    if sensor_disps is None:
        C = Csum + eta_flat
        wd = wsum
    else:
        m = (sensor_valid & (sensor_disps > 0)).reshape(F, HW).to(dt)
        C = Csum + m * cfg.alpha + (1 - m) * eta_flat
        wd = wsum - m * cfg.alpha * (disps.reshape(F, HW)
                                     - sensor_disps.reshape(F, HW))
    own_f = owner[:, None].to(dt)
    Q = own_f / C                  # non-owned frames contribute 0
    wd = wd * own_f

    # Schur products over the edges of the group table (owned frames)
    sel = torch.nonzero(dba.listed_edges(groups, ii.shape[0], dev)
                        & edge_valid).squeeze(1)
    frames, inv = torch.unique(ii[sel], return_inverse=True)
    U = frames.shape[0]
    Eblk = torch.zeros(U * (Pm + 1), 6, HW, dtype=dt, device=dev)
    Eblk.index_add_(0, inv * (Pm + 1) + pi_c[sel], b["Ei"][sel])
    Eblk.index_add_(0, inv * (Pm + 1) + pj_c[sel], b["Ej"][sel])
    Eblk = Eblk.reshape(U, Pm + 1, 6, HW)[:, :Pm].reshape(U, Pm * 6, HW)
    Qf = Q[frames]
    S = (Hmat.transpose(1, 2).reshape(Pm * 6, Pm * 6)
         - torch.einsum("kah,kbh->ab", Eblk * Qf[:, None, :], Eblk))
    v = vvec[:Pm].reshape(Pm * 6) - torch.einsum("kah,kh->a", Eblk,
                                                 Qf * wd[frames])
    return S, v, Hdiag, Q, wd, has_edge, (b["Ei"], b["Ej"], pi_c, pj_c, iic)


def _retract_window(poses, dx, t0, t1):
    """Frames t0..t1-1 moved by dx[f - t0] (clipped to dx's last row)."""
    t1 = min(t1, poses.shape[0])
    slot = torch.clamp(torch.arange(t1 - t0, device=dx.device),
                       max=dx.shape[0] - 1)
    return dba._retract_poses(poses, dx[slot], t0, t1)


def ba_step(mesh, poses, disps, intrinsics, target, weight, eta, ii, jj,
            edge_valid, groups, owner, t0, t1, cfg, sensor_disps,
            sensor_valid, pmax):
    """One sharded Gauss-Newton iteration (``ba_step_in_shardmap``).
    Edge arguments (target, weight, ii, jj, edge_valid, groups (F, degree),
    owner (F,)) are per-shard lists; poses, disps, eta, intrinsics and the
    sensor terms are per-shard lists of replicated copies (one tensor per
    card, see ``collectives.replicate``). Returns per-shard lists of the
    new poses and disps (one tensor per card)."""
    devs = mesh.devices
    D = len(devs)
    F, H, W = disps[0].shape
    parts = [_local_partials(
        poses[d], disps[d], intrinsics[d], target[d], weight[d], eta[d],
        ii[d], jj[d], edge_valid[d], groups[d], owner[d], t0, cfg,
        None if sensor_disps is None else sensor_disps[d],
        None if sensor_valid is None else sensor_valid[d], pmax)
        for d in range(D)]
    S = col.psum([p[0] for p in parts], devs)
    v = col.psum([p[1] for p in parts], devs)
    Hdiag = col.psum([p[2] for p in parts], devs)

    # the pose step, once per card
    dx_on = {}
    for d, dev in enumerate(devs):
        if dev in dx_on:
            continue
        eye6 = torch.eye(6, dtype=S[d].dtype, device=dev)
        damp = cfg.ep * eye6 + cfg.lm * Hdiag[d] * eye6      # (Pm, 6, 6)
        Sd = S[d] + torch.block_diag(*damp)
        dx_on[dev] = dba._cho_solve(Sd, v[d]).reshape(pmax, 6)

    # owned frames' depth back-substitution, combined by psum
    dzs = []
    for d, dev in enumerate(devs):
        _, _, _, Q, wd, has_edge, (Ei, Ej, pi_c, pj_c, iic) = parts[d]
        dx_pad = torch.cat([dx_on[dev], torch.zeros(1, 6, dtype=Q.dtype,
                                                    device=dev)])
        Et_dx_e = (torch.einsum("edh,ed->eh", Ei, dx_pad[pi_c])
                   + torch.einsum("edh,ed->eh", Ej, dx_pad[pj_c]))
        Et_dx = torch.zeros(F + 1, H * W, dtype=Q.dtype,
                            device=dev).index_add_(0, iic, Et_dx_e)[:F]
        dz = Q * (wd - Et_dx)
        dzs.append(torch.nan_to_num(torch.where(has_edge[:, None], dz,
                                                torch.zeros_like(dz))))
    dz = col.psum(dzs, devs)

    new_poses, new_disps = {}, {}
    for d, dev in enumerate(devs):
        if dev not in new_poses:
            new_poses[dev] = _retract_window(poses[d], dx_on[dev], t0, t1)
            new_disps[dev] = torch.clamp(disps[d] + dz[d].reshape(F, H, W),
                                         min=cfg.min_disp)
    return ([new_poses[dev] for dev in devs],
            [new_disps[dev] for dev in devs])


def make_sharded_ba(mesh, pmax: int, cfg: dba.BAConfig = dba.BAConfig(),
                    use_sensor: bool = True, iters: int = 2):
    """An edge-sharded BA: fn(poses, disps, intrinsics, target, weight, eta,
    ii, jj, valid, groups, owner, t0, t1, sensor_disps=None,
    sensor_valid=None) -> (poses, disps) on the device of poses.

    target/weight/ii/jj/valid are per-shard lists of (E_cap, ...) blocks
    (``collectives.shard_rows`` of the device-major arrays of
    ``shard_edges_by_frame``/``gather_edges``); groups (D, F, degree) and
    owner (D, F) are the tables ``shard_edges_by_frame`` returns."""
    devs = mesh.devices

    def fn(poses, disps, intrinsics, target, weight, eta, ii, jj, valid,
           groups, owner, t0, t1, sensor_disps=None, sensor_valid=None):
        out_dev = poses.device
        rep = [col.replicate(x, devs) for x in (poses, disps, intrinsics,
                                                eta)]
        sensor = [col.replicate(x, devs) if use_sensor else None
                  for x in (sensor_disps, sensor_valid)]
        groups_l, owner_l = shard_tables(groups, owner, devs)
        ii = [x.to(torch.int64) for x in ii]
        jj = [x.to(torch.int64) for x in jj]
        p, dsp = rep[0], rep[1]
        for _ in range(iters):
            p, dsp = ba_step(mesh, p, dsp, rep[2], target, weight, rep[3],
                             ii, jj, valid, groups_l, owner_l, t0, t1, cfg,
                             sensor[0], sensor[1], pmax)
        return col.move(p[0], out_dev), col.move(dsp[0], out_dev)

    return fn
