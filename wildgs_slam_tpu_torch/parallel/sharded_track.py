"""Edge-sharded tracking step over a mesh; torch port of
``wildgs_slam_tpu/parallel/sharded_track.py``.

One ``FactorGraph.update_n`` iteration (reproject, correlation lookup,
update operator, BA, convex upsample) with the edges sharded by source
frame, as ``sharded_dba`` places them:

  * reprojection, the motion features (``droid_net.motion_features``, as
    the single-device graph), the lookup and the update operator are per
    edge and run on each shard's active edges with no communication;
  * the update operator's per-frame aggregation (damping, upsampling mask)
    stays local, since every edge of a source frame lives on the frame's
    owner;
  * the BA's pose system is one psum per Gauss-Newton iteration
    (``sharded_dba.ba_step``), not ``keyframe_store.ba``: the padded
    rows' source frames are clamped into the buffer before the weighting;
  * the damping and upsampled disparities of each shard's frames are
    combined by a psum of their changes (a delta-psum).

Equal to the single-device iteration up to float32 summation order.
"""

from __future__ import annotations

import copy

import torch

from ..models import droid_net
from ..ops import correlation, dba, projective
from . import collectives as col
from .sharded_dba import ba_step, shard_tables

EP_DAMP = 1e-7  # as factor_graph.EP_DAMP


def make_sharded_track_step(mesh, F: int, hw_shape, pmax: int,
                            iters: int = 2, metric_depth_reg: bool = True,
                            uncertainty_aware: bool = True):
    """Build step(model, poses, disps, disps_up, intrinsics, uncert_inv,
    mono_disps, mono_mask_small, net, inp, target, weight, corr, ii, jj,
    valid, gru_valid, damping, groups, owner, t0, t1) -> (net, target,
    weight, damping, poses, disps, disps_up).

    net, inp, target, weight, ii, jj, valid and gru_valid are per-shard
    lists of (E_cap, ...) blocks in ``shard_edges_by_frame`` order (see
    ``collectives.shard_rows``); gru_valid marks the active edges (update
    operator and BA) among the BA-only ones (stored target and weight).
    corr[d] holds the packed correlation volumes of shard d's active edges
    in their local order (the JAX step takes zero volumes for the others).
    groups (D, F, degree) and owner (D, F) are ``shard_edges_by_frame``'s
    tables. The replicated arguments are tensors; the per-edge results are
    per-shard lists, the replicated ones on the device of poses. The model
    runs on each card from a copy made once per card."""
    h, w = hw_shape
    devs = mesh.devices
    D = len(devs)
    replicas = {}

    def model_on(model, dev):
        if next(model.parameters()).device == dev:
            return model
        if (id(model), dev) not in replicas:
            replicas[(id(model), dev)] = copy.deepcopy(model).to(dev)
        return replicas[(id(model), dev)]

    @torch.no_grad()
    def step(model, poses, disps, disps_up, intrinsics, uncert_inv,
             mono_disps, mono_mask_small, net, inp, target, weight, corr, ii,
             jj, valid, gru_valid, damping, groups, owner, t0, t1):
        out_dev = poses.device
        P, Dp, I, U, damp = (col.replicate(x, devs) for x in (
            poses, disps, intrinsics, uncert_inv, damping))
        groups_l, owner_l = shard_tables(groups, owner, devs)

        net2, tgt2, wgt2, upd = [], [], [], []
        d_damp = []
        for d, dev in enumerate(devs):
            act = torch.nonzero(gru_valid[d] & valid[d]).squeeze(1)
            n2, t2, w2 = net[d], target[d], weight[d]
            dd = torch.zeros_like(damp[d])
            if act.numel():
                ii_a, jj_a = ii[d][act], jj[d][act]
                coords0 = projective.coords_grid(h, w, device=dev)
                coords1, _ = projective.projective_transform(
                    P[d], Dp[d], I[d], ii_a, jj_a)
                motn = droid_net.motion_features(coords0, coords1,
                                                 target[d][act])
                cor = correlation.corr_lookup_packed(corr[d], coords1)
                net_a, delta, w_a, frames, eta, upmask = model_on(
                    model, dev).update(net[d][act], inp[d][act], cor, motn,
                                       ii_a)
                n2 = net[d].index_put((act,), net_a)
                t2 = target[d].index_put((act,), coords1 + delta)
                w2 = weight[d].index_put((act,), w_a)
                dd[frames] = eta - damp[d][frames]
                upd.append((frames, upmask))
            else:
                upd.append(None)
            net2.append(n2)
            tgt2.append(t2)
            wgt2.append(w2)
            d_damp.append(dd)
        dsum = col.psum(d_damp, devs)
        damping2 = [damp[d] + dsum[d] for d in range(D)]
        eta_l = [0.2 * x + EP_DAMP for x in damping2]

        if uncertainty_aware:
            wgt_ba = [wgt2[d] * U[d][torch.clamp(ii[d], 0, F - 1)][..., None]
                      for d in range(D)]
        else:
            wgt_ba = wgt2
        if metric_depth_reg:
            sens = col.replicate(mono_disps, devs)
            sens_v = col.replicate(mono_mask_small, devs)
        else:
            sens = sens_v = None
        P2, Dp2 = P, Dp
        for _ in range(iters):
            P2, Dp2 = ba_step(mesh, P2, Dp2, I, tgt2, wgt_ba, eta_l, ii, jj,
                              valid, groups_l, owner_l, t0, t1,
                              dba.BAConfig(lm=1e-4, ep=0.1), sens, sens_v,
                              pmax)

        # the upsampled disparities of each shard's frames, by a psum of
        # their changes over the rows the frames span
        spans = [(int(u[0].min()), int(u[0].max()) + 1) for u in upd
                 if u is not None]
        disps_up2 = disps_up
        if spans:
            lo = min(s[0] for s in spans)
            hi = max(s[1] for s in spans)
            win = col.replicate(disps_up[lo:hi], devs)
            deltas = []
            for d, dev in enumerate(devs):
                du = torch.zeros_like(win[d])
                if upd[d] is not None:
                    frames, upmask = upd[d]
                    up = droid_net.upsample_disp(Dp2[d][frames], upmask)
                    du[frames - lo] = up - win[d][frames - lo]
                deltas.append(du)
            dsum = col.psum(deltas, devs)
            rows = torch.arange(lo, hi, device=out_dev)
            disps_up2 = disps_up.index_copy(
                0, rows, col.move(win[0] + dsum[0], out_dev))
        return (net2, tgt2, wgt2, col.move(damping2[0], out_dev),
                col.move(P2[0], out_dev), col.move(Dp2[0], out_dev),
                disps_up2)

    return step
