"""Factor graph of the tracker; torch port of
``wildgs_slam_tpu/slam/factor_graph.py``.

Edge topology (ii, jj, age, the inactive and bad lists, the proximity
proposal with its NMS) lives on the host as numpy, as there. Edge state
lives on the device: GRU hidden states, context features, flow targets
and confidences are plain (E, h, w, C) tensors that grow and shrink with
the edge list; the correlation volumes of the live edges are rows of one
preallocated (capacity, h*w, sum of the 4 level sizes) bfloat16 tensor
(the JAX package also stores them in bfloat16; the lookup reads them back
in float32).

With a ``mesh`` (``parallel/mesh.py``) the network ``update_n`` runs the
edge-sharded step of ``parallel/sharded_track.py`` instead, as the JAX
graph's ``_update_n_sharded``: always ``n`` iterations, no early exit and no
``motion_only``, a NaN mean delta; the oracle branch comes first and
``update_lowmem`` stays on one device.

Every single-device path of the graph update meets the store at one seam:
``droid_net.motion_features`` builds the update operator's motion input,
``keyframe_store.reproject`` and ``.upsample`` the geometry, and every BA
is ``keyframe_store.ba`` (the uncertainty weights and the metric-depth
prior, then one ``dba.ba``). The paths differ only in the correlation
lookup and in how they write the new edge state back.

``update_n`` runs the JAX ``_update_core`` semantics as a Python loop: per
iteration reproject, build the motion features, look up the correlation,
run the update operator, write the damping of the edges' source frames,
then one ``keyframe_store.ba`` over the active and the selected inactive
edges, in that order (the Schur terms of each source frame's first
``GROUP_DEGREE`` edges only, as the JAX group table); stop early once the
mean |delta| is at most ``eps``; finally one convex upsample with the last
iteration's mask. With ``gt_injection`` set, the update operator is swapped
for ground-truth reprojection targets (the oracle used by the
trajectory-accuracy gates) and every other stage stays.

A graph built with ``corr_impl="alt"`` (the backend's) stores no volumes:
``update_lowmem`` runs global BA with on-the-fly correlation
(``correlation.alt_corr``). Per step it builds the feature pyramid, runs
the update operator over the edges in chunks of 8 source frames (in
ascending order, each against the same poses), writes back their GRU
states, targets, weights and damping rows, then solves one full-window
``keyframe_store.ba`` (lm 1e-5, ep 1e-2). The backend's graphs are seeded
by ``add_backend_proximity_factors`` and, for loop closure, by
``adopt_edges`` from the frontend's graph.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import droid_net
from ..ops import correlation, dba, projective
from ..utils.profiling import TIMER
from . import keyframe_store as kstore

EP_DAMP = 1e-7
ORACLE_UP_FRAMES = 96   # slots whose disps_up the oracle refreshes
PMAX = 96               # pose slots of the sharded step's BA (JAX pmax)
GROUP_DEGREE = 16       # edges per source frame whose Schur terms the BA
                        # takes (the JAX graph's group_degree)
CORR_CHUNK = 8          # edges per correlation-volume build
LOWMEM_CHUNK = 8        # source frames per update-operator call in
                        # update_lowmem
DIST_CHUNK = 1024       # frame pairs per distance evaluation
CORR_DTYPE = torch.bfloat16   # storage of the correlation volumes


def _t(x, device):
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


class FactorGraph:
    def __init__(self, state, model: droid_net.DroidNet, max_factors=-1,
                 corr_impl="volume", mesh=None):
        if corr_impl not in ("volume", "alt"):
            raise ValueError(f"corr_impl {corr_impl!r}: 'volume' or 'alt'")
        self.state = state
        self.model = model
        self.max_factors = max_factors
        self.corr_impl = corr_impl
        self.mesh = mesh           # the sharded update_n's mesh, or None
        self._sharded_steps = {}
        # oracle hook: callable(store, counter) -> (poses_gt (B, 7),
        # disps_gt (B, h, w)); set, it replaces the update operator
        self.gt_injection = None
        store = state.store
        self.device = store.poses.device
        self.h, self.w = store.disps.shape[-2:]
        e = np.zeros(0, np.int64)
        self.ii, self.jj, self.age = e, e.copy(), e.copy()
        self.ii_bad, self.jj_bad = e.copy(), e.copy()
        self.ii_inac, self.jj_inac = e.copy(), e.copy()

        def z(c):
            return torch.zeros(0, self.h, self.w, c, device=self.device)
        self.net, self.inp = z(128), z(128)
        self.target, self.weight = z(2), z(2)
        self.target_inac, self.weight_inac = z(2), z(2)
        self.corr = None   # (capacity, h*w, levels) bfloat16 once edges exist
        self.damping = 1e-6 * torch.ones(store.poses.shape[0], self.h,
                                         self.w, device=self.device)

    @property
    def E(self) -> int:
        return int(self.ii.shape[0])

    # ------------------------------------------------------------------
    # edge state
    # ------------------------------------------------------------------

    def _reserve_corr(self, need: int):
        """Make room for `need` correlation rows (the live rows are kept)."""
        cap = 0 if self.corr is None else self.corr.shape[0]
        if need <= cap:
            return
        new_cap = max(need, 2 * cap,
                      self.max_factors if self.max_factors > 0 else 64)
        n_lvl = sum(a * b for a, b in correlation.level_shapes(self.h,
                                                                self.w))
        grown = torch.empty(new_cap, self.h * self.w, n_lvl,
                            dtype=CORR_DTYPE, device=self.device)
        if self.corr is not None:
            grown[:self.E] = self.corr[:self.E]
        self.corr = None
        self.corr = grown

    @torch.no_grad()
    def _store_corr(self, ii, jj, off):
        fmaps = self.state.store.fmaps
        for s in range(0, ii.shape[0], CORR_CHUNK):
            pyr = correlation.corr_pyramid(fmaps[ii[s:s + CORR_CHUNK]],
                                           fmaps[jj[s:s + CORR_CHUNK]])
            packed = correlation.pack_pyramid(pyr)
            self.corr[off + s:off + s + packed.shape[0]] = packed

    def _keep_rows(self, keep: np.ndarray):
        """Compact the live edge state to the rows where `keep` is set."""
        idx = _t(np.where(keep)[0], self.device)
        self.net, self.inp = self.net[idx], self.inp[idx]
        self.target, self.weight = self.target[idx], self.weight[idx]
        if self.corr is not None:
            self.corr[:idx.shape[0]] = self.corr[idx]

    # ------------------------------------------------------------------
    # edge management
    # ------------------------------------------------------------------

    def _filter_repeated_edges(self, ii, jj):
        eset = set(zip(self.ii.tolist(), self.jj.tolist())) | set(
            zip(self.ii_inac.tolist(), self.jj_inac.tolist()))
        keep = [k for k, (i, j) in enumerate(zip(ii, jj))
                if (int(i), int(j)) not in eset]
        return ii[keep], jj[keep]

    @torch.no_grad()
    def add_factors(self, ii, jj, remove=False):
        ii = np.asarray(ii, np.int64).reshape(-1)
        jj = np.asarray(jj, np.int64).reshape(-1)
        ii, jj = self._filter_repeated_edges(ii, jj)
        if ii.shape[0] == 0:
            return
        if (self.max_factors > 0
                and self.E + ii.shape[0] > self.max_factors
                and self.corr is not None and remove):
            ix = np.argsort(np.argsort(self.age))   # rank by age
            self.rm_factors(ix >= self.max_factors - ii.shape[0], store=True)

        store = self.state.store
        E0 = self.E
        it, jt = _t(ii, self.device), _t(jj, self.device)
        if self.corr_impl == "volume":
            self._reserve_corr(E0 + ii.shape[0])
            self._store_corr(it, jt, E0)
        target, _ = kstore.reproject(store, it, jt)
        self.net = torch.cat([self.net, store.nets[it]])
        self.inp = torch.cat([self.inp, store.inps[it]])
        self.target = torch.cat([self.target, target])
        self.weight = torch.cat([self.weight, torch.zeros_like(target)])
        self.ii = np.concatenate([self.ii, ii])
        self.jj = np.concatenate([self.jj, jj])
        self.age = np.concatenate([self.age, np.zeros_like(ii)])

    @torch.no_grad()
    def rm_factors(self, mask, store=False):
        mask = np.asarray(mask, bool)
        if not mask.any():
            return
        if store:
            idx = _t(np.where(mask)[0], self.device)
            self.target_inac = torch.cat([self.target_inac, self.target[idx]])
            self.weight_inac = torch.cat([self.weight_inac, self.weight[idx]])
            self.ii_inac = np.concatenate([self.ii_inac, self.ii[mask]])
            self.jj_inac = np.concatenate([self.jj_inac, self.jj[mask]])
        keep = ~mask
        self.ii, self.jj, self.age = (self.ii[keep], self.jj[keep],
                                      self.age[keep])
        self._keep_rows(keep)

    @torch.no_grad()
    def rm_keyframe(self, ix: int):
        """Shift the store over keyframe ix and renumber the edges; edges
        touching ix are dropped."""
        kstore.remove_keyframe(self.state.store, ix)
        m = (self.ii_inac == ix) | (self.jj_inac == ix)
        self.ii_inac = np.where(self.ii_inac >= ix, self.ii_inac - 1,
                                self.ii_inac)
        self.jj_inac = np.where(self.jj_inac >= ix, self.jj_inac - 1,
                                self.jj_inac)
        if m.any():
            idx = _t(np.where(~m)[0], self.device)
            self.target_inac = self.target_inac[idx]
            self.weight_inac = self.weight_inac[idx]
            self.ii_inac, self.jj_inac = self.ii_inac[~m], self.jj_inac[~m]
        m = (self.ii == ix) | (self.jj == ix)
        self.ii = np.where(self.ii >= ix, self.ii - 1, self.ii)
        self.jj = np.where(self.jj >= ix, self.jj - 1, self.jj)
        self.rm_factors(m, store=False)

    # ------------------------------------------------------------------
    # updates
    # ------------------------------------------------------------------

    def _window(self, t0, t1, use_inactive):
        """The pose window, the inactive edges that join the BA and the BA's
        group table over the active then the inactive edges (the JAX
        graph's slot order)."""
        if use_inactive and self.ii_inac.shape[0] > 0:
            tmin = max(1, int(self.ii.min()) + 1) if t0 is None else t0
            m = (self.ii_inac >= tmin - 3) & (self.jj_inac >= tmin - 3)
        else:
            m = np.zeros(self.ii_inac.shape[0], bool)
        if t0 is None:
            t0 = max(1, int(self.ii.min()) + 1)
        if t1 is None:
            t1 = max(int(self.ii.max()), int(self.jj.max())) + 1
        sel = _t(np.where(m)[0], self.device)
        ii_np = np.concatenate([self.ii, self.ii_inac[m]])
        groups = dba.make_edge_groups(ii_np, self.state.store.poses.shape[0],
                                      GROUP_DEGREE)
        ii_all = _t(ii_np, self.device)
        jj_all = _t(np.concatenate([self.jj, self.jj_inac[m]]), self.device)
        return t0, t1, sel, ii_all, jj_all, groups

    def update(self, t0=None, t1=None, itrs=2, use_inactive=False,
               motion_only=False):
        return self.update_n(1, t0=t0, t1=t1, itrs=itrs,
                             use_inactive=use_inactive,
                             motion_only=motion_only)

    @torch.no_grad()
    def update_n(self, n, t0=None, t1=None, itrs=2, use_inactive=False,
                 motion_only=False, eps=0.0):
        """Up to `n` graph updates, stopping once the mean |delta| of an
        iteration is at most `eps` (0: always n). The edges age by `n`
        whatever ran. Returns (iterations run, mean |delta| of the last
        one). Each iteration of the single-device path adds to the counters
        ``track.update_iters`` and ``track.edges`` (its active edges) and
        runs three device-marked spans: ``track.upd.corr`` (reprojection,
        motion features, correlation lookup), ``track.upd.operator`` (the
        update operator and its writes) and ``track.upd.ba`` (one
        ``keyframe_store.ba`` over the active, then the inactive edges)."""
        if self.E == 0:
            return None
        if self.gt_injection is not None:
            return self._update_n_oracle(n, t0, t1, itrs, use_inactive,
                                         motion_only, eps)
        if self.mesh is not None:
            return self._update_n_sharded(n, t0, t1, itrs, use_inactive)
        st = self.state
        store = st.store
        t0, t1, sel, ii_all, jj_all, groups = self._window(t0, t1,
                                                           use_inactive)
        ii_t, jj_t = ii_all[:self.E], jj_all[:self.E]
        itgt, iwgt = self.target_inac[sel], self.weight_inac[sel]
        coords0 = projective.coords_grid(self.h, self.w, device=self.device)
        corr_vol = self.corr[:self.E]
        n_done, dmean = 0, torch.zeros((), device=self.device)
        for _ in range(n):
            TIMER.count("track.update_iters")
            TIMER.count("track.edges", self.E)
            with TIMER.phase("track.upd.corr", device=self.device):
                coords1, _ = kstore.reproject(store, ii_t, jj_t)
                motn = droid_net.motion_features(coords0, coords1,
                                                 self.target)
                corr = correlation.corr_lookup_packed(corr_vol, coords1)
            with TIMER.phase("track.upd.operator", device=self.device):
                net, delta, weight, frames, eta, upmask = self.model.update(
                    self.net, self.inp, corr, motn, ii_t)
                self.net, self.weight = net, weight
                self.target = coords1 + delta
                dmean = torch.linalg.norm(delta, dim=-1).mean()
                self.damping[frames] = eta
            with TIMER.phase("track.upd.ba", device=self.device):
                kstore.ba(store, torch.cat([self.target, itgt]),
                          torch.cat([weight, iwgt]),
                          0.2 * self.damping + EP_DAMP, ii_all, jj_all, groups,
                          t0, t1, iters=itrs, lm=1e-4, ep=0.1,
                          motion_only=motion_only,
                          metric_depth_reg=st.metric_depth_reg,
                          uncertainty_aware=st.uncertainty_aware)
            n_done += 1
            if eps > 0 and float(dmean) <= eps:
                break
        kstore.upsample(store, frames, upmask)
        self.age += n      # by the steps requested, as the JAX graph
        return n_done, dmean

    @torch.no_grad()
    def _update_n_sharded(self, n, t0, t1, itrs, use_inactive):
        """update_n over the mesh: `n` edge-sharded track steps (JAX
        ``_update_n_sharded``). The edge state (active rows, then the
        selected inactive ones with zero GRU state) is gathered into
        shard order once per call, and the active rows are written back
        after the last step."""
        from ..parallel import collectives as col
        from ..parallel import sharded_dba, sharded_track

        st = self.state
        store = st.store
        F = store.poses.shape[0]
        devs = self.mesh.devices
        E = self.E
        t0, t1, sel, ii_all, jj_all, _ = self._window(t0, t1, use_inactive)
        ii_np, jj_np = ii_all.cpu().numpy(), jj_all.cpu().numpy()
        meta = sharded_dba.shard_edges_by_frame(ii_np, jj_np, len(devs), F,
                                                GROUP_DEGREE)
        perm, ok = meta["perm"], meta["valid"]
        active = ok & (perm < E)
        n_inac = ii_np.shape[0] - E
        zeros = torch.zeros(n_inac, self.h, self.w, 128, device=self.device)
        gathered = sharded_dba.gather_edges(
            [torch.cat([self.net, zeros]),
             store.inps[torch.clamp(ii_all, 0, F - 1)],
             torch.cat([self.target, self.target_inac[sel]]),
             torch.cat([self.weight, self.weight_inac[sel]]),
             ii_all, jj_all], perm)
        netv, inpv, tgtv, wgtv, iiv, jjv = (col.shard_rows(x, devs)
                                            for x in gathered)
        valid = col.shard_rows(torch.as_tensor(ok.reshape(-1)), devs)
        gru = col.shard_rows(torch.as_tensor(active.reshape(-1)), devs)
        corr = [col.move(self.corr[_t(perm[d][active[d]], self.device)], dev)
                for d, dev in enumerate(devs)]

        key = (self.mesh, F, self.h, self.w, itrs, st.metric_depth_reg,
               st.uncertainty_aware)
        step = self._sharded_steps.get(key)
        if step is None:
            step = sharded_track.make_sharded_track_step(
                self.mesh, F, (self.h, self.w), PMAX, iters=itrs,
                metric_depth_reg=st.metric_depth_reg,
                uncertainty_aware=st.uncertainty_aware)
            self._sharded_steps[key] = step
        sh, sw = kstore.slice_hw(*store.mono_disps_up.shape[-2:])
        poses, disps, disps_up, damping = (store.poses, store.disps,
                                           store.disps_up, self.damping)
        for _ in range(n):
            (netv, tgtv, wgtv, damping, poses, disps, disps_up) = step(
                self.model, poses, disps, disps_up, store.intrinsics,
                store.uncertainties_inv, store.mono_disps,
                store.mono_mask_up[:, sh, sw], netv, inpv, tgtv, wgtv, corr,
                iiv, jjv, valid, gru, damping, meta["groups"], meta["owner"],
                t0, t1)

        # the active rows back into the graph's storage
        flat = _t(np.where(active.reshape(-1))[0], self.device)
        rows = _t(perm.reshape(-1)[active.reshape(-1)], self.device)
        for name, xs in (("net", netv), ("target", tgtv), ("weight", wgtv)):
            getattr(self, name)[rows] = col.unshard_rows(xs, self.device)[flat]
        self.damping.copy_(damping)
        store.poses.copy_(poses)
        store.disps.copy_(disps)
        store.disps_up.copy_(disps_up)
        self.age += n
        return n, torch.full((), float("nan"), device=self.device)

    def _oracle_targets(self, ii, jj):
        """Ground-truth reprojection targets with confidence 0.9."""
        poses_gt, disps_gt = self.gt_injection(self.state.store,
                                               self.state.counter)
        tgt, _ = projective.projective_transform(
            poses_gt, disps_gt, self.state.store.intrinsics, ii, jj)
        return tgt, torch.full_like(tgt, 0.9)

    @torch.no_grad()
    def _update_n_oracle(self, n, t0, t1, itrs, use_inactive, motion_only,
                         eps=0.0):
        """update_n with the update operator swapped for ground-truth
        targets; inactive-edge reuse, damping and the BA are the production
        path. With eps > 0 it stops once the mean flow residual |target -
        reprojection| over the active edges is below eps."""
        st = self.state
        t0, t1, sel, ii_all, jj_all, groups = self._window(t0, t1,
                                                           use_inactive)
        ii_t, jj_t = ii_all[:self.E], jj_all[:self.E]
        tgt, wgt = self._oracle_targets(ii_t, jj_t)
        self.target, self.weight = tgt, wgt
        tgt_all = torch.cat([tgt, self.target_inac[sel]])
        wgt_all = torch.cat([wgt, self.weight_inac[sel]])
        eta = 0.2 * self.damping + EP_DAMP
        n_done = 0
        for _ in range(n):
            if eps > 0 and n_done > 0:
                coords1, _ = kstore.reproject(st.store, ii_t, jj_t)
                if float(torch.linalg.norm(tgt - coords1, dim=-1).mean()) < eps:
                    break
            kstore.ba(st.store, tgt_all, wgt_all, eta, ii_all, jj_all, groups,
                      t0, t1, iters=itrs, motion_only=motion_only,
                      metric_depth_reg=st.metric_depth_reg,
                      uncertainty_aware=st.uncertainty_aware)
            n_done += 1
        # keep disps_up in sync: the oracle has no learned upsampling mask.
        # ORACLE_UP_FRAMES slots from t1 - ORACLE_UP_FRAMES on, as the JAX
        # package: past t1 too, where the depth filter's neighbours of the
        # newest frames (i + 3 .. i + 5) read
        store = st.store
        fb = max(0, t1 - ORACLE_UP_FRAMES)
        frames = torch.arange(fb, min(fb + ORACLE_UP_FRAMES,
                                      store.disps.shape[0]),
                              device=self.device)
        store.disps_up[frames] = kstore.resize_bilinear(
            store.disps[frames], store.disps_up.shape[-2:])
        self.age += n_done
        return n_done, torch.zeros((), device=self.device)

    # ------------------------------------------------------------------
    # global BA (the backend's graphs)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def update_lowmem(self, t0=None, t1=None, itrs=2, steps=8):
        """`steps` global-BA steps with on-the-fly correlation over the pose
        window [t0, t1) (default [1, last frame of an edge]), each the update
        operator per chunk (``alt_corr``), then one ``keyframe_store.ba``."""
        if self.E == 0:
            return
        st = self.state
        if t1 is None:
            t1 = max(int(self.ii.max()), int(self.jj.max())) + 1
        if t0 is None:
            t0 = 1
        ii_t, jj_t = _t(self.ii, self.device), _t(self.jj, self.device)
        groups = dba.make_edge_groups(self.ii, st.store.poses.shape[0],
                                      GROUP_DEGREE)
        ba_kw = dict(iters=itrs, lm=1e-5, ep=1e-2,
                     metric_depth_reg=st.metric_depth_reg,
                     uncertainty_aware=st.uncertainty_aware)
        if self.gt_injection is not None:
            self.target, self.weight = self._oracle_targets(ii_t, jj_t)
            eta = 0.2 * self.damping + EP_DAMP
            for _ in range(steps):
                with TIMER.phase("track.lowmem.step", device=self.device):
                    kstore.ba(st.store, self.target, self.weight, eta, ii_t,
                              jj_t, groups, t0, t1, **ba_kw)
            return

        # edge rows of each chunk of source frames, ascending (over the
        # frames up to the last target frame, as the JAX graph)
        chunks = []
        for i0 in range(0, int(self.jj.max()) + 1, LOWMEM_CHUNK):
            sel = np.where((self.ii >= i0) & (self.ii < i0 + LOWMEM_CHUNK))[0]
            if len(sel):
                chunks.append(_t(sel, self.device))
        n_frames = max(t1, int(self.ii.max()) + 1, int(self.jj.max()) + 1)
        for _ in range(steps):
            with TIMER.phase("track.lowmem.step", device=self.device):
                self._lowmem_step(chunks, ii_t, jj_t, groups, n_frames, t0,
                                  t1, ba_kw)

    def _lowmem_step(self, chunks, ii_t, jj_t, groups, n_frames, t0, t1,
                     ba_kw):
        """One step: the update operator over each chunk (alt_corr), then
        the full-window BA."""
        store = self.state.store
        coords0 = projective.coords_grid(self.h, self.w, device=self.device)
        fpyr = correlation.fmap_pyramid(store.fmaps[:n_frames])
        for sel in chunks:
            iic, jjc = ii_t[sel], jj_t[sel]
            coords1, _ = kstore.reproject(store, iic, jjc)
            motn = droid_net.motion_features(coords0, coords1,
                                             self.target[sel])
            corr = correlation.alt_corr(fpyr, coords1, iic, jjc)
            net, delta, weight, frames, eta, _ = self.model.update(
                self.net[sel], store.inps[iic], corr, motn, iic)
            self.net[sel] = net
            self.target[sel] = coords1 + delta
            self.weight[sel] = weight
            self.damping[frames] = eta
        kstore.ba(store, self.target, self.weight,
                  0.2 * self.damping + EP_DAMP, ii_t, jj_t, groups, t0, t1,
                  **ba_kw)

    def clear_edges(self):
        """Drop every live edge (and any volumes)."""
        e = np.zeros(0, np.int64)
        self.ii, self.jj, self.age = e, e.copy(), e.copy()
        self._keep_rows(np.zeros(0, bool))
        self.corr = None

    def adopt_edges(self, other: "FactorGraph"):
        """Take another graph's live edges with their GRU states, context
        features, targets and weights, in its order (loop closure seeds its
        graph with the frontend's); no volumes, as an alt graph needs
        none."""
        self.ii, self.jj, self.age = (other.ii.copy(), other.jj.copy(),
                                      other.age.copy())
        self.net, self.inp = other.net.clone(), other.inp.clone()
        self.target, self.weight = other.target.clone(), other.weight.clone()

    @torch.no_grad()
    def restore_edge_state(self, net, inp, target, weight, target_inac,
                           weight_inac):
        """Load the live and inactive edges' state (checkpoint resume) for
        the edge lists already set; the correlation volumes are rebuilt
        from the store's fmaps."""
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)
        self.net, self.inp = t(net), t(inp)
        self.target, self.weight = t(target), t(weight)
        self.target_inac, self.weight_inac = t(target_inac), t(weight_inac)
        if self.corr_impl == "volume" and self.E > 0:
            self._reserve_corr(self.E)
            self._store_corr(_t(self.ii, self.device),
                             _t(self.jj, self.device), 0)

    # ------------------------------------------------------------------
    # edge proposal (host numpy, as the JAX package)
    # ------------------------------------------------------------------

    def add_neighborhood_factors(self, t0, t1, r=3):
        ii, jj = np.meshgrid(np.arange(t0, t1), np.arange(t0, t1),
                             indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        keep = (np.abs(ii - jj) > 0) & (np.abs(ii - jj) <= r)
        self.add_factors(ii[keep], jj[keep])

    @torch.no_grad()
    def _distance_matrix(self, ii, jj, beta):
        out = np.empty(len(ii), np.float32)
        for s in range(0, len(ii), DIST_CHUNK):
            e = min(len(ii), s + DIST_CHUNK)
            d = kstore.distance(self.state.store, _t(ii[s:e], self.device),
                                _t(jj[s:e], self.device), beta=beta)
            out[s:e] = d.cpu().numpy()
        return out

    def add_proximity_factors(self, t0=0, t1=0, rad=2, nms=2, beta=0.25,
                              thresh=16.0, remove=False):
        t = self.state.counter
        ix = np.arange(t0, t)
        jx = np.arange(t1, t)
        if len(ix) == 0 or len(jx) == 0:
            return
        ii, jj = np.meshgrid(ix, jx, indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        d = self._distance_matrix(ii, jj, beta)
        d[ii - rad < jj] = np.inf
        d[d > 100] = np.inf

        def suppress(i, j):
            for di in range(-nms, nms + 1):
                for dj in range(-nms, nms + 1):
                    if abs(di) + abs(dj) <= max(min(abs(i - j) - 2, nms), 0):
                        i1, j1 = i + di, j + dj
                        if (t0 <= i1 < t) and (t1 <= j1 < t):
                            d[(i1 - t0) * (t - t1) + (j1 - t1)] = np.inf

        for i, j in zip(np.concatenate([self.ii, self.ii_bad, self.ii_inac]),
                        np.concatenate([self.jj, self.jj_bad, self.jj_inac])):
            suppress(i, j)
        es = []
        for i in range(t0, t):
            for j in range(max(i - rad - 1, 0), i):
                es.append((i, j))
                es.append((j, i))
                d[(i - t0) * (t - t1) + (j - t1)] = np.inf
        for k in np.argsort(d):
            if d[k] > thresh:
                continue
            if len(es) > self.max_factors:
                break
            i, j = int(ii[k]), int(jj[k])
            es.append((i, j))
            es.append((j, i))
            suppress(i, j)
        if es:
            ii_new, jj_new = np.array(es).T
            self.add_factors(ii_new, jj_new, remove)

    def add_backend_proximity_factors(self, t_start, t_end, nms, radius,
                                      thresh, max_factors, beta,
                                      t_start_loop=None, loop=False):
        """The backend's edge proposal over sources [t_start_loop, t_end) and
        targets [t_start, t_end): the radius neighbourhood, then the nearest
        pairs under `thresh` with a box NMS; with `loop`, each such pair
        brings the pairs around it that are more than 20 frames apart.
        Returns the live edge count, or 0 when nothing was added."""
        if t_start_loop is None or not loop:
            t_start_loop = t_start
        ilen = t_end - t_start_loop
        jlen = t_end - t_start
        ii, jj = np.meshgrid(np.arange(t_start_loop, t_end),
                             np.arange(t_start, t_end), indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        d = self._distance_matrix(ii, jj, beta)
        rawd = d.copy().reshape(ilen, jlen)
        d[ii - radius < jj] = np.inf
        d[d > thresh] = np.inf
        d = d.reshape(ilen, jlen)

        es = []
        for i in range(t_start_loop, t_end):
            for j in range(max(i - radius - 1, 0), i):
                es.append((i, j))
                es.append((j, i))
                d[i - t_start_loop, j - t_start] = np.inf
        flat = d.reshape(-1)
        order = np.argsort(flat)
        order = order[np.sort(flat) <= thresh]

        loop_edges = 0
        for k in order.tolist():
            di, dj = k // jlen, k % jlen
            if d[di, dj] > thresh:
                continue
            if len(es) > max_factors:
                break
            i, j = int(ii[k]), int(jj[k])
            if loop:
                sub = [(si, sj)
                       for si in range(max(i - 1, t_start_loop),
                                       min(i + 2, t_end))
                       for sj in range(max(j - 1, t_start), min(j + 2, t_end))
                       if rawd[si - t_start_loop, sj - t_start] <= thresh
                       and si != sj and si - sj > 20]
                es += sub
                loop_edges += len(sub)
            else:
                es.append((i, j))
                es.append((j, i))
            d[max(0, di - nms):min(ilen, di + nms + 1),
              max(0, dj - nms):min(jlen, dj + nms + 1)] = np.inf

        if len(es) < 3 or (loop and loop_edges == 0):
            return 0
        ii_new, jj_new = np.array(es).T
        self.add_factors(ii_new, jj_new, remove=True)
        return self.E
