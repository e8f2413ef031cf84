"""Frontend: the local sliding-window BA loop; torch port of
``wildgs_slam_tpu/slam/frontend.py``.

Initialization (the warmup keyframes get neighbourhood and proximity
factors and 8 + 8 updates), the per-keyframe update (edge aging, proximity
proposal, 8 updates split around the mono-depth filter, flow-based
keyframe culling, then loop-closure BA through the backend once the
window is full and enabled, else 4 more updates) and the second-stage
re-initialization once the uncertainty MLP has been trained.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import TIMER
from . import keyframe_store as kstore
from .factor_graph import FactorGraph


class Frontend:
    def __init__(self, state, model, cfg, backend=None,
                 uncertainty_update_fn=None, mesh=None):
        self.state = state
        self.cfg = cfg
        t = cfg["tracking"]
        fe = t["frontend"]
        self.max_age = t["max_age"]
        self.iters1 = 8
        self.iters2 = 4
        self.warmup = t["warmup"]
        self.beta = t["beta"]
        self.frontend_nms = fe["nms"]
        self.keyframe_thresh = fe["keyframe_thresh"]
        self.frontend_window = fe["window"]
        self.frontend_thresh = fe["thresh"]
        self.frontend_radius = fe["radius"]
        self.frontend_max_factors = fe["max_factors"]
        self.enable_loop = fe["enable_loop"]
        self.update_eps = float(fe.get("update_eps", 0.0))
        self.multiview_thresh = t["multiview_filter"]["thresh"]
        self.multiview_visible_num = t["multiview_filter"]["visible_num"]
        self.backend = backend          # Backend, for loop closure
        self.uncertainty_update_fn = uncertainty_update_fn  # () -> None

        self.graph = FactorGraph(state, model,
                                 max_factors=self.frontend_max_factors,
                                 mesh=mesh)
        self.t1 = 0
        self.is_initialized = False
        self.max_consecutive_drop = (self.max_age / self.iters1) // 3
        self.num_keyframes_dropped = 0
        self.n_updates = 0     # __update calls since creation

    # ------------------------------------------------------------------

    @torch.no_grad()
    def _prep_next_slot(self):
        """poses[t1] = poses[t1 - 1]; disps[t1] = mean of disps[t1 - 1]."""
        store = self.state.store
        store.poses[self.t1] = store.poses[self.t1 - 1]
        store.disps[self.t1] = store.disps[self.t1 - 1].mean()

    @torch.no_grad()
    def _prep_next_slot_init(self):
        store = self.state.store
        store.poses[self.t1] = store.poses[self.t1 - 1]
        store.disps[self.t1] = store.disps[self.t1 - 4:self.t1].mean()

    def _filter_mono_depth(self, idx):
        """Cross-view mono-depth filtering of keyframe idx against up to
        nb_ref_frame_metric_depth_filtering reference frames."""
        nb = self.cfg["tracking"]["nb_ref_frame_metric_depth_filtering"]
        jj = self.graph.jj[self.graph.ii == idx]
        refs = list(dict.fromkeys(int(j) for j in jj))[:nb]
        for j in range(idx - 1, max(-1, idx - nb - 1), -1):
            if len(refs) >= nb:
                break
            if j >= 0 and j not in refs:
                refs.append(j)
        if not refs:
            return
        ht, wd = self.state.images.shape[1:3]
        dev = self.state.store.poses.device

        def up(frames):
            f = torch.as_tensor(self.state.dino_feats[frames], device=dev)
            return kstore.resize_bilinear(f, (ht, wd))
        kstore.filter_high_err_mono_depth(
            self.state.store, idx, refs, up([idx])[0], up(refs))

    def _update_depth_masks(self, frames=None):
        """`frames`: the window BA touched (default: every live frame)."""
        with TIMER.phase("track.fe.depth_masks", device=self.graph.device):
            kstore.update_valid_depth_mask(
                self.state.store, self.state.counter, self.multiview_thresh,
                self.multiview_visible_num, frames=frames)

    def __update(self, force_to_add_keyframe):
        self.t1 += 1
        self.n_updates += 1
        g = self.graph
        if g.corr is not None:
            with TIMER.phase("track.fe.rm_factors", device=g.device):
                g.rm_factors(g.age > self.max_age, store=True)
        with TIMER.phase("track.fe.add_proximity", device=g.device):
            g.add_proximity_factors(
                self.t1 - 5, max(self.t1 - self.frontend_window, 0),
                rad=self.frontend_radius, nms=self.frontend_nms,
                thresh=self.frontend_thresh, beta=self.beta, remove=True)

        # iters1 updates, split where the mono-depth filter must see the
        # intermediate state
        run_mono_filter = (not self.cfg.get("fast_mode", False)
                           and self.state.metric_depth_reg
                           and self.state.uncertainty_aware)
        first = min(2, self.iters1) if run_mono_filter else self.iters1
        with TIMER.phase("track.fe.graph_update", device=g.device):
            g.update_n(first, None, None, use_inactive=True,
                       eps=self.update_eps)
        if run_mono_filter:
            with TIMER.phase("track.fe.mono_filter", device=g.device):
                self._filter_mono_depth(self.t1 - 1)
            if self.iters1 > first:
                with TIMER.phase("track.fe.graph_update", device=g.device):
                    g.update_n(self.iters1 - first, None, None,
                               use_inactive=True, eps=self.update_eps)

        with TIMER.phase("track.fe.kf_decision", device=g.device):
            dev = self.state.store.poses.device
            d = kstore.distance(self.state.store,
                                torch.tensor([self.t1 - 2], device=dev),
                                torch.tensor([self.t1 - 1], device=dev),
                                beta=self.beta)
            drop = (float(d[0]) < self.keyframe_thresh
                    and self.num_keyframes_dropped < self.max_consecutive_drop
                    and not force_to_add_keyframe)
        if drop:
            with TIMER.phase("track.fe.rm_keyframe", device=g.device):
                g.rm_keyframe(self.t1 - 1)
                self.state.remove_keyframe_host(self.t1 - 1)
            self.num_keyframes_dropped += 1
            self.state.counter -= 1
            self.t1 -= 1
        else:
            cur_t = self.state.counter
            self.num_keyframes_dropped = 0
            ran_loop = False
            if (self.enable_loop and cur_t > self.frontend_window
                    and self.backend is not None):
                with TIMER.phase("track.fe.loop_ba", device=g.device):
                    _, n_edge = self.backend.loop_ba(
                        t_start=0, t_end=cur_t, steps=self.iters2,
                        motion_only=False, local_graph=g)
                ran_loop = n_edge > 0
            if not ran_loop:
                with TIMER.phase("track.fe.graph_update", device=g.device):
                    g.update_n(self.iters2, None, None, use_inactive=True,
                               eps=self.update_eps)
        with TIMER.phase("track.fe.prep_next", device=g.device):
            self._prep_next_slot()

    def __initialize(self):
        self.t1 = self.state.counter
        g = self.graph
        g.add_neighborhood_factors(0, self.t1, r=3)
        g.update_n(8, 1, use_inactive=True, eps=self.update_eps)
        g.add_proximity_factors(0, 0, rad=2, nms=2,
                                thresh=self.frontend_thresh, remove=False)
        g.update_n(8, 1, use_inactive=True, eps=self.update_eps)
        self._prep_next_slot_init()
        self.is_initialized = True
        g.rm_factors(g.ii < self.warmup - 4, store=True)

    def initialize_second_stage(self):
        """Re-initialize after the first uncertainty training."""
        self.t1 = self.state.counter
        if self.uncertainty_update_fn is not None:
            self.uncertainty_update_fn()
        g = self.graph
        g.add_proximity_factors(0, 0, rad=2, nms=2,
                                thresh=self.frontend_thresh, remove=False)
        g.update_n(8, 1, use_inactive=True, eps=self.update_eps)
        g.age = np.maximum(g.age - 8, 0)
        self._prep_next_slot_init()
        self.is_initialized = True
        g.rm_factors(g.ii < self.warmup - 4, store=True)
        # the 8 updates moved every frame: refresh every mask
        self._update_depth_masks()

    def __call__(self, force_to_add_keyframe=False):
        """Its spans work for unit: the timestamp of the newest keyframe."""
        st = self.state
        with TIMER.unit(float(st.timestamps[st.counter - 1])
                        if st.counter else None):
            if not self.is_initialized and st.counter == self.warmup:
                self.__initialize()
                self._update_depth_masks()
            elif self.is_initialized and self.t1 < st.counter:
                if self.uncertainty_update_fn is not None:
                    with TIMER.phase("track.fe.uncer_update",
                                     device=self.graph.device):
                        self.uncertainty_update_fn()
                self.__update(force_to_add_keyframe)
                lo = int(self.graph.ii.min()) if len(self.graph.ii) else 0
                self._update_depth_masks(frames=np.arange(lo, self.t1))
