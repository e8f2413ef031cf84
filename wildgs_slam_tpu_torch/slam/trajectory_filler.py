"""PoseTrajectoryFiller: every frame's pose after tracking; torch port of
``wildgs_slam_tpu/slam/trajectory_filler.py``.

Frames go in batches of 16 (fewer when the buffer has fewer spare slots):
linear SE3 interpolation between the bracketing keyframes starts each
pose; the frames are appended past the keyframe counter with their fnet
features (and, with the uncertainty MLP, their BA weights), joined by
edges to both bracketing keyframes, and refined by 12 motion-only updates
of a volume graph; then the counter is restored. The DINO features of the
last call are kept in ``last_features`` for the pose refinement.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lie
from . import keyframe_store as kstore
from .factor_graph import FactorGraph
from .motion_filter import _encode_fmap, normalize_image


class PoseTrajectoryFiller:
    def __init__(self, state, model, feat_fn=None, uncer_apply=None,
                 train_frac_fix=0.3):
        self.state = state
        self.model = model
        self.feat_fn = feat_fn            # image -> (h14, w14, D)
        self.uncer_apply = uncer_apply    # (n, h14, w14, D) -> sigma
        self.train_frac_fix = train_frac_fix
        self.last_features = None

    @torch.no_grad()
    def _interpolate(self, timestamps):
        """(bracketing keyframes t0, t1, (M, 7) interpolated w2c)."""
        state = self.state
        N = state.counter
        ts = np.asarray(state.timestamps[:N])
        tt = np.asarray(timestamps)
        t0 = np.array([max(0, int((ts <= t).sum()) - 1) for t in tt])
        t1 = np.where(t0 < N - 1, t0 + 1, t0)
        dev = state.store.poses.device
        P0 = state.store.poses[torch.as_tensor(t0, device=dev)]
        P1 = state.store.poses[torch.as_tensor(t1, device=dev)]
        dt = torch.as_tensor((ts[t1] - ts[t0] + 1e-3).astype(np.float32),
                             device=dev)
        v = lie.se3_log(lie.se3_mul(P1, lie.se3_inv(P0))) / dt[:, None]
        w = v * torch.as_tensor((tt - ts[t0]).astype(np.float32),
                                device=dev)[:, None]
        return t0, t1, lie.se3_mul(lie.se3_exp(w), P0)

    @torch.no_grad()
    def _fill(self, timestamps, images):
        state = self.state
        store = state.store
        N = state.counter
        M = len(timestamps)
        t0, t1, Gs = self._interpolate(timestamps)
        if N + M > store.poses.shape[0]:
            # no spare slots (every frame a keyframe): the interpolation
            # stands
            if self.last_features is not None:
                self.last_features.extend([None] * M)
            return Gs.cpu().numpy()

        dev = store.poses.device
        for m in range(M):
            img = torch.as_tensor(np.asarray(images[m], np.float32),
                                  device=dev)
            fmap = _encode_fmap(self.model, normalize_image(img))
            kstore.append(store, N + m, timestamps[m], pose=Gs[m],
                          disp=torch.ones_like(store.disps[0]), fmap=fmap)
        state.counter = N + M

        if self.uncer_apply is not None and self.feat_fn is not None:
            feats = [np.asarray(self.feat_fn(images[m]), np.float32)
                     for m in range(M)]
            if self.last_features is not None:
                self.last_features.extend(feats)
            kstore.update_uncertainties(
                store, self.uncer_apply,
                torch.as_tensor(np.stack(feats), device=dev),
                torch.arange(N, N + M, device=dev), self.train_frac_fix)

        graph = FactorGraph(state, self.model, max_factors=-1)
        new_ids = np.arange(N, N + M)
        graph.add_factors(t0, new_ids)
        graph.add_factors(t1, new_ids)
        for _ in range(12):
            graph.update(N, N + M, motion_only=True)
        # a copy: the next batch reuses these slots
        poses = store.poses[N:N + M].cpu().numpy().copy()
        state.counter = N
        return poses

    def __call__(self, image_stream, stride=1, batch=16):
        """(frames, 7) w2c poses for frames 0, stride, 2 stride, ... of the
        stream."""
        self.last_features = ([] if (self.uncer_apply is not None
                                     and self.feat_fn is not None) else None)
        spare = self.state.store.poses.shape[0] - self.state.counter
        if spare >= 1:
            batch = min(batch, spare)
        poses, timestamps, images = [], [], []
        for i in range(0, len(image_stream), stride):
            index, color, _, _ = image_stream[i]
            timestamps.append(float(index))
            images.append(color)
            if len(timestamps) == batch:
                poses.append(self._fill(timestamps, images))
                timestamps, images = [], []
        if timestamps:
            poses.append(self._fill(timestamps, images))
        return np.concatenate(poses, axis=0)
