"""SLAM system, first piece; torch port of part of
``wildgs_slam_tpu/slam/system.py``.

``uncertainty_update`` refreshes the frontend's BA weights from the
mapper's uncertainty MLP, as the JAX ``SLAM.__init__``'s
``uncertainty_update`` closure does, over the DINO features of every live
keyframe (no device feature mirror, no frame-count buckets). The system's
frame loop, the backend and the evaluation wait for later slices.
"""

from __future__ import annotations

import torch

from . import keyframe_store as kstore


@torch.no_grad()
def uncertainty_update(state, mlp, train_frac_fix: float):
    """Run `mlp` over the DINO features of keyframes 0..counter-1 into
    ``state.store.uncertainties_inv``."""
    if not state.uncertainty_aware or state.counter == 0:
        return
    n = state.counter
    dev = state.store.poses.device
    feats = torch.as_tensor(state.dino_feats[:n], device=dev)
    kstore.update_uncertainties(state.store, mlp, feats,
                                torch.arange(n, device=dev), train_frac_fix)
