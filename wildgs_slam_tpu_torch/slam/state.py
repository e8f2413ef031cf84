"""SlamState: the single-controller shared state; torch port of
``wildgs_slam_tpu/slam/state.py``.

One host object owns the device ``KeyframeStore`` that the frontend and the
mapper share, the keyframe counter, and the host-side payloads the mapper
reads (full-resolution images, DINO features, timestamps) as numpy
arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from . import keyframe_store as kstore


@dataclass
class SlamState:
    store: Any                                # KeyframeStore (device)
    counter: int = 0                          # keyframe count
    images: Optional[np.ndarray] = None       # (B, H, W, 3) host float32
    dino_feats: Optional[np.ndarray] = None   # (B, h14, w14, D) host
    timestamps: Optional[np.ndarray] = None
    metric_depth_reg: bool = True
    uncertainty_aware: bool = True
    cfg: dict = field(default_factory=dict)

    @classmethod
    def create(cls, cfg, ht, wd, intrinsics_full, buffer=350,
               uncertainty_aware=True, metric_depth_reg=True,
               feature_dim=384, device="cuda"):
        store = kstore.create(buffer, ht, wd, intrinsics_full, device=device)
        images = np.zeros((buffer, ht, wd, 3), np.float32)
        dino = (np.zeros((buffer, ht // 14, wd // 14, feature_dim),
                         np.float32) if uncertainty_aware else None)
        return cls(store=store, counter=0, images=images, dino_feats=dino,
                   timestamps=np.zeros(buffer), cfg=cfg,
                   metric_depth_reg=metric_depth_reg,
                   uncertainty_aware=uncertainty_aware)

    def append_host(self, index, image, dino=None, timestamp=0.0):
        self.images[index] = np.asarray(image)
        if dino is not None and self.dino_feats is not None:
            self.dino_feats[index] = np.asarray(dino)
        self.timestamps[index] = timestamp
        self.counter = max(self.counter, index + 1)

    def remove_keyframe_host(self, ix):
        """Shift the host-side per-frame arrays down over slot ix."""
        self.images[ix:-1] = self.images[ix + 1:]
        if self.dino_feats is not None:
            self.dino_feats[ix:-1] = self.dino_feats[ix + 1:]
        self.timestamps[ix:-1] = self.timestamps[ix + 1:]
