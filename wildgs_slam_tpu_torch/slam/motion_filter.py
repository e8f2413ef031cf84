"""Motion filter: keyframe selection by approximate flow magnitude; torch
port of ``wildgs_slam_tpu/slam/motion_filter.py`` with the semantics of its
``_track_legacy`` path.

Every incoming frame is encoded with fnet; one update-operator step against
the last keyframe at the identity flow estimates the mean flow; the frame
becomes a keyframe if that flow exceeds ``thresh`` (px at 1/8 resolution)
or if ``force_keyframe_every_n_frames`` have passed. Keyframes also get
their context features, the metric depth prior and the DINO features, from
the injected ``depth_fn`` and ``feat_fn``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import droid_net
from ..ops import correlation, projective
from ..utils.profiling import TIMER
from . import keyframe_store as kstore

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_image(image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) in [0, 1] -> ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, device=image.device)
    std = torch.tensor(IMAGENET_STD, device=image.device)
    return (image - mean) / std


def _encode_fmap(model, image_norm):
    return model.fnet(image_norm[None])[0]


def _encode_context(model, image_norm):
    """cnet on one frame: (net, inp), each (h, w, 128)."""
    net, inp = droid_net.context_split(model.cnet(image_norm[None]))
    return net[0], inp[0]


def _flow_magnitude(model, fmap_last, gmap, net, inp):
    """One update-operator step at the pixel grid -> mean |delta|."""
    h, w, _ = gmap.shape
    pyr = correlation.corr_pyramid(fmap_last[None], gmap[None])
    coords0 = projective.coords_grid(h, w, device=gmap.device)[None]
    corr = correlation.corr_lookup(pyr, coords0)
    flow = torch.zeros(1, h, w, 4, device=gmap.device)
    ii = torch.zeros(1, dtype=torch.int64, device=gmap.device)
    _, delta, _, _, _, _ = model.update(net[None], inp[None], corr, flow, ii)
    return torch.linalg.norm(delta, dim=-1).mean()


class MotionFilter:
    def __init__(self, state, model: droid_net.DroidNet, thresh=2.5,
                 force_keyframe_every_n_frames=-1, depth_fn=None,
                 feat_fn=None):
        self.state = state
        self.model = model
        self.thresh = thresh
        self.force_every = force_keyframe_every_n_frames
        self.depth_fn = depth_fn    # image -> (H, W) metric depth or None
        self.feat_fn = feat_fn      # image -> (h14, w14, 384) or None
        self.count = 0
        self.fmap = self.net = self.inp = None   # last keyframe's features

    @torch.no_grad()
    def track(self, tstamp, image) -> bool:
        """image (H, W, 3) float in [0, 1]. Returns the force-keyframe
        flag."""
        state = self.state
        dev = state.store.poses.device
        with TIMER.phase("track.mf.encode_fmap"):
            img_norm = normalize_image(torch.as_tensor(
                np.ascontiguousarray(image, np.float32), device=dev))
            gmap = _encode_fmap(self.model, img_norm)
        if state.counter == 0:
            self._append_keyframe(tstamp, image, img_norm, gmap, first=True)
            return False
        with TIMER.phase("track.mf.flow"):
            flow = float(_flow_magnitude(self.model, self.fmap, gmap,
                                         self.net, self.inp))
        force = False
        if self.force_every > 0:
            last_t = state.timestamps[state.counter - 1]
            force = (tstamp - last_t) >= self.force_every
        if flow > self.thresh or force:
            self.count = 0
            self._append_keyframe(tstamp, image, img_norm, gmap, first=False)
        else:
            self.count += 1
        return force

    def _append_keyframe(self, tstamp, image, img_norm, gmap, first):
        state = self.state
        with TIMER.phase("track.mf.encode_ctx"):
            net, inp = _encode_context(self.model, img_norm)
        self.fmap, self.net, self.inp = gmap, net, inp
        with TIMER.phase("track.mf.priors"):
            depth = self.depth_fn(image) if self.depth_fn is not None else None
            dino = self.feat_fn(image) if self.feat_fn is not None else None
        idx = state.counter
        with TIMER.phase("track.mf.append"):
            kstore.append(
                state.store, idx, tstamp,
                pose=([0, 0, 0, 0, 0, 0, 1.0] if first else None),
                disp=(torch.ones_like(state.store.disps[0]) if first
                      else None),
                mono_depth_up=depth, fmap=gmap, net=net, inp=inp)
            state.append_host(idx, image, dino, tstamp)
