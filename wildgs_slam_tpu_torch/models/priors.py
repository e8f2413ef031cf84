"""Mono priors: metric depth and DINO feature predictors with disk caches;
torch port of ``wildgs_slam_tpu/models/priors.py``.

Keyframes get (a) a metric monocular depth map that regularizes the BA and
(b) DINOv2 patch features that drive the uncertainty MLP; both are cached
as .npy under <out>/mono_priors/{depths,features}. Predictors take a numpy
image (H, W, 3) in [0, 1] and return numpy, as the JAX ones; the networks
and every resize run on the predictor's device (the resizes with cv2's
semantics, ``utils/resample.py``).

Checkpoints are read from ``ckpt_dir`` under their published names:
  - depth: ``depth_anything_v2_metric_{hypersim,vkitti}_{vits,vitb,vitl}.pth``
    for ``dpt2_<encoder>_<dataset>_<max depth>``; ``metric3d_vit_*`` runs the
    Metric3D canonical-camera protocol with the DepthAnythingV2 stand-in
    trunk (the Metric3D decoder is not available offline);
  - features: ``dinov2_vits14[_reg].pth`` (hub names), or FiT3D's
    ``fit3d_<name>.pth`` first for ``dinov2[_reg]_small_fine``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.resample import resize
from . import dinov2 as dinov2_mod
from . import dpt as dpt_mod

# the DepthAnythingV2 model that stands in for each Metric3D trunk
METRIC3D_STAND_IN = {"metric3d_vit_small": "dpt2_vits_hypersim_20",
                     "metric3d_vit_large": "dpt2_vitl_hypersim_20",
                     "metric3d_vit_giant2": "dpt2_vitl_hypersim_20"}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _load(path, device):
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return torch.load(path, map_location=device, weights_only=True)


def dpt_checkpoint_name(depth_model: str) -> str:
    """dpt2_<encoder>_<dataset>_<max depth> -> its published file name."""
    encoder, dataset = depth_model.split("_")[1:3]
    return f"depth_anything_v2_metric_{dataset}_{encoder}.pth"


def _dpt_trunk(depth_model: str, ckpt_dir: str, device):
    """dpt2_<encoder>_<dataset>_<max depth> -> a DepthAnythingV2 with the
    published weights."""
    encoder, _, max_depth = depth_model.split("_")[1:4]
    model = dpt_mod.DepthAnythingV2(encoder, float(max_depth))
    model.load_state_dict(_load(os.path.join(
        ckpt_dir, dpt_checkpoint_name(depth_model)), device))
    return model.to(device).eval()


class _Predictor:
    device: torch.device

    def _normalized(self, image, h, w):
        """image -> INTER_AREA resize to (h, w), ImageNet-normalized, on the
        device."""
        x = torch.as_tensor(np.asarray(image, np.float32), device=self.device)
        x = resize(x, (h, w), "area")
        mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        std = torch.tensor(IMAGENET_STD, device=self.device)
        return (x - mean) / std


class DepthAnythingPredictor(_Predictor):
    """Metric depth from DepthAnythingV2 (dpt2_* configs): a 14-aligned
    resize with the shorter side near input_size, then back by INTER_CUBIC."""

    def __init__(self, depth_model: str, ckpt_dir="pretrained",
                 input_size=518, device="cuda"):
        self.device = torch.device(device)
        self.model = _dpt_trunk(depth_model, ckpt_dir, self.device)
        self.input_size = input_size

    @torch.no_grad()
    def __call__(self, image: np.ndarray) -> np.ndarray:
        H, W = image.shape[:2]
        scale = self.input_size / min(H, W)
        nh = int(round(H * scale / 14)) * 14
        nw = int(round(W * scale / 14)) * 14
        depth = self.model(self._normalized(image, nh, nw)[None])[0]
        return resize(depth, (H, W), "cubic").cpu().numpy()


class Metric3DPredictor(_Predictor):
    """The Metric3D canonical-camera protocol: fit the image into 616x1064
    (14-aligned), ImageNet-normalize, centre-pad, predict, crop the pad,
    INTER_CUBIC back to the input size, scale by fx / 1000 for a trunk that
    predicts in the canonical camera, clamp to [0, 300] m. The default trunk
    is the DepthAnythingV2 stand-in, which is already metric, so it skips
    the fx / 1000 rescale."""

    CANONICAL = (616, 1064)
    CANONICAL_F = 1000.0

    def __init__(self, depth_model: str, fx: float, ckpt_dir="pretrained",
                 trunk=None, device="cuda"):
        self.device = torch.device(device)
        self.fx = float(fx)
        self.canonical_trunk = trunk is not None
        if trunk is not None:
            self.model = trunk
        else:
            self.model = _dpt_trunk(
                METRIC3D_STAND_IN.get(depth_model, "dpt2_vitl_hypersim_20"),
                ckpt_dir, self.device)

    @torch.no_grad()
    def __call__(self, image: np.ndarray) -> np.ndarray:
        H, W = image.shape[:2]
        ch, cw = self.CANONICAL
        scale = min(ch / H, cw / W)
        nh, nw = int(H * scale), int(W * scale)
        nh14, nw14 = (nh // 14) * 14, (nw // 14) * 14
        x = self._normalized(image, nh14, nw14)
        pad_h, pad_w = ch - nh14, cw - nw14
        ph0, pw0 = pad_h // 2, pad_w // 2
        x = torch.nn.functional.pad(
            x, (0, 0, pw0, pad_w - pw0, ph0, pad_h - ph0))
        depth = self.model(x[None])[0]
        depth = depth[ph0:ch - (pad_h - ph0), pw0:cw - (pad_w - pw0)]
        depth = resize(depth, (H, W), "cubic")
        if self.canonical_trunk:
            depth = depth * (self.fx / self.CANONICAL_F)
        return torch.clamp(depth, 0.0, 300.0).cpu().numpy()


class DinoFeaturePredictor(_Predictor):
    """DINOv2 ViT-S/14 patch features of the last layer."""

    CANDIDATES = ("{name}.pth", "dinov2_vits14_reg4_pretrain.pth",
                  "dinov2_vits14_pretrain.pth")

    def __init__(self, extractor: str = "dinov2_vits14",
                 ckpt_dir="pretrained", device="cuda"):
        self.device = torch.device(device)
        n_reg = 4 if "reg" in extractor else 0
        self.model = dinov2_mod.make_dinov2("vits", num_register_tokens=n_reg)
        names = [c.format(name=extractor) for c in self._candidates(
            extractor)]
        path = next((os.path.join(ckpt_dir, n) for n in names
                     if os.path.exists(os.path.join(ckpt_dir, n))), None)
        if path is None:
            raise FileNotFoundError(
                f"no checkpoint for {extractor} in {ckpt_dir} (looked for "
                f"{', '.join(names)})")
        self.model.load_state_dict(_load(path, self.device))
        self.model.to(self.device).eval()

    def _candidates(self, extractor):
        return self.CANDIDATES

    @torch.no_grad()
    def __call__(self, image: np.ndarray) -> np.ndarray:
        """image (H, W, 3) in [0, 1] -> features (H//14, W//14, 384)."""
        H, W = image.shape[:2]
        ph, pw = H // 14, W // 14
        x = self._normalized(image, ph * 14, pw * 14)
        feats = self.model(x[None])[0][0][0]
        return feats.reshape(ph, pw, -1).cpu().numpy()


class Fit3DFeaturePredictor(DinoFeaturePredictor):
    """FiT3D's ``dinov2[_reg]_small_fine``: the DINOv2 ViT-S/14 architecture
    with 3D-aware fine-tuned weights, read as DinoFeaturePredictor reads
    them; FiT3D's checkpoint is looked for first, then the base DINOv2
    one."""

    def _candidates(self, extractor):
        base = "dinov2_vits14_reg" if "reg" in extractor else "dinov2_vits14"
        return ("fit3d_{name}.pth", "{name}.pth", f"{base}.pth",
                "dinov2_vits14_reg4_pretrain.pth",
                "dinov2_vits14_pretrain.pth")


class CachingPredictor:
    """Disk cache of a predictor's outputs, one .npy per call, named by a
    call counter unless the caller passes `idx` (ROADMAP Queue 3: every
    call site passes only the image)."""

    def __init__(self, fn, cache_dir):
        self.fn = fn
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)
        self._counter = 0

    def __call__(self, image, idx=None):
        if idx is None:
            idx = self._counter
        self._counter = idx + 1
        path = os.path.join(self.cache_dir, f"{int(idx):05d}.npy")
        if os.path.exists(path):
            return np.load(path)
        out = self.fn(image)
        np.save(path, out)
        return out


def make_prior_fns(cfg, output_dir, ckpt_dir="pretrained", device="cuda"):
    """(depth_fn, feat_fn) for the config's mono_prior section; raises if a
    checkpoint is missing."""
    depth_model = cfg["mono_prior"]["depth"]
    if "metric3d" in depth_model:
        depth_pred = Metric3DPredictor(depth_model, fx=cfg["cam"]["fx"],
                                       ckpt_dir=ckpt_dir, device=device)
    else:
        depth_pred = DepthAnythingPredictor(depth_model, ckpt_dir,
                                            device=device)
    extractor = cfg["mono_prior"]["feature_extractor"]
    cls = (Fit3DFeaturePredictor
           if extractor in ("dinov2_reg_small_fine", "dinov2_small_fine")
           else DinoFeaturePredictor)
    feat_pred = cls(extractor, ckpt_dir, device=device)
    depth_fn = CachingPredictor(
        depth_pred, os.path.join(output_dir, "mono_priors", "depths"))
    feat_fn = CachingPredictor(
        feat_pred, os.path.join(output_dir, "mono_priors", "features"))
    return depth_fn, feat_fn
