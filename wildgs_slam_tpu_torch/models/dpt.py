"""DPT metric-depth head and DepthAnythingV2 (inference); torch port of
``wildgs_slam_tpu/models/dpt.py``.

Four intermediate ViT layers -> 1x1 projections -> the resize stack (two
transposed convolutions, identity, a strided convolution) -> RefineNet
feature fusion -> a sigmoid head scaled by max_depth. Parameter names are
upstream's (``pretrained.*``, ``depth_head.projects.{i}``,
``depth_head.resize_layers.{0,1,3}``, ``depth_head.scratch.layer{i}_rn``,
``depth_head.scratch.refinenet{i}.{resConfUnit1,resConfUnit2,out_conv}``,
``depth_head.scratch.output_conv1``, ``depth_head.scratch.output_conv2.{0,2}``),
so a published metric checkpoint loads with ``load_state_dict``. The
convolutions run in float32 (``float32_convs``); the fusion resizes are
bilinear with ``align_corners=True``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ..utils.precision import float32_convs
from .dinov2 import CONFIGS, DINOv2

INTERMEDIATE_LAYER_IDX = {
    "vits": [2, 5, 8, 11],
    "vitb": [2, 5, 8, 11],
    "vitl": [4, 11, 17, 23],
    "vitg": [9, 19, 29, 39],
}
HEAD_CHANNELS = {
    "vits": (64, [48, 96, 192, 384]),
    "vitb": (128, [96, 192, 384, 768]),
    "vitl": (256, [256, 512, 1024, 1024]),
}


def _resize(x, size):
    return F.interpolate(x, size=(int(size[0]), int(size[1])),
                         mode="bilinear", align_corners=True)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)  # unused by refinenet4
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, res=None, size=None):
        if res is not None:
            x = x + self.resConfUnit1(res)
        x = self.resConfUnit2(x)
        if size is None:
            size = (2 * x.shape[2], 2 * x.shape[3])
        return self.out_conv(_resize(x, size))


class Scratch(nn.Module):
    def __init__(self, features: int, out_channels: Sequence[int]):
        super().__init__()
        for i, c in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(c, features, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features))
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1), nn.Sigmoid())


class DPTHead(nn.Module):
    def __init__(self, in_channels: int, features: int,
                 out_channels: Sequence[int]):
        super().__init__()
        self.projects = nn.ModuleList(nn.Conv2d(in_channels, c, 1)
                                      for c in out_channels)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(out_channels[0], out_channels[0], 4, stride=4),
            nn.ConvTranspose2d(out_channels[1], out_channels[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(out_channels[3], out_channels[3], 3, stride=2,
                      padding=1)])
        self.scratch = Scratch(features, out_channels)

    @float32_convs()
    def forward(self, layers, patch_h: int, patch_w: int):
        """layers: 4 (B, N, C) patch-token tensors (shallow -> deep).
        Returns (B, patch_h * 14, patch_w * 14) in [0, 1]."""
        outs = []
        for i, x in enumerate(layers):
            B, N, C = x.shape
            h = x.transpose(1, 2).reshape(B, C, patch_h, patch_w)
            outs.append(self.resize_layers[i](self.projects[i](h)))
        s = self.scratch
        rn = [getattr(s, f"layer{i + 1}_rn")(outs[i]) for i in range(4)]
        path4 = s.refinenet4(rn[3], size=rn[2].shape[2:])
        path3 = s.refinenet3(path4, rn[2], size=rn[1].shape[2:])
        path2 = s.refinenet2(path3, rn[1], size=rn[0].shape[2:])
        path1 = s.refinenet1(path2, rn[0])
        h = _resize(s.output_conv1(path1), (patch_h * 14, patch_w * 14))
        return s.output_conv2(h)[:, 0]


class DepthAnythingV2(nn.Module):
    def __init__(self, encoder: str = "vits", max_depth: float = 20.0):
        super().__init__()
        self.encoder = encoder
        self.max_depth = max_depth
        self.pretrained = DINOv2(**CONFIGS[encoder])
        features, out_channels = HEAD_CHANNELS[encoder]
        self.depth_head = DPTHead(CONFIGS[encoder]["embed_dim"], features,
                                  out_channels)

    def forward(self, x):
        """x (B, H, W, 3) normalized, H and W divisible by 14 -> metric
        depth (B, H, W)."""
        B, H, W, _ = x.shape
        feats = self.pretrained(x, out_layers=INTERMEDIATE_LAYER_IDX[
            self.encoder])
        depth = self.depth_head([f[0] for f in feats], H // 14, W // 14)
        return depth * self.max_depth
