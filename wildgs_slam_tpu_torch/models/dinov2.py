"""DINOv2 vision transformer (inference); torch port of
``wildgs_slam_tpu/models/dinov2.py``.

The ViT behind (a) the per-patch features that drive the uncertainty MLP
and (b) the DepthAnythingV2 encoder. Parameter names are upstream's
(``patch_embed.proj``, ``cls_token``, ``pos_embed``, ``register_tokens``,
``mask_token``, ``blocks.{i}.{norm1,attn.qkv,attn.proj,ls1.gamma,norm2,
mlp.fc1,mlp.fc2,ls2.gamma}``, ``norm``), so a published checkpoint loads
with ``load_state_dict``.

Inputs of any 14-divisible size: the patch positional embedding is resized
from its pretrained grid as the JAX package resizes it,
``jax.image.resize(method="bicubic")`` (Keys a = -0.5, antialiased when it
shrinks), through the per-axis weights of ``utils/resample.py``; upstream's
``F.interpolate(mode="bicubic")`` differs (ROADMAP Queue 3). Attention is
a float32 matmul and softmax, as the JAX einsum. Each forward adds the
tokens it runs through its blocks to the counter ``prior.tokens``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ..utils.precision import float32_convs
from ..utils.profiling import TIMER
from ..utils.resample import resize

CONFIGS = {
    "vits": dict(embed_dim=384, depth=12, num_heads=6),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16),
    "vitg": dict(embed_dim=1536, depth=40, num_heads=24),
}


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads,
                                  C // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)          # (B, heads, N, d)
        scale = (C // self.num_heads) ** -0.5
        attn = torch.softmax((q * scale) @ k.transpose(-1, -2), dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(B, N, C))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)


class DINOv2(nn.Module):
    def __init__(self, embed_dim=384, depth=12, num_heads=6, patch_size=14,
                 num_register_tokens=0, base_grid=37):
        super().__init__()
        self.embed_dim, self.depth = embed_dim, depth
        self.patch_size = patch_size
        self.num_register_tokens = num_register_tokens
        self.base_grid = base_grid     # pretrained pos-embed grid (518/14)
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + base_grid ** 2, embed_dim))
        if num_register_tokens > 0:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, num_register_tokens, embed_dim))
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))  # unused
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def interpolate_pos_embed(self, ph: int, pw: int) -> torch.Tensor:
        """The patch positional embedding resized to (ph, pw): (ph*pw, C)."""
        g, C = self.base_grid, self.embed_dim
        grid = self.pos_embed[0, 1:].reshape(g, g, C)
        return resize(grid, (ph, pw), "jax_cubic").reshape(ph * pw, C)

    def forward(self, x: torch.Tensor, out_layers: Sequence[int] = ()):
        """x: (B, H, W, 3) normalized images, H and W divisible by the patch
        size. Returns, for each of `out_layers` (default: the last), the
        layer-normed (patch tokens (B, h*w, C), class token (B, C))."""
        B, H, W, _ = x.shape
        ph, pw = H // self.patch_size, W // self.patch_size
        with float32_convs():
            t = self.patch_embed.proj(x.permute(0, 3, 1, 2))
        t = t.flatten(2).transpose(1, 2)
        t = t + self.interpolate_pos_embed(ph, pw)[None]
        tokens = [self.cls_token.expand(B, 1, -1) + self.pos_embed[:, :1]]
        if self.num_register_tokens > 0:
            tokens.append(self.register_tokens.expand(B, -1, -1))
        t = torch.cat(tokens + [t], dim=1)
        TIMER.count("prior.tokens", t.shape[0] * t.shape[1])
        out_layers = tuple(out_layers) or (self.depth - 1,)
        outputs = {}
        for i, blk in enumerate(self.blocks):
            t = blk(t)
            if i in out_layers:
                outputs[i] = t
        n_prefix = 1 + self.num_register_tokens
        result = []
        for i in out_layers:
            h = self.norm(outputs[i])
            result.append((h[:, n_prefix:], h[:, 0]))
        return result


def make_dinov2(variant: str = "vits", num_register_tokens: int = 0):
    return DINOv2(num_register_tokens=num_register_tokens, **CONFIGS[variant])
