"""Plain PyTorch reference of the keyframe priors' networks: the DINOv2
vision transformer (with or without registers), the DPT metric-depth head
and DepthAnythingV2.

Written for the benchmark from the published sources: DINOv2's
``dinov2/models/vision_transformer.py`` and ``dinov2/layers/`` (Oquab et
al. 2023; registers: Darcet et al. 2023) and Depth Anything V2's
``metric_depth/depth_anything_v2/dpt.py`` and ``util/blocks.py`` (Yang et
al. 2024). Weights come in as a dict of tensors by upstream's names
(``patch_embed.proj``, ``pos_embed``, ``blocks.{i}.{norm1, attn.qkv,
attn.proj, ls1.gamma, norm2, mlp.fc1, mlp.fc2, ls2.gamma}``, ``norm``;
``pretrained.*`` and ``depth_head.*`` in a DepthAnythingV2). Inputs are
(B, H, W, 3) normalised images with H and W divisible by 14. Everything
runs in float32 with TF32 off for matmuls and cuDNN (``precision``); the
control of the readings runs it with TF32 on. It imports nothing of the
program, has no cache and no batching beyond the input's own.

- Patch embedding, the class token with its positional embedding, the
  registers after it (no positional embedding), LayerNorm eps 1e-6, exact
  GELU, LayerScale after each branch; the tapped layers are LayerNormed and
  their prefix tokens dropped (``get_intermediate_layers(norm=True)``).
- Attention is the explicit softmax of the scaled scores, computed
  ``HEADS_AT_ONCE`` heads at a time to bound its memory.
- The DPT head: 1x1 projections, the resize stack (transposed convolutions
  at stride 4 and 2, identity, a 3x3 convolution at stride 2), the 3x3
  ``layer*_rn`` convolutions without bias, four RefineNet fusion blocks
  (residual conv units, bilinear resizes with ``align_corners=True``, 1x1
  out-convolutions), ``output_conv1``, a bilinear resize to the input's
  size, ``output_conv2``; the sigmoid's input is returned beside the depth,
  sigmoid x ``max_depth``.

One departure from upstream, noted here as the program and the JAX package
share it (ROADMAP Queue 3): the positional embedding is resized from its
37x37 grid as ``jax.image.resize(method="bicubic")`` resizes (Keys a =
-0.5, the kernel widened by the scale when shrinking, weights renormalised),
not by upstream's ``F.interpolate(mode="bicubic", scale_factor=(n + 0.1) /
37)`` (a = -0.75, no antialias). Written upstream's way, the comparison
would measure that known difference and not the program;
``resize_pos_embed_upstream`` is upstream's, for the planted fault.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

PATCH = 14
LN_EPS = 1e-6
HEADS_AT_ONCE = 4
INTERMEDIATE = {"vits": (2, 5, 8, 11), "vitb": (2, 5, 8, 11),
                "vitl": (4, 11, 17, 23), "vitg": (9, 19, 29, 39)}
HEADS = {"vits": 6, "vitb": 12, "vitl": 16, "vitg": 24}


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Matmuls and cuDNN in float32 (or, with `tf32`, in TF32) for the
    block; the caller's settings are restored after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# --------------------------------------------------------------------------
# the positional embedding's resize
# --------------------------------------------------------------------------

def _keys(x):
    """Keys' cubic kernel with a = -0.5."""
    x = x.abs()
    near = (1.5 * x - 2.5) * x * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x < 1.0, near, torch.where(x < 2.0, far,
                                                  torch.zeros_like(x)))


def resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) weights of one axis, as ``jax.image.resize``'s
    bicubic: sample i at (i + 0.5) n_in / n_out - 0.5, the kernel widened by
    n_in / n_out when shrinking, each row summing to 1. Built in float64."""
    if n_in == n_out:
        return torch.eye(n_in, device=device)
    inv = n_in / n_out
    at = (torch.arange(n_out, dtype=torch.float64) + 0.5) * inv - 0.5
    w = _keys((at[:, None] - torch.arange(n_in, dtype=torch.float64)[None])
              / max(inv, 1.0))
    return (w / w.sum(1, keepdim=True)).to(torch.float32).to(device)


def resize_pos_embed(grid: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(g, g, C) -> (ph, pw, C), rows first."""
    wh = resize_weights(grid.shape[0], ph, grid.device)
    ww = resize_weights(grid.shape[1], pw, grid.device)
    return torch.einsum("qw,pwc->pqc", ww, torch.einsum("ph,hwc->pwc", wh,
                                                         grid))


def resize_pos_embed_upstream(grid: torch.Tensor, ph: int,
                              pw: int) -> torch.Tensor:
    """Upstream DINOv2's ``interpolate_pos_encoding``: bicubic
    ``F.interpolate`` by the scale factor (n + 0.1) / g, no antialias."""
    g = grid.shape[0]
    out = F.interpolate(grid.permute(2, 0, 1)[None], mode="bicubic",
                        scale_factor=((ph + 0.1) / g, (pw + 0.1) / g))
    assert out.shape[-2:] == (ph, pw)
    return out[0].permute(1, 2, 0)


# --------------------------------------------------------------------------
# the vision transformer
# --------------------------------------------------------------------------

def _ln(w, name, x):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"],
                        w[f"{name}.bias"], LN_EPS)


def _linear(w, name, x):
    return F.linear(x, w[f"{name}.weight"], w[f"{name}.bias"])


def attention(w, name, x, heads: int):
    B, N, C = x.shape
    d = C // heads
    q, k, v = _linear(w, f"{name}.qkv", x).reshape(
        B, N, 3, heads, d).permute(2, 0, 3, 1, 4)
    outs = []
    for h in range(0, heads, HEADS_AT_ONCE):
        s = slice(h, h + HEADS_AT_ONCE)
        p = torch.softmax((q[:, s] * d ** -0.5) @ k[:, s].transpose(-1, -2),
                          dim=-1)
        outs.append(p @ v[:, s])
    o = torch.cat(outs, 1).transpose(1, 2).reshape(B, N, C)
    return _linear(w, f"{name}.proj", o)


def block(w, name, x, heads: int):
    x = x + w[f"{name}.ls1.gamma"] * attention(
        w, f"{name}.attn", _ln(w, f"{name}.norm1", x), heads)
    h = F.gelu(_linear(w, f"{name}.mlp.fc1", _ln(w, f"{name}.norm2", x)))
    return x + w[f"{name}.ls2.gamma"] * _linear(w, f"{name}.mlp.fc2", h)


def depth_of(w, prefix: str = "") -> int:
    return sum(1 for k in w if k.startswith(f"{prefix}blocks.")
               and k.endswith(".norm1.weight"))


def vit(w, x, out_layers, heads: int, prefix: str = "",
        pos_resize=resize_pos_embed, streams=None):
    """[(patch tokens, class token)] of each of `out_layers`, LayerNormed.
    `streams`, a list, receives the residual stream before the first block
    and after each."""
    B, H, W, _ = x.shape
    ph, pw = H // PATCH, W // PATCH
    t = F.conv2d(x.permute(0, 3, 1, 2), w[f"{prefix}patch_embed.proj.weight"],
                 w[f"{prefix}patch_embed.proj.bias"], stride=PATCH)
    t = t.flatten(2).transpose(1, 2)
    pos = w[f"{prefix}pos_embed"][0]
    g = math.isqrt(pos.shape[0] - 1)
    C = pos.shape[-1]
    t = t + pos_resize(pos[1:].reshape(g, g, C), ph, pw).reshape(ph * pw, C)
    tokens = [(w[f"{prefix}cls_token"] + pos[None, :1]).expand(B, -1, -1)]
    reg = w.get(f"{prefix}register_tokens")
    if reg is not None:
        tokens.append(reg.expand(B, -1, -1))
    t = torch.cat(tokens + [t], 1)
    n_prefix = 1 + (0 if reg is None else reg.shape[1])
    if streams is not None:
        streams.append(t)
    taps = {}
    for i in range(depth_of(w, prefix)):
        t = block(w, f"{prefix}blocks.{i}", t, heads)
        if streams is not None:
            streams.append(t)
        if i in out_layers:
            taps[i] = _ln(w, f"{prefix}norm", t)
    return [(taps[i][:, n_prefix:], taps[i][:, 0]) for i in out_layers]


# --------------------------------------------------------------------------
# the DPT head
# --------------------------------------------------------------------------

def _conv(w, name, x, stride=1, padding=0):
    return F.conv2d(x, w[f"{name}.weight"], w.get(f"{name}.bias"),
                    stride=stride, padding=padding)


def _rcu(w, name, x):
    out = _conv(w, f"{name}.conv1", F.relu(x), padding=1)
    return _conv(w, f"{name}.conv2", F.relu(out), padding=1) + x


def _fusion(w, name, x, res=None, size=None):
    if res is not None:
        x = x + _rcu(w, f"{name}.resConfUnit1", res)
    x = _rcu(w, f"{name}.resConfUnit2", x)
    if size is None:
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
    else:
        x = F.interpolate(x, size=tuple(size), mode="bilinear",
                          align_corners=True)
    return _conv(w, f"{name}.out_conv", x)


def dpt_head(w, patch_tokens, ph: int, pw: int, prefix="depth_head."):
    """The sigmoid's input (B, ph * 14, pw * 14) from the four tapped
    layers' patch tokens, shallow to deep."""
    outs = []
    for i, t in enumerate(patch_tokens):
        B, N, C = t.shape
        x = _conv(w, f"{prefix}projects.{i}",
                  t.permute(0, 2, 1).reshape(B, C, ph, pw))
        r = f"{prefix}resize_layers.{i}"
        if i in (0, 1):
            x = F.conv_transpose2d(x, w[f"{r}.weight"], w[f"{r}.bias"],
                                   stride=4 if i == 0 else 2)
        elif i == 3:
            x = _conv(w, r, x, stride=2, padding=1)
        outs.append(x)
    s = f"{prefix}scratch"
    rn = [_conv(w, f"{s}.layer{i + 1}_rn", outs[i], padding=1)
          for i in range(4)]
    path = _fusion(w, f"{s}.refinenet4", rn[3], size=rn[2].shape[2:])
    path = _fusion(w, f"{s}.refinenet3", path, rn[2], size=rn[1].shape[2:])
    path = _fusion(w, f"{s}.refinenet2", path, rn[1], size=rn[0].shape[2:])
    path = _fusion(w, f"{s}.refinenet1", path, rn[0])
    out = _conv(w, f"{s}.output_conv1", path, padding=1)
    out = F.interpolate(out, (ph * PATCH, pw * PATCH), mode="bilinear",
                        align_corners=True)
    out = F.relu(_conv(w, f"{s}.output_conv2.0", out, padding=1))
    return _conv(w, f"{s}.output_conv2.2", out)[:, 0]


# --------------------------------------------------------------------------
# the two networks
# --------------------------------------------------------------------------

@torch.no_grad()
def depth_anything(w, x, layers, heads: int, max_depth: float = 20.0,
                   tf32: bool = False, pos_resize=resize_pos_embed):
    """DepthAnythingV2: {"taps": the tapped layers' patch tokens, "logit":
    the head's map before the sigmoid, "depth": metric depth}."""
    with precision(tf32):
        B, H, W, _ = x.shape
        taps = [p for p, _ in vit(w, x, layers, heads, "pretrained.",
                                  pos_resize)]
        logit = dpt_head(w, taps, H // PATCH, W // PATCH)
        return dict(taps=taps, logit=logit,
                    depth=torch.sigmoid(logit) * max_depth)


@torch.no_grad()
def features(w, x, heads: int, tf32: bool = False,
             pos_resize=resize_pos_embed):
    """The last layer's LayerNormed patch tokens (B, h * w, C)."""
    with precision(tf32):
        return vit(w, x, (depth_of(w) - 1,), heads, "", pos_resize)[0][0]
