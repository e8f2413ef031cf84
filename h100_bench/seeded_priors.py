"""Weights the benchmark makes from the seed for the keyframe priors'
networks, DepthAnythingV2 and DINOv2, on the device, and hands to both the
program and the reference (``reference/priors.py``), by upstream's
parameter names. No trained checkpoint is in the repository.

``seeded.py``'s rule (lecun kernels, every rank-1 parameter zero) would
leave these networks inert: a zero LayerNorm weight and a zero LayerScale
gamma make every block add nothing, and the features and the head's input
constant. So, parameter by parameter:

- Linear and convolution kernels: lecun-normal (a unit normal clipped at
  two standard deviations, scaled to variance 1 / fan-in), as ``seeded.py``
  draws them; a transposed convolution's fan-in is the inputs that reach
  one output (its input channels, at stride = kernel);
- biases, LayerNorm biases included: N(0, ``BIAS_STD``);
- LayerNorm weights: 1 + N(0, ``NORM_STD``);
- ``pos_embed``, ``cls_token``, ``register_tokens``: N(0, 0.02), DINOv2's
  own initialisation; ``mask_token`` (unused at inference) zero;
- LayerScale gammas: ``LS_GAMMA`` x (1 + N(0, ``LS_SPREAD``)). DINOv2
  initialises them at 1e-5, which leaves a block's move below float32's
  resolution of the residual stream; at 0.25 every block of the ViT-L moves
  the stream by a few percent of its norm or more (the CPU tests hold the
  floor at 1%), as trained DINOv2 blocks do.
"""

from __future__ import annotations

import torch
from torch import nn

from wildgs_slam_tpu_torch.models import dinov2, dpt, priors

from .seeded import TRUNC, sub_seed

BIAS_STD = 0.02
NORM_STD = 0.05
TOKEN_STD = 0.02
LS_GAMMA = 0.25
LS_SPREAD = 0.2
TOKENS = ("pos_embed", "cls_token", "register_tokens")
SALT_DEPTH, SALT_FEAT = 41, 43


def _fan_ins(module: nn.Module) -> dict:
    """{parameter name: fan-in} of every Linear and convolution kernel."""
    out = {}
    for name, m in module.named_modules():
        key = f"{name}.weight" if name else "weight"
        if isinstance(m, nn.Linear):
            out[key] = m.in_features
        elif isinstance(m, nn.ConvTranspose2d):
            kh, kw = m.kernel_size
            sh, sw = m.stride
            out[key] = max(m.in_channels * kh * kw // (sh * sw), 1)
        elif isinstance(m, nn.Conv2d):
            kh, kw = m.kernel_size
            out[key] = m.in_channels // m.groups * kh * kw
    return out


def seeded_state(module: nn.Module, seed: int, salt: int, device) -> dict:
    """{name: tensor} for every parameter of `module`, by the rule above,
    from one generator of (seed, salt), made on `device`."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, salt))
    fans = _fan_ins(module)
    norms = {f"{n}.weight" if n else "weight"
             for n, m in module.named_modules() if isinstance(m, nn.LayerNorm)}

    def normal(shape):
        return torch.randn(shape, generator=g, device=device)
    out = {}
    for name, p in module.named_parameters():
        shape, leaf = tuple(p.shape), name.rsplit(".", 1)[-1]
        if leaf == "mask_token":
            out[name] = torch.zeros(shape, device=device)
        elif leaf in TOKENS:
            out[name] = TOKEN_STD * normal(shape)
        elif leaf == "gamma":
            out[name] = LS_GAMMA * (1.0 + LS_SPREAD * normal(shape))
        elif name in norms:
            out[name] = 1.0 + NORM_STD * normal(shape)
        elif name in fans:
            out[name] = (torch.clamp(normal(shape), -2.0, 2.0)
                         * ((1.0 / fans[name]) ** 0.5 / TRUNC))
        elif leaf == "bias":
            out[name] = BIAS_STD * normal(shape)
        else:
            raise KeyError(f"no seeded rule for {name} {shape}")
    return out


def load(module: nn.Module, seed: int, salt: int, device) -> dict:
    """Fill `module` (moved to `device`, eval) by the rule; returns its
    weights, as the reference takes them."""
    w = seeded_state(module, seed, salt, device)
    module.to(device).eval()
    module.load_state_dict(w)     # copies: `w` stays the reference's own
    return w


def networks(cfg: dict, seed: int, device):
    """The two networks the configuration's ``mono_prior`` names, built as
    ``models/priors.py`` builds them from their checkpoints and seeded:
    (depth network, feature network, {"depth": weights, "feat": weights})."""
    mp = cfg["mono_prior"]
    stand_in = priors.METRIC3D_STAND_IN.get(mp["depth"], mp["depth"])
    encoder, _, max_depth = stand_in.split("_")[1:4]
    n_reg = 4 if "reg" in mp["feature_extractor"] else 0
    with torch.device(device):
        depth = dpt.DepthAnythingV2(encoder, float(max_depth))
        feat = dinov2.make_dinov2("vits", num_register_tokens=n_reg)
    weights = {"depth": load(depth, seed, SALT_DEPTH, device),
               "feat": load(feat, seed, SALT_FEAT, device)}
    return depth, feat, weights
