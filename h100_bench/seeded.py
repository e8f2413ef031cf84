"""Weights the benchmark makes from the seed, on the device, in a few large
calls, and hands to both the program and the reference: the uncertainty
MLP's and the DROID network's. Kernels are lecun-normal (fan-in of one
output), clipped at two standard deviations as flax's truncated default
is, biases zero. No trained weights are in the repository."""

from __future__ import annotations

import torch

from wildgs_slam_tpu_torch.models.uncertainty import UncertaintyMLP

TRUNC = 0.87962566103423978    # std of a unit normal truncated at +-2


def sub_seed(seed: int, salt: int) -> int:
    return (int(seed) * 2_654_435_761 + salt) % (2 ** 63)


def lecun(shapes: dict, seed: int, salt: int, device) -> dict:
    """{name: tensor} for {name: shape}: one normal draw for every weight
    of rank > 1, split, scaled by each kernel's fan-in; zeros for the
    rest."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, salt))
    kernels = {n: s for n, s in shapes.items() if len(s) > 1}
    total = sum(torch.Size(s).numel() for s in kernels.values())
    flat = torch.clamp(torch.randn(total, generator=g, device=device),
                       -2.0, 2.0)
    out, off = {}, 0
    for n, s in shapes.items():
        if n not in kernels:
            out[n] = torch.zeros(s, device=device)
            continue
        size = torch.Size(s)
        fan_in = size.numel() // size[0]
        out[n] = (flat[off:off + size.numel()].reshape(size)
                  * ((1.0 / fan_in) ** 0.5 / TRUNC))
        off += size.numel()
    return out


def load(module: torch.nn.Module, seed: int, salt: int, device):
    """Fill `module` with lecun(...) of its own parameter shapes; returns
    the weights, as the reference takes them."""
    w = lecun({n: tuple(p.shape) for n, p in module.named_parameters()},
              seed, salt, device)
    module.to(device)
    module.load_state_dict(w)
    return {n: t.clone() for n, t in w.items()}


def uncertainty_mlp(seed: int, feat_dim: int, device) -> UncertaintyMLP:
    """The uncertainty MLP (feat_dim -> 64 -> 64 -> 1), one draw per
    layer."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 11))
    mlp = UncertaintyMLP(feat_dim, 64).to(device)
    with torch.no_grad():
        for lin in (mlp.fc1, mlp.fc2, mlp.fc3):
            std = (1.0 / lin.weight.shape[1]) ** 0.5 / TRUNC
            w = torch.randn(lin.weight.shape, generator=g, device=device)
            lin.weight.copy_(torch.clamp(w, -2.0, 2.0) * std)
            lin.bias.zero_()
    return mlp
