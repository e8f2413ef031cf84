"""Per-patch uncertainty MLP; torch port of
``wildgs_slam_tpu/models/uncertainty.py``.

DINOv2 patch features (384-d) -> σ > 0 through 384 -> 64 -> 64 -> 1 with
ReLU and a softplus output. Dropout is off, as on the JAX package's
deterministic path (the mapper never trains with dropout on).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


class UncertaintyMLP(nn.Module):
    def __init__(self, in_dim: int = 384, hidden: int = 64):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.fc3 = nn.Linear(hidden, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., in_dim) -> σ (...,)."""
        h = F.relu(self.fc1(x))
        h = F.relu(self.fc2(h))
        return F.softplus(self.fc3(h))[..., 0]


def init_uncertainty_mlp(generator: torch.Generator, in_dim: int = 384,
                         hidden: int = 64, device="cuda") -> UncertaintyMLP:
    """An MLP with flax's default initialisation (lecun-normal kernels
    truncated at 2σ, zero biases), drawn from `generator`."""
    mlp = UncertaintyMLP(in_dim, hidden)
    with torch.no_grad():
        for lin in (mlp.fc1, mlp.fc2, mlp.fc3):
            fan_in = lin.weight.shape[1]
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            w = torch.empty(lin.weight.shape)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            lin.weight.copy_(w)
            lin.bias.zero_()
    return mlp.to(device)
