"""Fixed-capacity Gaussian map with Adam and densify/prune; torch port of
``wildgs_slam_tpu/slam/gaussian_map.py``.

The JAX package keeps an immutable pytree and returns a new map from every
function. Here ``GaussianMap`` is a dataclass of tensors: ``adam_step``,
``add_densification_stats``, ``extend``, ``densify_and_prune``,
``prune_points`` and the opacity resets update it in place (and return it
for convenience). Capacity and slot semantics are the JAX package's, so two
maps compare slot by slot:

- a fixed capacity C of slots with an ``alive`` mask; prune clears bits;
- clone/split/extend write masked rows into the first free slots in order,
  zeroing their Adam moments and resetting every slot's densification
  stats (densification_postfix);
- storage as in the Inria model: pre-sigmoid opacity, log scales,
  (w, x, y, z) quaternions.

``save_ply`` / ``load_ply`` are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..ops import lie

PARAM_NAMES = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


@dataclass
class GaussianParams:
    xyz: torch.Tensor       # (C, 3)
    f_dc: torch.Tensor      # (C, 1, 3)
    f_rest: torch.Tensor    # (C, R, 3)
    opacity: torch.Tensor   # (C, 1) pre-sigmoid
    scaling: torch.Tensor   # (C, S) log-scale
    rotation: torch.Tensor  # (C, 4) unnormalized quaternion (w, x, y, z)

    def tensors(self):
        return [getattr(self, n) for n in PARAM_NAMES]


@dataclass
class GaussianAux:
    alive: torch.Tensor           # (C,) bool
    kf_id: torch.Tensor           # (C,) int32 anchoring keyframe
    n_obs: torch.Tensor           # (C,) int32
    xyz_grad_accum: torch.Tensor  # (C,)
    denom: torch.Tensor           # (C,)
    max_radii2d: torch.Tensor     # (C,)


@dataclass
class GaussianMap:
    params: GaussianParams
    aux: GaussianAux
    mu: GaussianParams     # Adam first moments
    nu: GaussianParams     # Adam second moments
    count: int = 0         # shared Adam step count

    @property
    def capacity(self) -> int:
        return self.aux.alive.shape[0]


def _zeros_like(p: GaussianParams) -> GaussianParams:
    return GaussianParams(*[torch.zeros_like(t) for t in p.tensors()])


def create(capacity: int, max_sh_degree: int = 0, isotropic: bool = False,
           device="cuda") -> GaussianMap:
    R = (max_sh_degree + 1) ** 2 - 1
    S = 1 if isotropic else 3

    def z(*s):
        return torch.zeros(s, dtype=torch.float32, device=device)
    rot = z(capacity, 4)
    rot[:, 0] = 1.0
    params = GaussianParams(xyz=z(capacity, 3), f_dc=z(capacity, 1, 3),
                            f_rest=z(capacity, R, 3), opacity=z(capacity, 1),
                            scaling=z(capacity, S), rotation=rot)
    aux = GaussianAux(
        alive=torch.zeros(capacity, dtype=torch.bool, device=device),
        kf_id=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        n_obs=torch.zeros(capacity, dtype=torch.int32, device=device),
        xyz_grad_accum=z(capacity), denom=z(capacity),
        max_radii2d=z(capacity))
    return GaussianMap(params, aux, _zeros_like(params), _zeros_like(params))


def get_scaling(p: GaussianParams) -> torch.Tensor:
    s = torch.exp(p.scaling)
    return s.expand(-1, 3) if s.shape[-1] == 1 else s


def get_rotation_xyzw(p: GaussianParams) -> torch.Tensor:
    """Normalized quaternion in the lie layout (x, y, z, w)."""
    q = p.rotation / torch.linalg.norm(p.rotation, dim=-1, keepdim=True)
    return torch.cat([q[:, 1:4], q[:, 0:1]], dim=-1)


def get_opacity(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.opacity)[:, 0]


def get_sh(p: GaussianParams) -> torch.Tensor:
    return torch.cat([p.f_dc, p.f_rest], dim=1)


def inverse_sigmoid(x: float) -> float:
    """log(x / (1 - x)), the log taken in float32 as in the JAX package."""
    return float(torch.log(torch.tensor(x / (1.0 - x), dtype=torch.float32)))


def num_alive(m: GaussianMap) -> int:
    return int(m.aux.alive.sum())


# ---------------------------------------------------------------------------
# Adam (torch.optim.Adam semantics, eps=1e-15), one lr per parameter group
# ---------------------------------------------------------------------------

def expon_lr(step, lr_init, lr_final, lr_delay_mult=1.0, max_steps=1000000,
             lr_delay_steps=0) -> float:
    """Log-lerp lr schedule (general_utils.helper) for the xyz group.
    Evaluated in float32, as the JAX package does."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    t = torch.clamp(f32(step) / f32(max_steps), 0.0, 1.0)
    log_lerp = torch.exp(torch.log(f32(lr_init)) * (1 - t)
                         + torch.log(f32(lr_final)) * t)
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(f32(step) / lr_delay_steps, 0, 1))
        log_lerp = delay * log_lerp
    return float(log_lerp)


def bias_corrections(b1: float, b2: float, count: int):
    """Adam's 1 - b**count for both betas, in float32 (as float)."""
    n = torch.tensor(float(count), dtype=torch.float32)
    f32 = torch.float32
    return (float(1 - torch.tensor(b1, dtype=f32) ** n),
            float(1 - torch.tensor(b2, dtype=f32) ** n))


@torch.no_grad()
def adam_step(m: GaussianMap, grads: GaussianParams, lrs: dict, b1=0.9,
              b2=0.999, eps=1e-15) -> GaussianMap:
    """One Adam step over every group in place; dead slots get zero grads.
    lrs maps each parameter name to its learning rate."""
    m.count += 1
    c1, c2 = bias_corrections(b1, b2, m.count)
    alive = m.aux.alive.to(torch.float32)
    for name in PARAM_NAMES:
        p, g = getattr(m.params, name), getattr(grads, name)
        mu, nu = getattr(m.mu, name), getattr(m.nu, name)
        if p.numel() == 0:
            continue
        g = g * alive.reshape((-1,) + (1,) * (g.dim() - 1))
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g * g)
        lr = float(torch.tensor(lrs[name], dtype=torch.float32))
        p.sub_(lr * (mu / c1) / (torch.sqrt(nu / c2) + eps))
    return m


# ---------------------------------------------------------------------------
# slot management
# ---------------------------------------------------------------------------

def _scatter_new(m: GaussianMap, new: GaussianParams, new_mask: torch.Tensor,
                 new_kf_id: torch.Tensor, new_n_obs: torch.Tensor) -> int:
    """Write the masked rows of `new` into the first free slots, in order.
    Zeroes their Adam moments and every slot's densification stats.
    Returns the number of rows dropped for lack of free slots."""
    free = torch.nonzero(~m.aux.alive).flatten()
    src = torch.nonzero(new_mask).flatten()
    n = min(free.numel(), src.numel())
    dropped = src.numel() - n
    dst, src = free[:n], src[:n]
    for name in PARAM_NAMES:
        if getattr(m.params, name).numel() == 0:
            continue
        getattr(m.params, name)[dst] = getattr(new, name)[src]
        getattr(m.mu, name)[dst] = 0.0
        getattr(m.nu, name)[dst] = 0.0
    a = m.aux
    a.alive[dst] = True
    a.kf_id[dst] = new_kf_id[src]
    a.n_obs[dst] = new_n_obs[src]
    a.xyz_grad_accum.zero_()
    a.denom.zero_()
    a.max_radii2d.zero_()
    return dropped


@torch.no_grad()
def extend(m: GaussianMap, new: GaussianParams, new_mask: torch.Tensor,
           kf_id: int) -> int:
    """Append new Gaussians in place. Returns the number dropped."""
    M = new_mask.shape[0]
    dev = new_mask.device
    return _scatter_new(m, new, new_mask,
                        torch.full((M,), kf_id, dtype=torch.int32, device=dev),
                        torch.zeros(M, dtype=torch.int32, device=dev))


@torch.no_grad()
def add_densification_stats(m: GaussianMap, mean2d_grad: torch.Tensor,
                            radii: torch.Tensor) -> GaussianMap:
    """Accumulate screen-space gradient norms of visible Gaussians."""
    a = m.aux
    vis = (radii > 0) & a.alive
    gnorm = torch.linalg.norm(mean2d_grad[:, :2], dim=-1)
    a.xyz_grad_accum += torch.where(vis, gnorm, torch.zeros_like(gnorm))
    a.denom += vis.to(torch.float32)
    a.max_radii2d.copy_(torch.where(
        vis, torch.maximum(a.max_radii2d, radii.to(torch.float32)),
        a.max_radii2d))
    return m


@torch.no_grad()
def densify_and_prune(m: GaussianMap, max_grad: float, min_opacity: float,
                      extent: float, max_screen_size: Optional[float],
                      percent_dense: float = 0.01,
                      draws: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> int:
    """Clone small high-gradient Gaussians, split big ones into two children
    sampled from them, prune transparent or huge ones; in place.

    draws: optional (2, C, 3) standard normals for the two split children
    (a test feeds the JAX draws); else drawn from `generator`.
    Returns the number of new rows dropped for lack of slots."""
    p, a = m.params, m.aux
    C = m.capacity
    grads = torch.where(a.denom > 0, a.xyz_grad_accum / a.denom,
                        torch.zeros_like(a.denom))
    scal = get_scaling(p)
    max_scale = scal.amax(-1)
    clone_mask = a.alive & (grads >= max_grad) & (
        max_scale <= percent_dense * extent)
    split_mask = a.alive & (grads >= max_grad) & (
        max_scale > percent_dense * extent)

    if draws is None:
        draws = torch.randn((2, C, 3), generator=generator,
                            device=p.xyz.device)
    R = lie.quat_to_matrix(get_rotation_xyzw(p))
    src = GaussianParams(*[t.clone() for t in p.tensors()])
    kf, nobs = a.kf_id.clone(), a.n_obs.clone()

    def child(sample):
        offset = (R @ (sample * scal)[..., None])[..., 0]
        return GaussianParams(xyz=src.xyz + offset, f_dc=src.f_dc,
                              f_rest=src.f_rest, opacity=src.opacity,
                              scaling=torch.log(torch.exp(src.scaling) / 1.6),
                              rotation=src.rotation)

    d = _scatter_new(m, src, clone_mask, kf, nobs)
    d += _scatter_new(m, child(draws[0]), split_mask, kf, nobs)
    d += _scatter_new(m, child(draws[1]), split_mask, kf, nobs)

    prune = get_opacity(m.params) < min_opacity
    if max_screen_size is not None:
        prune |= (m.aux.max_radii2d > max_screen_size) | (
            get_scaling(m.params).amax(-1) > 0.1 * extent)
    prune |= split_mask
    m.aux.alive &= ~prune
    return d


@torch.no_grad()
def prune_points(m: GaussianMap, mask: torch.Tensor) -> GaussianMap:
    m.aux.alive &= ~mask
    return m


@torch.no_grad()
def reset_opacity(m: GaussianMap, value: float = 0.01) -> GaussianMap:
    """Set every opacity to `value` and zero the opacity group's moments."""
    m.params.opacity.fill_(inverse_sigmoid(value))
    m.mu.opacity.zero_()
    m.nu.opacity.zero_()
    return m


@torch.no_grad()
def reset_opacity_nonvisible(m: GaussianMap, visible: torch.Tensor,
                             value: float = 0.4) -> GaussianMap:
    """Set the opacity of Gaussians not in `visible` to `value`; zero the
    opacity group's moments."""
    m.params.opacity.copy_(torch.where(
        visible[:, None], m.params.opacity,
        torch.full_like(m.params.opacity, inverse_sigmoid(value))))
    m.mu.opacity.zero_()
    m.nu.opacity.zero_()
    return m

