"""The collectives of a mesh driven by one process: the counterpart of what
``shard_map`` and ``jax.lax`` give the JAX package's sharded bodies.

A sharded value is a list of per-shard tensors, shard d's on
``mesh.devices[d]``; a replicated value is one tensor per distinct device.
Each collective is a few tensor moves and sums, so autograd gives the
transposes JAX autodiff gives: ``all_gather`` transposes to a sum of the
shard slices (``psum_scatter``), ``all_to_all`` to ``all_to_all``, and a
replicated input's cotangent is summed over the shards that read it
(``psum``).

A move between two cards is ``Tensor.to(device)``; a move onto the card the
tensor is already on copies nothing, so shards that share a card alias one
another's data. Nothing here, and nothing that uses these results, may
write into them in place. Where several shards share a card, a collective
forms its result once on that card and hands every such shard the same
tensor.
"""

from __future__ import annotations

from typing import Sequence

import torch


def move(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """x on `device`, differentiably; x itself if it is there already."""
    return x if x.device == device else x.to(device)


def replicate(x: torch.Tensor, devices: Sequence[torch.device]) -> list:
    """x on every shard's device (one copy per distinct device)."""
    return _per_device(devices, lambda dev: move(x, dev))


def shard_rows(x: torch.Tensor, devices: Sequence[torch.device]) -> list:
    """Split x's leading axis into len(devices) equal blocks, block d moved
    to devices[d] (views where it stays on its card)."""
    D = len(devices)
    if x.shape[0] % D:
        raise ValueError(f"leading axis {x.shape[0]} not divisible by {D} "
                         f"shards")
    n = x.shape[0] // D
    return [move(x[d * n:(d + 1) * n], dev) for d, dev in enumerate(devices)]


def unshard_rows(xs: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The inverse of shard_rows: the blocks concatenated on `device`."""
    return torch.cat([move(x, device) for x in xs])


def psum(xs: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> list:
    """Every shard gets the sum of all shards' tensors, added in shard
    order."""
    def total(dev):
        out = move(xs[0], dev)
        for x in xs[1:]:
            out = out + move(x, dev)
        return out
    return _per_device(devices, total)


def all_gather(xs: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> list:
    """Every shard gets the shards' tensors concatenated along axis 0 in
    shard order (``all_gather(x, axis, axis=0, tiled=True)``)."""
    return _per_device(devices,
                       lambda dev: torch.cat([move(x, dev) for x in xs]))


def all_to_all(xs: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> list:
    """Each shard's tensor has a leading axis of len(devices); shard d gets
    out[d][k] = xs[k][d] (``all_to_all(x, axis, 0, 0, tiled=False)``)."""
    D = len(devices)
    for x in xs:
        if x.shape[0] != D:
            raise ValueError(f"all_to_all: leading axis {x.shape[0]} != "
                             f"{D} shards")
    return [torch.stack([move(xs[k][d], dev) for k in range(D)])
            for d, dev in enumerate(devices)]


def _per_device(devices, make):
    """[make(devices[d]) for d], made once per distinct device."""
    made = {}
    out = []
    for dev in devices:
        if dev not in made:
            made[dev] = make(dev)
        out.append(made[dev])
    return out
