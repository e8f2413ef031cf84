"""The tile-table gather and its scatter-add: CUDA kernels K3/K4, their
plain versions, and the autograd wiring.

Port of the row gather and row scatter-add of
``scripts/microbench_gather.py`` (``_gather_kernel``, ``_scatter_kernel``),
which compute the JAX package's table gather and its VJP
(``wildgs_slam_tpu/ops/rasterizer/__init__.py``, ``attrs[safe_ids]`` with
the ``_gather_rows_mm`` backward):

- K3 ``table_gather`` (``csrc/table_gather.cu``): ``out[t, k] =
  attrs[max(ids[t, k], 0)]`` for attrs (N, 16) f32 and ids (T, K) int32;
- K4 ``table_scatter_add``: ``out = zeros(N, 16)``, then ``out[ids[t, k]]
  += g[t, k]`` for every slot whose id is >= 0 (empty slots, id -1, are
  skipped; their cotangents are zero on the mapping path).

``table_gather_plain`` / ``table_scatter_add_plain`` (``index_select`` and
a masked ``index_add_``) compute the same functions. A wrapper takes its
plain version only for a tensor on the CPU; for a CUDA tensor it launches
the kernel or raises. Each wrapper counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from ... import kernels
from ...kernels import check as _check, ptr as _ptr, stream as _stream

ATTR_F = 16


def table_gather_plain(attrs, ids):
    """(N, F) rows -> (T, K, F) table; ids of -1 read row 0."""
    safe = torch.clamp(ids, min=0).reshape(-1)
    return attrs.index_select(0, safe).reshape(ids.shape + attrs.shape[1:])


def table_scatter_add_plain(g, ids, n_rows):
    """(T, K, F) cotangents -> (n_rows, F) row sums over the live slots."""
    flat = ids.reshape(-1)
    live = flat >= 0
    gf = g.reshape(flat.shape[0], -1)
    out = torch.zeros(n_rows, gf.shape[1], dtype=g.dtype, device=g.device)
    out.index_add_(0, flat[live], gf[live])
    return out


def _check_ids(ids, dev):
    if ids.dim() != 2:
        raise ValueError(f"ids must be (T, K), got {tuple(ids.shape)}")
    _check("ids", ids, torch.int32, tuple(ids.shape), dev)


def table_gather(attrs, ids):
    """K3. attrs (N, 16) f32, ids (T, K) int32 -> (T, K, 16) f32."""
    if attrs.device.type == "cpu":
        return table_gather_plain(attrs, ids)
    if attrs.device.type != "cuda":
        raise ValueError(f"table_gather: unsupported device {attrs.device}")
    dev = attrs.device
    _check("attrs", attrs, torch.float32, (attrs.shape[0], ATTR_F), dev)
    _check_ids(ids, dev)
    T, K = ids.shape
    lib = kernels.library()
    out = torch.empty(T, K, ATTR_F, device=dev)
    with torch.cuda.device(dev):
        err = lib.table_gather(_ptr(attrs), _ptr(ids), _ptr(out), T * K,
                               attrs.shape[0], _stream(dev))
    if err:
        raise RuntimeError(f"table_gather launch failed: CUDA error {err}")
    table_gather.launches += 1
    return out


def table_scatter_add(g, ids, n_rows):
    """K4. g (T, K, 16) f32, ids (T, K) int32 -> (n_rows, 16) f32."""
    if g.device.type == "cpu":
        return table_scatter_add_plain(g, ids, n_rows)
    if g.device.type != "cuda":
        raise ValueError(f"table_scatter_add: unsupported device {g.device}")
    dev = g.device
    _check_ids(ids, dev)
    T, K = ids.shape
    _check("g", g, torch.float32, (T, K, ATTR_F), dev)
    lib = kernels.library()
    out = torch.empty(n_rows, ATTR_F, device=dev)
    with torch.cuda.device(dev):
        err = lib.table_scatter_add(_ptr(g), _ptr(ids), _ptr(out), T * K,
                                    n_rows, _stream(dev))
    if err:
        raise RuntimeError(f"table_scatter_add launch failed: CUDA error "
                           f"{err}")
    table_scatter_add.launches += 1
    return out


table_gather.launches = 0
table_scatter_add.launches = 0


class TableGather(torch.autograd.Function):
    """K3 forward, K4 backward (the plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, attrs, ids):
        ctx.save_for_backward(ids)
        ctx.n = attrs.shape[0]
        return table_gather(attrs, ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return table_scatter_add(grad.contiguous(), ids, ctx.n), None
