"""Fused tile compositing: CUDA kernels K1/K2, their plain versions, and the
autograd wiring.

Port of ``wildgs_slam_tpu/ops/rasterizer/pallas_composite.py``. Both kernels
read a (T, K, 16) packed per-tile table whose lanes are mx, my, conic a/b/c,
r, g, b, opacity, depth and 6 zero pads, plus ``tile_ids``, the global tile
of each table row:

- K1 ``composite_fwd`` (``csrc/composite_fwd.cu``, replaces ``_fwd_kernel``)
  composites each tile front to back in chunks of ``ck`` and also writes
  ``tentry``, the transmittance entering each chunk. One block per tile
  stages the chunk rows by asynchronous bulk copies (two buffers), and a
  dead pair stops after its geometry (some before their exp, by a per-slot
  threshold on the exponent).
- K2 ``composite_bwd`` (``csrc/composite_bwd.cu``, replaces ``_bwd_kernel``)
  writes per-slot gradients (T, K, 16) in two CUDA kernels on a (tile,
  chunk) grid: each chunk's per-pixel total of w g into a (T, K // ck, 256)
  scratch, then each chunk's gradients from the later chunks' totals. One
  call counts as one launch.

``composite_fwd_plain`` / ``composite_bwd_plain`` are chunked torch versions
of the same formulas. A wrapper takes its plain version only for a tensor
on the CPU; for a CUDA tensor it launches the kernel or raises. Each wrapper
counts its launches in ``<wrapper>.launches``.

The kernels are built and loaded by ``wildgs_slam_tpu_torch/kernels.py``
(nvcc at first use, one shared library for every source in ``csrc/``).
"""

from __future__ import annotations

import torch

from ... import kernels
from ...kernels import check as _check, ptr as _ptr, stream as _stream
from .binning import TILE
from .composite import ALPHA_MIN, T_EPS, tile_pixel_coords

P = TILE * TILE
ATTR_F = 16
MAX_CK = 64          # the kernels stage at most 64 rows per chunk
ONE_M_MIN = 0.01     # 1 - alpha >= 1 - 0.99
A_MX, A_MY, A_CA, A_CB, A_CC = 0, 1, 2, 3, 4
A_R, A_G, A_B, A_OP, A_D = 5, 6, 7, 8, 9



# ---------------------------------------------------------------------------
# plain versions (CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------

def _chunk_geometry(blk, live, px, py):
    """blk (T, ck, 16), live (T, ck), px/py (T, P) ->
    alpha, raw, G, dx, dy, dead, each (T, ck, P)."""
    def lane(i):
        return blk[..., i:i + 1]
    dx = lane(A_MX) - px[:, None, :]
    dy = lane(A_MY) - py[:, None, :]
    power = (-0.5 * (lane(A_CA) * dx * dx + lane(A_CC) * dy * dy)
             - lane(A_CB) * dx * dy)
    G = torch.exp(power)
    raw = lane(A_OP) * G
    alpha = torch.clamp(raw, max=0.99)
    dead = (power > 0) | (alpha < ALPHA_MIN) | ~live[..., None]
    alpha = torch.where(dead, torch.zeros_like(alpha), alpha)
    return alpha, raw, G, dx, dy, dead


def _chunk_live(counts, c, ck):
    slot = c * ck + torch.arange(ck, device=counts.device)
    return slot[None, :] < counts[:, None].long()


def composite_fwd_plain(counts, tile_ids, attrs, bg, tw, ck):
    """Torch version of K1. Returns color (T, P, 3), depth, alpha, tfin
    (T, P) and tentry (T, K // ck, P)."""
    T, K, _ = attrs.shape
    n_chunks = K // ck
    dev = attrs.device
    px, py = tile_pixel_coords(tile_ids, tw)
    T_run = torch.ones(T, P, device=dev)
    T_comm = torch.full((T, P), float("inf"), device=dev)
    acc = torch.zeros(T, P, 5, device=dev)
    tentry = torch.empty(T, n_chunks, P, device=dev)
    cols = attrs[..., [A_R, A_G, A_B, A_D]]
    for c in range(n_chunks):
        tentry[:, c] = T_run
        active = ((c * ck < counts.long())
                  & (T_run.amax(1) >= T_EPS))[:, None]
        sl = slice(c * ck, (c + 1) * ck)
        alpha, _, _, _, _, _ = _chunk_geometry(
            attrs[:, sl], _chunk_live(counts, c, ck), px, py)
        one_m = torch.clamp(1.0 - alpha, min=ONE_M_MIN)
        t_after = T_run[:, None, :] * torch.cumprod(one_m, dim=1)
        t_before = t_after / one_m
        contrib = t_after >= T_EPS
        w = alpha * t_before * contrib
        sums = torch.cat([(w[..., None] * cols[:, sl, None, :]).sum(1),
                          w.sum(1)[..., None]], dim=-1)
        acc = torch.where(active[..., None], acc + sums, acc)
        cand = torch.where(contrib, t_after, torch.full_like(t_after,
                                                             float("inf")))
        T_comm = torch.where(active, torch.minimum(T_comm, cand.amin(1)),
                             T_comm)
        T_run = torch.where(active, t_after[:, -1], T_run)
    tfin = torch.where(torch.isinf(T_comm), T_run, T_comm)
    color = acc[..., 0:3] + tfin[..., None] * bg
    return color, acc[..., 3], acc[..., 4], tfin, tentry


def composite_bwd_plain(counts, tile_ids, attrs, bg, tentry, tfin, gc, gd, ga,
                        gt, tw, ck):
    """Torch version of K2: per-slot gradients dattrs (T, K, 16)."""
    T, K, _ = attrs.shape
    n_chunks = K // ck
    dev = attrs.device
    px, py = tile_pixel_coords(tile_ids, tw)
    B = tfin * ((bg * gc).sum(-1) + gt)                  # (T, P)
    S = torch.zeros(T, P, device=dev)
    dattrs = torch.zeros(T, K, ATTR_F, device=dev)
    gcr, gcg, gcb = (gc[:, None, :, i] for i in range(3))   # (T, 1, P)
    gd_, ga_ = gd[:, None, :], ga[:, None, :]
    for c in range(n_chunks - 1, -1, -1):
        active = c * ck < counts.long()                  # (T,)
        sl = slice(c * ck, (c + 1) * ck)
        blk = attrs[:, sl]

        def lane(i):
            return blk[..., i:i + 1]
        alpha, raw, G, dx, dy, dead = _chunk_geometry(
            blk, _chunk_live(counts, c, ck), px, py)
        one_m = torch.clamp(1.0 - alpha, min=ONE_M_MIN)
        t_after = tentry[:, c][:, None, :] * torch.cumprod(one_m, dim=1)
        t_before = t_after / one_m
        contrib = (t_after >= T_EPS).to(attrs.dtype)
        w = alpha * t_before * contrib
        gsc = (lane(A_R) * gcr + lane(A_G) * gcg + lane(A_B) * gcb
               + lane(A_D) * gd_ + ga_)
        pref = torch.cumsum(w * gsc, dim=1)
        total = pref[:, -1:, :]
        S_k = (total - pref) + S[:, None, :]
        dalpha = t_before * gsc * contrib - (S_k + B[:, None, :] * contrib) / one_m
        dalpha = torch.where(dead | (raw >= 0.99), torch.zeros_like(dalpha),
                             dalpha)
        dpow = dalpha * lane(A_OP) * G
        grads = torch.stack([
            (dpow * -(lane(A_CA) * dx + lane(A_CB) * dy)).sum(-1),
            (dpow * -(lane(A_CC) * dy + lane(A_CB) * dx)).sum(-1),
            -0.5 * (dpow * dx * dx).sum(-1),
            -(dpow * dx * dy).sum(-1),
            -0.5 * (dpow * dy * dy).sum(-1),
            (w * gcr).sum(-1), (w * gcg).sum(-1), (w * gcb).sum(-1),
            (dalpha * G).sum(-1),
            (w * gd_).sum(-1),
        ], dim=-1)                                       # (T, ck, 10)
        dattrs[:, sl, :10] = torch.where(active[:, None, None], grads,
                                         torch.zeros_like(grads))
        S = torch.where(active[:, None], S + total[:, 0], S)
    return dattrs


def _check_table(counts, tile_ids, attrs, bg, ck):
    if attrs.dim() != 3 or attrs.shape[2] != ATTR_F:
        raise ValueError(f"attrs must be (T, K, {ATTR_F}), got "
                         f"{tuple(attrs.shape)}")
    T, K, _ = attrs.shape
    if not (0 < ck <= MAX_CK and K % ck == 0):
        raise ValueError(f"chunk {ck} must divide K={K} and be <= {MAX_CK}")
    dev = attrs.device
    _check("attrs", attrs, torch.float32, (T, K, ATTR_F), dev)
    _check("counts", counts, torch.int32, (T,), dev)
    _check("tile_ids", tile_ids, torch.int32, (T,), dev)
    _check("bg", bg, torch.float32, (3,), dev)
    return T, K


def composite_fwd(counts, tile_ids, attrs, bg, tw, ck):
    """K1. counts/tile_ids (T,) int32, attrs (T, K, 16) f32, bg (3,) f32 ->
    color (T, P, 3), depth, alpha, tfin (T, P), tentry (T, K // ck, P)."""
    if attrs.device.type == "cpu":
        return composite_fwd_plain(counts, tile_ids, attrs, bg, tw, ck)
    if attrs.device.type != "cuda":
        raise ValueError(f"composite_fwd: unsupported device {attrs.device}")
    T, K = _check_table(counts, tile_ids, attrs, bg, ck)
    lib = kernels.library()
    dev = attrs.device
    color = torch.empty(T, P, 3, device=dev)
    depth = torch.empty(T, P, device=dev)
    alpha = torch.empty(T, P, device=dev)
    tfin = torch.empty(T, P, device=dev)
    tentry = torch.empty(T, K // ck, P, device=dev)
    with torch.cuda.device(dev):
        err = lib.composite_fwd(
            _ptr(counts), _ptr(tile_ids), _ptr(attrs), _ptr(bg), _ptr(color),
            _ptr(depth), _ptr(alpha), _ptr(tfin), _ptr(tentry), T, K, ck, tw,
            _stream(dev))
    if err:
        raise RuntimeError(f"composite_fwd launch failed: CUDA error {err}")
    composite_fwd.launches += 1
    return color, depth, alpha, tfin, tentry


def composite_bwd(counts, tile_ids, attrs, bg, tentry, tfin, gc, gd, ga, gt,
                  tw, ck):
    """K2. The forward's inputs plus tentry, tfin and the cotangents gc
    (T, P, 3), gd/ga/gt (T, P) -> dattrs (T, K, 16)."""
    if attrs.device.type == "cpu":
        return composite_bwd_plain(counts, tile_ids, attrs, bg, tentry, tfin,
                                   gc, gd, ga, gt, tw, ck)
    if attrs.device.type != "cuda":
        raise ValueError(f"composite_bwd: unsupported device {attrs.device}")
    T, K = _check_table(counts, tile_ids, attrs, bg, ck)
    dev = attrs.device
    _check("tentry", tentry, torch.float32, (T, K // ck, P), dev)
    for name, x in (("tfin", tfin), ("gd", gd), ("ga", ga), ("gt", gt)):
        _check(name, x, torch.float32, (T, P), dev)
    _check("gc", gc, torch.float32, (T, P, 3), dev)
    lib = kernels.library()
    totals = torch.empty(T, K // ck, P, device=dev)   # per-chunk sums of w g
    dattrs = torch.empty(T, K, ATTR_F, device=dev)
    with torch.cuda.device(dev):
        err = lib.composite_bwd(
            _ptr(counts), _ptr(tile_ids), _ptr(attrs), _ptr(bg), _ptr(tentry),
            _ptr(tfin), _ptr(gc), _ptr(gd), _ptr(ga), _ptr(gt), _ptr(totals),
            _ptr(dattrs), T, K, ck, tw, _stream(dev))
    if err:
        raise RuntimeError(f"composite_bwd launch failed: CUDA error {err}")
    composite_bwd.launches += 1
    return dattrs


composite_fwd.launches = 0
composite_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class CompositeTiles(torch.autograd.Function):
    """K1 forward, K2 backward; the bg gradient is einsum(tfin, gc) outside
    the kernel, as in the JAX custom VJP."""

    @staticmethod
    def forward(ctx, attrs, bg, counts, tile_ids, tw, ck):
        color, depth, alpha, tfin, tentry = composite_fwd(
            counts, tile_ids, attrs, bg, tw, ck)
        ctx.save_for_backward(counts, tile_ids, attrs, bg, tentry, tfin)
        ctx.tw, ctx.ck = tw, ck
        return color, depth, alpha, tfin

    @staticmethod
    def backward(ctx, gc, gd, ga, gt):
        counts, tile_ids, attrs, bg, tentry, tfin = ctx.saved_tensors

        def ct(g, like):
            return torch.zeros_like(like) if g is None else g.contiguous()
        gc = ct(gc, tfin[..., None].expand(-1, -1, 3))
        gd, ga, gt = ct(gd, tfin), ct(ga, tfin), ct(gt, tfin)
        dattrs = composite_bwd(counts, tile_ids, attrs, bg, tentry, tfin, gc,
                               gd, ga, gt, ctx.tw, ctx.ck)
        dbg = torch.einsum("tp,tpc->c", tfin, gc)
        return dattrs, dbg, None, None, None, None


def composite_tiles(counts, attrs, bg, tw, ck):
    """Composite packed per-tile tables, row t being tile t (the
    counterpart of ``composite_tiles_pallas``). Returns color (T, P, 3),
    depth, alpha and tfin (T, P); differentiable in attrs and bg."""
    tile_ids = torch.arange(attrs.shape[0], dtype=torch.int32,
                            device=attrs.device)
    return CompositeTiles.apply(attrs.contiguous(), bg.contiguous(),
                                counts.contiguous(), tile_ids.contiguous(),
                                tw, ck)
