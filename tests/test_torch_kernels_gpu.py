"""K1-K4 and conv_nhwc on the card against their plain PyTorch versions.

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test, never at import). Run on a machine with a card:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: forward atol 1e-5 for colour, alpha, tfin and tentry, 1e-4 for
depth (values ~3), as in tests/test_pallas_composite.py; the kernels are
compiled with --fmad=false and round op by op as the plain versions do, so
what remains is the order of the per-pixel and per-slot sums. Gradients:
max-relative error (max |a - b| / max |b|) below 1e-5. K3 (the table
gather) copies rows and must equal its plain version exactly; K4 (the
scatter-add) sums with atomics in another order: max-relative below 1e-5,
with nonzero cotangents in the empty slots too (both skip them).

K2 skips work it can prove adds an exact zero: chunks past a tile's count,
chunks every pixel enters saturated (transmittance < 1e-4), a warp's
reduction when none of its pixels is alive, and a warp's walk once all its
pixels are saturated. `test_bwd_saturated_chunks` holds those skips
against the plain version on a table built to reach them. Where exp(power)
overflows on a slot of a chunk below the count, K2 writes NaN into that
slot's geometry lanes, as the plain version and the JAX kernel do; it walks
only slots whose conic is not positive semidefinite for that
(`test_bwd_overflow_nan`, on `overflow_table`).

K1 stops a dead pair after its geometry, finds some dead without their exp
(by a per-slot threshold on the exponent), stages only the rows up to a
tile's count, and stops at the count. `test_fwd_skip_edges` holds it on a
table built to reach those edges (`skip_edge_table`), alpha within a few
ulp of 1/255 included. K4 adds with vector atomics:
`test_scatter_add_repeated_ids` holds it with up to 8 slots on one row,
empty slots and rows that no slot touches (exactly 0).

P1/P2 (the render's projection, csrc/project_fused.cu) on scenes that cull
rows every way (near plane, det <= 0, out of the image, not alive): P1
rounds op by op as the plain projection does on the card, so radius, valid
and the binning's ids are equal and the packed columns within 1e-6 of their
largest entry; P2's gradients within max-relative 1e-5 of autograd's (the
K2 tolerance), exactly 0 on rows that are not valid, and the camera's
gradient (float64 block sums in a fixed order) bit-equal between two runs.

M1/M2 (the uncertainty-aware mapping loss, csrc/mapping_loss.cu) at both
cells' shapes (384x512 on the 27x36 DINO grid, 360x640 on 25x45), with and
without `initialization`, on inputs with reference-depth holes and values
past the depth threshold, opacity straddling opacity_th_for_uncer_loss and
sigma below its 0.1 clamp, against the plain loss
(`losses.mapping_loss_uncertainty_plain`) on the card: total and
uncer_loss within rel 1e-5, weights_pix and every gradient (image, depth,
exposure, sigma) within max-relative 1e-5 of its largest entry. Only the
order of the sums differs (the blurs' taps, the resamples' weights, the
means); the weight tables are the plain path's own. Two calls give the
same bits (fixed-order block sums, no atomics).

conv_nhwc (the update operator's convolutions) at E = 1, 8 and 64 edges,
at 48 x 64 and 45 x 80 (a ragged M, and the Wild-SLAM MoCap grid), for
each launch the operator makes (1x1 over 196 and 7x7 over 4 channels, not
multiples of the 8-channel K-slab; four sources with r * net, the
global-context vector and the blend; a channel slice as the input of a
2-channel head): max |kernel - plain| <= 1e-5 max |plain|, because the
kernel and cuDNN take sums of up to 4,032 float32 products (9 taps x 448
channels) in another order. The batch changes no result, nor the tile
the kernel picks by it: one edge alone equals the same edge in a batch of
64.
"""

import numpy as np
import pytest
import torch

from wildgs_slam_tpu_torch.models import droid_net as dn
from wildgs_slam_tpu_torch.ops import conv_nhwc as cn
from wildgs_slam_tpu_torch.ops import rasterizer as tr
from wildgs_slam_tpu_torch.ops.rasterizer import composite_cuda as cc
from wildgs_slam_tpu_torch.ops.rasterizer import projection_cuda as pc
from wildgs_slam_tpu_torch.ops.rasterizer import table_gather as tg
from wildgs_slam_tpu_torch.slam import losses
from wildgs_slam_tpu_torch.slam import losses_cuda as lc
from wildgs_slam_tpu_torch.utils.profiling import TIMER

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _table(n, h, w, capacity, seed, dev):
    """A packed table from the port's projection and binning of a seeded
    random scene of n Gaussians in front of an h x w camera."""
    rng = np.random.RandomState(seed)
    f = 0.9 * w
    means = np.concatenate([rng.uniform(-1.2, 1.2, (n, 1)) * w / f,
                            rng.uniform(-1.2, 1.2, (n, 1)) * h / f,
                            np.ones((n, 1))], -1)
    means *= 2.0 + 3.0 * rng.uniform(size=(n, 1))
    scales = np.exp(rng.uniform(np.log(0.005), np.log(0.05), (n, 3)))
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=-1, keepdims=True)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa
    proj = tr.project_gaussians(
        t(means), t(scales), t(rots), t(0.2 + 0.75 * rng.uniform(size=n)),
        t(rng.uniform(-1, 1, (n, 1, 3))), t([0, 0, 0, 0, 0, 0, 1]),
        t([f, f, w / 2, h / 2]), (h, w))
    bins = tr.bin_gaussians(proj.mean2d, proj.radius, proj.depth, proj.valid,
                            (h, w), capacity=capacity)
    z = torch.zeros_like(proj.depth)
    attrs = torch.stack([proj.mean2d[:, 0], proj.mean2d[:, 1],
                         proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
                         proj.color[:, 0], proj.color[:, 1], proj.color[:, 2],
                         proj.opacity, proj.depth] + [z] * 6, 1)
    return bins.counts, tr.gather_table(attrs, bins.ids).contiguous()


def saturating_table(K=128, seed=5):
    """counts, packed table and tile-grid width of a 48x64 image (3x4
    tiles), drawn with numpy. In tiles 0-7 a dense, opaque front layer (12
    Gaussians of sigma 12 px at the tile's centre, opacity 0.9-0.999)
    brings every pixel below transmittance 1e-4 within its first 12 slots;
    behind it, and alone in tiles 8-11, random Gaussians. Tiles 0 and 11
    are filled to the capacity K; the others hold K/2+1 to K-1 entries."""
    rng = np.random.RandomState(seed)
    th, tw = 3, 4
    T = th * tw
    ang = rng.uniform(0, np.pi, (T, K))
    s1, s2 = rng.uniform(1.5, 6, (2, T, K))
    c, s = np.cos(ang), np.sin(ang)
    x0 = (np.arange(T) % tw)[:, None] * 16.0
    y0 = (np.arange(T) // tw)[:, None] * 16.0
    table = np.zeros((T, K, 16), np.float32)
    table[..., 0] = x0 + rng.uniform(-8, 24, (T, K))
    table[..., 1] = y0 + rng.uniform(-8, 24, (T, K))
    table[..., 2] = c * c / s1 ** 2 + s * s / s2 ** 2   # inverse covariance
    table[..., 3] = c * s * (1 / s1 ** 2 - 1 / s2 ** 2)
    table[..., 4] = s * s / s1 ** 2 + c * c / s2 ** 2
    table[..., 5:8] = rng.uniform(0, 1, (T, K, 3))
    table[..., 8] = rng.uniform(0.2, 0.9, (T, K))
    table[..., 9] = rng.uniform(2, 4, (T, K))
    front = slice(0, 12)
    table[:8, front, 0] = x0[:8] + 8
    table[:8, front, 1] = y0[:8] + 8
    table[:8, front, 2] = table[:8, front, 4] = 1 / 144
    table[:8, front, 3] = 0
    table[:8, front, 8] = rng.uniform(0.9, 0.999, (8, 12))
    table[:8, front, 9] = 1.0
    counts = rng.randint(K // 2 + 1, K, T).astype(np.int32)
    counts[0] = counts[-1] = K
    return counts, table, tw


def skip_edge_table(K=128, seed=7):
    """counts, packed table and tile-grid width of a 48x64 image (3x4
    tiles), drawn with numpy, at the edges of K1's dead-pair skips:

    - tile 0: count 0;
    - tile 1: every slot dead, full to the capacity: Gaussians far off the
      tile, opacity 0, negative or below 1/255, and an indefinite conic
      (power > 0; small enough that exp stays finite, as K2's plain
      version needs);
    - tile 2: its first 10 slots dead, then visible ones, count 77 (ends
      inside a chunk of 32 and of 64);
    - tile 3: its first 64 slots dead (a whole chunk), then visible ones,
      count 100;
    - tile 4: slots whose alpha at one pixel is within a few ulp of 1/255
      on either side (power 0 and power near log(2/255)), count 90;
    - tiles 5-11: visible Gaussians, counts 1, 31, 33, 63, 65, 97 and K.
    """
    rng = np.random.RandomState(seed)
    th, tw = 3, 4
    T = th * tw
    x0 = (np.arange(T) % tw)[:, None] * 16.0
    y0 = (np.arange(T) // tw)[:, None] * 16.0
    ang = rng.uniform(0, np.pi, (T, K))
    s1, s2 = rng.uniform(1.5, 6, (2, T, K))
    c, s = np.cos(ang), np.sin(ang)
    table = np.zeros((T, K, 16), np.float32)
    table[..., 0] = x0 + rng.uniform(-8, 24, (T, K))
    table[..., 1] = y0 + rng.uniform(-8, 24, (T, K))
    table[..., 2] = c * c / s1 ** 2 + s * s / s2 ** 2
    table[..., 3] = c * s * (1 / s1 ** 2 - 1 / s2 ** 2)
    table[..., 4] = s * s / s1 ** 2 + c * c / s2 ** 2
    table[..., 5:8] = rng.uniform(0, 1, (T, K, 3))
    table[..., 8] = rng.uniform(0.05, 0.9, (T, K))
    table[..., 9] = rng.uniform(2, 4, (T, K))

    def dead(t, sl):
        n = len(range(K)[sl])
        kind = np.arange(n) % 5
        far = kind == 0                       # far off the tile
        table[t, sl, 0] = np.where(far, x0[t] + 400.0, table[t, sl, 0])
        table[t, sl, 8] = np.select(
            [kind == 1, kind == 2, kind == 3],
            [0.0, -0.5, 0.5 / 255], table[t, sl, 8])
        indef = kind == 4                     # 0 < power < 11 off the centre
        table[t, sl, 2] = np.where(indef, -0.01, table[t, sl, 2])
        table[t, sl, 4] = np.where(indef, -0.01, table[t, sl, 4])
        table[t, sl, 3] = np.where(indef, 0.0, table[t, sl, 3])

    dead(1, slice(0, K))
    dead(2, slice(0, 10))
    dead(3, slice(0, 64))
    # tile 4: round Gaussians (a = c = 1, b = 0) centred on pixel (px + d,
    # py), so that alpha there is op * exp(-d^2 / 2): at d = 0 op itself,
    # at d = 3.1139 about op * 2 / 255; op steps by ~1 ulp of alpha
    d = np.float32(3.1139)
    e = np.exp(np.float32(-0.5) * (d * d), dtype=np.float32)
    for k in range(90):
        j = k % 9 - 4                         # -4 .. 4
        at_centre = (k // 9) % 2 == 0
        table[4, k, 0] = x0[4, 0] + k % 16 + (0.0 if at_centre else d)
        table[4, k, 1] = y0[4, 0] + (k // 16) * 2
        table[4, k, 2] = table[4, k, 4] = 1.0
        table[4, k, 3] = 0.0
        base = np.float32(1 / 255) if at_centre else np.float32(1 / 255) / e
        table[4, k, 8] = base * np.float32(1 + j * 6e-8)
    counts = np.array([0, K, 77, 100, 90, 1, 31, 33, 63, 65, 97, K],
                      np.int32)
    return counts, table, tw


OVERFLOW_SLOTS = ((9, 5), (10, 40), (0, 100), (3, 70), (11, 127))


def overflow_table(K=128, seed=5):
    """saturating_table with indefinite conics (a = c = -2, b = 0: power =
    dx^2 + dy^2, above 88 up to 11 px off the centre, so exp overflows to
    inf at some pixels of the tile) in the slots OVERFLOW_SLOTS: live slots
    of open chunks (tiles 9, 10), a live slot of a saturated chunk (tile 0,
    slot 100), and slots at or past their tile's count inside an open chunk
    (tiles 3 and 11: counts 70 and 127). Tile 1's slot 20 gets an indefinite
    conic that stays finite (a = c = -0.01: power < 1.2)."""
    counts, table, tw = saturating_table(K, seed)
    counts[3], counts[11] = 70, 127
    for t, k in OVERFLOW_SLOTS:
        table[t, k, 0] = (t % tw) * 16.0 + 7.5
        table[t, k, 1] = (t // tw) * 16.0 + 7.5
        table[t, k, 2] = table[t, k, 4] = -2.0
        table[t, k, 3] = 0.0
    table[1, 20, 2] = table[1, 20, 4] = -0.01
    table[1, 20, 3] = 0.0
    return counts, table, tw


def _ids_attrs(n, h, w, capacity, dev):
    """A binned id table of a seeded scene and random (n, 16) rows."""
    rng = np.random.RandomState(3)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa
    means = np.concatenate([rng.uniform(-1, 1, (n, 2)),
                            2 + 2 * rng.uniform(size=(n, 1))], -1)
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=-1, keepdims=True)
    proj = tr.project_gaussians(
        t(means), t(0.01 + 0.04 * rng.uniform(size=(n, 3))), t(rots),
        t(0.3 + 0.6 * rng.uniform(size=n)), t(rng.uniform(size=(n, 1, 3))),
        t([0, 0, 0, 0, 0, 0, 1]), t([0.9 * w, 0.9 * w, w / 2, h / 2]),
        (h, w))
    bins = tr.bin_gaussians(proj.mean2d, proj.radius, proj.depth, proj.valid,
                            (h, w), capacity=capacity)
    attrs = torch.randn(n, 16, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    return attrs, bins.ids.to(torch.int32).contiguous()


def _max_rel(a, b):
    return float((a - b).abs().max() / (b.abs().max() + 1e-12))


def _composite_vs_plain(counts, table, tw, ck):
    """K1 and K2 against their plain versions on one table, with seeded
    random cotangents: forward atol, gradients max-rel, lanes 10-15 of the
    kernel's gradients exactly 0. Returns the plain forward's tentry and
    both gradients."""
    dev = table.device
    T = table.shape[0]
    tid = torch.arange(T, dtype=torch.int32, device=dev)
    bg = torch.tensor([0.1, 0.5, 0.9], device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    gc = torch.randn(T, 256, 3, device=dev, generator=g)
    gd, ga, gt = (torch.randn(T, 256, device=dev, generator=g)
                  for _ in range(3))

    k_out = cc.composite_fwd(counts, tid, table, bg, tw, ck)
    p_out = cc.composite_fwd_plain(counts, tid, table, bg, tw, ck)
    for name, a, b, tol in zip(("color", "depth", "alpha", "tfin", "tentry"),
                               k_out, p_out,
                               (1e-5, 1e-4, 1e-5, 1e-5, 1e-5)):
        err = float((a - b).abs().max())
        assert err <= tol, (name, err)

    args = (counts, tid, table, bg, p_out[4], p_out[3], gc, gd, ga, gt, tw,
            ck)
    k_d = cc.composite_bwd(*args)
    p_d = cc.composite_bwd_plain(*args)
    torch.cuda.synchronize()
    assert _max_rel(k_d, p_d) < 1e-5
    assert bool((k_d[..., 10:] == 0).all())
    return p_out[4], k_d, p_d


@pytest.mark.parametrize("ck", [32, 64])
@pytest.mark.parametrize("n,h,w,capacity", [(300, 48, 64, 128),
                                            (131072, 384, 512, 512)])
def test_kernels_match_plain(n, h, w, capacity, ck):
    _need_card()
    counts, table = _table(n, h, w, capacity, 0, torch.device("cuda"))
    tw = -(-w // 16)
    assert table.shape[0] == (-(-h // 16)) * tw
    _composite_vs_plain(counts, table, tw, ck)


@pytest.mark.parametrize("ck", [32, 64])
def test_bwd_saturated_chunks(ck):
    """K1/K2 on a table whose tiles saturate before their count, with two
    tiles filled to the capacity: the same tolerances, and every slot of a
    saturated chunk (and past a tile's count) exactly 0."""
    _need_card()
    dev = torch.device("cuda")
    counts_np, table_np, tw = saturating_table()
    counts = torch.as_tensor(counts_np, device=dev)
    table = torch.as_tensor(table_np, device=dev)
    K = table.shape[1]
    tentry, k_d, p_d = _composite_vs_plain(counts, table, tw, ck)
    starts = torch.arange(K // ck, device=dev) * ck
    below = starts[None] < counts[:, None]
    sat = below & (tentry.amax(-1) < 1e-4)
    assert bool(sat[0, -1]) and not bool(sat[8:].any())
    zero = (~below | sat).repeat_interleave(ck, dim=1)        # (T, K)
    zero |= torch.arange(K, device=dev)[None] >= counts[:, None]
    assert bool((k_d[zero] == 0).all()) and bool((p_d[zero] == 0).all())


@pytest.mark.parametrize("ck", [32, 64])
def test_bwd_overflow_nan(ck):
    """K2 where exp(power) overflows (``overflow_table``): NaN in the same
    positions as its plain version (the geometry lanes of the overflowing
    slots of chunks below the count, saturated ones included), every other
    value within max-rel 1e-5."""
    _need_card()
    dev = torch.device("cuda")
    counts_np, table_np, tw = overflow_table()
    counts = torch.as_tensor(counts_np, device=dev)
    table = torch.as_tensor(table_np, device=dev)
    T = table.shape[0]
    tid = torch.arange(T, dtype=torch.int32, device=dev)
    bg = torch.tensor([0.1, 0.5, 0.9], device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    gc = torch.randn(T, 256, 3, device=dev, generator=g)
    gd, ga, gt = (torch.randn(T, 256, device=dev, generator=g)
                  for _ in range(3))
    p_out = cc.composite_fwd_plain(counts, tid, table, bg, tw, ck)
    k_out = cc.composite_fwd(counts, tid, table, bg, tw, ck)
    for a, b in zip(k_out, p_out):
        assert float((a - b).abs().max()) <= 1e-4
    args = (counts, tid, table, bg, p_out[4], p_out[3], gc, gd, ga, gt, tw,
            ck)
    k_d = cc.composite_bwd(*args)
    p_d = cc.composite_bwd_plain(*args)
    torch.cuda.synchronize()
    nan = torch.isnan(p_d)
    assert torch.equal(torch.isnan(k_d), nan)
    lanes = torch.tensor([0, 1, 2, 3, 4, 8], device=dev)
    for t, k in OVERFLOW_SLOTS:
        assert bool(nan[t, k, lanes].all()), (t, k)
    assert int(nan.sum()) == len(OVERFLOW_SLOTS) * 6
    assert tentry_saturated(p_out[4], counts, ck)[0, 100 // ck]
    assert _max_rel(k_d[~nan], p_d[~nan]) < 1e-5


def tentry_saturated(tentry, counts, ck):
    """(T, K // ck): chunks below the count that every pixel enters with
    transmittance < 1e-4."""
    starts = torch.arange(tentry.shape[1], device=tentry.device) * ck
    return (starts[None] < counts[:, None]) & (tentry.amax(-1) < 1e-4)


@pytest.mark.parametrize("ck", [32, 64])
def test_fwd_skip_edges(ck):
    """K1 (and K2 behind it) on the table of `skip_edge_table`: the same
    tolerances as above, and the tiles with no slot alive composite to the
    background with tfin = 1."""
    _need_card()
    dev = torch.device("cuda")
    counts_np, table_np, tw = skip_edge_table()
    counts = torch.as_tensor(counts_np, device=dev)
    table = torch.as_tensor(table_np, device=dev)
    _composite_vs_plain(counts, table, tw, ck)
    tid = torch.arange(table.shape[0], dtype=torch.int32, device=dev)
    bg = torch.tensor([0.1, 0.5, 0.9], device=dev)
    color, depth, alpha, tfin, tentry = cc.composite_fwd(counts, tid, table,
                                                         bg, tw, ck)
    torch.cuda.synchronize()
    for t in (0, 1):
        assert bool((tfin[t] == 1).all()) and bool((tentry[t] == 1).all())
        assert bool((alpha[t] == 0).all()) and bool((depth[t] == 0).all())
        assert bool((color[t] == bg).all())


def test_render_fused_gradients_on_card():
    """The autograd wiring on the card: render_fused (kernels) against
    render_reference (the per-pixel oracle), forward and gradients."""
    _need_card()
    dev = torch.device("cuda")
    rng = np.random.RandomState(2)
    n, h, w = 200, 48, 64
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa
    means = t(np.concatenate([rng.uniform(-1, 1, (n, 2)),
                              2 + 2 * rng.uniform(size=(n, 1))], -1))
    scales = t(0.02 + 0.08 * rng.uniform(size=(n, 3)))
    rots = rng.normal(size=(n, 4))
    rots = t(rots / np.linalg.norm(rots, axis=-1, keepdims=True))
    opac = t(0.3 + 0.6 * rng.uniform(size=n))
    sh = t(rng.uniform(size=(n, 1, 3)))
    w2c = t([0, 0, 0, 0, 0, 0, 1])
    intr = t([55.0, 55.0, w / 2, h / 2])

    def grads(renderer, **kw):
        m = means.clone().requires_grad_(True)
        pd = torch.zeros(6, device=dev, requires_grad=True)
        out = renderer(m, scales, rots, opac, sh, w2c, intr, (h, w),
                       pose_delta=pd, **kw)
        ((out.color ** 2).sum() + 0.01 * (out.depth ** 2).sum()
         + 0.1 * (out.alpha ** 2).sum()).backward()
        return out, m.grad, pd.grad

    counters = (cc.composite_fwd, cc.composite_bwd, tg.table_gather,
                tg.table_scatter_add)
    before = [fn.launches for fn in counters]
    of, gmf, gpf = grads(tr.render_fused, capacity=256, chunk=64)
    assert [fn.launches for fn in counters] == [b + 1 for b in before]
    orf, gmr, gpr = grads(tr.render_reference)
    assert float((of.color - orf.color).abs().max()) < 1e-5
    assert float((of.depth - orf.depth).abs().max()) < 1e-4
    assert _max_rel(gmf, gmr) < 1e-5
    assert _max_rel(gpf, gpr) < 1e-5


@pytest.mark.parametrize("n,h,w,capacity", [(300, 48, 64, 128),
                                            (262144, 384, 512, 512)])
def test_table_kernels_match_plain(n, h, w, capacity):
    _need_card()
    dev = torch.device("cuda")
    attrs, ids = _ids_attrs(n, h, w, capacity, dev)
    assert bool((ids < 0).any()) and bool((ids >= 0).any())
    before = tg.table_gather.launches, tg.table_scatter_add.launches
    out = tg.table_gather(attrs, ids)
    assert torch.equal(out, tg.table_gather_plain(attrs, ids))
    g = torch.randn(ids.shape + (16,), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    for cot in (torch.where((ids >= 0)[..., None], g, torch.zeros_like(g)),
                g):                 # nonzero cotangents in the empty slots
        k = tg.table_scatter_add(cot, ids, n)
        p = tg.table_scatter_add_plain(cot, ids, n)
        torch.cuda.synchronize()
        assert _max_rel(k, p) < 1e-5
    assert (tg.table_gather.launches, tg.table_scatter_add.launches) == (
        before[0] + 1, before[1] + 2)


def repeated_ids(T=64, K=128, n_rows=2000, seed=11):
    """A (T, K) id table drawn with numpy: each row below n_rows // 2 in 1
    to 8 random slots, the other slots empty (-1; about 45% of them), the
    rows n_rows // 2 and above in none."""
    rng = np.random.RandomState(seed)
    slots = rng.permutation(T * K)
    reps = rng.randint(1, 9, n_rows // 2)
    ids = np.repeat(np.arange(n_rows // 2), reps)
    assert len(ids) < T * K
    flat = np.full(T * K, -1, np.int32)
    flat[slots[:len(ids)]] = ids
    return flat.reshape(T, K), n_rows


def test_scatter_add_repeated_ids():
    """K4 against its plain version with up to 8 slots on one row, empty
    slots with nonzero cotangents, and untouched rows exactly 0."""
    _need_card()
    dev = torch.device("cuda")
    ids_np, n_rows = repeated_ids()
    ids = torch.as_tensor(ids_np, device=dev)
    g = torch.randn(ids.shape + (16,), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(4))
    k = tg.table_scatter_add(g, ids, n_rows)
    p = tg.table_scatter_add_plain(g, ids, n_rows)
    torch.cuda.synchronize()
    assert _max_rel(k, p) < 1e-5
    used = torch.zeros(n_rows, dtype=torch.bool, device=dev)
    used[ids[ids >= 0].long()] = True
    assert int(used.sum()) == n_rows // 2
    assert bool((k[~used] == 0).all()) and bool((k[used] != 0).any())


def test_table_kernels_check_inputs():
    """No fallback: a CUDA tensor of the wrong type raises."""
    _need_card()
    dev = torch.device("cuda")
    attrs = torch.zeros(10, 16, device=dev)
    with pytest.raises(ValueError):
        tg.table_gather(attrs, torch.zeros(2, 4, dtype=torch.int64,
                                           device=dev))
    with pytest.raises(ValueError):
        tg.table_scatter_add(torch.zeros(2, 4, 8, device=dev),
                             torch.zeros(2, 4, dtype=torch.int32,
                                         device=dev), 10)


# ---------------------------------------------------------------------------
# P1 / P2: the render's projection
# ---------------------------------------------------------------------------

def needle_rows(n):
    """projection_scene's needle-shaped rows. Where they stay valid, their
    float32 det is rounding noise (a*c - b*b of ~1e28 each), and so is
    their gradient, in P2 and in autograd alike: against a float64
    autograd witness both miss by up to hundreds of times the largest
    witness entry (test_project_bwd_matches_autograd holds P2 to that)."""
    return np.arange(n) % 64 == 5


def projection_scene(n, h, w, seed=0):
    """A seeded numpy scene for the projection, with every way to cull a
    row: means over 1.4x the view (some out of the image) at z in [-0.5, 5]
    (some behind the near plane), 1 in 64 rows needle-shaped (one scale up
    to 1e5, two of 1e-7: det <= 0 by rounding), 1 in 10 not alive, SH of
    mixed sign (clamped colours), a small mean2d offset and a camera turned
    and moved off the identity. Returns a dict of float32 arrays (alive
    bool) and the intrinsics."""
    rng = np.random.RandomState(seed)
    f = 0.9 * w
    z = rng.uniform(-0.5, 5.0, (n, 1))
    xy = (rng.uniform(-0.7, 0.7, (n, 2)) * np.array([w, h]) / f
          * np.maximum(z, 0.3))
    scales = np.exp(rng.uniform(np.log(0.004), np.log(0.03), (n, 3)))
    needle = needle_rows(n)
    scales[needle, 0] = np.exp(rng.uniform(np.log(1e2), np.log(1e5),
                                           int(needle.sum())))
    scales[needle, 1:] = 1e-7
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=-1, keepdims=True)
    w2c = np.array([0.03, -0.02, 0.05, 0.04, -0.03, 0.02, 1.0])
    w2c[3:] /= np.linalg.norm(w2c[3:])
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(means=f32(np.concatenate([xy, z], -1)), scales=f32(scales),
                rots=f32(rots), opac=f32(0.2 + 0.75 * rng.uniform(size=n)),
                sh=f32(rng.uniform(-2.5, 1.0, (n, 1, 3))),
                offset=f32(0.05 * rng.normal(size=(n, 2))),
                alive=rng.uniform(size=n) >= 0.1, w2c=f32(w2c),
                intr=f32([f, f, w / 2, h / 2]))


def _proj_inputs(s, dev):
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return ([t(s[k]) for k in ("means", "scales", "rots", "opac", "sh")],
            t(s["w2c"]), t(s["intr"]), t(s["offset"]), t(s["alive"]))


PROJ_SHAPES = [(262144, 384, 512), (262144, 360, 640)]


@pytest.mark.parametrize("n,h,w", PROJ_SHAPES)
def test_project_fwd_matches_plain(n, h, w):
    """P1 against project_gaussians + pack_attrs at phase 3's shape and at
    MoCap's 360x640 (a half-filled last tile row): radius, valid and the
    binning's ids and counts equal; each packed column within 1e-6 of its
    largest entry; every culling reached."""
    _need_card()
    dev = torch.device("cuda")
    gauss, w2c, intr, off, alive = _proj_inputs(projection_scene(n, h, w),
                                                dev)
    before = pc.project_fwd.launches
    k = pc.project_fwd(*gauss, w2c, intr, (h, w), off, alive)
    assert pc.project_fwd.launches == before + 1
    p = pc.project_fwd_plain(*gauss, w2c, intr, (h, w), off, alive)
    proj = tr.project_gaussians(*gauss, w2c, intr, (h, w))
    conic_det = proj.conic[:, 0] * proj.conic[:, 2] - proj.conic[:, 1] ** 2
    near = proj.depth <= 0.2
    assert bool(near.any()) and bool((conic_det <= 0).any())
    assert bool((~proj.valid & ~near & (conic_det > 0)).any())  # off image
    assert int((k.radius != p.radius).sum()) == 0
    assert int((k.valid != p.valid).sum()) == 0
    assert torch.equal(k.mean2d, p.mean2d) and torch.equal(k.depth, p.depth)
    for c in range(16):   # a needle at z ~ 0 has a NaN conic on both sides
        nan = torch.isnan(p.attrs[:, c])
        assert torch.equal(torch.isnan(k.attrs[:, c]), nan), c
        assert _max_rel(k.attrs[~nan, c], p.attrs[~nan, c]) <= 1e-6, c
    assert bool((k.attrs[:, 10:] == 0).all())
    for kw in (4, 2):
        bk = tr.bin_gaussians(k.mean2d, k.radius, k.depth, k.valid, (h, w),
                              capacity=512, kw=kw)
        bp = tr.bin_gaussians(p.mean2d, p.radius, p.depth, p.valid, (h, w),
                              capacity=512, kw=kw)
        assert torch.equal(bk.ids, bp.ids) and torch.equal(bk.counts,
                                                           bp.counts)
        assert int(bk.overflow) == int(bp.overflow)


def _autograd_rows(gauss, w2c, intr, hw, off, alive, g, pose):
    """Gradients of sum(rows * g) through the plain projection under
    autograd: the five Gaussian inputs, the offset and pose_delta."""
    leaves = [x.clone().requires_grad_(True) for x in gauss]
    o = off.clone().requires_grad_(True)
    pd = torch.zeros(6, device=w2c.device, requires_grad=pose)
    proj = tr.project_gaussians(*leaves, w2c, intr, hw,
                                pose_delta=pd if pose else None)
    (tr.pack_attrs(proj.mean2d + o, proj) * g).sum().backward()
    return [x.grad for x in leaves] + [o.grad] + ([pd.grad] if pose else [])


def _kernel_rows(gauss, w2c, intr, hw, off, alive, g, pose):
    """The same gradients through ProjectRows (P1/P2)."""
    leaves = [x.clone().requires_grad_(True) for x in gauss]
    o = off.clone().requires_grad_(True)
    pd = torch.zeros(6, device=w2c.device, requires_grad=pose)
    rows = pc.project_rows(*leaves, w2c, intr, hw, mean2d_offset=o,
                           alive=alive, pose_delta=pd if pose else None)
    (rows.attrs * g).sum().backward()
    grads = [x.grad for x in leaves] + [o.grad] + ([pd.grad] if pose else [])
    return grads, rows.valid


@pytest.mark.parametrize("n,h,w", PROJ_SHAPES)
def test_project_bwd_matches_autograd(n, h, w):
    """P2 against autograd of the plain projection, with seeded cotangents
    on every valid row (as K4 gives them). On the valid rows but the
    needles every gradient within max-rel 1e-5 of autograd's. On the valid
    needles, where float32 gradients are rounding noise in either order,
    both are held to a float64 autograd witness, row by row (a row's
    max-abs miss over its largest witness entry): P2's misses must be
    distributed as float32 autograd's, their median and 90th percentile
    within 1.5 times autograd's (0.885-1.253 over 26 scenes of both
    shapes, this one among them; the largest misses, 1e0-1e4 of the
    witness, are noise on both sides). A needle that only the float32
    forward keeps (0-3 a scene) has no witness. On the rows that are not
    valid P2 writes exact zeros, where autograd gives 0 times the row's
    partials (NaN on a needle at z ~ 0, whose conic overflows)."""
    _need_card()
    dev = torch.device("cuda")
    gauss, w2c, intr, off, alive = _proj_inputs(projection_scene(n, h, w, 1),
                                                dev)
    valid = pc.project_fwd_plain(*gauss, w2c, intr, (h, w), off, alive).valid
    g = torch.randn(n, 16, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(4))
    g = torch.where(valid[:, None], g, torch.zeros_like(g))
    ref = _autograd_rows(gauss, w2c, intr, (h, w), off, alive, g, False)
    before = pc.project_bwd.launches
    got, kvalid = _kernel_rows(gauss, w2c, intr, (h, w), off, alive, g,
                               False)
    assert pc.project_bwd.launches == before + 1
    assert torch.equal(kvalid, valid)
    g64 = [x.double() for x in gauss]
    args64 = (w2c.double(), intr.double(), (h, w), off.double(), alive)
    wit = _autograd_rows(g64, *args64, g.double(), False)
    needle = torch.as_tensor(needle_rows(n), device=dev)
    other = valid & ~needle
    both = valid & pc.project_fwd_plain(*g64, *args64[:4], alive).valid
    nd = both & needle
    assert int(nd.sum()) > 500
    q = torch.tensor([0.5, 0.9], dtype=torch.float64, device=dev)

    def row_miss(x, c):
        x, c = (t[nd].double().reshape(int(nd.sum()), -1) for t in (x, c))
        return torch.quantile((x - c).abs().amax(1)
                              / c.abs().amax(1).clamp_min(1e-30), q)
    for name, a, b, c in zip(("means", "scales", "rots", "opac", "sh",
                              "offset"), got, ref, wit):
        assert _max_rel(a[other], b[other]) < 1e-5, name
        assert bool(torch.isfinite(a[valid]).all()), name
        miss_k, miss_a = row_miss(a, c), row_miss(b, c)
        assert bool((miss_k <= 1.5 * miss_a + 1e-6).all()), (
            name, miss_k.tolist(), miss_a.tolist())
        assert bool((a[~valid] == 0).all()), name


def test_project_pose_gradient():
    """The camera's gradient through P2's block sums and lie.se3_retr
    against autograd within max-rel 1e-5, and bit-equal in two runs. The
    needles get a zero cotangent here: the camera sums every row, and with
    the needles' cotangents float32 autograd's camera gradient was NaN in
    4 of 8 scenes and a float64 witness's up to 3e17 (P2's finite): no
    reference there."""
    _need_card()
    dev = torch.device("cuda")
    n, h, w = 262144, 384, 512
    gauss, w2c, intr, off, alive = _proj_inputs(projection_scene(n, h, w, 2),
                                                dev)
    valid = pc.project_fwd_plain(*gauss, w2c, intr, (h, w), off, alive).valid
    g = torch.randn(n, 16, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    keep = valid & ~torch.as_tensor(needle_rows(n), device=dev)
    g = torch.where(keep[:, None], g, torch.zeros_like(g))
    ref = _autograd_rows(gauss, w2c, intr, (h, w), off, alive, g, True)[-1]
    first = _kernel_rows(gauss, w2c, intr, (h, w), off, alive, g, True)[0]
    again = _kernel_rows(gauss, w2c, intr, (h, w), off, alive, g, True)[0]
    assert _max_rel(first[-1], ref) < 1e-5
    assert torch.equal(first[-1], again[-1])
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_render_fused_projection_on_card():
    """render_fused (P1/P2, K1-K4) against the plain render end to end:
    colour, depth, alpha, radii, and the gradients of every leaf, the
    offset and pose_delta; map.proj.kernel counts one per render, and an
    SH degree above 0 is refused on the card."""
    _need_card()
    dev = torch.device("cuda")
    n, h, w = 400, 48, 64
    s = projection_scene(n, h, w, 3)
    gauss, w2c, intr, off, alive = _proj_inputs(s, dev)
    gauss[1] = gauss[1] * 3.0   # a few px wide at 48x64

    def run(renderer, **kw):
        leaves = [x.clone().requires_grad_(True) for x in gauss]
        o = off.clone().requires_grad_(True)
        pd = torch.zeros(6, device=dev, requires_grad=True)
        out = renderer(*leaves, w2c, intr, (h, w), pose_delta=pd,
                       mean2d_offset=o, alive=alive, capacity=256, **kw)
        ((out.color ** 2).sum() + 0.01 * (out.depth ** 2).sum()
         + 0.1 * (out.alpha ** 2).sum()).backward()
        return out, [x.grad for x in leaves] + [o.grad, pd.grad]

    TIMER.reset()
    before = pc.project_fwd.launches, pc.project_bwd.launches
    of, gf = run(tr.render_fused, chunk=64)
    assert (pc.project_fwd.launches, pc.project_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert TIMER.counters["map.proj.kernel"].total() == 1
    orr, gr = run(tr.render)
    assert int(of.overflow) == int(orr.overflow)
    assert torch.equal(of.radii, orr.radii)
    assert float((of.color - orr.color).abs().max()) < 1e-5
    assert float((of.alpha - orr.alpha).abs().max()) < 1e-5
    assert float((of.depth - orr.depth).abs().max()) < 1e-4
    for name, a, b in zip(("means", "scales", "rots", "opac", "sh", "offset",
                           "pose"), gf, gr):
        assert _max_rel(a, b) < 1e-5, name
    sh16 = torch.cat([gauss[4], torch.zeros(n, 15, 3, device=dev)], 1)
    launches = pc.project_fwd.launches
    with pytest.raises(NotImplementedError):
        tr.render_fused(*gauss[:4], sh16, w2c, intr, (h, w), sh_degree=1,
                        alive=alive, capacity=256)
    assert pc.project_fwd.launches == launches
    TIMER.reset()


def test_project_bwd_skips_gradients_not_asked():
    """Leaves that take no gradient get none from P2, and a camera that
    takes none gets no pose sum; the one asked equals autograd's."""
    _need_card()
    dev = torch.device("cuda")
    n, h, w = 4096, 48, 64
    gauss, w2c, intr, off, alive = _proj_inputs(projection_scene(n, h, w, 6),
                                                dev)
    m = gauss[0].clone().requires_grad_(True)
    rows = pc.ProjectRows.apply(m, *gauss[1:], w2c, intr, off, alive, (h, w),
                                1.0)
    keep = rows[2] & ~torch.as_tensor(needle_rows(n), device=dev)
    g = torch.randn(n, 16, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    g = torch.where(keep[:, None], g, torch.zeros_like(g))
    (rows[0] * g).sum().backward()
    want = _autograd_rows(gauss, w2c, intr, (h, w), off, alive, g, False)[0]
    assert _max_rel(m.grad[rows[2]], want[rows[2]]) < 1e-5
    out = pc.project_bwd(*gauss[:3], gauss[4], rows[2], w2c, intr, (h, w),
                         g, need=(True, False, False, True, False, False))
    assert out[1] is None and out[2] is None and out[4] is None
    assert out[5] is None and out[6] is None
    assert out[0] is not None and out[3] is not None


def test_project_kernels_check_inputs():
    """No fallback: a CUDA tensor of the wrong type or shape raises."""
    _need_card()
    dev = torch.device("cuda")
    gauss, w2c, intr, off, alive = _proj_inputs(projection_scene(64, 48, 64),
                                                dev)
    with pytest.raises(ValueError):
        pc.project_fwd(*gauss, w2c.double(), intr, (48, 64))
    with pytest.raises(ValueError):
        pc.project_fwd(*gauss, w2c, intr, (48, 64), alive=alive.int())
    rows = pc.project_fwd(*gauss, w2c, intr, (48, 64))
    with pytest.raises(ValueError):
        pc.project_bwd(gauss[0], gauss[1], gauss[2], gauss[4], rows.valid,
                       w2c, intr, (48, 64), torch.zeros(64, 10, device=dev))


# ---------------------------------------------------------------------------
# the mapping loss, M1/M2
# ---------------------------------------------------------------------------

LOSS_SHAPES = [(384, 512, 27, 36), (360, 640, 25, 45)]
LOSS_MAX_REL = 1e-5


def loss_cfg(alpha):
    """The loss's settings in tum_dynamic.yaml (alpha 0.8) and
    wild_slam_mocap.yaml (0.5)."""
    return {"alpha": alpha, "rgb_boundary_threshold": 0.01,
            "ssim_loss": True, "lambda_dssim": 0.2,
            "uncertainty_params": {
                "ssim_window_size": 7, "ssim_median_filter_size": 5,
                "opacity_th_for_uncer_loss": 0.9, "ssim_mult": 0.5,
                "uncer_depth_mult": 0.2}}


def loss_inputs(H, W, h, w, seed, dev):
    """(img, depth, gt, ref, sigma, opacity, exposure, median): a render and
    its target with black pixels under the RGB threshold, reference depth
    with holes and a block past the depth threshold, opacity whose DINO-grid
    average straddles 0.9, sigma partly under its 0.1 clamp."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    img = np.clip(0.5 + 0.3 * np.sin(0.05 * xx + 0.03 * yy)[..., None]
                  + 0.2 * rng.uniform(-1, 1, (H, W, 3)), 0, 1)
    gt = np.clip(img + 0.1 * rng.normal(size=img.shape), 0, 1)
    gt[:8, :40] = 0.0
    depth = 2.0 + 0.5 * np.sin(0.01 * xx) + 0.3 * rng.uniform(size=(H, W))
    ref = depth + 0.6 * rng.normal(size=(H, W))
    ref[:6] = 0.0
    ref[rng.uniform(size=(H, W)) < 0.05] = 0.0
    ref[-40:, -70:] = 60.0
    opac = np.clip(0.9 + 0.08 * np.sin(2 * np.pi * 3 * xx / W)
                   + 0.05 * rng.uniform(-1, 1, (H, W)), 0, 1)
    sigma = 0.03 + 2.0 * rng.uniform(size=(h, w))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa
    ref_t = t(ref)
    return (t(img), t(depth), t(gt), ref_t, t(sigma), t(opac),
            t([0.05, -0.02]), losses.ssim_ops.median(ref_t))


def _loss_run(fn, x, cfg, init):
    """fn's outputs and the gradients of total + 0.25 sum(uncer_loss) in
    (img, depth, sigma, exposure)."""
    img, depth, gt, ref, sigma, opac, exp, med = x
    leaves = [v.clone().requires_grad_(True) for v in (img, depth, sigma,
                                                        exp)]
    lo = fn(leaves[0], leaves[1], gt, ref, leaves[2], opac, leaves[3][0],
            leaves[3][1], 0.3, 0.3, cfg, initialization=init,
            ref_depth_median=med)
    (lo.total + 0.25 * lo.uncer_loss.sum()).backward()
    torch.cuda.synchronize()
    return lo, [v.grad for v in leaves]


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("H,W,h,w", LOSS_SHAPES)
def test_mapping_loss_matches_plain(H, W, h, w, init):
    _need_card()
    dev = torch.device("cuda")
    x = loss_inputs(H, W, h, w, 3, dev)
    cfg = loss_cfg(0.8 if W == 512 else 0.5)
    TIMER.reset()
    fwd, bwd = lc.mapping_loss_fwd.launches, lc.mapping_loss_bwd.launches
    k, kg = _loss_run(losses.mapping_loss_uncertainty, x, cfg, init)
    assert lc.mapping_loss_fwd.launches - fwd == 1
    assert lc.mapping_loss_bwd.launches - bwd == 1
    assert TIMER.counters["map.loss.kernel"].total() == 1
    p, pg = _loss_run(losses.mapping_loss_uncertainty_plain, x, cfg, init)
    # the inputs reach every branch
    small_op = losses.ssim_ops.resample_bilinear(x[5], (h, w))
    assert 0 < int((small_op < 0.9).sum()) < h * w
    assert bool((x[4] < 0.1).any())
    assert bool((p.uncer_loss == 0).any()) and bool((p.weights_pix == 0).any())

    kt, pt = float(k.total.detach()), float(p.total.detach())
    assert abs(kt - pt) <= LOSS_MAX_REL * abs(pt)
    for a, b in ((k.uncer_loss, p.uncer_loss), (k.weights_pix, p.weights_pix),
                 (k.l1_rgb, p.l1_rgb), (k.l1_depth, p.l1_depth)):
        assert _max_rel(a.detach(), b.detach()) < LOSS_MAX_REL
    for name, a, b in zip(("img", "depth", "sigma", "exposure"), kg, pg):
        if init and name == "exposure":
            assert a is None and b is None
            continue
        assert _max_rel(a, b) < LOSS_MAX_REL, name

    k2, kg2 = _loss_run(losses.mapping_loss_uncertainty, x, cfg, init)
    assert torch.equal(k.total, k2.total)
    assert torch.equal(k.uncer_loss, k2.uncer_loss)
    assert torch.equal(k.weights_pix, k2.weights_pix)
    for a, b in zip(kg, kg2):
        assert (a is None and b is None) or torch.equal(a, b)


def test_mapping_loss_kernels_check_inputs():
    """No fallback: a tensor on another device, of another type or shape,
    or not contiguous, raises."""
    _need_card()
    dev = torch.device("cuda")
    img, depth, gt, ref, sigma, opac, exp, med = loss_inputs(48, 64, 3, 4, 0,
                                                             dev)
    p = lc.LossParams(7, 5, False, True, 0.01, 1.5, 400.0, 0.8, 0.2, 0.5,
                      0.2, 0.9)
    args = [img, depth, gt, ref, sigma, opac, exp[0], exp[1], med]
    bad = {0: img.cpu(), 1: depth.double(), 3: ref[:, :32],
           2: gt.permute(1, 0, 2).contiguous().permute(1, 0, 2),
           4: sigma.t().contiguous().t()}
    for i, v in bad.items():
        with pytest.raises(ValueError):
            lc.mapping_loss_fwd(*(v if j == i else a
                                  for j, a in enumerate(args)), p)
    out = lc.mapping_loss_fwd(*args, p)
    _, _, weights, _, _, coef, sums, du = out
    with pytest.raises(ValueError):
        lc.mapping_loss_bwd(img, depth, gt, ref, exp[0], exp[1], med, weights,
                            coef, sums, du, torch.ones((), device=dev,
                                                       dtype=torch.float64),
                            None, p)
    with pytest.raises(ValueError):
        lc.mapping_loss_bwd(img, depth, gt, ref, exp[0], exp[1], med, weights,
                            coef, sums, du, torch.ones((), device=dev),
                            torch.ones(4, 3, device=dev), p)


# ---------------------------------------------------------------------------
# conv_nhwc
# ---------------------------------------------------------------------------

CONV_CASES = ["corr0", "flow0", "flow2", "w", "glo", "zr", "q", "heads",
              "delta", "eta", "upmask"]


def _conv_case(case, E, h, w, dev, seed=0):
    """(sources, packed weights, act, epilogue kwargs) of one launch of the
    update operator, on seeded inputs of its widths."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    def conv(cin, n, k):
        c = torch.nn.Conv2d(cin, n, k, padding=k // 2)
        torch.nn.init.normal_(c.weight, std=(1.0 / (cin * k * k)) ** 0.5,
                              generator=g)
        torch.nn.init.normal_(c.bias, std=0.1, generator=g)
        return cn.pack(c.to(dev))

    net = torch.tanh(rnd(E, h, w, 128))
    srcs4 = (net, torch.relu(rnd(E, h, w, 128)), torch.relu(rnd(E, h, w, 128)),
             torch.relu(rnd(E, h, w, 64)))
    if case == "corr0":
        return rnd(E, h, w, 196), conv(196, 128, 1), "relu", {}
    if case == "flow0":
        return rnd(E, h, w, 4), conv(4, 128, 7), "relu", {}
    if case == "flow2":
        return srcs4[1], conv(128, 64, 3), "relu", {}
    if case == "w":
        return net, conv(128, 128, 1), "sigmoid", {"mul": net}
    if case == "glo":
        return rnd(E, 1, 1, 128), conv(128, 384, 1), "none", {}
    if case == "zr":
        return srcs4, conv(448, 256, 3), "sigmoid", {
            "glo": rnd(E, 384)[:, :256]}
    if case == "q":
        zr = torch.sigmoid(rnd(E, h, w, 256))
        return srcs4, conv(448, 128, 3), "tanh", {
            "glo": rnd(E, 384)[:, 256:], "scale": zr[..., 128:],
            "blend": (net, zr[..., :128])}
    if case == "heads":
        return net, conv(128, 384, 3), "relu", {}
    heads = torch.relu(rnd(E, h, w, 384))
    if case == "delta":
        return heads[..., :128], conv(128, 2, 3), "none", {}
    if case == "eta":
        return heads[..., 256:], conv(128, 1, 3), "none", {}
    assert case == "upmask"
    return heads[..., 128:256], conv(128, 576, 1), "none", {}


@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("h,w", [(48, 64), (45, 80)])
@pytest.mark.parametrize("E", [1, 8, 64])
def test_conv_nhwc_matches_plain(E, h, w, case):
    _need_card()
    dev = torch.device("cuda")
    srcs, packed, act, kw = _conv_case(case, E, h, w, dev)
    before = cn.conv_nhwc.launches
    out = cn.conv_nhwc(srcs, packed, act, **kw)
    ref = cn.conv_nhwc_plain(srcs, packed, act, **kw)
    torch.cuda.synchronize()
    assert cn.conv_nhwc.launches == before + 1
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    scale = float(ref.abs().max())
    assert scale > 0
    assert float((out - ref).abs().max()) <= 1e-5 * scale


def _edge(x, i):
    """Edge i of a launch's operands, as a batch of one."""
    if isinstance(x, torch.Tensor):
        return x[i:i + 1]
    if isinstance(x, dict):
        return {k: _edge(v, i) for k, v in x.items()}
    return type(x)(_edge(v, i) for v in x)


@pytest.mark.parametrize("case", ["corr0", "flow2", "zr", "q"])
def test_conv_nhwc_batch_changes_no_result(case):
    """A batch gives each edge what it gets alone, bit for bit: at 64 edges
    the kernel runs its 128-row tiles, at one edge its 32-row ones, and
    every tile adds each output's products in one order, whatever the
    block's place in the batch. So the edge-sharded update
    (parallel/sharded_track.py) gets the single device's numbers."""
    _need_card()
    dev = torch.device("cuda")
    srcs, packed, act, kw = _conv_case(case, 64, 45, 80, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (cn.plan(64 * 45 * 80, packed.n, sms) < cn.SHORT
            <= cn.plan(45 * 80, packed.n, sms))
    full = cn.conv_nhwc(srcs, packed, act, **kw)
    for i in (0, 37):
        one = cn.conv_nhwc(_edge(srcs, i), packed, act, **_edge(kw, i))
        assert torch.equal(one[0], full[i])


def test_conv_nhwc_rejects_bad_inputs():
    """No fallback: channels that are not contiguous, float64, or a source
    on another device than the weights raise."""
    _need_card()
    dev = torch.device("cuda")
    packed = cn.pack(torch.nn.Conv2d(8, 4, 3, padding=1).to(dev))
    x = torch.randn(2, 5, 6, 8, device=dev)
    before = cn.conv_nhwc.launches
    for bad in (x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
                x.double(), x.cpu()):
        with pytest.raises(ValueError):
            cn.conv_nhwc(bad, packed)
    assert cn.conv_nhwc.launches == before


@torch.no_grad()
def test_update_operator_runs_the_kernel():
    """DroidNet.update on the card: 14 kernel launches a call, each counted
    in track.upd.kernel_convs, and its outputs equal the CPU module's
    (plain path) within 1e-5 of each output's largest entry."""
    _need_card()
    dev = torch.device("cuda")
    model = dn.init_droid_net(torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    E, h, w = 6, 48, 64
    args = [torch.tanh(torch.randn(E, h, w, 128, generator=g)),
            torch.relu(torch.randn(E, h, w, 128, generator=g)),
            torch.randn(E, h, w, 196, generator=g),
            torch.randn(E, h, w, 4, generator=g),
            torch.tensor([0, 3, 0, 1, 3, 3])]
    ref = model.update(*args)
    model = model.to(dev)
    TIMER.reset()
    before = cn.conv_nhwc.launches
    out = model.update(*(a.to(dev) for a in args))
    torch.cuda.synchronize()
    assert cn.conv_nhwc.launches - before == 14
    assert TIMER.counters["track.upd.kernel_convs"].total() == 14
    assert torch.equal(out[3].cpu(), ref[3])
    for a, b in zip(out[:3] + out[4:], ref[:3] + ref[4:]):
        scale = float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * scale
