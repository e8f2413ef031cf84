"""K1-K4 on the card against their plain PyTorch versions.

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
"""

import numpy as np
import pytest
import torch

from wildgs_slam_tpu_torch.ops import rasterizer as tr
from wildgs_slam_tpu_torch.ops.rasterizer import composite_cuda as cc
from wildgs_slam_tpu_torch.ops.rasterizer import table_gather as tg

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
