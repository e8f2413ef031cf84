"""The port's rasterizer against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. Where
the JAX side reaches the Pallas kernels it runs them in interpret mode, as
tests/test_pallas_composite.py does.

Tolerances, and why:
- SE3, SH, projection: float32 elementwise math in both, rtol 1e-5 /
  atol 1e-5 (op order differs only in library reductions).
- Binning: ids, counts and overflow must be exactly equal.
- Composite forward: atol 1e-5 colour and alpha, 1e-4 depth (depth is not
  normalized, values ~3), the tolerances of test_pallas_composite.py.
- Gradients: max-relative error (max |a - b| / max |b|) below 1e-5, as in
  test_pallas_composite.py; 1e-4 against the JAX XLA path, whose prefix
  products go through exp(cumsum(log)) rather than products.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildgs_slam_tpu.ops import lie as jlie
from wildgs_slam_tpu.ops import sh as jsh
from wildgs_slam_tpu.ops import rasterizer as jr
from wildgs_slam_tpu.ops.rasterizer import binning as jbin
from wildgs_slam_tpu.ops.rasterizer import pallas_composite as jpc
from wildgs_slam_tpu.ops.rasterizer import projection as jproj
from wildgs_slam_tpu_torch.ops import lie as tlie
from wildgs_slam_tpu_torch.ops import sh as tsh
from wildgs_slam_tpu_torch.ops import rasterizer as tr
from wildgs_slam_tpu_torch.ops.rasterizer import binning as tbin
from wildgs_slam_tpu_torch.ops.rasterizer import composite_cuda as tcc
from test_torch_kernels_gpu import (OVERFLOW_SLOTS, overflow_table,
                                    saturating_table, skip_edge_table)

torch.set_num_threads(1)
H, W = 48, 64


def T(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@pytest.fixture(scope="module")
def scene():
    """The scene of test_pallas_composite.py, drawn with numpy."""
    rng = np.random.RandomState(0)
    N = 200
    means = np.concatenate([rng.uniform(-1, 1, (N, 2)),
                            2.0 + 2.0 * rng.uniform(size=(N, 1))], -1)
    scales = 0.02 + 0.08 * rng.uniform(size=(N, 3))
    rots = rng.normal(size=(N, 4))
    rots /= np.linalg.norm(rots, axis=-1, keepdims=True)
    opac = 0.3 + 0.6 * rng.uniform(size=N)
    sh = rng.uniform(size=(N, 1, 3))
    w2c = np.array([0.02, -0.01, 0.03, 0.01, -0.02, 0.015, 1.0])
    w2c[3:] /= np.linalg.norm(w2c[3:])
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(means=f32(means), scales=f32(scales), rots=f32(rots),
                opac=f32(opac), sh=f32(sh), w2c=f32(w2c),
                intr=f32([55.0, 55.0, W / 2, H / 2]))


def test_se3_ops():
    rng = np.random.RandomState(1)
    xi = (0.3 * rng.normal(size=(16, 6))).astype(np.float32)
    xi[0] = 0.0
    xi[1, 3:] = 1e-5
    pts = rng.normal(size=(16, 3)).astype(np.float32)
    g_j = jlie.se3_exp(jnp.asarray(xi))
    g_t = tlie.se3_exp(T(xi))
    np.testing.assert_allclose(g_t, g_j, rtol=1e-5, atol=1e-6)
    g2 = np.asarray(jlie.se3_exp(jnp.asarray(xi[::-1].copy())))
    for fj, ft in ((jlie.se3_inv, tlie.se3_inv),):
        np.testing.assert_allclose(ft(T(g_j)), fj(g_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tlie.se3_mul(T(g_j), T(g2)),
                               jlie.se3_mul(g_j, jnp.asarray(g2)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tlie.se3_act(T(g_j), T(pts)),
                               jlie.se3_act(g_j, jnp.asarray(pts)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tlie.se3_retr(T(g2), T(xi)),
                               jlie.se3_retr(jnp.asarray(g2), jnp.asarray(xi)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tlie.quat_to_matrix(T(g_j)[:, 3:]),
                               jlie.quat_to_matrix(g_j[:, 3:]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tlie.se3_identity((2,), device="cpu"),
                                  jlie.se3_identity((2,)))


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh(deg):
    rng = np.random.RandomState(deg)
    sh = rng.normal(size=(50, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tsh.eval_sh(deg, T(sh), T(dirs)),
        jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)),
        rtol=1e-5, atol=1e-6)


def test_projection_and_pose_gradient(scene):
    s = scene
    args = [s["means"], s["scales"], s["rots"], s["opac"], s["sh"],
            s["w2c"], s["intr"]]
    pj = jproj.project_gaussians(*map(jnp.asarray, args), (H, W),
                                 pose_delta=jnp.zeros(6))
    pt = tr.project_gaussians(*map(T, args), (H, W),
                              pose_delta=torch.zeros(6))
    for name in ("mean2d", "depth", "conic", "color", "opacity"):
        np.testing.assert_allclose(getattr(pt, name).detach(),
                                   getattr(pj, name), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(pt.radius, pj.radius)
    np.testing.assert_array_equal(pt.valid, pj.valid)

    rng = np.random.RandomState(2)
    wm = rng.normal(size=(200, 2)).astype(np.float32)
    wc = rng.normal(size=(200, 3)).astype(np.float32)

    def jloss(m, pd):
        p = jproj.project_gaussians(m, *map(jnp.asarray, args[1:]), (H, W),
                                    pose_delta=pd)
        return jnp.sum(p.mean2d * wm) + jnp.sum(p.conic * wc)
    gj = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(s["means"]),
                                         jnp.zeros(6))
    m = T(s["means"]).requires_grad_(True)
    pd = torch.zeros(6, requires_grad=True)
    p = tr.project_gaussians(m, *map(T, args[1:]), (H, W), pose_delta=pd)
    ((p.mean2d * T(wm)).sum() + (p.conic * T(wc)).sum()).backward()
    assert max_rel(m.grad, gj[0]) < 1e-5
    assert max_rel(pd.grad, gj[1]) < 1e-5


@pytest.mark.parametrize("capacity,kw", [(256, 4), (24, 4), (64, 2),
                                         (512, 3), (512, 6)])
def test_binning_exact(scene, capacity, kw):
    s = scene
    pj = jproj.project_gaussians(
        *map(jnp.asarray, [s["means"], 2.5 * s["scales"], s["rots"],
                           s["opac"], s["sh"], s["w2c"], s["intr"]]), (H, W))
    bj = jbin.bin_gaussians(pj.mean2d, pj.radius, pj.depth, pj.valid, (H, W),
                            capacity=capacity, method="sort", kw=kw,
                            with_rev=False)
    bt = tbin.bin_gaussians(T(pj.mean2d), T(pj.radius, torch.int32),
                            T(pj.depth), T(pj.valid, torch.bool), (H, W),
                            capacity=capacity, kw=kw)
    np.testing.assert_array_equal(bt.ids, bj.ids)
    np.testing.assert_array_equal(bt.counts, bj.counts)
    assert int(bt.overflow) == int(bj.overflow)
    if capacity == 24 or kw == 3:     # lists, or windows, overflow
        assert int(bj.overflow) > 0


def _table(scene, capacity=256):
    """A packed per-tile table from the scene, built with the JAX package's
    projection and binning."""
    s = scene
    pj = jproj.project_gaussians(*map(jnp.asarray, [
        s["means"], s["scales"], s["rots"], s["opac"], s["sh"], s["w2c"],
        s["intr"]]), (H, W))
    b = jbin.bin_gaussians(pj.mean2d, pj.radius, pj.depth, pj.valid, (H, W),
                           capacity=capacity, method="sort", with_rev=False)
    zc = jnp.zeros_like(pj.depth)
    attrs = jnp.stack([pj.mean2d[:, 0], pj.mean2d[:, 1], pj.conic[:, 0],
                       pj.conic[:, 1], pj.conic[:, 2], pj.color[:, 0],
                       pj.color[:, 1], pj.color[:, 2], pj.opacity, pj.depth]
                      + [zc] * 6, axis=1)
    table = np.asarray(attrs[jnp.maximum(b.ids, 0)])
    return np.asarray(b.counts, np.int32), table


@pytest.mark.parametrize("ck", [64, 8])
def test_composite_kernels_plain_vs_pallas(scene, ck):
    counts, table = _table(scene)
    tw = jbin.num_tiles((H, W))[1]
    bg = np.array([0.1, 0.5, 0.9], np.float32)
    n_t = table.shape[0]
    rng = np.random.RandomState(3)
    gc = rng.normal(size=(n_t, 256, 3)).astype(np.float32)
    gd, ga, gt = (rng.normal(size=(n_t, 256)).astype(np.float32)
                  for _ in range(3))

    def jfun(attrs, bgv):
        out = jpc.composite_tiles_pallas(tw, ck, True, jnp.asarray(counts),
                                         attrs, bgv)
        return out
    jout, vjp = jax.vjp(jfun, jnp.asarray(table), jnp.asarray(bg))
    jgrad = vjp(jpc.PallasTiles(jnp.asarray(gc), jnp.asarray(gd),
                                jnp.asarray(ga), jnp.asarray(gt)))

    tid = torch.arange(n_t, dtype=torch.int32)
    color, depth, alpha, tfin, tentry = tcc.composite_fwd_plain(
        T(counts, torch.int32), tid, T(table), T(bg), tw, ck)
    np.testing.assert_allclose(color, jout.color, atol=1e-5)
    np.testing.assert_allclose(depth, jout.depth, atol=1e-4)
    np.testing.assert_allclose(alpha, jout.alpha, atol=1e-5)
    np.testing.assert_allclose(tfin, jout.tfin, atol=1e-5)

    dattrs = tcc.composite_bwd_plain(T(counts, torch.int32), tid, T(table),
                                     T(bg), tentry, tfin, T(gc), T(gd), T(ga),
                                     T(gt), tw, ck)
    assert max_rel(dattrs, jgrad[0]) < 1e-5
    assert np.all(np.asarray(dattrs)[..., 10:] == 0)

    # the autograd wiring (plain versions on the CPU) gives the same
    a = T(table).requires_grad_(True)
    bgt = T(bg).requires_grad_(True)
    outs = tcc.composite_tiles(T(counts, torch.int32), a, bgt, tw, ck)
    sum((o * T(g)).sum() for o, g in zip(outs, (gc, gd, ga, gt))).backward()
    assert max_rel(a.grad, jgrad[0]) < 1e-5
    assert max_rel(bgt.grad, jgrad[1]) < 1e-5
    assert tcc.composite_fwd.launches == 0  # no kernel on a CPU tensor


@pytest.mark.parametrize("ck", [8, 32])
def test_composite_bwd_saturated_chunks_vs_pallas(ck):
    """K2's plain version against the Pallas VJP on a table whose tiles
    saturate before their count (a dense, opaque front layer; two tiles
    filled to the capacity): every slot of a chunk that every pixel enters
    with transmittance < 1e-4 has an exactly zero gradient in both, the
    premise of the CUDA kernel's skips."""
    counts, table, tw = saturating_table()
    n_t, K, _ = table.shape
    bg = np.array([0.1, 0.5, 0.9], np.float32)
    rng = np.random.RandomState(3)
    gc = rng.normal(size=(n_t, 256, 3)).astype(np.float32)
    gd, ga, gt = (rng.normal(size=(n_t, 256)).astype(np.float32)
                  for _ in range(3))
    jout, vjp = jax.vjp(
        lambda a, b: jpc.composite_tiles_pallas(tw, ck, True,
                                                jnp.asarray(counts), a, b),
        jnp.asarray(table), jnp.asarray(bg))
    jgrad = np.asarray(vjp(jpc.PallasTiles(
        jnp.asarray(gc), jnp.asarray(gd), jnp.asarray(ga),
        jnp.asarray(gt)))[0])

    tid = torch.arange(n_t, dtype=torch.int32)
    color, depth, alpha, tfin, tentry = tcc.composite_fwd_plain(
        T(counts, torch.int32), tid, T(table), T(bg), tw, ck)
    np.testing.assert_allclose(color, jout.color, atol=1e-5)
    np.testing.assert_allclose(tfin, jout.tfin, atol=1e-5)
    dattrs = tcc.composite_bwd_plain(T(counts, torch.int32), tid, T(table),
                                     T(bg), tentry, tfin, T(gc), T(gd), T(ga),
                                     T(gt), tw, ck).numpy()
    assert max_rel(dattrs, jgrad) < 1e-5

    starts = np.arange(K // ck) * ck
    sat = (starts[None] < counts[:, None]) & (tentry.amax(-1).numpy() < 1e-4)
    assert sat[0, -1] and sat.sum() >= 8 and not sat[8:].any()
    rows = np.repeat(sat, ck, axis=1)                       # (T, K)
    assert np.all(dattrs[rows] == 0) and np.all(jgrad[rows] == 0)
    assert np.abs(dattrs[~rows]).max() > 0


@pytest.mark.parametrize("ck", [8, 32])
def test_composite_bwd_overflow_nan_vs_pallas(ck):
    """Where exp(power) overflows (indefinite conics of ``overflow_table``,
    in open and saturated chunks and past a tile's count inside an open
    chunk), dalpha = 0 and G = inf make the slot's geometry gradients NaN
    in the Pallas VJP; K2's plain version puts NaN in the same positions
    and agrees elsewhere."""
    counts, table, tw = overflow_table()
    n_t = table.shape[0]
    bg = np.array([0.1, 0.5, 0.9], np.float32)
    rng = np.random.RandomState(3)
    gc = rng.normal(size=(n_t, 256, 3)).astype(np.float32)
    gd, ga, gt = (rng.normal(size=(n_t, 256)).astype(np.float32)
                  for _ in range(3))
    jout, vjp = jax.vjp(
        lambda a, b: jpc.composite_tiles_pallas(tw, ck, True,
                                                jnp.asarray(counts), a, b),
        jnp.asarray(table), jnp.asarray(bg))
    jgrad = np.asarray(vjp(jpc.PallasTiles(
        jnp.asarray(gc), jnp.asarray(gd), jnp.asarray(ga),
        jnp.asarray(gt)))[0])
    tid = torch.arange(n_t, dtype=torch.int32)
    color, _, _, tfin, tentry = tcc.composite_fwd_plain(
        T(counts, torch.int32), tid, T(table), T(bg), tw, ck)
    np.testing.assert_allclose(color, jout.color, atol=1e-5)
    dattrs = tcc.composite_bwd_plain(T(counts, torch.int32), tid, T(table),
                                     T(bg), tentry, tfin, T(gc), T(gd), T(ga),
                                     T(gt), tw, ck).numpy()
    nan = np.isnan(jgrad)
    np.testing.assert_array_equal(np.isnan(dattrs), nan)
    assert nan.sum() == 6 * len(OVERFLOW_SLOTS)
    for t, k in OVERFLOW_SLOTS:
        assert nan[t, k, [0, 1, 2, 3, 4, 8]].all()
    assert max_rel(dattrs[~nan], jgrad[~nan]) < 1e-5


@pytest.mark.parametrize("ck", [8, 32])
def test_composite_fwd_skip_edges_vs_pallas(ck):
    """K1's plain version against the Pallas forward on the table of
    `skip_edge_table` (a tile with count 0, a tile whose every slot is dead,
    tiles whose first slots or first chunk are dead, alpha within a few ulp
    of 1/255, counts that end inside a chunk): the semantics the CUDA
    kernel's dead-pair skips rely on. Pixels that no slot reaches keep
    tfin = 1 and composite to the background in both."""
    counts, table, tw = skip_edge_table()
    n_t = table.shape[0]
    bg = np.array([0.1, 0.5, 0.9], np.float32)
    jout = jpc.composite_tiles_pallas(tw, ck, True, jnp.asarray(counts),
                                      jnp.asarray(table), jnp.asarray(bg))
    tid = torch.arange(n_t, dtype=torch.int32)
    color, depth, alpha, tfin, tentry = tcc.composite_fwd_plain(
        T(counts, torch.int32), tid, T(table), T(bg), tw, ck)
    np.testing.assert_allclose(color, jout.color, atol=1e-5)
    np.testing.assert_allclose(depth, jout.depth, atol=1e-4)
    np.testing.assert_allclose(alpha, jout.alpha, atol=1e-5)
    np.testing.assert_allclose(tfin, jout.tfin, atol=1e-5)
    untouched = np.asarray(jout.alpha) == 0                 # (T, P)
    assert untouched[:2].all() and untouched[2:].any()
    assert np.all(np.asarray(tfin)[untouched] == 1)
    assert np.all(np.asarray(jout.tfin)[untouched] == 1)
    np.testing.assert_array_equal(np.asarray(color)[:2],
                                  np.broadcast_to(bg, (2, 256, 3)))
    assert np.asarray(alpha)[2:].max() > 0.5


def _loss_and_grads(renderer, scene, torch_side, **kw):
    s = scene
    rng = np.random.RandomState(4)
    wc = rng.uniform(size=(H, W, 3)).astype(np.float32)
    if torch_side:
        m = T(s["means"]).requires_grad_(True)
        sc = T(s["scales"]).requires_grad_(True)
        o = T(s["opac"]).requires_grad_(True)
        pd = torch.zeros(6, requires_grad=True)
        out = renderer(m, sc, T(s["rots"]), o, T(s["sh"]), T(s["w2c"]),
                       T(s["intr"]), (H, W), pose_delta=pd, **kw)
        loss = ((out.color * T(wc)).sum() + 0.01 * (out.depth ** 2).sum()
                + 0.1 * (out.alpha ** 2).sum())
        loss.backward()
        return out, [x.grad for x in (m, sc, o, pd)]

    def f(m, sc, o, pd):
        out = renderer(m, sc, jnp.asarray(s["rots"]), o, jnp.asarray(s["sh"]),
                       jnp.asarray(s["w2c"]), jnp.asarray(s["intr"]), (H, W),
                       pose_delta=pd, **kw)
        return (jnp.sum(out.color * wc) + 0.01 * jnp.sum(out.depth ** 2)
                + 0.1 * jnp.sum(out.alpha ** 2)), out
    (_, out), g = jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(s["means"]), jnp.asarray(s["scales"]),
        jnp.asarray(s["opac"]), jnp.zeros(6))
    return out, g


def _compare(ot, gt_, oj, gj, grad_tol):
    np.testing.assert_allclose(ot.color.detach(), oj.color, atol=1e-5)
    np.testing.assert_allclose(ot.depth.detach(), oj.depth, atol=1e-4)
    np.testing.assert_allclose(ot.alpha.detach(), oj.alpha, atol=1e-5)
    np.testing.assert_array_equal(ot.radii, oj.radii)
    assert int(ot.overflow) == int(oj.overflow)
    for a, b in zip(gt_, gj):
        assert max_rel(a, b) < grad_tol, max_rel(a, b)


def test_render_matches_jax_render(scene):
    """The plain all-tiles path against the JAX XLA path, n_touched too."""
    kw = dict(capacity=256, chunk=64, bin_kw=4)
    ot, gt_ = _loss_and_grads(tr.render, scene, True, **kw)
    oj, gj = _loss_and_grads(jr.render, scene, False, bin_method="sort_norev",
                             **kw)
    _compare(ot, gt_, oj, gj, 1e-4)
    np.testing.assert_array_equal(ot.n_touched, oj.n_touched)


def test_render_fused_matches_render_pallas(scene):
    """The kernel path (plain versions on the CPU) against render_pallas in
    interpret mode, forward and every gradient including the pose's."""
    kw = dict(capacity=256, chunk=64, bin_kw=4)
    ot, gt_ = _loss_and_grads(tr.render_fused, scene, True, **kw)
    oj, gj = _loss_and_grads(jr.render_pallas, scene, False,
                             bin_method="sort_norev", interpret=True, **kw)
    _compare(ot, gt_, oj, gj, 1e-5)


def test_render_reference_matches_jax(scene):
    ot, gt_ = _loss_and_grads(tr.render_reference, scene, True)
    oj, gj = _loss_and_grads(jr.render_reference, scene, False)
    _compare(ot, gt_, oj, gj, 1e-5)
    np.testing.assert_array_equal(ot.n_touched, oj.n_touched)


def test_projected_conics_keep_power_nonpositive():
    """K2's domain (ROADMAP Queue 3): on the tile table that the port's own
    projection and binning build, the Gaussian exponent is <= 0 at every
    pixel of every live slot, so exp(power) never overflows there. The
    scene mixes round and needle-thin Gaussians (scale ratios to 1000) at
    depths 0.3-6 with random rotations; the projection's 0.3 px dilation
    keeps every conic positive definite."""
    from wildgs_slam_tpu_torch.ops.rasterizer import table_gather as ttg

    rng = np.random.RandomState(12)
    n = 3000
    means = np.concatenate([rng.uniform(-1.2, 1.2, (n, 2)),
                            np.ones((n, 1))], -1) * rng.uniform(
        0.3, 6.0, (n, 1))
    scales = np.exp(rng.uniform(np.log(1e-4), np.log(0.1), (n, 3)))
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=-1, keepdims=True)
    proj = tr.project_gaussians(
        T(means), T(scales), T(rots), T(rng.uniform(0.05, 1.0, n)),
        T(rng.uniform(size=(n, 1, 3))), T([0, 0, 0, 0, 0, 0, 1]),
        T([50.0, 50.0, W / 2, H / 2]), (H, W))
    bins = tr.bin_gaussians(proj.mean2d, proj.radius, proj.depth, proj.valid,
                            (H, W), capacity=512)
    z = torch.zeros_like(proj.depth)
    attrs = torch.stack([proj.mean2d[:, 0], proj.mean2d[:, 1],
                         proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
                         z, z, z, proj.opacity, proj.depth] + [z] * 6, 1)
    table = ttg.table_gather_plain(attrs, bins.ids.to(torch.int32))
    n_tiles, K, _ = table.shape
    px, py = tcc.tile_pixel_coords(torch.arange(n_tiles, dtype=torch.int32),
                                   -(-W // 16))
    live = (torch.arange(K)[None, :] < bins.counts[:, None].long())
    assert int(live.sum()) > 1000
    dx = table[..., tcc.A_MX, None] - px[:, None, :]
    dy = table[..., tcc.A_MY, None] - py[:, None, :]
    power = (-0.5 * (table[..., tcc.A_CA, None] * dx * dx
                     + table[..., tcc.A_CC, None] * dy * dy)
             - table[..., tcc.A_CB, None] * dx * dy)
    assert float(power[live].max()) <= 0.0
