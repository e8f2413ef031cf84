"""K3/K4's plain versions (the tile-table gather and its masked scatter-add)
against the JAX package's table gather and its VJP, on a binned table.

The table comes from the JAX package's own projection and sort binning of
a seeded scene, so it has live slots and empty (-1) slots as on the mapping
path. The JAX side is ``attrs[max(ids, 0)]`` under ``jax.vjp`` and the
``_gather_rows_mm`` custom VJP that ``render_pallas`` uses.

Tolerances: the forward gathers are copies, so they must be equal. The
backward sums up to a few hundred cotangents per Gaussian in another order
than XLA's scatter: max-abs 1e-5 on sums of O(1) values. The
``_gather_rows_mm`` VJP splits each cotangent into bfloat16 high and low
halves, which bounds its own error at ~2^-17 relative per cotangent: max-abs
1e-4 there. With zero cotangents in the empty slots (the mapping path's
contract, K2 zeroes them) the masked backward equals the JAX VJP; with
nonzero ones it differs exactly by what JAX piles onto row 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildgs_slam_tpu.ops.rasterizer import _gather_rows_mm
from wildgs_slam_tpu.ops.rasterizer import binning as jbin
from wildgs_slam_tpu.ops.rasterizer import projection as jproj
from wildgs_slam_tpu_torch.ops import rasterizer as tr
from wildgs_slam_tpu_torch.ops.rasterizer import table_gather as tg

torch.set_num_threads(1)
N, H, W, CAP = 600, 48, 64, 64
BWD_ATOL = {"index": 1e-5, "gather_rows_mm": 1e-4}


@pytest.fixture(scope="module")
def table():
    rng = np.random.RandomState(0)
    means = np.concatenate([rng.uniform(-1, 1, (N, 2)),
                            2 + 2 * rng.uniform(size=(N, 1))], -1)
    rots = rng.normal(size=(N, 4))
    rots /= np.linalg.norm(rots, axis=-1, keepdims=True)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    proj = jproj.project_gaussians(
        f32(means), f32(0.02 + 0.08 * rng.uniform(size=(N, 3))), f32(rots),
        f32(0.3 + 0.6 * rng.uniform(size=N)), f32(rng.uniform(size=(N, 1, 3))),
        f32([0, 0, 0, 0, 0, 0, 1]), f32([55.0, 55.0, W / 2, H / 2]), (H, W))
    bins = jbin.bin_gaussians(proj.mean2d, proj.radius, proj.depth,
                              proj.valid, (H, W), capacity=CAP,
                              method="sort_norev")
    ids = np.asarray(bins.ids).astype(np.int32)
    assert (ids < 0).any() and (ids >= 0).sum() > 500
    attrs = rng.normal(size=(N, 16)).astype(np.float32)
    g = rng.normal(size=ids.shape + (16,)).astype(np.float32)
    return attrs, ids, g


def test_gather_plain_matches_jax(table):
    attrs, ids, _ = table
    ref = np.asarray(jnp.asarray(attrs)[jnp.maximum(jnp.asarray(ids), 0)])
    out = tg.table_gather_plain(torch.from_numpy(attrs),
                                torch.from_numpy(ids))
    np.testing.assert_array_equal(out.numpy(), ref)
    # the CPU wrapper is the plain version
    np.testing.assert_array_equal(
        tg.table_gather(torch.from_numpy(attrs), torch.from_numpy(ids)), ref)


@pytest.mark.parametrize("jax_vjp", ["index", "gather_rows_mm"])
def test_scatter_plain_matches_jax_vjp(table, jax_vjp):
    attrs, ids, g = table
    live = ids >= 0
    g0 = np.where(live[..., None], g, 0.0).astype(np.float32)
    safe = jnp.maximum(jnp.asarray(ids), 0)
    fn = ((lambda a: a[safe]) if jax_vjp == "index"
          else (lambda a: _gather_rows_mm(a, safe)))
    _, vjp = jax.vjp(fn, jnp.asarray(attrs))
    ref = np.asarray(vjp(jnp.asarray(g0))[0])
    out = tg.table_scatter_add_plain(torch.from_numpy(g0),
                                     torch.from_numpy(ids), N).numpy()
    np.testing.assert_allclose(out, ref, atol=BWD_ATOL[jax_vjp], rtol=0)
    # nonzero empty-slot cotangents: skipped by the port, added to row 0 by
    # the clamped JAX gather; everything else is unchanged
    out_g = tg.table_scatter_add_plain(torch.from_numpy(g),
                                       torch.from_numpy(ids), N).numpy()
    np.testing.assert_array_equal(out_g, out)
    ref_g = np.asarray(jax.vjp(lambda a: a[safe], jnp.asarray(attrs))[1](
        jnp.asarray(g))[0])
    np.testing.assert_allclose(ref_g[1:], out[1:], atol=BWD_ATOL["index"],
                               rtol=0)
    np.testing.assert_allclose(ref_g[0] - out[0], g[~live].sum(0),
                               atol=1e-3, rtol=0)


def test_gather_table_autograd(table):
    """gather_table's backward is the masked scatter-add."""
    attrs, ids, g = table
    a = torch.from_numpy(attrs).requires_grad_(True)
    out = tr.gather_table(a, torch.from_numpy(ids).long())
    assert out.shape == ids.shape + (16,)
    (out * torch.from_numpy(g)).sum().backward()
    ref = tg.table_scatter_add_plain(torch.from_numpy(g),
                                     torch.from_numpy(ids), N)
    np.testing.assert_array_equal(a.grad.numpy(), ref.numpy())
