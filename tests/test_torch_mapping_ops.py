"""The port's mapping-step pieces against the JAX package's, on the CPU:
SSIM, median pooling, resampling, the median helper, the losses, the
uncertainty MLP (weights converted across), the Gaussian map (Adam, extend,
densify with the JAX draws injected), seeding (JAX draws injected), the
view store and the k-NN scale init.

Tolerances, and why:
- Convolutions, resamples and losses: rtol/atol 1e-5 (float32; the two
  libraries sum convolution taps and means in different orders). Loss
  gradients: max-relative 1e-5.
- Medians, masks, ids, counts and alive masks: exact.
- Adam and densify updates: atol 1e-6 on parameters of size ~1.
- k-NN distances: rtol 1e-4 (|a|^2 + |b|^2 - 2ab cancels for near points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildgs_slam_tpu.models.uncertainty import UncertaintyMLP as JMLP
from wildgs_slam_tpu.ops import knn as jknn
from wildgs_slam_tpu.ops import ssim as jssim
from wildgs_slam_tpu.slam import gaussian_map as jgm
from wildgs_slam_tpu.slam import losses as jloss
from wildgs_slam_tpu.slam import pcd as jpcd
from wildgs_slam_tpu.slam import viewpoints as jvp
from wildgs_slam_tpu_torch import convert
from wildgs_slam_tpu_torch.models.uncertainty import UncertaintyMLP as TMLP
from wildgs_slam_tpu_torch.ops import knn as tknn
from wildgs_slam_tpu_torch.ops import ssim as tssim
from wildgs_slam_tpu_torch.slam import gaussian_map as tgm
from wildgs_slam_tpu_torch.slam import losses as tloss
from wildgs_slam_tpu_torch.slam import pcd as tpcd
from wildgs_slam_tpu_torch.slam import viewpoints as tvp

torch.set_num_threads(1)
H, W = 48, 64
SMALL = (27, 36)


def T(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def rand(*shape, seed=0):
    return np.random.RandomState(seed).uniform(size=shape).astype(np.float32)


def test_ssim_and_components():
    a, b = rand(H, W, 3, seed=1), rand(H, W, 3, seed=2)
    b = 0.7 * a + 0.3 * b
    np.testing.assert_allclose(float(tssim.ssim(T(a), T(b))),
                               float(jssim.ssim(a, b)), rtol=1e-5)
    for x, y in zip(tssim.ssim_components(T(a), T(b), window_size=7),
                    jssim.ssim_components(a, b, window_size=7)):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [3, 5])
def test_median_pool2d(k):
    x = rand(*SMALL, seed=k)
    np.testing.assert_array_equal(tssim.median_pool2d(T(x), k),
                                  jssim.median_pool2d(jnp.asarray(x), k))


@pytest.mark.parametrize("src,dst", [(SMALL, (H, W)), ((H, W), SMALL)])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_resample_both_directions(src, dst, mode):
    x = rand(*src, seed=5)
    t = getattr(tssim, f"resample_{mode}")(T(x), dst)
    j = getattr(jssim, f"resample_{mode}")(jnp.asarray(x), dst)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def test_median_helper_matches_jnp_median():
    cases = [np.array([1.0, 2.0, 3.0, 4.0]), np.array([3.0, 1.0, 2.0]),
             np.array([1.0, np.nan, 3.0, 4.0]), rand(7, 10, seed=6),
             rand(6, 12, seed=7)]
    for x in cases:
        x = x.astype(np.float32)
        np.testing.assert_array_equal(tssim.median(T(x)), jnp.median(x))
    x = rand(5, 8, seed=8)
    x[2, 3] = np.nan
    np.testing.assert_array_equal(tssim.median(T(x), dim=1),
                                  jnp.median(x, axis=1))
    assert float(tssim.median(T([1.0, 2.0, 3.0, 4.0]))) == 2.5


def test_grad_mask():
    img = rand(64, 64, 3, seed=9)
    np.testing.assert_array_equal(tloss.compute_grad_mask(T(img), 4.0),
                                  jloss.compute_grad_mask(img, 4.0))


def _loss_cfg():
    return dict(alpha=0.8, rgb_boundary_threshold=0.01, ssim_loss=True,
                lambda_dssim=0.2, uncertainty_params=dict(
                    ssim_window_size=7, ssim_median_filter_size=5,
                    uncer_depth_mult=0.2, opacity_th_for_uncer_loss=0.9,
                    ssim_mult=0.5, train_frac_fix=0.3))


@pytest.mark.parametrize("initialization", [True, False])
def test_mapping_loss_uncertainty(initialization):
    rng = np.random.RandomState(10)
    img = rand(H, W, 3, seed=11)
    gt = np.clip(img + 0.1 * rng.normal(size=img.shape), 0, 1).astype(
        np.float32)
    depth = (2 + rand(H, W, seed=12)).astype(np.float32)
    ref = (2 + rand(H, W, seed=13)).astype(np.float32)
    ref[:4] = 0.0
    sigma = (0.05 + rand(*SMALL, seed=14)).astype(np.float32)
    opac = (0.5 + 0.5 * rand(H, W, seed=15)).astype(np.float32)
    exp = np.array([0.05, -0.02], np.float32)
    cfg = _loss_cfg()

    def jf(img, depth, sigma, exp):
        lo = jloss.mapping_loss_uncertainty(
            img, depth, gt, ref, sigma, opac, exp[0], exp[1], 0.3, 0.3, cfg,
            initialization=initialization)
        return lo.total, lo
    (jt, jlo), jg = jax.value_and_grad(jf, argnums=(0, 1, 2, 3),
                                       has_aux=True)(img, depth, sigma, exp)
    xs = [T(v).requires_grad_(True) for v in (img, depth, sigma, exp)]
    tlo = tloss.mapping_loss_uncertainty(
        xs[0], xs[1], T(gt), T(ref), xs[2], T(opac), xs[3][0], xs[3][1], 0.3,
        0.3, cfg, initialization=initialization)
    tlo.total.backward()
    np.testing.assert_allclose(float(tlo.total.detach()), float(jt),
                               rtol=1e-5)
    np.testing.assert_allclose(tlo.uncer_loss.detach(), jlo.uncer_loss,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tlo.weights_pix, jlo.weights_pix, rtol=1e-5)
    for x, g in zip(xs, jg):
        if x.grad is None:  # exposure is unused at initialization
            assert not np.any(np.asarray(g))
        else:
            assert max_rel(x.grad, g) < 1e-5


def test_mapping_loss_rgbd_dino_reg_isotropic():
    img, gt = rand(H, W, 3, seed=16), rand(H, W, 3, seed=17)
    d, gd = rand(H, W, seed=18), rand(H, W, seed=19)
    args = (np.float32(0.1), np.float32(0.02))
    t = tloss.mapping_loss_rgbd(T(img), T(d), T(gt), T(gd), *map(T, args),
                                0.8, 0.01, True, 0.2)
    j = jloss.mapping_loss_rgbd(img, d, gt, gd, *args, 0.8, 0.01, True, 0.2)
    np.testing.assert_allclose(float(t), float(j), rtol=1e-5)

    feats = np.random.RandomState(20).normal(size=(300, 16)).astype(
        np.float32)
    feats[150:] = feats[:150] + 0.1 * feats[150:]
    u = rand(300, seed=21)
    np.testing.assert_allclose(
        float(tloss.dino_regularization_loss(T(u), T(feats))),
        float(jloss.dino_regularization_loss(u, feats)), rtol=1e-5)

    s = np.random.RandomState(22).normal(size=(100, 3)).astype(np.float32)
    alive = np.arange(100) % 3 > 0
    np.testing.assert_allclose(
        float(tloss.isotropic_loss(T(s), T(alive, torch.bool))),
        float(jloss.isotropic_loss(s, alive)), rtol=1e-6)


def test_uncertainty_mlp_converted_weights():
    fd = 384
    params = JMLP(in_dim=fd).init(jax.random.PRNGKey(1), jnp.zeros((1, fd)))
    mlp = TMLP(fd)
    mlp.load_state_dict(convert.uncertainty_params_from_jax(
        jax.tree.map(np.asarray, params)))
    x = np.random.RandomState(23).normal(size=SMALL + (fd,)).astype(
        np.float32)
    np.testing.assert_allclose(mlp(T(x)).detach(),
                               JMLP(in_dim=fd).apply(params, x), rtol=1e-5,
                               atol=1e-6)


def _np_map(m):
    """Numpy copy of a JAX GaussianMap in convert's layout."""
    def d(p):
        return {k: np.asarray(v) for k, v in p._asdict().items()}
    return dict(params=d(m.params), aux=d(m.aux), mu=d(m.adam.mu),
                nu=d(m.adam.nu), count=int(m.adam.count))


def _assert_maps_close(tm, jm, atol=1e-6):
    np.testing.assert_array_equal(tm.aux.alive, jm.aux.alive)
    np.testing.assert_array_equal(tm.aux.kf_id, jm.aux.kf_id)
    for name in tgm.PARAM_NAMES:
        for t, j in ((tm.params, jm.params), (tm.mu, jm.adam.mu),
                     (tm.nu, jm.adam.nu)):
            np.testing.assert_allclose(getattr(t, name),
                                       getattr(j, name), atol=atol,
                                       err_msg=name)
    assert tm.count == int(jm.adam.count)


def _seeded_map(C=256, n=150, seed=24):
    rng = np.random.RandomState(seed)
    jm = jgm.create(C)
    new = jgm.GaussianParams(
        xyz=rng.normal(size=(n, 3)).astype(np.float32),
        f_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
        f_rest=np.zeros((n, 0, 3), np.float32),
        opacity=rng.normal(size=(n, 1)).astype(np.float32),
        scaling=(np.log(0.01 + 0.1 * rng.uniform(size=(n, 3)))).astype(
            np.float32),
        rotation=rng.normal(size=(n, 4)).astype(np.float32))
    mask = rng.uniform(size=n) > 0.2
    return jm, new, mask


def test_gaussian_map_extend_adam_densify():
    jm, new, mask = _seeded_map()
    tm = tgm.create(256, device="cpu")
    jm, jd = jgm.extend(jm, jgm.GaussianParams(*map(jnp.asarray, new)),
                        jnp.asarray(mask), kf_id=3)
    td = tgm.extend(tm, tgm.GaussianParams(*map(T, new)), T(mask, torch.bool),
                    kf_id=3)
    assert td == int(jd)
    _assert_maps_close(tm, jm)

    rng = np.random.RandomState(25)
    lrs = dict(xyz=1e-3, f_dc=2.5e-3, f_rest=1.25e-4, opacity=0.05,
               scaling=6e-3, rotation=1e-3)
    jl = jgm.LearningRates(**{k: jnp.float32(v) for k, v in lrs.items()})
    for step in range(3):
        grads = [rng.normal(size=np.shape(p)).astype(np.float32)
                 for p in jm.params]
        radii = rng.randint(0, 5, size=256).astype(np.int32)
        m2d = rng.normal(size=(256, 2)).astype(np.float32) * 1e-3
        jm = jgm.add_densification_stats(jm, m2d, radii)
        tgm.add_densification_stats(tm, T(m2d), T(radii, torch.int32))
        jm = jgm.adam_step(jm, jgm.GaussianParams(*grads), jl)
        tgm.adam_step(tm, tgm.GaussianParams(*map(T, grads)), lrs)
    _assert_maps_close(tm, jm)
    np.testing.assert_allclose(tm.aux.xyz_grad_accum, jm.aux.xyz_grad_accum,
                               rtol=1e-6)

    # densify with the JAX draws injected: the same keys give the same
    # normals the JAX function draws internally
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    draws = np.stack([np.asarray(jax.random.normal(k, (256, 3)))
                      for k in (k1, k2)])
    jm2, jd2 = jgm.densify_and_prune(jm, key, 2e-4, 0.3, 6.0, 20.0, 0.01)
    td2 = tgm.densify_and_prune(tm, 2e-4, 0.3, 6.0, 20.0, 0.01,
                                draws=T(draws))
    assert td2 == int(jd2)
    assert int(jm2.aux.alive.sum()) != int(jm.aux.alive.sum())
    _assert_maps_close(tm, jm2, atol=1e-5)

    jm3 = jgm.reset_opacity_nonvisible(jm2, jnp.arange(256) % 2 == 0)
    tgm.reset_opacity_nonvisible(tm, torch.arange(256) % 2 == 0)
    _assert_maps_close(tm, jm3, atol=1e-5)
    jm4 = jgm.reset_opacity(jm3)
    tgm.reset_opacity(tm)
    _assert_maps_close(tm, jm4, atol=1e-5)

    # and the converted copy equals the JAX map
    _assert_maps_close(convert.gaussian_map_from_numpy(_np_map(jm4), "cpu"),
                       jm4, atol=0)


@pytest.mark.parametrize("holes", [False, True])
def test_seed_gaussians_injected_draws(holes):
    color = rand(H, W, 3, seed=26)
    depth = (1.5 + rand(H, W, seed=27)).astype(np.float32)
    if holes:
        depth[10:20, 5:30] = 0.0
    w2c = np.array([0.1, -0.05, 0.02, 0.0, 0.05, 0.0, 1.0], np.float32)
    w2c[3:] /= np.linalg.norm(w2c[3:])
    intr = np.array([55.0, 55.0, W / 2, H / 2], np.float32)
    key = jax.random.PRNGKey(3)
    jp, jv = jpcd.seed_gaussians_from_depth(key, color, depth, w2c, intr, 16,
                                            0.05, 0, False)
    draws = np.asarray(jax.random.uniform(key, (H * W,)))
    tp, tv = tpcd.seed_gaussians_from_depth(T(color), T(depth), T(w2c),
                                            T(intr), 16, 0.05, 0, False,
                                            draws=T(draws))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tp.xyz, jp.xyz, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tp.f_dc, jp.f_dc, rtol=1e-5, atol=1e-6)
    # log scales from k-NN distances: see the module docstring
    np.testing.assert_allclose(tp.scaling, jp.scaling, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tp.rotation, jp.rotation)
    np.testing.assert_array_equal(tp.opacity, jp.opacity)


def test_knn_dist2():
    pts = np.random.RandomState(28).normal(size=(200, 3)).astype(np.float32)
    valid = np.arange(200) % 7 > 0
    np.testing.assert_allclose(tknn.knn_dist2(T(pts), T(valid, torch.bool)),
                               jknn.knn_dist2(pts, valid), rtol=1e-4,
                               atol=1e-6)


def test_viewpoint_store():
    B, fh, fw, fd = 4, 3, 4, 8
    jv = jvp.create(B, H, W, (fh, fw), fd)
    tv = tvp.create(B, H, W, (fh, fw), fd, device="cpu")
    color = rand(H, W, 3, seed=29)
    depth = (1 + rand(H, W, seed=30)).astype(np.float32)
    feats = rand(fh, fw, fd, seed=31)
    w2c = np.array([0.1, 0, 0, 0, 0, 0, 1.0], np.float32)
    jv = jvp.set_view(jv, 2, color, depth, w2c, feats, edge_threshold=4.0)
    tvp.set_view(tv, 2, T(color), T(depth), T(w2c), T(feats),
                 edge_threshold=4.0)
    for step in range(3):
        g = np.array([0.3, -0.2 * step], np.float32)
        jv = jvp.exposure_adam_step(jv, 2, g)
        tvp.exposure_adam_step(tv, 2, T(g))
    jv = jvp.reset_exposure_adam(jv, 1)
    tvp.reset_exposure_adam(tv, 1)
    for name in jv._fields:
        np.testing.assert_allclose(
            getattr(tv, name).float(), np.asarray(getattr(jv, name),
                                                  np.float32),
            rtol=1e-6, atol=1e-7, err_msg=name)
    assert float(tv.depth_med[2]) == float(jnp.median(depth))
    back = convert.viewpoint_store_from_numpy(
        {k: np.asarray(v, np.float32) if k in ("colors", "features")
         else np.asarray(v) for k, v in jv._asdict().items()}, "cpu")
    np.testing.assert_array_equal(back.colors.float(),
                                  np.asarray(jv.colors, np.float32))
