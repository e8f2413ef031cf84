"""The tracking frontend slice as a whole: the port's keyframe store,
motion filter, factor graph and Frontend follow the JAX package's on the
scene of ``tests/test_tracking_integration.py`` (48x64, warmup 5,
``max_factors`` 48, window 8, no loop closure, the DROID weights of
``init_droid_params(PRNGKey(0))`` converted into the port's DroidNet).

Both packages store the correlation volumes in bfloat16. A float32 value
within rounding noise of a bfloat16 rounding boundary rounds differently
in the two, which moves that correlation feature by one bfloat16 ulp
(2^-8 relative) and the GRU state at that pixel by up to ~1e-3, and the
random-weight frontend amplifies such differences over its 24 updates. So
the tests that follow the packages through many updates store float32
volumes in both (the JAX graph's storage is created in float32 before its
first edge; the port's ``CORR_DTYPE`` is set to float32), and one test
holds the bfloat16 path through a single update.

Tolerances, and why: the update operator's convolutions sum in another
order (1e-4 on its outputs, see test_torch_tracking_ops.py), and BA solves
with those targets, so poses, disparities, targets and GRU states follow
JAX within 1e-4 absolute plus 1e-4 relative after initialization and two
frontend updates (the random-weight GRU drives translations to ~2 units
and targets are pixel coordinates up to ~10). With bfloat16 volumes, after
one update: poses and disparities 1e-5, targets 1e-3, GRU states 2e-3.
Keyframe counts, timestamps, edge lists and the depth-filter masks are
discrete and must be equal; the scene keeps them away from thresholds.
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildgs_slam_tpu.config import load_config
from wildgs_slam_tpu.models import droid_net as jdn
from wildgs_slam_tpu.models.uncertainty import init_uncertainty_mlp
from wildgs_slam_tpu.ops import lie as jlie
from wildgs_slam_tpu.slam import keyframe_store as jks
from wildgs_slam_tpu.slam.factor_graph import FactorGraph as JGraph
from wildgs_slam_tpu.slam.frontend import Frontend as JFrontend
from wildgs_slam_tpu.slam.motion_filter import MotionFilter as JMF
from wildgs_slam_tpu.slam.state import SlamState as JState
from wildgs_slam_tpu_torch import convert
from wildgs_slam_tpu_torch.models import droid_net as tdn
from wildgs_slam_tpu_torch.models.uncertainty import UncertaintyMLP
from wildgs_slam_tpu_torch.slam import keyframe_store as tks
from wildgs_slam_tpu_torch.slam import factor_graph as tfg
from wildgs_slam_tpu_torch.slam import system as tsys
from wildgs_slam_tpu_torch.slam.factor_graph import FactorGraph as TGraph
from wildgs_slam_tpu_torch.slam.frontend import Frontend as TFrontend
from wildgs_slam_tpu_torch.slam.motion_filter import MotionFilter as TMF
from wildgs_slam_tpu_torch.slam.state import SlamState as TState

torch.set_num_threads(1)
HT, WD = 48, 64
ATOL = 1e-4
RTOL = 1e-4


@pytest.fixture(scope="module")
def cfg():
    c = load_config("configs/wildgs_slam.yaml")
    c["tracking"]["buffer"] = 32
    c["tracking"]["warmup"] = 5
    c["tracking"]["frontend"]["window"] = 8
    c["tracking"]["frontend"]["max_factors"] = 48
    c["tracking"]["frontend"]["enable_loop"] = False
    return c


@pytest.fixture(scope="module")
def nets():
    params = jdn.init_droid_params(jax.random.PRNGKey(0), HT, WD)
    model = tdn.DroidNet()
    model.load_state_dict(convert.droid_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return params, model.eval()


def synth_image(t):
    y, x = np.meshgrid(np.arange(HT), np.arange(WD), indexing="ij")
    img = np.stack([0.5 + 0.5 * np.sin(0.2 * (x - 3 * t)),
                    0.5 + 0.5 * np.cos(0.15 * (y + 2 * t)),
                    0.5 + 0.4 * np.sin(0.1 * (x + y - t))], -1)
    return np.clip(img, 0, 1).astype(np.float32)


def depth_fn(im):
    return np.full((HT, WD), 2.0, np.float32)


def feat_fn(im):
    """Per-image seeded DINO features (both packages see the same)."""
    seed = int(im.sum() * 1000) % (2 ** 31)
    return np.random.RandomState(seed).rand(HT // 14, WD // 14, 384).astype(
        np.float32)


def states(cfg):
    intr = np.array([40.0, 40.0, WD / 2, HT / 2])
    B = cfg["tracking"]["buffer"]
    return (JState.create(cfg, HT, WD, intr, buffer=B),
            TState.create(cfg, HT, WD, intr, buffer=B, device="cpu"))


def close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol,
                               rtol=rtol)


@contextlib.contextmanager
def f32_volumes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfg, "CORR_DTYPE", torch.float32)
        yield


def f32_storage(jg):
    """Create the JAX graph's correlation storage in float32 (its writes
    cast to the storage's type)."""
    jg.corr_pyr = [jnp.zeros((jg.cap, jg.h * jg.w, jg.h // 2 ** k,
                              jg.w // 2 ** k), jnp.float32)
                   for k in range(4)]


def track_both(cfg, nets, n, thresh, force=-1, feats=None):
    params, model = nets
    js, ts = states(cfg)
    jm = JMF(js, params, thresh=thresh, force_keyframe_every_n_frames=force,
             depth_fn=depth_fn, feat_fn=feats)
    jm.fused = False
    tm = TMF(ts, model, thresh=thresh, force_keyframe_every_n_frames=force,
             depth_fn=depth_fn, feat_fn=feats)
    for t in range(n):
        assert jm.track(float(t), synth_image(t)) == tm.track(
            float(t), synth_image(t))
    return js, ts


# ---------------------------------------------------------------------------
# motion filter and keyframe store
# ---------------------------------------------------------------------------

def test_motion_filter_appends(cfg, nets):
    js, ts = track_both(cfg, nets, 7, thresh=0.05, force=4)
    assert ts.counter == js.counter >= 3
    n = ts.counter
    jst, tst = js.store, ts.store
    np.testing.assert_array_equal(tst.timestamp[:n], jst.timestamp[:n])
    for name in ("fmaps", "nets", "inps", "mono_disps", "mono_disps_up",
                 "poses", "disps"):
        close(getattr(tst, name)[:n], getattr(jst, name)[:n])


def test_keyframe_store_filters(cfg, nets):
    """Depth-mask filter, mono-depth vote, uncertainty weights and keyframe
    removal on a moved store."""
    js, ts = track_both(cfg, nets, 6, thresh=-1.0, feats=feat_fn)
    rng = np.random.RandomState(0)
    xi = np.zeros((6, 6), np.float32)
    xi[:, 0] = 0.03 * np.arange(6)
    xi[:, 1] = 0.002 * np.arange(6)   # keeps row 0 off the image border
    poses = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    # a fronto-parallel plane with 20% outliers, and a mono depth off by
    # 10% on a quarter of the pixels: every comparison is far from its
    # threshold
    dup = np.where(rng.uniform(size=(6, HT, WD)) < 0.2, 0.8, 0.5).astype(
        np.float32)
    mono = np.where(rng.uniform(size=(6, HT, WD)) < 0.25, 2.2, 2.0).astype(
        np.float32)
    js.store = js.store._replace(
        poses=js.store.poses.at[:6].set(poses),
        disps_up=js.store.disps_up.at[:6].set(dup),
        mono_disps_up=js.store.mono_disps_up.at[:6].set(1 / mono))
    ts.store.poses[:6] = torch.from_numpy(poses)
    ts.store.disps_up[:6] = torch.from_numpy(dup)
    ts.store.mono_disps_up[:6] = torch.from_numpy(1 / mono)

    js.store = jks.update_valid_depth_mask(js.store, 6, 0.01, 2,
                                           frames=np.arange(1, 6))
    tks.update_valid_depth_mask(ts.store, 6, 0.01, 2, frames=np.arange(1, 6))
    vm = np.asarray(js.store.valid_depth_mask)
    assert 0.05 < vm[1:6].mean() < 0.95
    np.testing.assert_array_equal(ts.store.valid_depth_mask, vm)
    np.testing.assert_array_equal(ts.store.dirty, js.store.dirty)

    def up(f):
        return jax.image.resize(jnp.asarray(f), (HT, WD, f.shape[-1]),
                                "bilinear")
    fi = up(js.dino_feats[4])
    fr = jnp.stack([up(js.dino_feats[j]) for j in (2, 3, 5)])
    fr = fr.at[0].set(fi)          # one reference whose features match
    js.store = jks.filter_high_err_mono_depth(js.store, 4, [2, 3, 5], fi, fr)
    tks.filter_high_err_mono_depth(ts.store, 4, [2, 3, 5],
                                   torch.from_numpy(np.asarray(fi)),
                                   torch.from_numpy(np.asarray(fr)))
    mm = np.asarray(js.store.mono_mask_up)
    assert not mm[4].all()
    np.testing.assert_array_equal(ts.store.mono_mask_up, mm)
    # the port's bilinear resize is jax.image.resize's
    close(tks.resize_bilinear(torch.from_numpy(js.dino_feats[4][None]),
                              (HT, WD))[0], up(js.dino_feats[4]), 1e-5, 0)

    mlp, mlp_params = init_uncertainty_mlp(jax.random.PRNGKey(1))
    tmlp = UncertaintyMLP()
    tmlp.load_state_dict(convert.uncertainty_params_from_jax(
        jax.tree.map(np.asarray, mlp_params)))
    js.store = jks.update_uncertainties(
        js.store, lambda f: mlp.apply(mlp_params, f),
        jnp.asarray(js.dino_feats[:6]), jnp.arange(6), train_frac_fix=0.3)
    tsys.uncertainty_update(ts, tmlp, 0.3)
    inv = np.asarray(js.store.uncertainties_inv)
    assert not np.allclose(inv[:6], 1.0)
    close(ts.store.uncertainties_inv, inv, 1e-5, 0)

    js.store = jks.remove_keyframe(js.store, 2)
    tks.remove_keyframe(ts.store, 2)
    for name in tks.PER_FRAME:
        close(getattr(ts.store, name), getattr(js.store, name))


# ---------------------------------------------------------------------------
# factor graph
# ---------------------------------------------------------------------------

def test_factor_graph_lifecycle(cfg, nets):
    with f32_volumes():
        _factor_graph_lifecycle(cfg, nets)


def _factor_graph_lifecycle(cfg, nets):
    params, model = nets
    js, ts = track_both(cfg, nets, 6, thresh=-1.0)
    jg = JGraph(js, params, max_factors=48, pmax=16)
    f32_storage(jg)
    tg = TGraph(ts, model, max_factors=48)
    for g in (jg, tg):
        g.add_neighborhood_factors(0, 6, r=2)
        n0 = len(g.ii)
        g.add_factors([0], [1])         # a duplicate: filtered
        assert len(g.ii) == n0
    np.testing.assert_array_equal(tg.ii, jg.ii)
    np.testing.assert_array_equal(tg.jj, jg.jj)
    E = tg.E
    close(tg.target, np.asarray(jg.target)[:E], 1e-5, 0)

    jg.update(1, use_inactive=True)
    tg.update(1, use_inactive=True)
    close(ts.store.poses, js.store.poses)
    close(ts.store.disps, js.store.disps)
    close(ts.store.disps_up[:6], js.store.disps_up[:6])
    close(tg.target, np.asarray(jg.target)[:E])
    close(tg.weight, np.asarray(jg.weight)[:E])
    close(tg.net, np.asarray(jg.net)[:E])
    close(tg.damping, jg.damping)
    np.testing.assert_array_equal(tg.age, jg.age)

    mask = np.zeros(E, bool)
    mask[:4] = True
    for g in (jg, tg):
        g.rm_factors(mask, store=True)
    close(tg.target_inac, np.asarray(jg.target_inac)[:4])
    close(tg.target, np.asarray(jg.target)[:E - 4])
    for g in (jg, tg):
        g.rm_keyframe(3)
    for name in ("ii", "jj", "ii_inac", "jj_inac", "age"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name))
    close(ts.store.poses, js.store.poses)
    close(tg.net, np.asarray(jg.net)[:tg.E])
    # an update with inactive edges in the BA
    jg.update(1, use_inactive=True)
    tg.update(1, use_inactive=True)
    close(ts.store.poses, js.store.poses)
    close(ts.store.disps, js.store.disps)


def test_update_bf16_volumes(cfg, nets):
    """The production storage: bfloat16 volumes in both packages."""
    params, model = nets
    js, ts = track_both(cfg, nets, 6, thresh=-1.0)
    jg = JGraph(js, params, max_factors=48, pmax=16)
    tg = TGraph(ts, model, max_factors=48)
    for g in (jg, tg):
        g.add_neighborhood_factors(0, 6, r=2)
        g.update(1, use_inactive=True)
    assert tg.corr.dtype == torch.bfloat16
    E = tg.E
    close(ts.store.poses, js.store.poses, 1e-5, 0)
    close(ts.store.disps, js.store.disps, 1e-5, 0)
    close(tg.target, np.asarray(jg.target)[:E], 1e-3, 0)
    close(tg.net, np.asarray(jg.net)[:E], 2e-3, 0)


def test_oracle_update_n(cfg, nets):
    """gt_injection: ground-truth targets, the real BA. Both packages move
    the poses to the ground truth the same way."""
    params, model = nets
    c = copy.deepcopy(cfg)
    js, ts = track_both(c, nets, 6, thresh=-1.0)
    for s in (js, ts):
        s.metric_depth_reg = False
        s.uncertainty_aware = False
    # the ground-truth disparity pins the scale of the solution
    js.store = js.store._replace(disps=jnp.full(js.store.disps.shape, 0.5))
    ts.store.disps.fill_(0.5)
    xi = np.zeros((32, 6), np.float32)
    xi[:, 0] = 0.04 * np.arange(32)
    xi[:, 4] = 0.01 * np.arange(32)
    gt = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    jg = JGraph(js, params, max_factors=48, pmax=16)
    tg = TGraph(ts, model, max_factors=48)
    jg.gt_injection = lambda store, counter: (
        jnp.asarray(gt), jnp.full(store.disps.shape, 0.5))
    tg.gt_injection = lambda store, counter: (
        torch.from_numpy(gt), torch.full(store.disps.shape, 0.5))
    for g in (jg, tg):
        g.add_neighborhood_factors(0, 6, r=3)
        g.update_n(4, 1, use_inactive=True)
    close(ts.store.poses, js.store.poses, 1e-5, 0)
    close(ts.store.disps, js.store.disps)
    close(ts.store.disps_up[:6], js.store.disps_up[:6])
    np.testing.assert_array_equal(tg.age, jg.age)
    # the ground-truth targets pull the poses towards the ground truth
    # (frame 0 is the gauge; the LM damping of a 6x8 image slows the steps)
    err = np.abs(ts.store.poses[:6, :3].numpy() - gt[:6, :3]).max()
    assert err < 0.75 * np.abs(gt[:6, :3]).max()


# ---------------------------------------------------------------------------
# the frontend: initialization and two updates
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frontends(cfg, nets):
    params, model = nets
    js, ts = states(cfg)
    jm = JMF(js, params, thresh=-1.0, depth_fn=depth_fn, feat_fn=feat_fn)
    jm.fused = False
    tm = TMF(ts, model, thresh=-1.0, depth_fn=depth_fn, feat_fn=feat_fn)
    jf = JFrontend(js, params, cfg)
    f32_storage(jf.graph)
    tf = TFrontend(ts, model, cfg)
    log = []
    with f32_volumes():
        for t in range(cfg["tracking"]["warmup"] + 2):
            for mf, fe in ((jm, jf), (tm, tf)):
                mf.track(float(t), synth_image(t))
                fe(False)
            log.append((js.counter, ts.counter, jf.t1, tf.t1))
    return jf, tf, log


def test_frontend_follows_jax(frontends):
    jf, tf, log = frontends
    assert tf.is_initialized and jf.is_initialized
    assert tf.n_updates == 2
    for jc, tc, jt1, tt1 in log:
        assert (jc, jt1) == (tc, tt1)
    js, ts = jf.state, tf.state
    n = ts.counter
    for name in ("ii", "jj", "ii_inac", "jj_inac", "age"):
        np.testing.assert_array_equal(getattr(tf.graph, name),
                                      getattr(jf.graph, name))
    np.testing.assert_array_equal(ts.store.timestamp[:n + 1],
                                  js.store.timestamp[:n + 1])
    close(ts.store.poses[:n + 1], js.store.poses[:n + 1])
    close(ts.store.disps[:n + 1], js.store.disps[:n + 1])
    close(ts.store.disps_up[:n], js.store.disps_up[:n])
    E = tf.graph.E
    close(tf.graph.target, np.asarray(jf.graph.target)[:E])
    close(tf.graph.net, np.asarray(jf.graph.net)[:E])
    np.testing.assert_array_equal(ts.store.valid_depth_mask[:n],
                                  js.store.valid_depth_mask[:n])
    np.testing.assert_array_equal(ts.store.mono_mask_up[:n],
                                  js.store.mono_mask_up[:n])
    assert np.all(np.isfinite(ts.store.poses.numpy()))
