"""The backend slice: the port's on-the-fly correlation, scale
normalization, backend edge proposal, edge adoption, ``update_lowmem``
(network and oracle), ``Backend.dense_ba`` / ``loop_ba`` and the repaired
edge aging follow the JAX package's, on the scene of
``tests/test_tracking_integration.py`` (48x64, buffer 32, the DROID
weights of ``init_droid_params(PRNGKey(0))`` converted into the port's
DroidNet).

Tolerances, and why:
- ``alt_corr``: atol 1e-5 against both JAX forms (``_alt_corr_vol``, the
  default, and ``_alt_corr_gather``); the products sum 128 channels in
  another order.
- ``normalize``: 1e-6 (one mean, one division).
- edge lists, ages and depth masks: equal.
- after ``update_lowmem``, ``dense_ba`` and ``loop_ba``: poses and
  disparities within max-relative 1e-4 (max |port - JAX| over max |JAX|):
  the update operator's convolutions sum in another order (1e-4 on its
  outputs, see test_torch_tracking_ops.py) and the BA solves with its
  targets.
- adopted edge state: 1e-5 (copies of tensors that agree to 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildgs_slam_tpu.config import load_config
from wildgs_slam_tpu.models import droid_net as jdn
from wildgs_slam_tpu.ops import correlation as jcorr
from wildgs_slam_tpu.ops import lie as jlie
from wildgs_slam_tpu.slam import keyframe_store as jks
from wildgs_slam_tpu.slam.backend import Backend as JBackend
from wildgs_slam_tpu.slam.factor_graph import FactorGraph as JGraph
from wildgs_slam_tpu.slam.motion_filter import MotionFilter as JMF
from wildgs_slam_tpu.slam.state import SlamState as JState
from wildgs_slam_tpu_torch import convert
from wildgs_slam_tpu_torch.models import droid_net as tdn
from wildgs_slam_tpu_torch.ops import correlation as tcorr
from wildgs_slam_tpu_torch.slam import keyframe_store as tks
from wildgs_slam_tpu_torch.slam.backend import Backend as TBackend
from wildgs_slam_tpu_torch.slam.factor_graph import FactorGraph as TGraph
from wildgs_slam_tpu_torch.slam.motion_filter import MotionFilter as TMF
from wildgs_slam_tpu_torch.slam.state import SlamState as TState

torch.set_num_threads(1)
HT, WD = 48, 64
MAX_REL = 1e-4


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


def states(cfg):
    intr = np.array([40.0, 40.0, WD / 2, HT / 2])
    B = cfg["tracking"]["buffer"]
    return (JState.create(cfg, HT, WD, intr, buffer=B),
            TState.create(cfg, HT, WD, intr, buffer=B, device="cpu"))


def tracked(cfg, nets, n):
    """n keyframes through both motion filters (every frame a keyframe)."""
    params, model = nets
    js, ts = states(cfg)
    depth = lambda im: np.full((HT, WD), 2.0, np.float32)  # noqa: E731
    jm = JMF(js, params, thresh=-1.0, depth_fn=depth)
    jm.fused = False
    tm = TMF(ts, model, thresh=-1.0, depth_fn=depth)
    for t in range(n):
        jm.track(float(t), synth_image(t))
        tm.track(float(t), synth_image(t))
    assert js.counter == ts.counter == n
    return js, ts


def set_poses(js, ts, poses, disps=None):
    poses = np.array(poses, np.float32)
    n = len(poses)
    js.store = js.store._replace(poses=js.store.poses.at[:n].set(poses))
    ts.store.poses[:n] = torch.from_numpy(poses)
    if disps is not None:
        js.store = js.store._replace(disps=jnp.asarray(disps))
        ts.store.disps.copy_(torch.from_numpy(np.asarray(disps)))


def trajectory(n, step=0.02):
    xi = np.zeros((n, 6), np.float32)
    xi[:, 0] = step * np.arange(n)
    xi[:, 1] = 0.3 * step * np.sin(np.arange(n))
    xi[:, 4] = 0.5 * step * np.arange(n)
    return np.asarray(jlie.se3_exp(jnp.asarray(xi)))


def close(port, ref, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol,
                               rtol=rtol)


def max_rel(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    return float(np.abs(port - ref).max() / np.abs(ref).max())


def same_store(js, ts, n, tol=MAX_REL):
    assert max_rel(ts.store.poses[:n], js.store.poses[:n]) < tol
    assert max_rel(ts.store.disps[:n], js.store.disps[:n]) < tol


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["vol_onehot", "gather"])
def test_alt_corr(method):
    rng = np.random.RandomState(0)
    F, h, w = 5, 6, 8
    fmaps = rng.normal(size=(F, h, w, 128)).astype(np.float32)
    E = 11      # not a multiple of the 8-edge sub-chunk
    ii = rng.randint(0, F, E)
    jj = (ii + 1 + rng.randint(0, F - 1, E)) % F
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
    coords = (grid[None] + rng.uniform(-4, 4, (E, h, w, 2))).astype(
        np.float32)
    coords[0, 0, 0] = [40.0, -30.0]            # far out of bounds
    jp = jcorr.fmap_pyramid(jnp.asarray(fmaps))
    tp = tcorr.fmap_pyramid(torch.from_numpy(fmaps))
    for a, b in zip(tp, jp):
        close(a, b, 1e-6)
    ref = jcorr.alt_corr(jp, jnp.asarray(coords), jnp.asarray(ii),
                         jnp.asarray(jj), method=method)
    out = tcorr.alt_corr(tp, torch.from_numpy(coords), torch.from_numpy(ii),
                         torch.from_numpy(jj))
    assert out.shape == ref.shape == (E, h, w, 4 * 49)
    assert float(np.abs(np.asarray(ref)).max()) > 1.0
    close(out, ref, 1e-5)


def test_normalize(cfg):
    rng = np.random.RandomState(1)
    B, n = 32, 5
    js, ts = states(cfg)
    disps = rng.uniform(0.2, 1.5, (B, HT // 8, WD // 8)).astype(np.float32)
    set_poses(js, ts, trajectory(B, 0.1), disps)
    js.store = jks.normalize(js.store, n)
    tks.normalize(ts.store, n)
    close(ts.store.disps, js.store.disps, 1e-6)
    close(ts.store.poses, js.store.poses, 1e-6)
    assert abs(float(ts.store.disps[:n].mean()) - 1.0) < 1e-5


# ---------------------------------------------------------------------------
# edge proposal, adoption
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loop", [False, True])
def test_backend_proximity_factors(cfg, nets, loop):
    """A trajectory that comes back: frames 21+ apart see the same view,
    so the loop proposal has pairs to take."""
    params, model = nets
    js, ts = states(cfg)
    n = 28
    ang = 2 * np.pi * np.arange(n) / 24
    xi = np.zeros((n, 6), np.float32)
    xi[:, 0] = 0.15 * np.sin(ang)
    xi[:, 2] = 0.1 * (1 - np.cos(ang))
    disps = np.full((32, HT // 8, WD // 8), 0.5, np.float32)
    set_poses(js, ts, np.asarray(jlie.se3_exp(jnp.asarray(xi))), disps)
    js.counter = ts.counter = n
    b = cfg["tracking"]["backend"]
    jg = JGraph(js, params, corr_impl="alt", max_factors=200, pmax=32)
    tg = TGraph(ts, model, max_factors=200, corr_impl="alt")
    if loop:
        t0 = n - b["loop_window"]
        args = (0, n, b["loop_nms"], b["loop_radius"], b["loop_thresh"], 200,
                cfg["tracking"]["beta"], t0, True)
    else:
        args = (0, n, b["nms"], b["radius"], b["thresh"], 3 * 2 * n,
                cfg["tracking"]["beta"])
    nj = jg.add_backend_proximity_factors(*args)
    nt = tg.add_backend_proximity_factors(*args)
    assert nt == nj > 0
    np.testing.assert_array_equal(tg.ii, jg.ii)
    np.testing.assert_array_equal(tg.jj, jg.jj)
    if loop:
        assert ((tg.ii - tg.jj) > 20).any()
    assert tg.corr is None and jg.corr_pyr is None
    close(tg.target, np.asarray(jg.target)[:tg.E], 1e-4)


def test_adopt_then_clear(cfg, nets):
    params, model = nets
    js, ts = tracked(cfg, nets, 6)
    set_poses(js, ts, trajectory(6))
    jf = JGraph(js, params, max_factors=48, pmax=16)
    tf = TGraph(ts, model, max_factors=48)
    for g in (jf, tf):
        g.add_neighborhood_factors(0, 6, r=2)
        g.age[:] = np.arange(g.E) % 3
    jb = JGraph(js, params, corr_impl="alt", max_factors=200, pmax=32)
    tb = TGraph(ts, model, max_factors=200, corr_impl="alt")
    jb.adopt_edges(jf)
    tb.adopt_edges(tf)
    for name in ("ii", "jj", "age"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name))
        np.testing.assert_array_equal(getattr(tb, name), getattr(tf, name))
    E = tb.E
    for name in ("net", "inp", "target", "weight"):
        close(getattr(tb, name), np.asarray(getattr(jb, name))[:E], 1e-5)
        assert torch.equal(getattr(tb, name), getattr(tf, name))
    assert tb.corr is None
    # adopted edges are not proposed again
    for g in (jb, tb):
        g.add_factors(g.ii[:3], g.jj[:3])
        assert g.E == E
        g.clear_edges()
        assert g.E == 0 and len(g.age) == 0
    assert tb.net.shape[0] == 0 and tf.E == E


# ---------------------------------------------------------------------------
# update_lowmem, dense_ba, loop_ba
# ---------------------------------------------------------------------------

def backend_graphs(cfg, nets, js, ts, n):
    params, model = nets
    b = cfg["tracking"]["backend"]
    mf = (b["radius"] + 2) * 2 * n
    jg = JGraph(js, params, corr_impl="alt", max_factors=mf, pmax=32)
    tg = TGraph(ts, model, max_factors=mf, corr_impl="alt")
    for g in (jg, tg):
        g.add_backend_proximity_factors(0, n, b["nms"], b["radius"],
                                        b["thresh"], mf,
                                        cfg["tracking"]["beta"])
    np.testing.assert_array_equal(tg.ii, jg.ii)
    return jg, tg


def test_update_lowmem_network(cfg, nets):
    js, ts = tracked(cfg, nets, 8)
    set_poses(js, ts, trajectory(8))
    jg, tg = backend_graphs(cfg, nets, js, ts, 8)
    p0 = ts.store.poses[:8].clone()
    jg.update_lowmem(t0=1, t1=8, itrs=2, steps=1)
    tg.update_lowmem(t0=1, t1=8, itrs=2, steps=1)
    assert not torch.allclose(ts.store.poses[:8], p0)
    same_store(js, ts, 8)
    E = tg.E
    assert max_rel(tg.target, np.asarray(jg.target)[:E]) < MAX_REL
    assert max_rel(tg.weight, np.asarray(jg.weight)[:E]) < MAX_REL
    assert max_rel(tg.damping, jg.damping) < MAX_REL


def test_update_lowmem_oracle(cfg, nets):
    js, ts = tracked(cfg, nets, 8)
    for s in (js, ts):
        s.metric_depth_reg = False
    gt = np.array(trajectory(32, 0.03))
    jg, tg = backend_graphs(cfg, nets, js, ts, 8)
    jg.gt_injection = lambda store, counter: (
        jnp.asarray(gt), jnp.full(store.disps.shape, 0.5))
    tg.gt_injection = lambda store, counter: (
        torch.from_numpy(gt), torch.full(store.disps.shape, 0.5))
    # the ground-truth disparity pins the scale of the solution
    js.store = js.store._replace(disps=jnp.full(js.store.disps.shape, 0.5))
    ts.store.disps.fill_(0.5)
    jg.update_lowmem(t0=1, t1=8, steps=3)
    tg.update_lowmem(t0=1, t1=8, steps=3)
    same_store(js, ts, 8)
    err = np.abs(ts.store.poses[:8, :3].numpy() - gt[:8, :3]).max()
    assert err < 0.5 * np.abs(gt[:8, :3]).max()


def test_dense_ba(cfg, nets):
    js, ts = tracked(cfg, nets, 8)
    set_poses(js, ts, trajectory(8))
    params, model = nets
    jb, tb = JBackend(js, params, cfg), TBackend(ts, model, cfg)
    assert jb.dense_ba(steps=1) == tb.dense_ba(steps=1)
    same_store(js, ts, 8)
    np.testing.assert_array_equal(ts.store.valid_depth_mask[:8],
                                  js.store.valid_depth_mask[:8])


def test_loop_ba(cfg, nets):
    """24 keyframes, the last ones back where the first were: loop_ba finds
    pairs more than 20 frames apart and runs its BA."""
    params, model = nets
    n = 24
    js, ts = tracked(cfg, nets, n)
    ang = 2 * np.pi * np.arange(n) / 23
    xi = np.zeros((n, 6), np.float32)
    xi[:, 0] = 0.1 * np.sin(ang)
    xi[:, 4] = 0.05 * np.sin(ang)
    set_poses(js, ts, np.asarray(jlie.se3_exp(jnp.asarray(xi))))
    jf = JGraph(js, params, max_factors=48, pmax=16)
    tf = TGraph(ts, model, max_factors=48)
    for g in (jf, tf):
        g.add_neighborhood_factors(n - 6, n, r=2)
    jb, tb = JBackend(js, params, cfg), TBackend(ts, model, cfg)
    for b in (jb, tb):
        b.loop_window = 22
    out_j = jb.loop_ba(0, n, steps=1, local_graph=jf)
    out_t = tb.loop_ba(0, n, steps=1, local_graph=tf)
    assert out_t == out_j and out_t[1] > 0
    same_store(js, ts, n)


# ---------------------------------------------------------------------------
# edge aging under the early exit
# ---------------------------------------------------------------------------

def test_update_n_ages_by_steps_requested(cfg, nets):
    """With eps > 0 the network update stops after its first iteration;
    both graphs still age their edges by the 3 requested."""
    params, model = nets
    js, ts = tracked(cfg, nets, 6)
    set_poses(js, ts, trajectory(6))
    jg = JGraph(js, params, max_factors=48, pmax=16)
    tg = TGraph(ts, model, max_factors=48)
    for g in (jg, tg):
        g.add_neighborhood_factors(0, 6, r=2)
    n_j, _ = jg.update_n(3, None, None, use_inactive=True, eps=1e6)
    n_t, _ = tg.update_n(3, None, None, use_inactive=True, eps=1e6)
    assert int(n_j) == n_t == 1
    np.testing.assert_array_equal(tg.age, jg.age)
    assert (tg.age == 3).all()
    close(ts.store.poses[:6], js.store.poses[:6], 1e-5)
