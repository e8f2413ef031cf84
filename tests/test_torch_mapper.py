"""The slice as a whole: the port's Mapper follows the JAX Mapper through
``initialize_mapper`` and one ``on_keyframe`` on the same small scene.

Both packages get the same numpy scene (48x64, 4 keyframes, capacity 2048,
list capacity 128), the same uncertainty-MLP weights (converted from the
flax tree), the same view schedule (both draw it from
``np.random.RandomState(0)``) and the same random draws for seeding and
densification (the port's ``draw_fn`` replays the JAX key chain). The run
crosses init densify boundaries, the init opacity reset, an online densify
and a BA pose update that deforms one keyframe's Gaussians rigidly.

Tolerances, and why: both render through the plain all-tiles composite on
the CPU and the first two steps' losses agree to rtol 1e-5. But Adam
normalizes each gradient by its own running magnitude, so float32 noise in
near-zero gradients (a freshly seeded Gaussian is isotropic, and its
rotation gradient is pure noise) becomes an update of a whole learning rate
in either direction. Over the 25 steps that bounds the drift at 25 x lr
(2.5e-2 for quaternions and xyz, 0.15 for log-scales). Measured here: per-
step losses within 1.5e-3 relative (tolerance 3e-3); parameter differences
(max / 99th percentile) below xyz 2e-2 / 2e-3, colour 2e-3 / 2e-4, opacity
3e-3 / 1e-3, log-scale 3e-2 / 2e-2, quaternion 5e-2 / 3e-2; rendered
colours within 1e-3 mean and 2e-2 max. Window, keyframe flags, iteration
counts and the alive mask: exact.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildgs_slam_tpu.config import load_config
from wildgs_slam_tpu.models.uncertainty import UncertaintyMLP as JMLP
from wildgs_slam_tpu.ops import lie as jlie
from wildgs_slam_tpu.slam import keyframe_store as jks
from wildgs_slam_tpu.slam import mapper as jmapper
from wildgs_slam_tpu.slam.state import SlamState as JState
from wildgs_slam_tpu_torch import convert
from wildgs_slam_tpu_torch.config import load_config as tload_config
from wildgs_slam_tpu_torch.models.uncertainty import UncertaintyMLP as TMLP
from wildgs_slam_tpu_torch.ops import rasterizer as tr
from wildgs_slam_tpu_torch.slam import gaussian_map as tgm
from wildgs_slam_tpu_torch.slam import keyframe_store as tks
from wildgs_slam_tpu_torch.slam.mapper import Mapper as TMapper
from wildgs_slam_tpu_torch.slam.state import SlamState as TState

torch.set_num_threads(1)
H, W = 48, 64
N_KF = 4
CFG_PATH = "configs/Dynamic/TUM_RGBD/tum_dynamic.yaml"


def small_cfg(cfg):
    cfg = copy.deepcopy(cfg)
    tr = cfg["mapping"]["Training"]
    tr.update(init_itr_num=16, init_gaussian_update=8, init_gaussian_reset=12,
              mapping_itr_num=8, gaussian_update_every=20,
              gaussian_update_offset=4, gaussian_th=0.005, window_size=3)
    cfg["mapping"]["gaussian_capacity"] = 2048
    cfg["mapping"]["render_list_capacity"] = 128
    cfg["tracking"]["buffer"] = 6
    return cfg


def scene():
    """A textured slanted wall seen from 4 poses; metric depth is exact."""
    rng = np.random.RandomState(0)
    fx = 55.0
    intr = np.array([fx, fx, W / 2, H / 2]) * 8 / 8
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    frames = []
    for i in range(N_KF):
        xi = np.array([0.04 * i, 0.01 * i, 0.0, 0.0, 0.02 * i, 0.0])
        pose = np.asarray(jlie.se3_exp(jnp.asarray(xi, jnp.float32)))
        depth = (2.0 + 0.01 * xx + 0.004 * yy
                 + 0.05 * np.sin(0.2 * xx + i)).astype(np.float32)
        img = np.stack([0.5 + 0.4 * np.sin(0.3 * xx + 0.5 * i),
                        0.5 + 0.4 * np.cos(0.25 * yy),
                        0.5 + 0.3 * np.sin(0.2 * (xx + yy))], -1)
        img = np.clip(img + 0.02 * rng.normal(size=img.shape), 0, 1)
        dino = rng.normal(size=(H // 14, W // 14, 384))
        frames.append((pose.astype(np.float32), depth,
                       img.astype(np.float32), dino.astype(np.float32)))
    return intr.astype(np.float32), frames


class JaxDraws:
    """Replays the JAX Mapper's key chain: one split per seeding or
    densification, then the draws its jitted function makes from the key."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, kind, shape):
        self.key, k = jax.random.split(self.key)
        if kind == "seed":
            return np.array(jax.random.uniform(k, shape))
        return np.stack([np.asarray(jax.random.normal(kk, shape[1:]))
                         for kk in jax.random.split(k)])


@pytest.fixture(scope="module")
def runs(monkeypatch_module):
    cfg = small_cfg(load_config(CFG_PATH))
    assert cfg == small_cfg(tload_config(CFG_PATH))
    intr, frames = scene()
    B = cfg["tracking"]["buffer"]
    js = JState.create(cfg, H, W, intr, buffer=B)
    ts = TState.create(cfg, H, W, intr, buffer=B, device="cpu")
    for i, (pose, depth, img, dino) in enumerate(frames):
        js.store = jks.append(js.store, i, float(i), pose=jnp.asarray(pose),
                              mono_depth_up=jnp.asarray(depth))
        tks.append(ts.store, i, float(i), pose=torch.as_tensor(pose),
                   mono_depth_up=torch.as_tensor(depth))
        js.append_host(i, img, dino, float(i))
        ts.append_host(i, img, dino, float(i))

    params = JMLP(in_dim=384).init(jax.random.PRNGKey(1), jnp.zeros((1, 384)))
    mlp = TMLP(384)
    mlp.load_state_dict(convert.uncertainty_params_from_jax(
        jax.tree.map(np.asarray, params)))

    j_losses = []
    orig = jmapper.Mapper._opt_steps_one

    def recording(self, K, *a, **k):
        ls = orig(self, K, *a, **k)
        j_losses.extend(np.asarray(ls)[:K].tolist())
        return ls
    monkeypatch_module.setattr(jmapper.Mapper, "_opt_steps_one", recording)

    jm = jmapper.Mapper(js, cfg, uncer_params=params, rng_seed=0)
    tm = TMapper(ts, cfg, uncer_mlp=mlp, rng_seed=0, device="cpu",
                 draw_fn=JaxDraws(0))
    jm.initialize_mapper(N_KF - 2)
    tm.initialize_mapper(N_KF - 2)
    init_alive = (np.asarray(jm.gaussians.aux.alive).copy(),
                  tm.gaussians.aux.alive.clone())

    # a BA update moves keyframe 1: its Gaussians deform rigidly
    moved = np.asarray(jlie.se3_retr(
        js.store.poses[1], jnp.asarray([0.01, -0.02, 0.0, 0.0, 0.01, 0.0],
                                       jnp.float32)))
    js.store = js.store._replace(poses=js.store.poses.at[1].set(moved))
    ts.store.poses[1] = torch.from_numpy(moved.copy())

    jm.on_keyframe(N_KF - 1, N_KF - 1)
    tm.on_keyframe(N_KF - 1, N_KF - 1)
    return jm, tm, j_losses, init_alive


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_schedule_and_window(runs):
    jm, tm, j_losses, init_alive = runs
    assert tm.iteration_count == jm.iteration_count == 16 + 8 + 1
    assert len(tm.step_losses) == len(j_losses) == tm.iteration_count
    assert tm.current_window == jm.current_window
    assert tm.is_kf == jm.is_kf
    assert tm.video_idxs == jm.video_idxs
    assert tm.overflow_events == jm.overflow_events
    np.testing.assert_array_equal(init_alive[1], init_alive[0])
    # the JAX store converts into the port's: same poses and depths
    kf = convert.keyframe_store_from_numpy(
        {k: np.asarray(v) for k, v in jm.state.store._asdict().items()},
        "cpu")
    for name in ("poses", "mono_disps_up", "intrinsics", "timestamp"):
        np.testing.assert_array_equal(getattr(kf, name),
                                      getattr(tm.state.store, name))


def test_per_step_losses(runs):
    jm, tm, j_losses, _ = runs
    # the first steps agree to float32 noise; Adam then amplifies it
    np.testing.assert_allclose(tm.step_losses[:2], j_losses[:2], rtol=1e-5)
    np.testing.assert_allclose(tm.step_losses, j_losses, rtol=3e-3)
    assert min(tm.step_losses[:12]) < tm.step_losses[0]


def test_final_state(runs):
    jm, tm, _, _ = runs
    jg, tg = jm.gaussians, tm.gaussians
    alive = np.asarray(jg.aux.alive)
    np.testing.assert_array_equal(tg.aux.alive, alive)
    np.testing.assert_array_equal(tg.aux.kf_id, jg.aux.kf_id)
    assert tgm.num_alive(tg) > 500
    assert tg.count == int(jg.adam.count)
    # (max, 99th percentile) of |port - JAX| over the alive slots
    tol = dict(xyz=(2e-2, 2e-3), f_dc=(2e-3, 2e-4), opacity=(3e-3, 1e-3),
               scaling=(3e-2, 2e-2), rotation=(5e-2, 3e-2))
    for name, (t_max, t_q99) in tol.items():
        d = np.abs(getattr(tg.params, name).detach().numpy()[alive]
                   - np.asarray(getattr(jg.params, name))[alive])
        assert d.max() < t_max, (name, d.max())
        assert np.quantile(d, 0.99) < t_q99, (name, np.quantile(d, 0.99))
    np.testing.assert_allclose(tm.vstore.w2c, jm.vstore.w2c, atol=1e-6)
    np.testing.assert_allclose(tm.vstore.exposure, jm.vstore.exposure,
                               atol=2e-3)
    np.testing.assert_allclose(tm.vstore.depth_med, jm.vstore.depth_med)
    sd = convert.uncertainty_params_from_jax(
        jax.tree.map(np.asarray, jm.uncer_params))
    for k, v in tm.uncer_mlp.state_dict().items():
        np.testing.assert_allclose(v, sd[k], atol=2e-3, err_msg=k)


def test_final_renders(runs):
    """What the maps render agrees far closer than the raw parameters: the
    parameters that differ most are those the image barely depends on."""
    jm, tm, _, _ = runs
    for v in range(N_KF):
        jo = jmapper._render_view(
            jm.gaussians.params, jm.gaussians.aux.alive, jm.vstore.w2c[v],
            jm.intrinsics_full, (H, W), 128, 64, bin_method="sort_norev")
        p = tm.gaussians.params
        with torch.no_grad():
            to = tr.render(p.xyz, tgm.get_scaling(p), tgm.get_rotation_xyzw(p),
                           tgm.get_opacity(p), tgm.get_sh(p), tm.vstore.w2c[v],
                           tm.intrinsics_full, (H, W),
                           alive=tm.gaussians.aux.alive, capacity=128)
        d = np.abs(to.color.numpy() - np.asarray(jo.color))
        assert d.mean() < 1e-3 and d.max() < 2e-2, (v, d.mean(), d.max())
