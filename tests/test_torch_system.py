"""The system slice: the tracking loss, non-keyframe pose refinement, the
trajectory filler, trajectory evaluation, PLY export, the ``droid.pth``
loader, and the port's ``SLAM.run()`` as a whole, each held against the
JAX package on the same inputs (numpy, seeded).

Tolerances, and why:
- ``tracking_loss_rgb``: 1e-6 (elementwise, one mean).
- the refinement (20 Adam steps, plain render on both sides): w2c 1e-4;
  the render's sums run in another order and Adam normalizes each step.
- the trajectory filler (12 motion-only updates of the random-weight
  update operator): poses 1e-4; float32 volumes on both sides, as in
  test_torch_frontend.py, because a bfloat16 rounding that falls the other
  way moves a GRU state by ~1e-3.
- ``eval_traj``: 1e-9 (float64 numpy on both sides); files equal.
- ``save_ply``: byte-equal; ``load_ply`` returns what was written.
- the ``droid.pth`` loader: weights equal after conversion.
- ``SLAM.run()`` on an oracle scene (ground-truth targets in place of the
  update operator, as tests/test_integrated_ate.py): keyframe timestamps
  equal, keyframe poses 1e-5 (the BA converges on the same targets), both
  keyframe ATEs < 1 cm, the output files written. The JAX package runs its
  eager BA iteration through ``jax.jit`` here (a test-side wrapper of the
  same function; the package is unchanged): eagerly its per-call scan
  compile made this run take minutes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildgs_slam_tpu.config import load_config
from wildgs_slam_tpu.models import droid_net as jdn
from wildgs_slam_tpu.models.uncertainty import UncertaintyMLP as JMLP
from wildgs_slam_tpu.ops import lie as jlie
from wildgs_slam_tpu.slam import gaussian_map as jgm
from wildgs_slam_tpu.slam import losses as jlosses
from wildgs_slam_tpu.slam import mapper as jmapper
from wildgs_slam_tpu.slam import trajectory_filler as jtf
from wildgs_slam_tpu.slam.motion_filter import MotionFilter as JMF
from wildgs_slam_tpu.slam.state import SlamState as JState
from wildgs_slam_tpu.utils import eval_traj as jev
from wildgs_slam_tpu_torch import convert
from wildgs_slam_tpu_torch.config import load_config as tload_config
from wildgs_slam_tpu_torch.models import droid_net as tdn
from wildgs_slam_tpu_torch.models.uncertainty import UncertaintyMLP as TMLP
from wildgs_slam_tpu_torch.ops import lie as tlie
from wildgs_slam_tpu_torch.ops import rasterizer as tr
from wildgs_slam_tpu_torch.slam import factor_graph as tfg
from wildgs_slam_tpu_torch.slam import gaussian_map as tgm
from wildgs_slam_tpu_torch.slam import keyframe_store as tks
from wildgs_slam_tpu_torch.slam import losses as tlosses
from wildgs_slam_tpu_torch.slam.mapper import Mapper as TMapper
from wildgs_slam_tpu_torch.slam.motion_filter import MotionFilter as TMF
from wildgs_slam_tpu_torch.slam.state import SlamState as TState
from wildgs_slam_tpu_torch.slam.trajectory_filler import (
    PoseTrajectoryFiller as TFiller)
from wildgs_slam_tpu_torch.utils import eval_traj as tev

torch.set_num_threads(1)
CFG_PATH = "configs/Dynamic/TUM_RGBD/tum_dynamic.yaml"


def close(port, ref, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol,
                               rtol=rtol)


def jax_mlp(seed=1):
    params = JMLP(in_dim=384).init(jax.random.PRNGKey(seed),
                                   jnp.zeros((1, 384)))
    mlp = TMLP(384)
    mlp.load_state_dict(convert.uncertainty_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return params, mlp


# ---------------------------------------------------------------------------
# tracking loss and non-keyframe pose refinement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_uncertainty", [False, True])
def test_tracking_loss_rgb(with_uncertainty):
    rng = np.random.RandomState(0)
    H, W = 24, 32
    img, gt = rng.uniform(size=(2, H, W, 3)).astype(np.float32)
    gt[:3] = 0.0                                   # under the boundary
    op = rng.uniform(size=(H, W)).astype(np.float32)
    mask = (rng.uniform(size=(H, W)) > 0.3).astype(np.float32)
    unc = (rng.uniform(0.5, 3.0, (H, W)).astype(np.float32)
           if with_uncertainty else None)
    ref = jlosses.tracking_loss_rgb(
        jnp.asarray(img), jnp.asarray(gt), jnp.asarray(op), jnp.asarray(mask),
        jnp.float32(0.1), jnp.float32(-0.05), 0.01,
        uncertainty_pix=None if unc is None else jnp.asarray(unc))
    out = tlosses.tracking_loss_rgb(
        torch.from_numpy(img), torch.from_numpy(gt), torch.from_numpy(op),
        torch.from_numpy(mask), torch.tensor(0.1), torch.tensor(-0.05), 0.01,
        uncertainty_pix=None if unc is None else torch.from_numpy(unc))
    close(out, ref, 1e-6)


def small_map(n=600, seed=0):
    """Gaussians on a slanted textured plane in front of the camera, as
    numpy arrays of the maps' storage."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-1.0, 1.0, (n, 2))
    xyz = np.concatenate([xy, 2.5 + 0.3 * xy[:, :1]], -1)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    p = dict(xyz=xyz, f_dc=rng.uniform(-1.5, 1.5, (n, 1, 3)),
             f_rest=np.zeros((n, 0, 3)), opacity=rng.uniform(0, 3, (n, 1)),
             scaling=np.log(rng.uniform(0.03, 0.08, (n, 3))), rotation=q)
    return {k: v.astype(np.float32) for k, v in p.items()}


def test_refine_pose_non_key_frame():
    """20 refinement steps from a perturbed pose, against the JAX
    _refine_pose_core (XLA render), with the uncertainty weights."""
    H, W = 64, 64
    cfg = tload_config(CFG_PATH)
    cfg["mapping"]["gaussian_capacity"] = 1024
    cfg["mapping"]["render_list_capacity"] = 256
    cfg["mapping"]["Training"]["pose_refine_iters"] = 20
    cfg["tracking"]["buffer"] = 2
    intr = np.array([60.0, 60.0, W / 2, H / 2], np.float32)
    ts = TState.create(cfg, H, W, intr, buffer=2, device="cpu")
    uparams, mlp = jax_mlp()
    tm = TMapper(ts, cfg, uncer_mlp=mlp, device="cpu")
    p = small_map()
    n = len(p["xyz"])
    for name, v in p.items():
        getattr(tm.gaussians.params, name)[:n] = torch.from_numpy(v)
    tm.gaussians.aux.alive[:n] = True
    g = tm.gaussians.params
    true_w2c = tlie.se3_exp(torch.tensor([0.02, -0.01, 0.05, 0.01, 0.0,
                                          0.02]))
    with torch.no_grad():
        gt = tr.render(g.xyz, tgm.get_scaling(g), tgm.get_rotation_xyzw(g),
                       tgm.get_opacity(g), tgm.get_sh(g), true_w2c,
                       tm.intrinsics_full, (H, W), alive=tm.gaussians.aux.alive,
                       capacity=256).color.numpy()
    w2c0 = tlie.se3_retr(true_w2c, torch.tensor(
        [0.01, 0.005, -0.01, 0.004, -0.006, 0.003])).numpy()
    feats = np.random.RandomState(3).normal(
        size=(H // 14, W // 14, 384)).astype(np.float32)

    out = tm.refine_pose_non_key_frame(gt, w2c0, features=feats).numpy()
    assert tm.refine_calls == 1 and tm.refine_steps == 20

    jparams = jgm.GaussianParams(**{k: jnp.asarray(
        getattr(tm.gaussians.params, k).numpy()) for k in p})
    tr_cfg = cfg["mapping"]["Training"]
    grad_mask, uncer = jmapper._refine_prep(
        jnp.asarray(gt), jnp.asarray(feats), uparams,
        tr_cfg["edge_threshold"], 384, 0.3, (H, W))
    t_mask, t_uncer = tm._refine_prep(torch.from_numpy(gt),
                                      torch.from_numpy(feats))
    assert 0 < float(t_mask.mean()) < 1
    np.testing.assert_array_equal(t_mask, grad_mask)
    close(t_uncer, uncer, 1e-5)
    ref = jmapper._refine_pose_core(
        jparams, jnp.asarray(tm.gaussians.aux.alive.numpy()),
        jnp.asarray(w2c0), jnp.asarray(gt), grad_mask, uncer,
        jnp.asarray(tm.intrinsics_full.numpy()), (H, W), 256, 64,
        tr_cfg["lr"]["cam_rot_delta"], tr_cfg["lr"]["cam_trans_delta"],
        tr_cfg["rgb_boundary_threshold"], iters=20, bin_method="sort_norev")
    close(out, ref, 1e-4)
    assert np.abs(out - w2c0).max() > 1e-3       # 20 steps moved the pose


# ---------------------------------------------------------------------------
# trajectory filler
# ---------------------------------------------------------------------------

HT, WD = 48, 64


def synth_image(t):
    y, x = np.meshgrid(np.arange(HT), np.arange(WD), indexing="ij")
    img = np.stack([0.5 + 0.5 * np.sin(0.2 * (x - 3 * t)),
                    0.5 + 0.5 * np.cos(0.15 * (y + 2 * t)),
                    0.5 + 0.4 * np.sin(0.1 * (x + y - t))], -1)
    return np.clip(img, 0, 1).astype(np.float32)


def feat_fn(im):
    seed = int(im.sum() * 1000) % (2 ** 31)
    return np.random.RandomState(seed).rand(HT // 14, WD // 14, 384).astype(
        np.float32)


class ListStream:
    def __init__(self, n):
        self.frames = [synth_image(t) for t in range(n)]

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return i, self.frames[i], None, None


def test_trajectory_filler(monkeypatch):
    cfg = load_config("configs/wildgs_slam.yaml")
    cfg["tracking"]["buffer"] = 9
    params = jdn.init_droid_params(jax.random.PRNGKey(0), HT, WD)
    model = tdn.DroidNet()
    model.load_state_dict(convert.droid_params_from_jax(
        jax.tree.map(np.asarray, params)))
    model.eval()
    intr = np.array([40.0, 40.0, WD / 2, HT / 2])
    js = JState.create(cfg, HT, WD, intr, buffer=9)
    ts = TState.create(cfg, HT, WD, intr, buffer=9, device="cpu")
    depth = lambda im: np.full((HT, WD), 2.0, np.float32)  # noqa: E731
    jm = JMF(js, params, thresh=-1.0, depth_fn=depth)
    jm.fused = False
    tm = TMF(ts, model, thresh=-1.0, depth_fn=depth)
    stream = ListStream(10)
    for t in range(0, 10, 3):            # keyframes 0, 3, 6, 9
        jm.track(float(t), stream.frames[t])
        tm.track(float(t), stream.frames[t])
    n = ts.counter
    xi = np.zeros((n, 6), np.float32)
    xi[:, 0] = 0.03 * np.arange(n)
    xi[:, 4] = 0.01 * np.arange(n)
    kf = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    js.store = js.store._replace(poses=js.store.poses.at[:n].set(kf))
    ts.store.poses[:n] = torch.from_numpy(np.array(kf))

    # float32 volumes on both sides
    monkeypatch.setattr(tfg, "CORR_DTYPE", torch.float32)

    class F32Graph(jtf.FactorGraph):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.corr_pyr = [jnp.zeros((self.cap, self.h * self.w,
                                        self.h // 2 ** k, self.w // 2 ** k))
                             for k in range(4)]
    monkeypatch.setattr(jtf, "FactorGraph", F32Graph)

    uparams, mlp = jax_mlp()
    jfill = jtf.PoseTrajectoryFiller(
        js, params, feat_fn=feat_fn,
        uncer_apply=lambda f: JMLP(in_dim=384).apply(uparams, f))
    tfill = TFiller(ts, model, feat_fn=feat_fn, uncer_apply=mlp)
    ref = jfill(stream)
    out = tfill(stream)
    assert out.shape == ref.shape == (10, 7)
    assert ts.counter == js.counter == n
    close(out, ref, 1e-4)
    # the 5 spare slots take two batches; the last batch's uncertainty
    # weights and every frame's features were written and kept
    assert len(tfill.last_features) == len(jfill.last_features) == 10
    close(ts.store.uncertainties_inv, js.store.uncertainties_inv, 1e-5)
    # the updates moved every frame off its interpolation
    interp = np.concatenate([np.asarray(jfill._interpolate(
        [float(t) for t in range(a, a + 5)])[2]) for a in (0, 5)])
    assert np.abs(out - interp).max(axis=1).min() > 1e-3


# ---------------------------------------------------------------------------
# evaluation and export
# ---------------------------------------------------------------------------

def test_eval_traj(tmp_path):
    rng = np.random.RandomState(4)
    n = 15
    xi = rng.normal(scale=0.3, size=(n, 6))
    gt = np.asarray(jlie.se3_matrix(jlie.se3_exp(jnp.asarray(
        xi, jnp.float32)))).astype(np.float64)
    est = gt.copy()
    R = np.asarray(jlie.quat_to_matrix(jnp.asarray([0.1, 0.2, -0.1, 0.97])
                                       / np.linalg.norm([0.1, 0.2, -0.1,
                                                         0.97])))
    est[:, :3, 3] = 0.7 * gt[:, :3, 3] @ R.T + 0.3 + 0.01 * rng.normal(
        size=(n, 3))
    gt[4] = np.nan                         # a frame without ground truth
    xyz = tev.poses_c2w_to_xyz(est)
    np.testing.assert_array_equal(xyz, jev.poses_c2w_to_xyz(est))
    a_t, (R_t, t_t, s_t) = tev.align_trajectories(xyz[5:], xyz[:-5])
    a_j, (R_j, t_j, s_j) = jev.align_trajectories(xyz[5:], xyz[:-5])
    for x, y in ((a_t, a_j), (R_t, R_j), (t_t, t_j), (s_t, s_j)):
        close(x, y, 1e-9)
    valid = np.arange(n) != 7
    st = tev.evaluate_ate(est, gt, valid=valid)
    sj = jev.evaluate_ate(est, gt, valid=valid)
    assert st.keys() == sj.keys() and st["n"] == sj["n"] == n - 2
    for k in st:
        assert abs(st[k] - sj[k]) < 1e-9, k
    ts = np.arange(n)
    for mod, d in ((tev, "t"), (jev, "j")):
        mod.save_traj_tum(str(tmp_path / d / "est.txt"), ts, est)
        mod.write_metrics(str(tmp_path / d / "m.txt"), st, label="ATE")
    for f in ("est.txt", "m.txt"):
        assert (tmp_path / "t" / f).read_text() == (
            tmp_path / "j" / f).read_text()
    assert tev.read_metric(str(tmp_path / "t" / "m.txt")) == st["rmse"]
    pytest.importorskip("matplotlib")
    tev.plot_trajectory(str(tmp_path / "t" / "plot.png"), xyz[5:],
                        xyz[:-5], st)
    assert (tmp_path / "t" / "plot.png").stat().st_size > 0


def test_save_ply(tmp_path):
    p = small_map(300, seed=5)
    rng = np.random.RandomState(6)
    p["f_rest"] = rng.normal(size=(300, 3, 3)).astype(np.float32)
    alive = rng.uniform(size=400) < 0.7
    C = 400
    full = {k: np.zeros((C,) + v.shape[1:], np.float32) for k, v in p.items()}
    for k, v in p.items():
        full[k][:300] = v
    m_t = tgm.create(C, max_sh_degree=1, device="cpu")
    for k, v in full.items():
        getattr(m_t.params, k).copy_(torch.from_numpy(v))
    m_t.aux.alive.copy_(torch.from_numpy(alive))
    m_j = jgm.create(C, max_sh_degree=1)
    m_j = m_j._replace(
        params=jgm.GaussianParams(**{k: jnp.asarray(v)
                                     for k, v in full.items()}),
        aux=m_j.aux._replace(alive=jnp.asarray(alive)))
    n_t = tgm.save_ply(m_t, str(tmp_path / "t.ply"))
    n_j = jgm.save_ply(m_j, str(tmp_path / "j.ply"))
    assert n_t == n_j == int(alive.sum())
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    back = tgm.load_ply(str(tmp_path / "t.ply"))
    ref = jgm.load_ply(str(tmp_path / "t.ply"))
    for k, v in full.items():
        np.testing.assert_array_equal(back[k], v[alive])
        np.testing.assert_array_equal(back[k], ref[k])


def test_droid_checkpoint_loader(tmp_path):
    """A state dict in upstream's naming (``module.`` prefix, 3-channel
    weight and delta heads) loads through both loaders to equal weights."""
    net = tdn.init_droid_net(torch.Generator().manual_seed(7), device="cpu")
    g = torch.Generator().manual_seed(8)
    sd = {}
    for k, v in net.state_dict().items():
        if k.startswith(tdn.HEADS):
            v = torch.cat([v, torch.randn((1,) + v.shape[1:], generator=g)])
        sd["module." + k] = v.clone()
    path = str(tmp_path / "droid.pth")
    torch.save(sd, path)
    loaded = tdn.load_droid_checkpoint(path, device="cpu")
    ref = convert.droid_params_from_jax(jax.tree.map(
        np.asarray, jdn.load_droid_checkpoint(path)))
    out = loaded.state_dict()
    assert out.keys() == ref.keys() == net.state_dict().keys()
    for k in out:
        assert torch.equal(out[k], ref[k]), k
        assert torch.equal(out[k], net.state_dict()[k]), k


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

SH, SW = 32, 40
N_FRAMES = 8


class PlaneStream:
    """A textured plane (world z = 2) seen by a moving camera: (index,
    image, None, c2w 4x4); depth_fn gives each frame's exact depth."""

    def __init__(self, n, fx=45.0):
        self.intrinsic = np.array([fx, fx, SW / 2.0, SH / 2.0])
        yy, xx = np.meshgrid(np.arange(SH) + 0.5, np.arange(SW) + 0.5,
                             indexing="ij")
        dirs = np.stack([(xx - SW / 2) / fx, (yy - SH / 2) / fx,
                         np.ones_like(xx)], -1)
        self.frames, self.depth, poses = [], {}, []
        for i in range(n):
            xi = torch.tensor([0.03 * i, 0.01 * np.sin(0.4 * i), 0.01 * i,
                               0.0, 0.02 * i, 0.004 * i])
            T = tlie.se3_matrix(tlie.se3_exp(xi)).numpy().astype(np.float64)
            d = dirs @ T[:3, :3].T
            s = (2.0 - T[2, 3]) / d[..., 2]
            x, y = (T[:3, 3] + s[..., None] * d)[..., :2].transpose(2, 0, 1)
            img = np.stack([0.5 + 0.4 * np.sin(7.0 * x) * np.cos(5.0 * y),
                            0.5 + 0.4 * np.cos(6.0 * y + 2.0 * x),
                            0.5 + 0.3 * np.sin(4.0 * (x + y))], -1)
            img = np.clip(img, 0, 1).astype(np.float32)
            self.frames.append(img)
            self.depth[id(img)] = s.astype(np.float32)
            poses.append(T)
        self.poses = np.stack(poses)
        self.w2c = tlie.se3_inv(tlie.se3_from_matrix(torch.as_tensor(
            self.poses, dtype=torch.float32))).numpy()
        sh, sw = tks.slice_hw(SH, SW)
        self.disps_small = np.stack([1.0 / self.depth[id(f)][sh, sw]
                                     for f in self.frames])

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return i, self.frames[i], None, self.poses[i]

    def depth_fn(self, image):
        return self.depth[id(image)]


def slam_cfg(load, out):
    cfg = load("configs/wildgs_slam.yaml")
    cfg["scene"] = "oracle"
    cfg["data"]["output"] = out
    cfg["cam"].update(H_out=SH, W_out=SW, H_edge=0, W_edge=0)
    cfg["verbose"] = False
    t = cfg["tracking"]
    t.update(buffer=14, warmup=4, force_keyframe_every_n_frames=1)
    t["motion_filter"]["thresh"] = 1e9
    # oracle geometry: the BA weights stay 1 (no uncertainty MLP), so the
    # keyframe poses do not depend on the mapper
    t["uncertainty_params"]["activate"] = False
    cfg["mapping"]["uncertainty_params"]["activate"] = False
    t["frontend"].update(window=5, max_factors=24, enable_loop=True)
    t["backend"].update(ba_freq=2, loop_window=5)
    m = cfg["mapping"]
    m.update(final_refine_iters=6, gaussian_capacity=2048,
             render_list_capacity=128)
    m["Training"].update(init_itr_num=6, mapping_itr_num=2, window_size=3,
                         init_gaussian_update=5, init_gaussian_reset=6,
                         pose_refine_iters=3)
    return cfg


class JaxDraws:
    """Replays the JAX Mapper's key chain (see test_torch_mapper.py)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, kind, shape):
        self.key, k = jax.random.split(self.key)
        if kind == "seed":
            return np.array(jax.random.uniform(k, shape))
        return np.stack([np.asarray(jax.random.normal(kk, shape[1:]))
                         for kk in jax.random.split(k)])


def test_slam_run_follows_jax(tmp_path, monkeypatch):
    from wildgs_slam_tpu.ops import dba as jdba
    from wildgs_slam_tpu.slam.system import SLAM as JSLAM
    from wildgs_slam_tpu_torch.slam.system import SLAM as TSLAM

    monkeypatch.setattr(jdba, "ba_iteration", jax.jit(
        jdba.ba_iteration, static_argnames=("cfg", "motion_only", "pmax")))
    stream = PlaneStream(N_FRAMES)
    params = jdn.init_droid_params(jax.random.PRNGKey(0), SH, SW)
    model = tdn.DroidNet()
    model.load_state_dict(convert.droid_params_from_jax(
        jax.tree.map(np.asarray, params)))
    uparams, mlp = jax_mlp()

    jcfg = slam_cfg(load_config, str(tmp_path / "jax"))
    tcfg = slam_cfg(tload_config, str(tmp_path / "port"))
    assert ({k: v for k, v in jcfg.items() if k != "data"}
            == {k: v for k, v in tcfg.items() if k != "data"})
    js = JSLAM(jcfg, stream, depth_fn=stream.depth_fn, droid_params=params)
    tsl = TSLAM(tcfg, stream, depth_fn=stream.depth_fn, model=model.eval(),
                uncer_mlp=mlp, draw_fn=JaxDraws(jcfg["setup_seed"]),
                device="cpu")
    w2c_j, dsm_j = jnp.asarray(stream.w2c), jnp.asarray(stream.disps_small)
    w2c_t, dsm_t = (torch.from_numpy(stream.w2c),
                    torch.from_numpy(stream.disps_small))

    def oracle_j(store, counter):
        ts = np.clip(np.asarray(store.timestamp).astype(int), 0, N_FRAMES - 1)
        return w2c_j[ts], dsm_j[ts]

    def oracle_t(store, counter):
        ts = store.timestamp.long().clamp(0, N_FRAMES - 1)
        return w2c_t[ts], dsm_t[ts]
    js.frontend.graph.gt_injection = js.backend.gt_injection = oracle_j
    tsl.frontend.graph.gt_injection = tsl.backend.gt_injection = oracle_t
    js.run()
    tsl.run()

    n = tsl.state.counter
    assert n == js.state.counter == N_FRAMES
    np.testing.assert_array_equal(tsl.state.store.timestamp[:n],
                                  np.asarray(js.state.store.timestamp[:n]))
    close(tsl.state.store.poses[:n], js.state.store.poses[:n], 1e-5)
    assert tsl.mapper.refine_calls == N_FRAMES   # one refinement per frame
    for d, name in ((tmp_path / "jax" / "oracle", "kf"),
                    (tmp_path / "port" / "oracle", "kf"),
                    (tmp_path / "port" / "oracle", "full")):
        rmse = tev.read_metric(str(d / "traj" / f"{name}_traj_metrics.txt"))
        assert rmse < 0.01, (d, name, rmse)
    out = tmp_path / "port" / "oracle"
    for f in ("cfg.yaml", "video.npz", "final_gs.ply", "profile.txt",
              "traj/kf_traj_est.txt", "traj/full_traj_est.txt"):
        assert (out / f).stat().st_size > 0, f
    ply = tgm.load_ply(str(out / "final_gs.ply"))
    assert len(ply["xyz"]) == tgm.num_alive(tsl.mapper.gaussians) > 0
    video = np.load(str(out / "video.npz"))
    close(video["poses"], tsl.state.store.poses[:n], 0)
