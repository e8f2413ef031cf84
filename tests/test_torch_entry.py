"""The port's entry point and what it wires: depth alignment and the
depth-L1 evaluation, the control channel, the anomaly checks, the HTML
viewer export, checkpoints (the graph's edge state, a JAX-written
checkpoint, kill-and-resume) and ``wildgs_slam_tpu_torch.run`` on a TUM
folder, each held against the JAX package where it has a counterpart.

Tolerances, and why:
- ``align_scale_and_shift`` and ``eval_depth_l1``: rtol 1e-4 (float32 sums
  of H*W terms in another order; the shift and the residual are
  differences of such sums, measured up to 2.4e-5 apart);
- ``export_viewer_from_map``: both HTML files byte-equal to the JAX
  export of the same map outside the embedded float32 data; in the data
  positions, colours and opacities equal, the mean scales within 3e-7
  relative and the covariances within 2e-5 (torch's and XLA's float32 exp
  and quaternion normalization differ in the last bit, measured 1 ulp on
  the scales and up to 71 ulp on the covariances built from them);
- ``restore_edge_state`` and the JAX-written checkpoint: every restored
  array equal (bfloat16 rows exactly as stored), the rebuilt correlation
  volumes equal to the graph's own;
- kill-and-resume against the uninterrupted run (tests/test_resume.py's
  tolerances): keyframe poses atol 1e-5, alive set equal, Gaussian centres
  atol 1e-4;
- ``run.build`` + ``run()``: the files the JAX ``run.py`` path writes (the
  port writes the uncertainty MLP's weights as .pth, the JAX package as
  .pkl), keyframe ATE < 1 cm under the oracle, on both sides; without the
  prior checkpoints the one fallback line, its three switches off, and a
  run to its end (keyframe ATE < 1 cm).

The JAX BA iteration runs through ``jax.jit`` (a test-side wrapper, as in
tests/test_torch_system.py).
"""

import base64
import hashlib
import json
import os
import re
import threading
import time
import urllib.request

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from wildgs_slam_tpu.config import load_config
from wildgs_slam_tpu.gui import html_viewer as jviewer
from wildgs_slam_tpu.slam import gaussian_map as jgm
from wildgs_slam_tpu.slam import keyframe_store as jks
from wildgs_slam_tpu.utils import checkpoint as jckpt
from wildgs_slam_tpu.utils import common as jcommon
from wildgs_slam_tpu.utils import eval_depth as jeval
from wildgs_slam_tpu_torch import convert
from wildgs_slam_tpu_torch import run as trun
from wildgs_slam_tpu_torch.config import load_config as tload_config
from wildgs_slam_tpu_torch.gui import html_viewer as tviewer
from wildgs_slam_tpu_torch.gui.control import ControlChannel
from wildgs_slam_tpu_torch.models import dinov2 as tdino
from wildgs_slam_tpu_torch.models import dpt as tdpt
from wildgs_slam_tpu_torch.ops import lie as tlie
from wildgs_slam_tpu_torch.slam import factor_graph as tfg
from wildgs_slam_tpu_torch.slam import gaussian_map as tgm
from wildgs_slam_tpu_torch.slam import keyframe_store as tks
from wildgs_slam_tpu_torch.slam.state import SlamState as TState
from wildgs_slam_tpu_torch.slam.system import SLAM as TSLAM
from wildgs_slam_tpu_torch.utils import checkpoint as tckpt
from wildgs_slam_tpu_torch.utils import common as tcommon
from wildgs_slam_tpu_torch.utils import debug as tdebug
from wildgs_slam_tpu_torch.utils import eval_depth as teval
from wildgs_slam_tpu_torch.utils import eval_traj as tev

from test_torch_system import SH, SW, PlaneStream, slam_cfg

torch.set_num_threads(1)


def close(port, ref, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol,
                               rtol=rtol)


# ---------------------------------------------------------------------------
# depth alignment and the depth-L1 evaluation
# ---------------------------------------------------------------------------

def test_align_scale_and_shift():
    rng = np.random.RandomState(0)
    pred = rng.uniform(0.5, 4.0, (3, 12, 16)).astype(np.float32)
    target = (1.7 * pred + 0.3 + 0.05 * rng.normal(size=pred.shape)).astype(
        np.float32)
    w = (rng.uniform(size=pred.shape) > 0.2).astype(np.float32)
    for args in ((pred, target, w), (pred[0], target[0], w[0]),
                 (pred, target)):
        ref = jcommon.align_scale_and_shift(*args)
        out = tcommon.align_scale_and_shift(*args)
        for o, r in zip(out, ref):
            close(o, r, 0, rtol=1e-4)


def test_eval_depth_l1():
    rng = np.random.RandomState(1)
    B, H, W, n = 5, 24, 32, 4
    intr = np.array([30.0, 30.0, 16.0, 12.0])
    disps_up = rng.uniform(0.2, 1.0, (B, H, W)).astype(np.float32)
    mask = rng.uniform(size=(B, H, W)) > 0.3
    mask[2] = False                                  # an empty mask
    ts = np.array([0, 2, 3, 5, 0], np.float32)
    gt = {int(t): (2.0 / disps_up[k] + 0.1 * rng.normal(size=(H, W))
                   ).astype(np.float32) for k, t in enumerate(ts[:n])}
    gt[5][:4] = 6.0                                  # beyond the 4 m cut
    stream = {t: (t, None, d, None) for t, d in gt.items()}
    js = jks.create(B, H, W, intr)._replace(
        timestamp=jnp.asarray(ts), disps_up=jnp.asarray(disps_up),
        valid_depth_mask=jnp.asarray(mask))
    ts_ = tks.create(B, H, W, intr, device="cpu")
    ts_.timestamp.copy_(torch.from_numpy(ts))
    ts_.disps_up.copy_(torch.from_numpy(disps_up))
    ts_.valid_depth_mask.copy_(torch.from_numpy(mask))
    ref = jeval.eval_depth_l1(js, n, stream)
    out = teval.eval_depth_l1(ts_, n, stream)
    close(out, ref, 0, rtol=1e-4)


# ---------------------------------------------------------------------------
# control channel, anomaly checks, viewer export
# ---------------------------------------------------------------------------

def write_cmd(path, cmd):
    with open(path + ".tmp", "w") as f:
        json.dump(cmd, f)
    os.replace(path + ".tmp", path)


def test_control_channel_file_commands(tmp_path):
    chan = ControlChannel(str(tmp_path))
    assert chan.poll() == {"pause": False, "stop": False,
                           "save_checkpoint": False}
    write_cmd(chan.path, {"pause": True})
    assert chan.poll()["pause"]
    time.sleep(0.01)
    write_cmd(chan.path, {"save_checkpoint": True})
    assert chan.consume_checkpoint_request()
    assert not chan.consume_checkpoint_request()
    t0 = time.time()

    def resume():
        time.sleep(0.3)
        write_cmd(chan.path, {"pause": False})
    th = threading.Thread(target=resume)
    th.start()
    chan.wait_if_paused(interval=0.05)
    th.join(timeout=5)
    assert not th.is_alive() and time.time() - t0 >= 0.25
    time.sleep(0.01)
    write_cmd(chan.path, {"pause": True, "stop": True})
    chan.wait_if_paused(interval=0.05)          # stop ends the wait
    assert chan.poll()["stop"]


def test_control_channel_http_commands(tmp_path):
    chan = ControlChannel(str(tmp_path), http_port=0)
    base = f"http://127.0.0.1:{chan.http_port}"

    def get(cmd):
        with urllib.request.urlopen(f"{base}/{cmd}", timeout=5) as r:
            return json.loads(r.read())
    try:
        assert not get("status")["pause"]
        assert get("pause")["pause"]
        assert not get("resume")["pause"]
        assert get("checkpoint")["save_checkpoint"]
        assert chan.consume_checkpoint_request()
        assert get("stop")["stop"]
    finally:
        chan.close()
    assert chan._server is None
    with pytest.raises(OSError):
        urllib.request.urlopen(f"{base}/status", timeout=2)


def test_anomaly_check():
    store = tks.create(4, 16, 16, [20.0, 20.0, 8.0, 8.0], device="cpu")
    tdebug.anomaly_check("off", store)          # disabled: returns
    tdebug.enable()
    try:
        assert torch.is_anomaly_enabled()
        tdebug.anomaly_check("clean", store, {"x": [torch.ones(3)]})
        store.disps[1, 0, 0] = float("nan")
        with pytest.raises(tdebug.AnomalyError,
                           match=r"phase 'track.frontend'.*\.disps"):
            tdebug.anomaly_check("track.frontend", store)
    finally:
        tdebug.disable()
    assert not torch.is_anomaly_enabled()
    tdebug.anomaly_check("off again", store)


def random_map_numpy(C=96, n=60, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.normal(size=(C, 4))
    params = dict(xyz=rng.normal(size=(C, 3)), f_dc=rng.normal(size=(C, 1, 3)),
                  f_rest=np.zeros((C, 0, 3)), opacity=rng.normal(size=(C, 1)),
                  scaling=rng.uniform(-5, -2, (C, 3)), rotation=q)
    params = {k: v.astype(np.float32) for k, v in params.items()}
    alive = np.zeros(C, bool)
    alive[rng.permutation(C)[:n]] = True
    aux = dict(alive=alive, kf_id=rng.randint(0, 4, C).astype(np.int32),
               n_obs=rng.randint(0, 9, C).astype(np.int32),
               xyz_grad_accum=rng.uniform(size=C).astype(np.float32),
               denom=rng.uniform(size=C).astype(np.float32),
               max_radii2d=rng.uniform(size=C).astype(np.float32))
    mu = {k: rng.normal(size=v.shape).astype(np.float32)
          for k, v in params.items()}
    nu = {k: rng.uniform(size=v.shape).astype(np.float32)
          for k, v in params.items()}
    return dict(params=params, aux=aux, mu=mu, nu=nu, count=7)


def jax_map(d):
    return jgm.GaussianMap(
        params=jgm.GaussianParams(**{k: jnp.asarray(v)
                                     for k, v in d["params"].items()}),
        aux=jgm.GaussianAux(**{k: jnp.asarray(v)
                               for k, v in d["aux"].items()}),
        adam=jgm.AdamState(
            mu=jgm.GaussianParams(**{k: jnp.asarray(v)
                                     for k, v in d["mu"].items()}),
            nu=jgm.GaussianParams(**{k: jnp.asarray(v)
                                     for k, v in d["nu"].items()}),
            count=jnp.asarray(d["count"], jnp.int32)))


def viewer_parts(path):
    """An exported viewer's HTML with its embedded data cut out, and the
    data as float32."""
    html = path.read_text()
    b64 = re.search(r'B64="([^"]+)"', html).group(1)
    return (html.replace(b64, ""),
            np.frombuffer(base64.b64decode(b64), np.float32))


def test_export_viewer_from_map(tmp_path):
    d = random_map_numpy()
    n = int(d["aux"]["alive"].sum())
    jviewer.export_viewer_from_map(str(tmp_path / "jax.html"), jax_map(d))
    tviewer.export_viewer_from_map(str(tmp_path / "port.html"),
                                   convert.gaussian_map_from_numpy(d, "cpu"))
    (hj, fj), (hp, fp) = (viewer_parts(tmp_path / f"{s}.html")
                          for s in ("jax", "port"))
    assert hj == hp
    # splats: positions, colours and opacities; the covariances from the
    # exponentiated scales and the normalized quaternions
    close(fp[:7 * n], fj[:7 * n], 0)
    close(fp[7 * n:], fj[7 * n:], 0, rtol=2e-5)
    (hj, fj), (hp, fp) = (viewer_parts(tmp_path / f"{s}_points.html")
                          for s in ("jax", "port"))
    assert hj == hp
    close(fp[:6 * n], fj[:6 * n], 0)              # positions, colours
    close(fp[6 * n:], fj[6 * n:], 0, rtol=3e-7)   # mean scales


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def small_cfg(load, out, buffer=8):
    cfg = load("configs/wildgs_slam.yaml")
    cfg["scene"] = "ckpt"
    cfg["data"]["output"] = out
    cfg["verbose"] = False
    cfg["cam"].update(H_out=SH, W_out=SW, H_edge=0, W_edge=0)
    cfg["tracking"]["buffer"] = buffer
    cfg["mapping"].update(gaussian_capacity=96, render_list_capacity=64)
    return cfg


class StubStream:
    intrinsic = np.array([45.0, 45.0, SW / 2.0, SH / 2.0])
    poses = None

    def __len__(self):
        return 0


def fill_store(store, rng, n):
    """Random contents for the first n slots of a port store; returns them
    as numpy arrays keyed by field."""
    out = {}
    for f in tks.KeyframeStore.__dataclass_fields__:
        t = getattr(store, f)
        if f == "intrinsics":
            out[f] = t.numpy()
            continue
        a = (rng.uniform(size=t.shape) > 0.5 if t.dtype == torch.bool
             else rng.uniform(0.1, 1.0, t.shape).astype(np.float32))
        t.copy_(torch.as_tensor(a))
        out[f] = a
    return out


def test_restore_edge_state():
    rng = np.random.RandomState(2)
    cfg = small_cfg(tload_config, "unused")
    st = TState.create(cfg, SH, SW, StubStream.intrinsic, buffer=8,
                       device="cpu")
    fill_store(st.store, rng, 8)
    st.store.poses[:, 3:] = torch.tensor([0.0, 0.0, 0.0, 1.0])
    st.counter = 6
    g = tfg.FactorGraph(st, None, max_factors=12)
    g.add_factors([0, 1, 2, 3, 4], [1, 2, 3, 4, 5])
    g.add_factors([1, 2], [0, 1])
    g.weight = torch.rand(g.target.shape, generator=torch.Generator()
                          .manual_seed(0))
    g.rm_factors(np.array([False, True, False, False, False, False, True]),
                 store=True)
    g2 = tfg.FactorGraph(st, None, max_factors=12)
    for name in tckpt.GRAPH_LISTS:
        setattr(g2, name, getattr(g, name).copy())
    g2.restore_edge_state(g.net.numpy(), g.inp.numpy(), g.target.numpy(),
                          g.weight.numpy(), g.target_inac.numpy(),
                          g.weight_inac.numpy())
    for name in ("net", "inp", "target", "weight", "target_inac",
                 "weight_inac"):
        close(getattr(g2, name), getattr(g, name), 0)
    assert g2.E == g.E == 5 and len(g2.ii_inac) == 2
    close(g2.corr[:g2.E].float(), g.corr[:g.E].float(), 0)


class FakeGraph:
    """What the JAX save reads off a frontend graph."""

    def __init__(self, rng, h, w, B):
        self.ii = np.array([0, 1, 2, 1], np.int64)
        self.jj = np.array([1, 2, 1, 0], np.int64)
        self.age = np.array([3, 1, 0, 2], np.int64)
        self.ii_bad = self.jj_bad = np.zeros(0, np.int64)
        self.ii_inac = np.array([0, 2], np.int64)
        self.jj_inac = np.array([2, 0], np.int64)

        def r(*s):
            return jnp.asarray(rng.normal(size=s).astype(np.float32))
        self.net, self.inp = r(4, h, w, 128), r(4, h, w, 128)
        self.target, self.weight = r(4, h, w, 2), r(4, h, w, 2)
        self.target_inac, self.weight_inac = r(2, h, w, 2), r(2, h, w, 2)
        self.damping = r(B, h, w)


class FakeJaxSlam:
    def __init__(self, state, mapper, graph):
        self.state, self.mapper = state, mapper
        self.frontend = type("F", (), dict(
            t1=3, is_initialized=True, num_keyframes_dropped=1,
            graph=graph))()
        self.motion_filter = type("M", (), dict(count=2))()


def test_jax_checkpoint_loads_into_port(tmp_path):
    from wildgs_slam_tpu.slam.mapper import Mapper as JMapper
    from wildgs_slam_tpu.slam.state import SlamState as JState

    rng = np.random.RandomState(3)
    jcfg = small_cfg(load_config, str(tmp_path / "jax"))
    tcfg = small_cfg(tload_config, str(tmp_path / "port"))
    B, h, w = 8, SH // 8, SW // 8
    # the port system to load into; its store's random contents go into
    # the JAX state, so the stores' dtypes and shapes match by construction
    tsl = TSLAM(tcfg, StubStream(), device="cpu")
    arrays = fill_store(tsl.state.store, rng, B)
    tsl.state.store = tks.create(B, SH, SW, StubStream.intrinsic,
                                 device="cpu")   # load overwrites it
    tsl.frontend.graph.state = tsl.state
    js = JState.create(jcfg, SH, SW, StubStream.intrinsic, buffer=B)
    js.store = js.store._replace(**{k: jnp.asarray(v)
                                    for k, v in arrays.items()})
    js.counter = 3
    js.images[:] = rng.uniform(size=js.images.shape)
    js.dino_feats[:] = rng.normal(size=js.dino_feats.shape)
    js.timestamps[:] = np.arange(B) * 2.0
    jm = JMapper(js, jcfg, rng_seed=4)
    mapd = random_map_numpy(C=96, seed=5)
    jm.gaussians = jax_map(mapd)
    vs = {f: getattr(jm.vstore, f) for f in jm.vstore._fields}
    vs = {f: jnp.asarray(rng.uniform(size=v.shape) > 0.5) if v.dtype == bool
          else jnp.asarray(rng.uniform(size=v.shape)).astype(v.dtype)
          for f, v in vs.items()}
    jm.vstore = jm.vstore._replace(**vs)
    jm.uncer_params = jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32),
        jm.uncer_params)
    jm.uncer_mu = jax.tree.map(lambda a: a * 0.5, jm.uncer_params)
    jm.uncer_nu = jax.tree.map(lambda a: a * a, jm.uncer_params)
    jm.uncer_count = jnp.asarray(11, jnp.int32)
    jm.current_window, jm.video_idxs, jm.frame_idxs = [2, 0], [0, 1, 2], \
        [0, 2, 4]
    jm.is_kf = {0: True, 1: False, 2: True}
    jm.iteration_count, jm.iters_after_densify = 17, 5
    jm.occ_aware_visibility = {0: jnp.asarray(mapd["aux"]["alive"])}
    graph = FakeGraph(rng, h, w, B)
    path = str(tmp_path / "checkpoint.npz")
    jckpt.save_slam_checkpoint(path, FakeJaxSlam(js, jm, graph),
                               loop_state=dict(next_frame=5, prev_kf_idx=2,
                                               prev_ba_idx=0))

    loop = tckpt.load_slam_checkpoint(path, tsl)
    assert loop == dict(next_frame=5, prev_kf_idx=2, prev_ba_idx=0)
    st, m, g = tsl.state, tsl.mapper, tsl.frontend.graph
    for f, v in arrays.items():
        close(getattr(st.store, f), np.asarray(getattr(js.store, f)), 0)
    close(st.images, js.images, 0)
    close(st.dino_feats, js.dino_feats, 0)
    close(st.timestamps, js.timestamps, 0)
    assert st.counter == 3
    port_map = convert.gaussian_map_from_numpy(mapd, "cpu")
    for part in ("params", "aux", "mu", "nu"):
        for a, b in zip(getattr(m.gaussians, part).__dict__.values(),
                        getattr(port_map, part).__dict__.values()):
            close(a, b, 0)
    assert m.gaussians.count == 7
    for f in jm.vstore._fields:
        close(getattr(m.vstore, f).float(),
              np.asarray(getattr(jm.vstore, f)).astype(np.float32), 0)
    sd = convert.uncertainty_params_from_jax(
        jax.tree.map(np.asarray, jm.uncer_params))
    for k, v in m.uncer_mlp.state_dict().items():
        close(v, sd[k], 0)
    assert m.uncer_adam.count == 11
    close(m.uncer_adam.mu[0], np.asarray(
        jm.uncer_mu["params"]["fc1"]["kernel"]).T, 0)
    assert (m.current_window, m.video_idxs, m.frame_idxs) == (
        [2, 0], [0, 1, 2], [0, 2, 4])
    assert m.is_kf == {0: True, 1: False, 2: True}
    assert (m.iteration_count, m.iters_after_densify) == (17, 5)
    close(m.occ_aware_visibility[0], mapd["aux"]["alive"], 0)
    close(m.cam_w2c_old[2], m.vstore.w2c[2], 0)
    for name in tckpt.GRAPH_LISTS:
        np.testing.assert_array_equal(getattr(g, name), getattr(graph, name))
    for name in ("net", "inp", "target", "weight", "target_inac",
                 "weight_inac", "damping"):
        close(getattr(g, name), np.asarray(getattr(graph, name)), 0)
    # the volumes rebuilt from the loaded fmaps are the graph's own
    ref = tfg.FactorGraph(tsl.state, None, max_factors=g.max_factors)
    ref.add_factors(graph.ii, graph.jj)
    close(g.corr[:4].float(), ref.corr[:4].float(), 0)
    assert (tsl.frontend.t1, tsl.frontend.is_initialized,
            tsl.frontend.num_keyframes_dropped) == (3, True, 1)
    assert tsl.motion_filter.count == 2
    close(tsl.motion_filter.fmap, st.store.fmaps[2], 0)


def resume_cfg(out):
    cfg = slam_cfg(tload_config, out)
    cfg["scene"] = "resume"
    cfg["fast_mode"] = True
    t = cfg["tracking"]
    t["uncertainty_params"]["activate"] = True
    cfg["mapping"]["uncertainty_params"]["activate"] = True
    t["frontend"]["enable_loop"] = False
    t["backend"].update(ba_freq=100, final_ba=False)
    return cfg


def resume_slam(cfg, stream, feats):
    model = __import__("wildgs_slam_tpu_torch.models.droid_net",
                       fromlist=["x"]).init_droid_net(
        torch.Generator().manual_seed(0), device="cpu")

    def feat_fn(im):
        # a function of the image alone, so every run sees the same priors
        return feats[int(np.asarray(im).sum() * 1e3) % len(feats)]
    s = TSLAM(cfg, stream, depth_fn=stream.depth_fn, feat_fn=feat_fn,
              model=model, device="cpu")
    w2c, dsm = (torch.from_numpy(stream.w2c),
                torch.from_numpy(stream.disps_small))

    def oracle(store, counter):
        ts = store.timestamp.long().clamp(0, len(stream) - 1)
        return w2c[ts], dsm[ts]
    s.frontend.graph.gt_injection = s.backend.gt_injection = oracle
    return s


def test_kill_and_resume_matches_uninterrupted(tmp_path):
    stream = PlaneStream(12)
    feats = np.random.RandomState(1).rand(16, SH // 14, SW // 14, 384
                                          ).astype(np.float32)
    a = resume_slam(resume_cfg(str(tmp_path / "a")), stream, feats)
    a.run()
    cfg_b = resume_cfg(str(tmp_path / "b"))
    cfg_b.update(max_frames=8, checkpoint_every=2)
    b = resume_slam(cfg_b, stream, feats)
    b.terminate = lambda: None           # killed: no final pipeline
    b.run()
    ckpt = tmp_path / "b" / "resume" / "checkpoint.npz"
    assert ckpt.exists()
    c = resume_slam(resume_cfg(str(tmp_path / "b")), stream, feats)
    c.run(resume_path=str(ckpt))
    n = a.state.counter
    assert c.state.counter == n == 12
    close(c.state.store.poses[:n], a.state.store.poses[:n], 1e-5)
    ga, gc = a.mapper.gaussians, c.mapper.gaussians
    assert torch.equal(ga.aux.alive, gc.aux.alive)
    close(gc.params.xyz[gc.aux.alive], ga.params.xyz[ga.aux.alive], 1e-4)
    out = tmp_path / "b" / "resume"
    for f in ("video.npz", "final_gs.ply", "cfg.yaml", "map_viewer.html",
              "uncertainty_mlp_weight.pth"):
        assert (out / f).stat().st_size > 0, f


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

TH, TW = 48, 64     # the frames on disk; read at SH x SW
N_TUM = 8


def plane_render(c2w, H, W, intr):
    """Image and depth of PlaneStream's textured plane (world z = 2)."""
    fx, fy, cx, cy = intr
    yy, xx = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    dirs = np.stack([(xx - cx) / fx, (yy - cy) / fy, np.ones_like(xx)], -1)
    d = dirs @ c2w[:3, :3].T
    s = (2.0 - c2w[2, 3]) / d[..., 2]
    x, y = (c2w[:3, 3] + s[..., None] * d)[..., :2].transpose(2, 0, 1)
    img = np.stack([0.5 + 0.4 * np.sin(7.0 * x) * np.cos(5.0 * y),
                    0.5 + 0.4 * np.cos(6.0 * y + 2.0 * x),
                    0.5 + 0.3 * np.sin(4.0 * (x + y))], -1)
    return np.clip(img, 0, 1), s


@pytest.fixture(scope="module")
def tum_scene(tmp_path_factory):
    """A TUM folder of PlaneStream's motion at 48x64, seeded prior
    checkpoints in upstream names, and a config that reads them."""
    from scipy.spatial.transform import Rotation

    root = tmp_path_factory.mktemp("tum")
    poses = PlaneStream(N_TUM).poses
    intr = (45.0 * TW / SW, 45.0 * TH / SH, TW / 2.0, TH / 2.0)
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    lines = {"rgb.txt": [], "depth.txt": [], "groundtruth.txt": []}
    for i, c2w in enumerate(poses):
        t = f"{1.0 + 0.05 * i:.6f}"
        img, depth = plane_render(c2w, TH, TW, intr)
        cv2.imwrite(str(root / "rgb" / f"{t}.png"),
                    np.round(img[..., ::-1] * 255).astype(np.uint8))
        cv2.imwrite(str(root / "depth" / f"{t}.png"),
                    np.round(depth * 5000).astype(np.uint16))
        lines["rgb.txt"].append(f"{t} rgb/{t}.png")
        lines["depth.txt"].append(f"{t} depth/{t}.png")
        q = Rotation.from_matrix(c2w[:3, :3]).as_quat()
        lines["groundtruth.txt"].append(
            f"{t} " + " ".join(f"{v:.9f}" for v in (*c2w[:3, 3], *q)))
    for name, ls in lines.items():
        (root / name).write_text("# a\n# b\n# c\n" + "\n".join(ls))
    ckpts = tmp_path_factory.mktemp("pretrained")
    gen = torch.Generator().manual_seed(0)
    for model, name in (
            (tdpt.DepthAnythingV2("vits", 20.0),
             "depth_anything_v2_metric_hypersim_vits.pth"),
            (tdino.make_dinov2("vits", num_register_tokens=4),
             "fit3d_dinov2_reg_small_fine.pth")):
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
        torch.save(model.state_dict(), ckpts / name)
    cfg = {"inherit_from": os.path.abspath("configs/wildgs_slam.yaml"),
           "scene": "tum_entry", "dataset": "tumrgbd", "verbose": False,
           "data": {"input_folder": str(root)},
           "cam": {"H": TH, "W": TW, "fx": intr[0], "fy": intr[1],
                   "cx": intr[2], "cy": intr[3], "H_out": SH, "W_out": SW,
                   "H_edge": 0, "W_edge": 0, "png_depth_scale": 5000.0},
           "mono_prior": {"depth": "metric3d_vit_small",
                          "feature_extractor": "dinov2_reg_small_fine"},
           "fast_mode": True,
           "tracking": {"buffer": 12, "warmup": 4,
                        "force_keyframe_every_n_frames": 1,
                        "motion_filter": {"thresh": 1e9},
                        "frontend": {"window": 5, "max_factors": 24,
                                     "enable_loop": False},
                        "backend": {"ba_freq": 100, "final_ba": False}},
           "mapping": {"gaussian_capacity": 2048,
                       "render_list_capacity": 128,
                       "Training": {"init_itr_num": 4, "mapping_itr_num": 2,
                                    "window_size": 3,
                                    "init_gaussian_update": 5,
                                    "init_gaussian_reset": 6}}}
    return root, str(ckpts), cfg


def write_cfg(tmp_path, cfg, out):
    cfg = dict(cfg, data=dict(cfg["data"], output=str(out)))
    path = tmp_path / f"{os.path.basename(str(out))}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def exact_priors(slam, stream, intr):
    """The plane's exact depth at the read intrinsics in place of the
    seeded depth network, keyed by the frames the reader returns; and the
    oracle (ground-truth poses and 1/8-resolution disparities)."""
    depth, w2c, disps = {}, [], []
    sh, sw = tks.slice_hw(SH, SW)
    for i in range(len(stream)):
        _, img, _, c2w = stream[i]
        _, d = plane_render(np.asarray(c2w, np.float64), SH, SW, intr)
        depth[hashlib.sha1(img.tobytes()).digest()] = d.astype(np.float32)
        w2c.append(tlie.se3_inv(tlie.se3_from_matrix(torch.as_tensor(
            np.asarray(c2w), dtype=torch.float32))).numpy())
        disps.append(1.0 / d[sh, sw])
    slam.motion_filter.depth_fn = \
        lambda im: depth[hashlib.sha1(im.tobytes()).digest()]
    return np.stack(w2c).astype(np.float32), np.stack(disps).astype(
        np.float32)


def test_entry_point_writes_what_the_jax_run_writes(tmp_path, tum_scene,
                                                    monkeypatch):
    from wildgs_slam_tpu.models.priors import make_prior_fns
    from wildgs_slam_tpu.ops import dba as jdba
    from wildgs_slam_tpu.slam.system import SLAM as JSLAM
    from wildgs_slam_tpu.utils.datasets import get_dataset

    monkeypatch.setattr(jdba, "ba_iteration", jax.jit(
        jdba.ba_iteration, static_argnames=("cfg", "motion_only", "pmax")))
    root, ckpts, cfg = tum_scene
    cfg_port = write_cfg(tmp_path, cfg, tmp_path / "port")
    _, slam, resume = trun.build([cfg_port, "--device", "cpu",
                                  "--pretrained", ckpts])
    assert resume is None and slam.device.type == "cpu"
    w2c, disps = exact_priors(slam, slam.stream, slam.stream.intrinsic)
    w2c_t, disps_t = torch.from_numpy(w2c), torch.from_numpy(disps)

    def oracle_t(store, counter):
        ts = store.timestamp.long().clamp(0, N_TUM - 1)
        return w2c_t[ts], disps_t[ts]
    slam.frontend.graph.gt_injection = slam.backend.gt_injection = oracle_t
    slam.run()

    # the JAX run.py path: load_config, get_dataset, make_prior_fns, SLAM
    jcfg = load_config(write_cfg(tmp_path, cfg, tmp_path / "jax"))
    jout = os.path.join(jcfg["data"]["output"], jcfg["scene"])
    os.makedirs(jout)
    jstream = get_dataset(jcfg)
    depth_fn, feat_fn = make_prior_fns(jcfg, jout, ckpt_dir=ckpts)
    js = JSLAM(jcfg, jstream, depth_fn=depth_fn, feat_fn=feat_fn)
    jw2c, jdisps = exact_priors(js, jstream, jstream.intrinsic)

    def oracle_j(store, counter):
        ts = np.clip(np.asarray(store.timestamp).astype(int), 0, N_TUM - 1)
        return jnp.asarray(jw2c[ts]), jnp.asarray(jdisps[ts])
    js.frontend.graph.gt_injection = js.backend.gt_injection = oracle_j
    js.run()

    def files(d):
        return sorted(os.path.relpath(os.path.join(p, f), d).replace(
            "uncertainty_mlp_weight.pkl", "uncertainty_mlp_weight.pth")
            for p, _, fs in os.walk(d) for f in fs)
    port_out = os.path.join(str(tmp_path / "port"), "tum_entry")
    assert files(port_out) == files(jout)
    assert "map_viewer.html" in files(port_out)
    # one feature call per keyframe, then one per frame in the trajectory
    # filler, each a file named by the call count
    assert len(os.listdir(os.path.join(port_out, "mono_priors",
                                       "features"))) == 2 * N_TUM
    for d in (port_out, jout):
        assert tev.read_metric(os.path.join(
            d, "traj", "kf_traj_metrics.txt")) < 0.01, d


def test_entry_point_refusals(tmp_path, tum_scene, monkeypatch, capsys):
    root, ckpts, cfg = tum_scene
    path = write_cfg(tmp_path, cfg, tmp_path / "out")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        trun.build([path])
    # --mesh N asks for N cards: make_mesh's message when fewer are visible
    with pytest.raises(ValueError, match="parallel.n_devices=2 but only 0 "
                                         "devices visible"):
        trun.build([path, "--device", "cpu", "--mesh", "2",
                    "--pretrained", ckpts])
    # no checkpoints: the reference's fallback, on one line, and the run
    # goes on without metric depth and without uncertainty
    cfg_, slam, _ = trun.build([path, "--device", "cpu", "--pretrained",
                                str(tmp_path / "none")])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "mono priors unavailable" in ln]
    assert len(lines) == 1
    for switch in ("tracking.backend.metric_depth_reg",
                   "tracking.uncertainty_params.activate",
                   "mapping.uncertainty_params.activate"):
        assert switch in lines[0]
    assert not (slam.state.metric_depth_reg or slam.uncertainty_aware
                or slam.mapper.uncertainty_aware)
    assert slam.motion_filter.depth_fn is None
    # and runs to its end on the oracle (no prior to fill holes from)
    w2c, disps = (torch.from_numpy(a) for a in exact_priors(
        slam, slam.stream, slam.stream.intrinsic))
    slam.motion_filter.depth_fn = None

    def oracle(store, counter):
        ts = store.timestamp.long().clamp(0, N_TUM - 1)
        return w2c[ts], disps[ts]
    slam.frontend.graph.gt_injection = slam.backend.gt_injection = oracle
    slam.run()
    assert slam.state.counter == N_TUM
    # every keyframe filled, and again as BA moves it
    assert slam.mapper.fills > N_TUM and slam.mapper.invalid_keyframes == 0
    out = os.path.join(cfg_["data"]["output"], cfg_["scene"])
    assert tev.read_metric(os.path.join(out, "traj",
                                        "kf_traj_metrics.txt")) < 0.01
    assert os.path.getsize(os.path.join(out, "final_gs.ply")) > 0
