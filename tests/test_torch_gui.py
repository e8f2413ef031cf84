"""The file GUI (``gui/file_gui.py``), the live half of ``gui/html_viewer.py``,
the PNG writer and the mapper's GUI hook, against the JAX package and
matplotlib.

Tolerances, and why:
- the ``GaussianPacket`` of ``Mapper._send_to_gui`` on the same map and
  views: colours, uncertainty, trajectory and map arrays within 1e-5, the
  rendered depth within 1e-4 (tests/test_torch_rasterizer.py's forward
  bounds: float32 sums in another order), frame index, window and count
  exact;
- ``index.html``, ``live.html`` and ``map.json``: byte-equal to what the
  JAX ``FileGui`` writes for the same packets;
- the PNG panels: decoded, equal to matplotlib's ``to_rgba(..., bytes=True)``
  of the same data (the bytes ``imshow`` colours), and the colour tables
  equal to ``matplotlib.colormaps``;
- ``write_png``: equal after ``cv2.imread`` for every row filter.
"""

import os

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
from matplotlib.cm import ScalarMappable
from matplotlib.colors import Normalize

from wildgs_slam_tpu.config import load_config
from wildgs_slam_tpu.gui import file_gui as jgui
from wildgs_slam_tpu.models.uncertainty import UncertaintyMLP as JMLP
from wildgs_slam_tpu.slam import gaussian_map as jgm
from wildgs_slam_tpu.slam import keyframe_store as jks
from wildgs_slam_tpu.slam import mapper as jmapper
from wildgs_slam_tpu.slam.state import SlamState as JState
from wildgs_slam_tpu_torch import convert
from wildgs_slam_tpu_torch.config import load_config as tload_config
from wildgs_slam_tpu_torch.gui import FileGui, GaussianPacket
from wildgs_slam_tpu_torch.gui import file_gui as tgui
from wildgs_slam_tpu_torch.models.uncertainty import UncertaintyMLP as TMLP
from wildgs_slam_tpu_torch.slam import gaussian_map as tgm
from wildgs_slam_tpu_torch.slam import keyframe_store as tks
from wildgs_slam_tpu_torch.slam import mapper as tmapper
from wildgs_slam_tpu_torch.slam.state import SlamState as TState
from wildgs_slam_tpu_torch.utils import png

from test_torch_mapper import CFG_PATH, H, W, scene, small_cfg

torch.set_num_threads(1)


def close(port, ref, atol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol)


class Recorder:
    """Stands in for the GUI: keeps the packets pushed to it."""

    def __init__(self):
        self.packets = []

    def push(self, pkt):
        self.packets.append(pkt)


def mapper_packets():
    """Both packages' mappers with the same 3 keyframes in their view stores
    and the same 400 seeded Gaussians; each pushes keyframe 2."""
    cfg = small_cfg(load_config(CFG_PATH))
    intr, frames = scene()
    B = cfg["tracking"]["buffer"]
    js = JState.create(cfg, H, W, intr, buffer=B)
    ts = TState.create(cfg, H, W, intr, buffer=B, device="cpu")
    for i, (pose, depth, img, dino) in enumerate(frames[:3]):
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
    jm = jmapper.Mapper(js, cfg, uncer_params=params, rng_seed=0)
    tm = tmapper.Mapper(ts, cfg, uncer_mlp=mlp, rng_seed=0, device="cpu")

    rng = np.random.RandomState(3)
    n = 400
    f32 = lambda a: np.asarray(a, np.float32)
    fields = dict(
        xyz=f32(np.c_[rng.uniform(-1.2, 1.2, (n, 2)),
                      rng.uniform(2.0, 3.0, n)]),
        f_dc=f32(rng.normal(size=(n, 1, 3))),
        f_rest=np.zeros((n, 0, 3), np.float32),
        opacity=f32(rng.normal(size=(n, 1)) + 1),
        scaling=f32(np.log(rng.uniform(0.03, 0.1, (n, 3)))),
        rotation=f32(rng.normal(size=(n, 4))))
    valid = np.ones(n, bool)
    jm.gaussians, _ = jgm.extend(jm.gaussians, jgm.GaussianParams(**{
        k: jnp.asarray(v) for k, v in fields.items()}), jnp.asarray(valid), 1)
    tgm.extend(tm.gaussians, tgm.GaussianParams(**{
        k: torch.from_numpy(v) for k, v in fields.items()}),
        torch.from_numpy(valid), 1)
    for m in (jm, tm):
        for v in range(3):
            m._make_viewpoint(v)
            m.video_idxs.append(v)
            m.is_kf[v] = v != 1
        m.current_window = [2, 0]
        m.gui = Recorder()
        m._send_to_gui(2)
    return jm.gui.packets[0], tm.gui.packets[0]


def test_send_to_gui_packet_follows_jax():
    jp, tp = mapper_packets()
    assert (tp.frame_idx, tp.window, tp.n_gaussians) == (
        jp.frame_idx, jp.window, jp.n_gaussians) == (2, [2, 0], 400)
    for name, atol in (("gt_color", 0), ("rendered_color", 1e-5),
                       ("rendered_depth", 1e-4), ("uncertainty", 1e-5),
                       ("traj_xyz", 1e-5), ("map_xyz", 0), ("map_rgb", 1e-6),
                       ("map_scale", 1e-6)):
        a, b = getattr(tp, name), getattr(jp, name)
        assert a.shape == np.asarray(b).shape and a.dtype == np.float32, name
        close(a, b, atol)
    assert tp.traj_xyz.shape == (2, 3)          # keyframes 0 and 2
    assert tp.rendered_color.max() > 0.1


def packets(n_map, seed=0):
    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.rand(*s).astype(np.float32)
    return GaussianPacket(
        frame_idx=7, gt_color=f32(24, 32, 3),
        rendered_color=f32(24, 32, 3) * 1.2 - 0.1,
        rendered_depth=1.0 + f32(24, 32), uncertainty=f32(4, 5) * 3,
        traj_xyz=f32(6, 3), window=[7, 3, 1], n_gaussians=n_map,
        map_xyz=f32(n_map, 3), map_rgb=f32(n_map, 3) * 1.4 - 0.2,
        map_scale=f32(n_map))


@pytest.mark.parametrize("http_port", [None, 8123])
def test_file_gui_writes_what_jax_writes(tmp_path, http_port):
    tg = FileGui(str(tmp_path / "port"), http_port=http_port)
    jg = jgui.FileGui(str(tmp_path / "jax"), http_port=http_port)
    for pkt in (packets(500), packets(61000, seed=1)):   # the second thinned
        tg.push(pkt)
        jg.push(jgui.GaussianPacket(**vars(pkt)))
        for name in ("index.html", "live.html", "map.json"):
            with open(os.path.join(tg.dir, name), "rb") as f, \
                    open(os.path.join(jg.dir, name), "rb") as g:
                assert f.read() == g.read(), name
    assert sorted(os.listdir(tg.dir)) == sorted(os.listdir(jg.dir))

    def rgba_bytes(x, cmap=None):
        sm = ScalarMappable(Normalize() if cmap else None,
                            matplotlib.colormaps[cmap] if cmap else None)
        return sm.to_rgba(x, bytes=True)[..., :3]
    read = lambda name: png.read_png(os.path.join(tg.dir, name))
    side = np.concatenate([pkt.gt_color, pkt.rendered_color], 1)
    np.testing.assert_array_equal(read("render.png"),
                                  rgba_bytes(np.clip(side, 0, 1)))
    np.testing.assert_array_equal(read("depth.png"),
                                  rgba_bytes(pkt.rendered_depth, "plasma"))
    np.testing.assert_array_equal(read("uncertainty.png"),
                                  rgba_bytes(pkt.uncertainty, "jet"))
    traj = read("traj.png")
    assert traj.shape == tgui.TRAJ_HW + (3,)
    reds = np.all(traj == tgui.TRAJ_LAST, -1)
    cyans = np.all(traj == tgui.TRAJ_LINE, -1)
    assert reds.sum() == 49 and cyans.sum() > 6 * 9


def test_colour_tables_equal_matplotlib():
    for name in ("plasma", "jet"):
        np.testing.assert_array_equal(
            tgui.LUTS[name],
            matplotlib.colormaps[name](np.arange(256), bytes=True)[:, :3])
    flat = np.full((3, 4), 2.5, np.float32)      # min == max: the first bin
    np.testing.assert_array_equal(tgui.colormap_bytes(flat, "jet"),
                                  np.broadcast_to(tgui.LUTS["jet"][0],
                                                  (3, 4, 3)))


def test_write_png_round_trips_through_cv2(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(0)
    images = (rng.randint(0, 256, (17, 23, 3)).astype(np.uint8),
              rng.randint(0, 256, (9, 31)).astype(np.uint8),
              rng.randint(0, 65536, (13, 7)).astype(np.uint16))
    path = str(tmp_path / "x.png")
    for a in images:
        for filters in ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)):
            png.write_png(path, a, filters)
            back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(
                back[..., ::-1] if a.ndim == 3 else back, a)
            np.testing.assert_array_equal(png.read_png(path), a)
    with pytest.raises(ValueError, match="cannot write"):
        png.write_png(path, np.zeros((4, 4, 3), np.uint16))


def test_gui_gets_the_control_channels_port(tmp_path):
    """With gui on, SLAM publishes the control channel's HTTP port in
    cfg["_gui_http_port"] before the mapper builds its FileGui, so that the
    GUI's buttons point at it."""
    from wildgs_slam_tpu_torch.models import droid_net as tdn
    from wildgs_slam_tpu_torch.slam.system import SLAM

    from test_torch_system import PlaneStream, slam_cfg

    cfg = slam_cfg(tload_config, str(tmp_path))
    cfg["gui"] = True
    model = tdn.init_droid_net(torch.Generator().manual_seed(0), device="cpu")
    slam = SLAM(cfg, PlaneStream(2), model=model, device="cpu")
    try:
        port = slam.control.http_port
        assert isinstance(port, int) and port > 0
        assert cfg["_gui_http_port"] == port == slam.mapper.gui.http_port
        assert slam.mapper.gui.dir == os.path.join(str(tmp_path), "oracle",
                                                   "gui")
    finally:
        slam.control.close()
