"""The port's mesh mode through the whole system, as
``tests/test_mesh_e2e.py``: ``SLAM.run()`` over an explicit CPU mesh
(``parallel.n_devices`` set as ``run.py --mesh`` sets it, and the mesh
passed as ``SLAM(..., mesh=)`` since this machine has no card), tracking
through the edge-sharded step and the mapper with its padded capacity and
sharded renderer, run as kill-and-resume and held against the port's
uninterrupted single-device run. Both runs fire one online global BA.

Tolerances are test_mesh_e2e.py's: the sharded paths sum in another order,
and that noise compounds through the update operator, BA and Adam over a
run: keyframe poses 2e-3, disparities 5e-3, alive count equal, the live
Gaussians' positions 5e-3.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_system_e2e import make_tum_scene  # noqa: E402

from wildgs_slam_tpu_torch.config import load_config  # noqa: E402
from wildgs_slam_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from wildgs_slam_tpu_torch.slam import gaussian_map as gm  # noqa: E402
from wildgs_slam_tpu_torch.slam.system import SLAM  # noqa: E402
from wildgs_slam_tpu_torch.utils.datasets import get_dataset  # noqa: E402
from wildgs_slam_tpu_torch.utils.profiling import TIMER  # noqa: E402

torch.set_num_threads(1)
H, W = 64, 80


def _cfg(tmp_path, root, n_devices, tag):
    cfg = load_config("configs/wildgs_slam.yaml")
    cfg["scene"] = f"mesh{tag}"
    cfg["dataset"] = "tumrgbd"
    cfg["data"]["input_folder"] = root
    cfg["data"]["output"] = str(tmp_path / f"out{tag}")
    cfg["cam"].update(H=H * 2, W=W * 2, fx=90.0, fy=90.0, cx=W * 1.0,
                      cy=H * 1.0, H_out=H, W_out=W, H_edge=0, W_edge=0)
    cfg["fast_mode"] = True
    cfg["parallel"]["n_devices"] = n_devices
    t = cfg["tracking"]
    t["buffer"] = 16
    t["warmup"] = 4
    t["force_keyframe_every_n_frames"] = 1
    t["motion_filter"]["thresh"] = 1e9
    t["frontend"].update(window=6, max_factors=32, enable_loop=False)
    t["backend"]["ba_freq"] = 3
    t["backend"]["final_ba"] = False
    m = cfg["mapping"]
    m["final_refine_iters"] = 0
    m["gaussian_capacity"] = 4096
    m["render_list_capacity"] = 512
    m["Training"].update(init_itr_num=8, mapping_itr_num=4, window_size=4,
                         init_gaussian_update=6, init_gaussian_reset=7)
    return cfg


def _run(cfg, mesh=None, resume_path=None, suppress_terminate=False):
    stream = get_dataset(cfg)
    rng = np.random.RandomState(0)
    feats = [rng.rand(H // 14, W // 14, 384).astype(np.float32)
             for _ in range(len(stream))]

    def feat_fn(im):
        # a function of the image, so every run sees the same features
        return feats[int(np.asarray(im).sum() * 1e3) % len(feats)]

    slam = SLAM(cfg, stream, depth_fn=lambda im: np.full((H, W), 2.0,
                                                         np.float32),
                feat_fn=feat_fn, device="cpu", mesh=mesh)
    if suppress_terminate:
        slam.terminate = lambda: None
    slam.run(resume_path=resume_path)
    return slam


def _mesh_matches_single(tmp_path, n_shards, n_frames, kill_at):
    root = str(tmp_path / "tum")
    make_tum_scene(root, n=n_frames, H=H, W=W)

    n_ba0 = TIMER.stats["track.online_global_ba"].count if (
        "track.online_global_ba" in TIMER.stats) else 0
    slam1 = _run(_cfg(tmp_path, root, 0, "single"))
    assert TIMER.stats["track.online_global_ba"].count > n_ba0, \
        "online global BA never fired"

    mesh = make_mesh(devices=["cpu"] * n_shards, axis="g")
    # leg A: killed after kill_at frames, with checkpoints
    cfg_a = _cfg(tmp_path, root, n_shards, "mesh")
    cfg_a["max_frames"] = kill_at
    cfg_a["checkpoint_every"] = 2
    _run(cfg_a, mesh, suppress_terminate=True)
    ckpt = os.path.join(str(tmp_path / "outmesh"), "meshmesh",
                        "checkpoint.npz")
    assert os.path.exists(ckpt), "mesh-mode checkpoint not written"

    # leg B: a fresh mesh system resumed from it, to the end
    slam8 = _run(_cfg(tmp_path, root, n_shards, "mesh"), mesh,
                 resume_path=ckpt)
    assert slam8.mesh is mesh and slam8.mapper.mesh is mesh
    assert slam8.frontend.graph.mesh is mesh
    assert slam8.mapper.mesh_render_fn is not None
    assert slam8.mapper.capacity % n_shards == 0

    n = slam1.state.counter
    assert slam8.state.counter == n
    np.testing.assert_allclose(slam8.state.store.poses[:n].numpy(),
                               slam1.state.store.poses[:n].numpy(),
                               atol=2e-3, err_msg="keyframe poses diverged")
    np.testing.assert_allclose(slam8.state.store.disps[:n].numpy(),
                               slam1.state.store.disps[:n].numpy(), atol=5e-3)
    a1 = gm.num_alive(slam1.mapper.gaussians)
    assert gm.num_alive(slam8.mapper.gaussians) == a1
    m1 = slam1.mapper.gaussians.aux.alive.numpy()
    x1 = slam1.mapper.gaussians.params.xyz.numpy()
    x8 = slam8.mapper.gaussians.params.xyz.numpy()
    np.testing.assert_allclose(x8[:len(m1)][m1], x1[m1], atol=5e-3)
    assert os.path.exists(os.path.join(str(tmp_path / "outmesh"),
                                       "meshmesh", "final_gs.ply"))


def test_mesh_system_two_shards(tmp_path):
    """The smaller case: 2 shards, 7 frames, killed at 5."""
    _mesh_matches_single(tmp_path, 2, 7, 5)


@pytest.mark.slow
def test_mesh_system_matches_single(tmp_path):
    """test_mesh_e2e.py's case: 8 shards, 9 frames, killed at 6."""
    _mesh_matches_single(tmp_path, 8, 9, 6)


def test_mesh_from_config_needs_cards(tmp_path):
    """parallel.n_devices > 1 without an explicit mesh asks for that many
    cards, and this machine has none."""
    root = str(tmp_path / "tum")
    make_tum_scene(root, n=2, H=H, W=W)
    with pytest.raises(ValueError, match="parallel.n_devices=8 but only 0 "
                                         "devices visible"):
        _run(_cfg(tmp_path, root, 8, "refused"))
