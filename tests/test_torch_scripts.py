"""The port's measuring programs and their helpers on the CPU.

- ``PhaseTimer.add`` / ``summary`` / ``write`` / ``report`` equal to the JAX
  ``PhaseTimer``'s on the same ``add`` calls (the same floats, the same
  columns), beside the port's own self time and device columns.
- ``keyframe_store.backproject_pointcloud`` and ``reprojection_map``
  against the JAX functions on a seeded store, within 1e-5 abs + 1e-5 rel
  (float32 elementwise math in both).
- ``profile_pipeline``'s synthetic TUM scene, written by the port's own
  PNG writer: the 16-bit depth files decode to the written values exactly,
  the colour files to the JAX script's cv2 channel order, and the port's
  TUM reader equals the JAX reader on them (colour within one level, depth
  equal, as tests/test_torch_datasets.py).
- ``summarize_pose_eval`` writes the CSV byte-equal to the JAX script's.
- The profile scripts run end to end with ``--device cpu`` at small sizes
  (seconds each); ``profile_pipeline``'s ``profile_summary.json`` holds the
  ``map.*`` and ``track.*`` phases and its ``_meta``.
"""

import copy
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildgs_slam_tpu.ops import lie as jlie
from wildgs_slam_tpu.slam import keyframe_store as jks
from wildgs_slam_tpu.utils import datasets as jds
from wildgs_slam_tpu.utils.profiling import PhaseTimer as JTimer
from wildgs_slam_tpu_torch.scripts import (profile_map_opt,
                                           profile_mapping_raster,
                                           profile_pipeline,
                                           profile_rasterizer,
                                           summarize_pose_eval)
from wildgs_slam_tpu_torch.slam import keyframe_store as tks
from wildgs_slam_tpu_torch.utils import datasets as tds
from wildgs_slam_tpu_torch.utils.png import read_png
from wildgs_slam_tpu_torch.utils.profiling import PhaseTimer as TTimer

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _cells(report):
    """The report's rows below its rule, split into their cells."""
    return [re.split(r"\s{2,}", line.strip())
            for line in report.splitlines()[2:]]


def test_phase_timer_matches_jax(tmp_path):
    """The JAX timer's keys and columns, the same values; the port adds
    ``self_s`` (the whole call: `add` records no children) and the
    self and device columns."""
    calls = [("a", 1.5), ("b", 0.25), ("a", 0.125), ("a", 0.5), ("c", 3.0),
             ("b", 0.75)] + [("d", 0.001 * k) for k in range(70)]
    jt, tt = JTimer(), TTimer()
    for name, dt in calls:
        jt.add(name, dt)
        tt.add(name, dt)
    js, ts = jt.summary(), tt.summary()
    assert set(ts) == set(js)
    for name in js:
        assert {k: v for k, v in ts[name].items() if k != "self_s"} == js[
            name]
        assert ts[name]["self_s"] == ts[name]["total_s"]
    assert set(ts["a"]) == {"count", "first_s", "warm_mean_ms", "total_s",
                            "self_s"}
    assert ts["a"]["count"] == 3
    jrows, trows = _cells(jt.report()), _cells(tt.report())
    assert [r[:6] for r in trows] == jrows
    assert all(r[6] == r[5] and r[7] == "-" for r in trows)
    jt.write(str(tmp_path / "j.txt"))
    tt.write(str(tmp_path / "t.txt"))
    assert _cells((tmp_path / "t.txt").read_text()) == trows
    assert _cells((tmp_path / "j.txt").read_text()) == jrows
    assert (tmp_path / "t.txt").read_text().endswith("\n")


def stores():
    """A JAX and a port store holding the same 4 seeded keyframes."""
    rng = np.random.RandomState(5)
    ht, wd = 32, 48
    intr = np.array([40.0, 42.0, 23.5, 15.5])
    js = jks.create(4, ht, wd, intr)
    ts = tks.create(4, ht, wd, intr, device="cpu")
    xi = np.concatenate([0.1 * rng.normal(size=(4, 3)),
                         0.05 * rng.normal(size=(4, 3))], -1)
    poses = np.asarray(jlie.se3_exp(jnp.asarray(xi.astype(np.float32))))
    disps = rng.uniform(0.2, 1.0, (4, ht // 8, wd // 8)).astype(np.float32)
    up = rng.uniform(0.2, 1.0, (4, ht, wd)).astype(np.float32)
    up[1, :3, :5] = 0.0                       # invalid depth
    js = js._replace(poses=jnp.asarray(poses), disps=jnp.asarray(disps),
                     disps_up=jnp.asarray(up))
    ts.poses.copy_(torch.from_numpy(poses.copy()))
    ts.disps.copy_(torch.from_numpy(disps))
    ts.disps_up.copy_(torch.from_numpy(up))
    return js, ts


@pytest.mark.parametrize("up", [True, False])
def test_backproject_pointcloud_matches_jax(up):
    js, ts = stores()
    for index in (0, 1, 3):
        jp, jv = jks.backproject_pointcloud(js, index, up=up)
        tp, tv = tks.backproject_pointcloud(ts, index, up=up)
        np.testing.assert_allclose(tp, jp, atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(tv, jv)
    assert not bool(tks.backproject_pointcloud(ts, 1)[1].all())


def test_reprojection_map_matches_jax():
    js, ts = stores()
    ii, jj = np.array([0, 1, 2, 3]), np.array([1, 2, 0, 0])
    jc, jv = jks.reprojection_map(js, ii, jj)
    tc, tv = tks.reprojection_map(ts, ii, jj)
    assert tuple(tc.shape) == (4, 4, 6, 3)
    np.testing.assert_allclose(tc, jc, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tv, jv)


def test_profile_pipeline_scene_round_trips(tmp_path):
    args = profile_pipeline.parse_args(
        ["--h", "24", "--w", "32", "--frames", "3", "--out", str(tmp_path)])
    root = str(tmp_path / "tum")
    profile_pipeline.make_tum_scene(root, 3, 24, 32)
    yy, xx = np.meshgrid(np.arange(48), np.arange(64), indexing="ij")
    depth = ((2.0 + 0.5 * np.sin(0.01 * xx) * np.cos(0.01 * yy))
             * 5000).astype(np.uint16)
    for i in range(3):
        t = f"{100.0 + i * 0.1:.6f}"
        d = read_png(os.path.join(root, "depth", f"{t}.png"))
        assert d.dtype == np.uint16
        np.testing.assert_array_equal(d, depth)
        np.testing.assert_array_equal(
            cv2.imread(os.path.join(root, "depth", f"{t}.png"),
                       cv2.IMREAD_UNCHANGED), depth)
        img = np.stack([128 + 100 * np.sin(0.05 * (xx - 4 * i)),
                        128 + 100 * np.cos(0.04 * (yy + 3 * i)),
                        128 + 80 * np.sin(0.03 * (xx + yy - 2 * i))],
                       -1).clip(0, 255).astype(np.uint8)
        # cv2 reads back what the JAX script's cv2.imwrite(img) stored
        np.testing.assert_array_equal(
            cv2.imread(os.path.join(root, "rgb", f"{t}.png")), img)
    cfg = profile_pipeline.pipeline_config(args, root)
    js, ts = jds.get_dataset(copy.deepcopy(cfg)), tds.get_dataset(cfg)
    assert len(js) == len(ts) == 3
    for i in range(3):
        ji, jc, jd, jp = js[i]
        ti, tc, td, tp = ts[i]
        assert ti == ji and tc.shape == jc.shape == (24, 32, 3)
        assert np.abs(tc - jc).max() <= 1.0 / 255 + 1e-7
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tp, jp)


def _jax_summarizer():
    spec = importlib.util.spec_from_file_location(
        "jax_summarize_pose_eval", ROOT / "scripts" / "summarize_pose_eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_summarize_pose_eval_matches_jax_script(tmp_path, monkeypatch,
                                                capsys):
    out = tmp_path / "output"
    for name, rmse in (("scene_b", 0.01234), ("scene_a", 0.2), ("c", 0.005)):
        d = out / name / "traj"
        d.mkdir(parents=True)
        (d / "full_traj_metrics.txt").write_text(
            f"rmse: {rmse}\nmean: 0.1\nnote: text\n")
    (out / "no_metrics").mkdir()
    (out / "scene_x" / "traj").mkdir(parents=True)
    (out / "scene_x" / "traj" / "full_traj_metrics.txt").write_text("max: 1\n")
    monkeypatch.setattr(sys, "argv", ["summarize_pose_eval.py", str(out),
                                      "--out_csv", str(tmp_path / "j.csv")])
    _jax_summarizer().main()
    path = summarize_pose_eval.main([str(out)])
    assert path == str(out / "pose_eval.csv")
    assert (out / "pose_eval.csv").read_bytes() == (tmp_path / "j.csv"
                                                    ).read_bytes()
    assert (out / "pose_eval.csv").read_text().startswith(
        "scene,ate_rmse_cm\nc,0.50\n")
    empty = tmp_path / "empty"
    empty.mkdir()
    assert summarize_pose_eval.main([str(empty)]) is None
    assert "no metrics found" in capsys.readouterr().out


def test_profile_rasterizer_on_cpu(tmp_path):
    out = profile_rasterizer.main(["--device", "cpu", "--iters", "1",
                                   str(tmp_path / "trace")])
    assert out["wall_ms"] > 0 and out["device_ms"] is None
    assert (tmp_path / "trace" / "trace.json").exists()


def test_profile_mapping_raster_step_on_cpu():
    s = profile_mapping_raster.make_scene(0, n=500, image_size=(48, 64))
    assert s["means"].shape == (500, 3)
    z = s["means"][:, 2]
    assert np.all((z >= 1.0) & (z < 5.0))
    ts = {k: torch.as_tensor(v) for k, v in s.items()}
    m, sc, o, acc = profile_mapping_raster.run_pass(ts, 2)
    assert bool(torch.isfinite(acc)) and float(acc) > 0
    assert float((m - ts["means"]).abs().max()) > 0


def test_profile_map_opt_segment_on_cpu():
    mapper = profile_map_opt.build_mapper(2, 6, "cpu", ht=48, wd=64)
    mapper.initialize_mapper(cur_video_idx=5)
    assert mapper.bin_method == "sort_norev"
    assert mapper.render_list_capacity == 512
    xyz = mapper.gaussians.params.xyz.clone()
    mapper.map_opt_online(mapper.current_window, iters=2)
    assert float((mapper.gaussians.params.xyz - xyz).abs().max()) > 0


def test_profile_global_ba_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m",
         "wildgs_slam_tpu_torch.scripts.profile_global_ba", "--device",
         "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "GB_FRAMES": "6", "GB_H": "48", "GB_W": "64",
             "GB_BUF": "8"})
    assert out.returncode == 0, out.stderr
    for label in ("online dense_ba(2)", "final dense_ba(7)",
                  "final dense_ba(12)"):
        assert f"[gb] {label}: cold" in out.stdout
    assert "track.lowmem.step" in out.stdout


def test_profile_pipeline_on_cpu(tmp_path):
    summary = profile_pipeline.main(
        ["--device", "cpu", "--h", "48", "--w", "64", "--frames", "10",
         "--mapping_iters", "2", "--init_iters", "4", "--final_refine", "2",
         "--capacity", "4096", "--fast_mode", "--out", str(tmp_path)])
    with open(tmp_path / "profile_summary.json") as f:
        on_disk = json.load(f)
    assert on_disk == json.loads(json.dumps(summary))
    phases = [k for k in on_disk if k != "_meta"]
    assert any(k.startswith("map.") for k in phases)
    assert any(k.startswith("track.") for k in phases)
    assert {"count", "first_s", "warm_mean_ms", "total_s", "self_s"} == set(
        on_disk["map.initialize"])
    meta = on_disk["_meta"]
    assert meta["frames"] == 10 and meta["device"] == "cpu"
    assert (tmp_path / "out" / "profile" / "profile.txt").exists()


def test_profile_scripts_stop_without_a_card():
    for mod in ("profile_rasterizer", "profile_pipeline", "ab_bin_kw",
                "ab_update_eps", "microbench_motion_filter",
                "microbench_frontend"):
        out = subprocess.run(
            [sys.executable, "-m", f"wildgs_slam_tpu_torch.scripts.{mod}"],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert "no CUDA device" in out.stderr, mod
