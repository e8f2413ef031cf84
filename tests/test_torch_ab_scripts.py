"""The port's A/B programs and microbenches on the CPU.

- ``ab_bin_kw``: ``radius_stats`` and ``render_ab((4, 3, 2))`` on a seeded
  map (``build_scene`` at 48x64, its scales widened so that windows and
  lists overflow) against the JAX ``project_gaussians`` and
  ``mapper._fast_render`` (the XLA ``render`` on the CPU) on the same
  Gaussians: radius percentiles and overflow counts exact, colour within
  1e-5 and depth within 1e-4 at each kw, and the deltas against kw 4
  as the JAX script computes them; ``Mapper.bin_kw`` is the window of every
  render of the optimisation step (``time_segment``).
- ``ab_update_eps``: the scene writer against
  ``tests/test_integrated_ate.py::write_scene`` (``groundtruth.txt`` within
  1e-6; colour and depth PNGs, read with cv2, equal but for +-1 at no more
  than 0.1% of pixels, from float32 rounding in ``se3_matrix``), and one
  ``run_once`` under the oracle with an early exit (fewer BA steps than
  asked, keyframe ATE under 1 cm).
- ``microbench_motion_filter`` and ``microbench_frontend`` end to end with
  ``--device cpu`` at 48x64.
"""

import math

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_integrated_ate as jate
from wildgs_slam_tpu.ops.rasterizer.projection import (
    project_gaussians as jproject)
from wildgs_slam_tpu.slam.mapper import _fast_render
from wildgs_slam_tpu_torch.scripts import (ab_bin_kw, ab_update_eps,
                                           microbench_frontend,
                                           microbench_motion_filter)
from wildgs_slam_tpu_torch.utils.png import read_png

torch.set_num_threads(1)
H, W = 48, 64
CPU = torch.device("cpu")
WIDEN = math.log(3.0)      # added to the log-scales: radii up to ~3 tiles


@pytest.fixture(scope="module")
def mapper():
    m = ab_bin_kw.build_scene(2, CPU, H, W)
    with torch.no_grad():
        m.gaussians.params.scaling.add_(WIDEN)
    return m


def jax_inputs(m):
    *args, alive = ab_bin_kw.view_inputs(m)
    return [jnp.asarray(a.detach().numpy()) for a in args], jnp.asarray(
        alive.numpy())


def test_radius_stats_matches_jax(mapper):
    args, alive = jax_inputs(mapper)
    proj = jproject(*args, (H, W))
    rad = np.asarray(proj.radius)[np.asarray(proj.valid & alive)]
    got = ab_bin_kw.radius_stats(mapper)
    assert got["n"] == rad.size > 1000
    for q in ab_bin_kw.PERCENTILES:
        assert got[f"p{q:g}"] == np.percentile(rad, q), q
    assert got["max"] == rad.max() > 16       # wider than one tile


def test_render_ab_matches_jax_fast_render(mapper):
    args, alive = jax_inputs(mapper)
    res, outs = ab_bin_kw.render_ab(mapper, (4, 3, 2))
    jout = {}
    for kw in (4, 3, 2):
        j = _fast_render(*args, (H, W), alive=alive, capacity=512, chunk=64,
                         bin_method="sort", bin_kw=kw)
        jout[kw] = j
        t = outs[kw]
        assert res[kw]["overflow"] == int(j.overflow), kw
        np.testing.assert_allclose(t.color, j.color, atol=1e-5, rtol=0)
        np.testing.assert_allclose(t.depth, j.depth, atol=1e-4, rtol=0)
    # narrower windows truncate more; kw 4 covers the 4 tile columns, and
    # what it drops are the entries past a full list's 512
    assert res[4]["overflow"] < res[3]["overflow"] < res[2]["overflow"]
    assert res[4]["truncated"] == 0 < res[4]["dropped"]
    assert 0 < res[3]["truncated"] < res[2]["truncated"]
    for kw in (4, 3, 2):
        assert (res[kw]["truncated"] + res[kw]["dropped"]
                == res[kw]["overflow"])
    for kw in (3, 2):
        dc = float(jnp.abs(jout[kw].color - jout[4].color).max())
        dd = float(jnp.abs(jout[kw].depth - jout[4].depth).max())
        mse = float(jnp.mean((jout[kw].color - jout[4].color) ** 2))
        assert res[kw]["dcolor"] == pytest.approx(dc, abs=2e-5)
        assert res[kw]["ddepth"] == pytest.approx(dd, abs=2e-4)
        assert res[kw]["psnr"] == pytest.approx(
            10 * np.log10(1.0 / max(mse, 1e-20)), abs=1e-2)
        assert dc > 0


def test_bin_kw_reaches_every_optimisation_render(mapper, monkeypatch):
    from wildgs_slam_tpu_torch.slam import mapper as tmapper

    seen = []
    plain = tmapper.render

    def recording(*a, **k):
        seen.append(k["bin_kw"])
        return plain(*a, **k)
    monkeypatch.setattr(tmapper, "render", recording)
    kw0 = mapper.bin_kw
    try:
        ms = ab_bin_kw.time_segment(mapper, 3, 2, reps=1)
    finally:
        mapper.bin_kw = kw0
    assert ms > 0
    # 2 segments of 2 steps, and the covisibility renders after each
    assert len(seen) >= 4 and set(seen) == {3}


def test_scene_writer_matches_jax(tmp_path):
    n = jate.N_FRAMES
    assert (ab_update_eps.H, ab_update_eps.W, ab_update_eps.N_FRAMES) == (
        jate.H, jate.W, n)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jate.write_scene(jroot, jate.gt_trajectory(n))
    ab_update_eps.write_scene(troot, ab_update_eps.gt_trajectory(n))
    for name in ("rgb.txt", "depth.txt"):
        assert (tmp_path / "port" / name).read_text() == (
            tmp_path / "jax" / name).read_text()

    def gt(root):
        lines = (tmp_path / root / "groundtruth.txt").read_text().splitlines()
        return np.array([[float(v) for v in ln.split()]
                         for ln in lines if not ln.startswith("#")])
    np.testing.assert_allclose(gt("port"), gt("jax"), atol=1e-6, rtol=0)
    off = total = 0
    for i in range(n):
        for kind, flag in (("rgb", cv2.IMREAD_COLOR),
                           ("depth", cv2.IMREAD_UNCHANGED)):
            name = f"{kind}/{float(i):.6f}.png"
            j = cv2.imread(str(tmp_path / "jax" / name), flag)
            t = read_png(str(tmp_path / "port" / name))
            if kind == "rgb":
                t = t[..., ::-1]
            np.testing.assert_array_equal(
                cv2.imread(str(tmp_path / "port" / name), flag), t)
            d = np.abs(t.astype(np.int64) - j.astype(np.int64))
            assert d.max() <= 1, (name, d.max())
            off += int((d > 0).sum())
            total += d.size
    assert off <= 1e-3 * total, (off, total)


def test_update_eps_run_exits_early(tmp_path):
    r = ab_update_eps.run_once(0.05, str(tmp_path / "tum"),
                               str(tmp_path / "out"), CPU)
    assert r["calls"] > 0
    assert 0 < r["steps"] < r["asked"]
    assert r["steps"] >= r["calls"]          # each call runs at least once
    assert r["rmse"] < 0.01


def test_microbench_motion_filter_on_cpu(capsys):
    out = microbench_motion_filter.main(
        ["--device", "cpu", "--h", str(H), "--w", str(W), "--frames", "10",
         "--buffer", "16"])
    text = capsys.readouterr().out
    assert "[mf] per-frame: mean" in text and "track.mf.flow" in text
    assert "not measured" in text
    assert out["keyframes"] == 4                 # frames 0, 3, 6, 9
    assert out["mean_ms"] > 0 and out["profile"]["device_ms"] is None
    assert {"track.mf.encode_fmap", "track.mf.flow",
            "track.mf.encode_ctx"} <= set(out["phases"])


def test_microbench_frontend_on_cpu(capsys):
    out = microbench_frontend.main(
        ["--device", "cpu", "--h", str(H), "--w", str(W), "--reps", "2"])
    text = capsys.readouterr().out
    assert "[mb] warm update: min" in text
    assert "per-frame frontend cost at 12 updates/frame" in text
    assert out["edges"] == 58                  # |i - j| in {1, 2} of 16
    assert 0 < out["min_ms"] <= out["mean_ms"]
    assert out["profile"]["device_ms"] is None
