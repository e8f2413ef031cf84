"""The port's bench (``python -m wildgs_slam_tpu_torch.bench``) on the CPU.

The bench's step (its scene's distributions and loss, the gradients of
means, scales, opacities and the pose delta, the SGD step) through the
port's ``render_fused`` on its plain versions, against the JAX
``render_pallas`` in interpret mode with the same binning
(``sort_norev``), capacity, chunk and window, for 2 chained iterations;
the scene is the bench's at a small size (300 Gaussians at 48x64, the
intrinsics scaled with the width) so that interpret mode takes seconds.
Tolerances are test_torch_rasterizer.py's for this pair: the loss within
1e-5 relative (it sums the colour within atol 1e-5 and the depth within
1e-4), every gradient max-relative 1e-5.

The program itself runs with ``--device cpu`` and BENCH_ITERS=2 and must
print its one-line JSON result with its keys; without ``--device cpu``
and without a card it stops with a message.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from wildgs_slam_tpu.ops import rasterizer as jr
from wildgs_slam_tpu_torch import bench

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SIZE = (48, 64)
N = 300


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def jax_loss_and_grads(s, means, scales, opac):
    def f(m, sc, o, pd):
        out = jr.render_pallas(
            m, sc, jnp.asarray(s["rots"]), o, jnp.asarray(s["sh"]),
            jnp.asarray(s["w2c"]), jnp.asarray(s["intr"]), SIZE,
            pose_delta=pd, bin_method="sort_norev", interpret=True,
            **bench.render_kw())
        return (jnp.mean((out.color - s["target"]) ** 2)
                + 0.01 * jnp.mean(out.depth ** 2))
    return jax.value_and_grad(f, argnums=(0, 1, 2, 3))(
        means, scales, opac, jnp.zeros(6))


def test_bench_step_matches_render_pallas():
    s = bench.make_scene(0, n=N, image_size=SIZE)
    ts = bench.to_device(s, "cpu")
    jm, js_, jo = (jnp.asarray(s[k]) for k in ("means", "scales", "opac"))
    tm, ts_, to = ts["means"], ts["scales"], ts["opac"]
    for _ in range(2):
        jl, jg = jax_loss_and_grads(s, jm, js_, jo)
        tl, tg = bench.loss_and_grads(ts, tm, ts_, to)
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
        for a, b in zip(tg, jg):
            assert max_rel(a, b) < 1e-5, max_rel(a, b)
        assert float(np.abs(np.asarray(jg[3])).max()) > 0   # pose gradient
        jm, js_, jo = (jm - bench.LR * jg[0], js_ - bench.LR * jg[1],
                       jo - bench.LR * jg[2])
        tm, ts_, to = (tm - bench.LR * tg[0], ts_ - bench.LR * tg[1],
                       to - bench.LR * tg[2])


def test_bench_scene_distributions():
    s = bench.make_scene(0)
    assert s["means"].shape == (bench.N_GAUSS, 3)
    assert s["target"].shape == (bench.H, bench.W, 3)
    assert np.all(np.abs(s["means"][:, :2]) <= 1.5)
    assert np.all((s["means"][:, 2] >= 1.5) & (s["means"][:, 2] < 4.5))
    assert np.all((s["scales"] >= 0.01) & (s["scales"] < 0.06))
    np.testing.assert_allclose(np.linalg.norm(s["rots"], axis=-1), 1,
                               rtol=1e-6)
    assert np.all((s["opac"] >= 0.2) & (s["opac"] < 0.9))
    np.testing.assert_array_equal(s["intr"], [260, 260, 160, 120])
    np.testing.assert_array_equal(s["means"], bench.make_scene(0)["means"])


def run_bench(args, **env):
    return subprocess.run(
        [sys.executable, "-m", "wildgs_slam_tpu_torch.bench", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **env})


def test_bench_json_line_on_cpu():
    out = run_bench(["--device", "cpu"], BENCH_ITERS="2")
    assert out.returncode == 0, out.stderr
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(last) == {"metric", "value", "unit", "kernel_check",
                         "kernel_relerr", "bin_overflow", "bin_method"}
    assert last["metric"] == "rasterize_fwd_bwd_pose_grad_5k_320x240"
    assert last["unit"] == "rays/s/cpu" and last["value"] > 0
    assert last["kernel_check"] == "ok"
    assert set(last["kernel_relerr"]) == {"color", "depth", "alpha", "grad"}
    assert isinstance(last["bin_overflow"], int)
    assert last["bin_method"] == "sort_norev"
    assert "device time not measured (CPU)" in out.stdout


def test_bench_stops_without_a_card():
    out = run_bench([])
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr
    assert out.stdout.strip() == ""
