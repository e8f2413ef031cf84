"""Benchmark of the port's main path: the rasterizer forward and backward
with the pose gradient and an SGD step, on the card; the port of the
repository's root ``bench.py``.

    python -m wildgs_slam_tpu_torch.bench [--device cuda|cpu] [--seed 0]

The scene has ``bench.py``'s distributions: 5,000 Gaussians, means xy
uniform in [-1.5, 1.5) and z in [1.5, 4.5), scales 0.01 + 0.05 U,
normalised normal quaternions, opacity 0.2 + 0.7 U, SH (N, 1, 3) uniform,
seen at 240x320 through intrinsics (260, 260, 160, 120) from the identity
pose, against a uniform target. The draws come from
``numpy.random.default_rng(seed)``: JAX's PRNG cannot be replayed without
JAX, so the scene is the same in distribution, not in value.

Each iteration renders through ``render_fused`` (K3, K1, then K2 and K4 in
the backward), takes the loss mean((colour - target)^2) + 0.01 mean(depth^2),
its gradients with respect to the means, scales, opacities and a zero pose
delta, an SGD step of 1e-6 on the first three, and accumulates
loss + sum(pose gradient^2): a data-dependent chain, as the mapper's. ITERS
iterations run in a host loop with one ``torch.cuda.synchronize()`` at the
end; one warm pass, then the best of 3 timed passes gives
value = H * W * ITERS / best in rays/s/chip. A last pass of
PROFILE_ITERS (20) steps runs under torch.profiler for the device time per
step: the profiler's processing on the host grows with the device
operations it recorded (about a thousand per step), so a whole 400-step
pass would take longer to read than to run.

The gate compares ``render_fused`` (the kernels) with the plain ``render``
on the same scene: colour, depth, alpha and the gradient of the colour
loss with respect to the means, each by its norm-relative error, under
``bench.py``'s limits.

Environment, as ``bench.py`` reads it: BENCH_ITERS (400), BENCH_CAPACITY
(192), BENCH_CHUNK (64), BENCH_BIN_KW (4). BENCH_BIN_METHOD and
BENCH_BIN_SEG_CAP are not read: they choose among the JAX package's binning
methods, and the port has one, ``sort_norev``, which the line names.

Earlier lines give the card and the wall and device ms per step; the last
line is one JSON object: metric, value, unit ("rays/s/chip"; "rays/s/cpu"
with --device cpu), kernel_check, kernel_relerr, bin_overflow, bin_method.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .ops import rasterizer as tr
from .utils.profiling import card_line, device_summary, run_device

N_GAUSS = 5000
H, W = 240, 320
ITERS = int(os.environ.get("BENCH_ITERS", "400"))
CAPACITY = int(os.environ.get("BENCH_CAPACITY", "192"))
CHUNK = int(os.environ.get("BENCH_CHUNK", "64"))
BIN_KW = int(os.environ.get("BENCH_BIN_KW", "4"))
BIN_METHOD = "sort_norev"
METRIC = "rasterize_fwd_bwd_pose_grad_5k_320x240"
LR = 1e-6
TIMED_PASSES = 3
PROFILE_ITERS = 20
GATE_LIMITS = {"color": 1e-2, "depth": 1e-2, "alpha": 1e-2, "grad": 5e-2}


def intrinsics(image_size=(H, W)):
    """(260, 260, 160, 120) at 240x320, scaled with the width."""
    h, w = image_size
    f = 260.0 * w / W
    return np.array([f, f, w / 2, h / 2], np.float32)


def make_scene(seed: int = 0, n: int = N_GAUSS, image_size=(H, W)):
    """The bench's scene as float32 numpy arrays (see the module's
    docstring): means, scales, rots, opac, sh, w2c, intr, target."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.uniform(size=(n, 2)) * 3 - 1.5,
                            1.5 + rng.uniform(size=(n, 1)) * 3.0], -1)
    scales = 0.01 + 0.05 * rng.uniform(size=(n, 3))
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=-1, keepdims=True)
    opac = 0.2 + 0.7 * rng.uniform(size=n)
    sh = rng.uniform(size=(n, 1, 3))
    target = rng.uniform(size=tuple(image_size) + (3,))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(means=f32(means), scales=f32(scales), rots=f32(rots),
                opac=f32(opac), sh=f32(sh),
                w2c=f32([0, 0, 0, 0, 0, 0, 1]),
                intr=intrinsics(image_size), target=f32(target))


def to_device(scene, device):
    return {k: torch.as_tensor(v, device=device) for k, v in scene.items()}


def render_kw():
    return dict(capacity=CAPACITY, chunk=CHUNK, bin_kw=BIN_KW)


def loss_fn(scene, means, scales, opac, pose_delta, renderer=tr.render_fused):
    """The bench's loss, and the render."""
    s = scene
    out = renderer(means, scales, s["rots"], opac, s["sh"], s["w2c"],
                   s["intr"], tuple(s["target"].shape[:2]),
                   pose_delta=pose_delta, **render_kw())
    return (((out.color - s["target"]) ** 2).mean()
            + 0.01 * (out.depth ** 2).mean()), out


def loss_and_grads(scene, means, scales, opac, renderer=tr.render_fused):
    """The loss and its gradients with respect to means, scales, opacities
    and a zero pose delta."""
    params = [x.detach().requires_grad_(True) for x in (means, scales, opac)]
    pd = torch.zeros(6, device=means.device, requires_grad=True)
    loss, _ = loss_fn(scene, *params, pd, renderer)
    return loss.detach(), torch.autograd.grad(loss, params + [pd])


def step(scene, means, scales, opac, acc, renderer=tr.render_fused):
    """One iteration: the gradients, the SGD step and the accumulator.
    Returns (means, scales, opac, acc)."""
    loss, (gm, gs, go, gp) = loss_and_grads(scene, means, scales, opac,
                                            renderer)
    return (means - LR * gm, scales - LR * gs, opac - LR * go,
            acc + loss + (gp ** 2).sum())


def run_pass(scene, iters=None):
    """`iters` (ITERS) chained steps from the scene's parameters, one
    synchronize at the end; returns the final carry."""
    carry = (scene["means"], scene["scales"], scene["opac"],
             torch.zeros((), device=scene["means"].device))
    for _ in range(ITERS if iters is None else iters):
        carry = step(scene, *carry)
    if carry[0].is_cuda:
        torch.cuda.synchronize()
    return carry


def relerr(a, b):
    a = a.detach().double()
    b = b.detach().double()
    return float(torch.linalg.norm(a - b) / (torch.linalg.norm(b) + 1e-12))


def kernel_gate(scene):
    """render_fused against the plain render on the same scene: colour,
    depth, alpha and the means gradient of the colour loss, norm-relative.
    Returns (check, errors, overflow)."""
    outs = {}
    for name, fn in (("fused", tr.render_fused), ("plain", tr.render)):
        m = scene["means"].detach().requires_grad_(True)
        pd = torch.zeros(6, device=m.device)
        out = fn(m, scene["scales"], scene["rots"], scene["opac"],
                 scene["sh"], scene["w2c"], scene["intr"],
                 tuple(scene["target"].shape[:2]), pose_delta=pd,
                 **render_kw())
        loss = ((out.color - scene["target"]) ** 2).mean()
        (g,) = torch.autograd.grad(loss, [m])
        outs[name] = (out, g)
    (fo, fg), (po, pg) = outs["fused"], outs["plain"]
    errs = {"color": relerr(fo.color, po.color),
            "depth": relerr(fo.depth, po.depth),
            "alpha": relerr(fo.alpha, po.alpha), "grad": relerr(fg, pg)}
    bad = [k for k in errs if not errs[k] < GATE_LIMITS[k]]
    check = "ok" if not bad else "FAIL:" + ",".join(
        f"{k}={errs[k]:.2e}" for k in bad)
    return check, errs, int(fo.overflow)


def profiled_pass(scene):
    """PROFILE_ITERS steps under torch.profiler: (wall s, device busy us,
    device operations' us, device operations)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_pass(scene, PROFILE_ITERS)
        wall = time.perf_counter() - t0
    busy, total, n_ops, _ = device_summary(prof)
    return wall, busy, total, n_ops


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m wildgs_slam_tpu_torch.bench")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the bench; prints its lines and returns {"result": the last
    line's object, "steps": render_fused steps run, "renders": the gate's
    render_fused calls}."""
    args = parse_args(argv)
    device = run_device(args.device)
    if device.type == "cuda":
        print(f"card: {card_line()}")
    scene = to_device(make_scene(args.seed), device)

    t0 = time.perf_counter()
    run_pass(scene)                                   # warm
    print(f"warm pass: {time.perf_counter() - t0:.3f} s for {ITERS} steps")
    best = float("inf")
    for _ in range(TIMED_PASSES):
        t0 = time.perf_counter()
        run_pass(scene)
        best = min(best, time.perf_counter() - t0)
    steps = ITERS * (1 + TIMED_PASSES)
    line = (f"wall {best / ITERS * 1e3:.4f} ms per step (best of "
            f"{TIMED_PASSES} passes of {ITERS})")
    if device.type == "cuda":
        wall, busy, total, n_ops = profiled_pass(scene)
        n = PROFILE_ITERS
        steps += n
        line += (f"; device {total / 1e3 / n:.4f} ms per step "
                 f"(torch.profiler over a pass of {n}: busy "
                 f"{busy / 1e3 / n:.4f} ms, {n_ops / n:.0f} device "
                 f"operations per step, wall {wall / n * 1e3:.4f} ms "
                 f"under the profiler)")
    else:
        line += "; device time not measured (CPU)"
    print(line)

    check, errs, overflow = kernel_gate(scene)
    result = {
        "metric": METRIC,
        "value": round(H * W * ITERS / best, 1),
        "unit": "rays/s/chip" if device.type == "cuda" else "rays/s/cpu",
        "kernel_check": check,
        "kernel_relerr": {k: round(v, 6) for k, v in errs.items()},
        "bin_overflow": overflow,
        "bin_method": BIN_METHOD,
    }
    print(json.dumps(result))
    return {"result": result, "steps": steps, "renders": 1}


if __name__ == "__main__":
    main()
