"""The rasterizer forward and backward at mapping scale, timed and
profiled: the shapes the mapper renders at 384x512 (``profile_pipeline``),
N = 131,072 Gaussians, 768 tiles, render_list_capacity 512, ``sort_norev``
binning (the port's one method).

    python -m wildgs_slam_tpu_torch.scripts.profile_mapping_raster [outdir]
        [--iters 5] [--device cuda|cpu]

Each step renders through ``render_fused``, takes the bench's loss and
its gradients with respect to means, scales, opacities and a zero pose
delta, and an SGD step of 1e-7 (the capacity drops join the accumulator,
as in the JAX script). Prints the best of 3 timed passes of `iters` steps
in ms per step and Mrays/s, then profiles one pass.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ops import rasterizer as tr
from ..utils.profiling import card_line, profile_steps, run_device

N = 131072
H, W = 384, 512
CAPACITY = 512
CHUNK = 64
FOCAL = 520.0
LR = 1e-7


def make_scene(seed: int = 0, n: int = N, image_size=(H, W)):
    """Gaussians spread over the image at depths 1-5 (the JAX script's
    distributions, drawn with numpy), and a uniform target."""
    h, w = image_size
    rng = np.random.default_rng(seed)
    px = rng.uniform(size=n) * w
    py = rng.uniform(size=n) * h
    z = 1.0 + rng.uniform(size=n) * 4.0
    means = np.stack([(px - w / 2) * z / FOCAL, (py - h / 2) * z / FOCAL, z],
                     -1)
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=-1, keepdims=True)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(means=f32(means),
                scales=f32(0.002 + 0.008 * rng.uniform(size=(n, 3))),
                rots=f32(rots), opac=f32(rng.uniform(size=n) * 0.8 + 0.1),
                sh=f32(rng.uniform(size=(n, 1, 3))),
                w2c=f32([0, 0, 0, 0, 0, 0, 1]),
                intr=f32([FOCAL, FOCAL, w / 2, h / 2]),
                target=f32(rng.uniform(size=(h, w, 3))))


def step(s, means, scales, opac, acc):
    params = [x.detach().requires_grad_(True) for x in (means, scales, opac)]
    pd = torch.zeros(6, device=means.device, requires_grad=True)
    out = tr.render_fused(params[0], params[1], s["rots"], params[2],
                          s["sh"], s["w2c"], s["intr"],
                          tuple(s["target"].shape[:2]), pose_delta=pd,
                          capacity=CAPACITY, chunk=CHUNK)
    loss = (((out.color - s["target"]) ** 2).mean()
            + 0.01 * (out.depth ** 2).mean())
    gm, gs, go, gp = torch.autograd.grad(loss, params + [pd])
    return (means - LR * gm, scales - LR * gs, opac - LR * go,
            acc + loss.detach() + (gp ** 2).sum()
            + out.overflow.to(acc.dtype) * 1e-12)


def run_pass(s, iters):
    carry = (s["means"], s["scales"], s["opac"],
             torch.zeros((), device=s["means"].device))
    for _ in range(iters):
        carry = step(s, *carry)
    if carry[0].is_cuda:
        torch.cuda.synchronize()
    return carry


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m wildgs_slam_tpu_torch.scripts.profile_mapping_raster")
    p.add_argument("outdir", nargs="?", default=None,
                   help="write the Chrome trace here")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = run_device(args.device)
    if device.type == "cuda":
        print(f"card: {card_line()}")
    s = {k: torch.as_tensor(v, device=device)
         for k, v in make_scene().items()}
    run_pass(s, args.iters)                           # warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run_pass(s, args.iters)
        best = min(best, time.perf_counter() - t0)
    ms = best / args.iters * 1e3
    print(f"[map-raster] N={N} {H}x{W} capacity {CAPACITY} sort_norev: "
          f"{ms:.3f} ms per step, {H * W * args.iters / best / 1e6:.1f} "
          f"Mrays/s (wall, best of 3 passes of {args.iters})")
    out = profile_steps(lambda: run_pass(s, args.iters), args.iters,
                        args.outdir)
    out["best_wall_ms"] = ms
    return out


if __name__ == "__main__":
    main()
