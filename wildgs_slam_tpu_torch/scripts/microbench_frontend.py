"""The frontend's graph update, warm, at full tracking resolution.

    python -m wildgs_slam_tpu_torch.scripts.microbench_frontend [--h 384
        --w 512 --frames 16 --edges 48 --reps 5] [--device cuda|cpu]

Ingests `frames` synthetic keyframes (a drifting sinusoidal texture,
constant depth 2 m) through ``MotionFilter(thresh=-1)`` with seeded DROID
weights (``init_droid_net``, generator seed 0), builds
``FactorGraph(state, model, max_factors=edges)`` and adds the
neighbourhood edges of radius 2 (their correlation volumes built), then
runs one warm ``update(use_inactive=True)`` and times `reps` more. It
prints the min and mean ms per update and the frontend's cost per frame
at 12 updates per frame, then the device ms and device operations per
update over one more update under torch.profiler (on the CPU: not
measured). The JAX script's xplane trace (--trace_dir) has no counterpart
here: ``utils/profiling.trace`` is the port's form of it.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..config import load_config
from ..models import droid_net
from ..slam.factor_graph import FactorGraph
from ..slam.motion_filter import MotionFilter
from ..slam.state import SlamState
from ..utils.profiling import card_line, profile_steps, run_device

REPO = Path(__file__).resolve().parents[2]
UPDATES_PER_FRAME = 12


def synth_image(t, ht, wd):
    y, x = np.meshgrid(np.arange(ht), np.arange(wd), indexing="ij")
    img = np.stack([
        0.5 + 0.5 * np.sin(0.05 * (x - 4 * t)),
        0.5 + 0.5 * np.cos(0.04 * (y + 3 * t)),
        0.5 + 0.4 * np.sin(0.03 * (x + y - 2 * t)),
    ], -1).astype(np.float32)
    return np.clip(img, 0, 1)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m wildgs_slam_tpu_torch.scripts.microbench_frontend")
    p.add_argument("--h", type=int, default=384)
    p.add_argument("--w", type=int, default=512)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--edges", type=int, default=48)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = run_device(args.device)
    if device.type == "cuda":
        print(f"card: {card_line()}")
    ht, wd = args.h, args.w
    print(f"[mb] device={device} image {ht}x{wd} features "
          f"{ht // 8}x{wd // 8}", flush=True)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()
    cfg = load_config(str(REPO / "configs" / "wildgs_slam.yaml"))
    cfg["tracking"]["buffer"] = args.frames + 2
    intr = np.array([wd * 1.2, wd * 1.2, wd / 2, ht / 2])
    state = SlamState.create(cfg, ht, wd, intr,
                             buffer=cfg["tracking"]["buffer"], device=device)
    model = droid_net.init_droid_net(torch.Generator().manual_seed(0),
                                     device=device)

    t0 = time.perf_counter()
    mf = MotionFilter(state, model, thresh=-1.0,
                      depth_fn=lambda im: np.full((ht, wd), 2.0, np.float32))
    for t in range(args.frames):
        mf.track(float(t), synth_image(t, ht, wd))
    sync()
    print(f"[mb] {args.frames} keyframes ingested in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    g = FactorGraph(state, model, max_factors=args.edges)
    t0 = time.perf_counter()
    g.add_neighborhood_factors(0, args.frames, r=2)
    sync()
    print(f"[mb] E={g.E} edges added (correlation volumes built) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    g.update(None, None, use_inactive=True)
    sync()
    print(f"[mb] first update {time.perf_counter() - t0:.3f} s", flush=True)
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        g.update(None, None, use_inactive=True)
        sync()
        times.append(time.perf_counter() - t0)
    out = {"edges": g.E, "min_ms": min(times) * 1e3,
           "mean_ms": float(np.mean(times)) * 1e3}
    print(f"[mb] warm update: min {out['min_ms']:.1f} ms  mean "
          f"{out['mean_ms']:.1f} ms  over {args.reps} reps", flush=True)
    print(f"[mb] per-frame frontend cost at {UPDATES_PER_FRAME} "
          f"updates/frame: {UPDATES_PER_FRAME * min(times):.2f} s",
          flush=True)

    prof = profile_steps(lambda: g.update(None, None, use_inactive=True), 1,
                         top=10)
    out["profile"] = prof
    if prof["device_ms"] is None:
        print("[mb] device ms and operations per update: not measured")
    else:
        print(f"[mb] device {prof['device_ms']:.2f} ms per update (busy "
              f"{prof['busy_ms']:.2f}) of {prof['wall_ms']:.2f} ms wall, "
              f"{prof['device_ops']:.0f} device operations per update",
              flush=True)
    return out


if __name__ == "__main__":
    main()
