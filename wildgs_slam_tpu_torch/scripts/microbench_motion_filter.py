"""The motion filter's cost per frame at pipeline scale.

    python -m wildgs_slam_tpu_torch.scripts.microbench_motion_filter
        [--h 384 --w 512 --frames 30 --buffer 64]
        [--device cuda|cpu]

The motion filter runs on every frame, so its time per frame bounds the
pipeline's frame rate from below. This drives ``MotionFilter.track`` on
`frames` random 384x512 images (8 drawn with numpy seed 0, in turn) with a
constant depth of 2 m, random 384-d features and seeded DROID weights
(``init_droid_net``, generator seed 0); its threshold is 1e9, so a
keyframe is made every 3 frames by force, as the reference's cadence.
It prints the mean, median and max wall time per frame over the frames
after the first 6, the TIMER's ``track.mf.*`` phases, then the device ms
and device operations per frame over PROFILE_FRAMES (6) more frames under
torch.profiler (on the CPU: not measured). The defaults are the JAX
script's (its MF_H, MF_W, MF_FRAMES and MF_BUF); the port has one form of
the filter, so the JAX script's WILDGS_MF_FUSED switch has no counterpart.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models import droid_net
from ..slam.motion_filter import MotionFilter
from ..slam.state import SlamState
from ..utils.profiling import TIMER, card_line, profile_steps, run_device

WARM_FROM = 6          # frames left out of the per-frame statistics
FORCE_EVERY = 3
PROFILE_FRAMES = 6     # frames under torch.profiler after the timed ones


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m wildgs_slam_tpu_torch.scripts."
             "microbench_motion_filter")
    p.add_argument("--h", type=int, default=384)
    p.add_argument("--w", type=int, default=512)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--buffer", type=int, default=64)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = run_device(args.device)
    if device.type == "cuda":
        print(f"card: {card_line()}")
    ht, wd = args.h, args.w
    print(f"[mf] device={device} {ht}x{wd} frames={args.frames}", flush=True)
    intr = np.array([260.0, 260.0, wd / 2, ht / 2])
    state = SlamState.create({}, ht, wd, intr, buffer=args.buffer,
                             device=device)
    model = droid_net.init_droid_net(torch.Generator().manual_seed(0),
                                     device=device)
    rng = np.random.RandomState(0)
    imgs = [rng.rand(ht, wd, 3).astype(np.float32) for _ in range(8)]

    def depth_fn(image):
        return np.full((ht, wd), 2.0, np.float32)

    def feat_fn(image):
        return rng.rand(ht // 14, wd // 14, 384).astype(np.float32)
    mf = MotionFilter(state, model, thresh=1e9,
                      force_keyframe_every_n_frames=FORCE_EVERY,
                      depth_fn=depth_fn, feat_fn=feat_fn)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()
    TIMER.reset()
    times = []
    for i in range(args.frames):
        t0 = time.perf_counter()
        mf.track(float(i), imgs[i % len(imgs)])
        sync()
        times.append(time.perf_counter() - t0)
    warm = np.asarray(times[WARM_FROM:] or times) * 1e3
    out = {"mean_ms": float(warm.mean()), "p50_ms": float(np.median(warm)),
           "max_ms": float(warm.max()), "first_ms": times[0] * 1e3,
           "keyframes": state.counter}
    print(f"[mf] per-frame: mean {out['mean_ms']:.1f} ms  p50 "
          f"{out['p50_ms']:.1f}  max {out['max_ms']:.1f}  (first "
          f"{out['first_ms']:.0f}; {state.counter} keyframes)", flush=True)
    print(TIMER.report(), flush=True)
    out["phases"] = TIMER.summary()

    first = args.frames

    def window():
        for i in range(first, first + PROFILE_FRAMES):
            mf.track(float(i), imgs[i % len(imgs)])
    prof = profile_steps(window, PROFILE_FRAMES, top=10)
    out["profile"] = prof
    if prof["device_ms"] is None:
        print("[mf] device ms and operations per frame: not measured")
    else:
        print(f"[mf] device {prof['device_ms']:.2f} ms per frame (busy "
              f"{prof['busy_ms']:.2f}) of {prof['wall_ms']:.2f} ms wall, "
              f"{prof['device_ops']:.0f} device operations per frame",
              flush=True)
    return out


if __name__ == "__main__":
    main()
