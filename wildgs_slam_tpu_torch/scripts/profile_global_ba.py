"""The global BA's cost at pipeline scale: ``Backend.dense_ba`` on a
synthetic keyframe store.

    python -m wildgs_slam_tpu_torch.scripts.profile_global_ba
        [--device cuda|cpu]

Environment, as the JAX script reads it: GB_FRAMES (25 keyframes), GB_H
and GB_W (384x512), GB_BUF (64 store slots). The store holds forward-moving
poses, disparities 0.5 + 0.05 U, random feature, context and GRU maps and a
constant mono depth of 2; the DROID weights are seeded random ones
(``init_droid_net``, generator seed 0), uncertainty off. It times
``dense_ba(2)`` (the online global BA), then ``dense_ba(7)`` and
``dense_ba(12)`` (the final pair), each cold and then warm, and prints the
TIMER's ``track.lowmem.*`` phases. The JAX script's GB_ALT (an A/B of two
JAX forms of ``alt_corr``) has no counterpart: the port has one form.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..config import load_config
from ..models import droid_net
from ..ops import lie
from ..slam import keyframe_store as kstore
from ..slam.backend import Backend
from ..slam.state import SlamState
from ..utils.profiling import TIMER, card_line, run_device

REPO = Path(__file__).resolve().parents[2]
F = int(os.environ.get("GB_FRAMES", "25"))
HT = int(os.environ.get("GB_H", "384"))
WD = int(os.environ.get("GB_W", "512"))
BUF = int(os.environ.get("GB_BUF", "64"))


def build_backend(device):
    """The Backend over the synthetic store of F keyframes."""
    cfg = load_config(str(REPO / "configs" / "wildgs_slam.yaml"))
    cfg["tracking"]["buffer"] = BUF
    intr = np.array([260.0, 260.0, WD / 2, HT / 2])
    state = SlamState.create(cfg, HT, WD, intr, buffer=BUF,
                             uncertainty_aware=False, device=device)
    model = droid_net.init_droid_net(torch.Generator().manual_seed(0),
                                     device=device)
    rng = np.random.RandomState(0)
    h, w = HT // 8, WD // 8
    for i in range(F):
        xi = torch.tensor([0.06 * i, 0.01 * np.sin(0.4 * i), 0.01 * i, 0.0,
                           0.02 * i, 0.0])
        kstore.append(
            state.store, i, float(i), pose=lie.se3_exp(xi),
            disp=0.5 + 0.05 * rng.rand(h, w).astype(np.float32),
            mono_depth_up=np.full((HT, WD), 2.0, np.float32),
            fmap=0.5 * rng.randn(h, w, 128).astype(np.float32),
            net=0.1 * rng.randn(h, w, 128).astype(np.float32),
            inp=0.1 * rng.randn(h, w, 128).astype(np.float32))
    state.counter = F
    return Backend(state, model, cfg)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m wildgs_slam_tpu_torch.scripts.profile_global_ba")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = run_device(args.device)
    if device.type == "cuda":
        print(f"card: {card_line()}")
    print(f"[gb] device={device} F={F} {HT}x{WD} buffer {BUF}", flush=True)
    backend = build_backend(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()
    times = {}
    for label, steps in (("online dense_ba(2)", 2), ("final dense_ba(7)", 7),
                         ("final dense_ba(12)", 12)):
        runs = []
        for _ in range(2):                    # cold, then warm
            t0 = time.perf_counter()
            _, edges = backend.dense_ba(steps)
            sync()
            runs.append(time.perf_counter() - t0)
        times[label] = {"cold_s": runs[0], "warm_s": runs[1], "edges": edges}
        print(f"[gb] {label}: cold {runs[0]:.3f} s, warm {runs[1]:.3f} s "
              f"(edges={edges})", flush=True)
    print(TIMER.report(), flush=True)
    return times


if __name__ == "__main__":
    main()
