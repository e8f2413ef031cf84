"""The mapper's optimisation segment (``Mapper._opt_segment``, through
``map_opt_online``) timed and profiled at full scale.

    python -m wildgs_slam_tpu_torch.scripts.profile_map_opt [outdir] [K]
        [n_kf] [--device cuda|cpu]

A ``Mapper`` on the JAX script's synthetic scene: 384x512, n_kf (8)
keyframes stepping 5 cm along x with a textured wall for colour, depth
2 + 0.3 U and random DINO features, configs/wildgs_slam.yaml with
gaussian_capacity 131,072, render_list_capacity 512 (PM_CAP), window 8 and
K (64) iterations per segment. After initialize_mapper it runs one online
segment of K iterations (the first), times 3 more and keeps the best, then
profiles one. The JAX script's bin_method argument is not taken: the
port's mapper bins by sort only.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..config import load_config
from ..ops import lie
from ..slam import gaussian_map as gm
from ..slam import keyframe_store as kstore
from ..slam.mapper import Mapper
from ..slam.state import SlamState
from ..utils.profiling import card_line, profile_steps, run_device

REPO = Path(__file__).resolve().parents[2]
HT, WD = 384, 512


def textured_wall(t, ht=HT, wd=WD):
    y, x = np.meshgrid(np.arange(ht), np.arange(wd), indexing="ij")
    img = np.stack([0.5 + 0.4 * np.sin(0.05 * x + t),
                    0.5 + 0.4 * np.cos(0.04 * y),
                    0.5 + 0.3 * np.sin(0.03 * (x + y))], -1)
    return np.clip(img, 0, 1).astype(np.float32)


def build_mapper(K, n_kf, device, ht=HT, wd=WD):
    """The Mapper on the synthetic scene, before initialize_mapper."""
    cfg = load_config(str(REPO / "configs" / "wildgs_slam.yaml"))
    tr = cfg["mapping"]["Training"]
    tr["init_itr_num"] = K
    tr["mapping_itr_num"] = K
    tr["window_size"] = 8
    cfg["mapping"]["gaussian_capacity"] = 131072
    cfg["mapping"]["render_list_capacity"] = int(os.environ.get("PM_CAP",
                                                                "512"))
    cfg["tracking"]["buffer"] = n_kf + 2
    intr = np.array([wd * 1.2, wd * 1.2, wd / 2, ht / 2])
    state = SlamState.create(cfg, ht, wd, intr,
                             buffer=cfg["tracking"]["buffer"], device=device)
    rng = np.random.RandomState(0)
    for i in range(n_kf):
        xi = torch.zeros(6)
        xi[0] = 0.05 * i
        depth = (2.0 + 0.3 * rng.rand(ht, wd)).astype(np.float32)
        kstore.append(state.store, i, float(i), pose=lie.se3_exp(xi),
                      disp=np.full((ht // 8, wd // 8), 0.5, np.float32),
                      mono_depth_up=depth)
        dino = rng.rand(ht // 14, wd // 14, 384).astype(np.float32)
        state.append_host(i, textured_wall(i, ht, wd), dino, float(i))
    return Mapper(state, cfg, rng_seed=0, device=device)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m wildgs_slam_tpu_torch.scripts.profile_map_opt")
    p.add_argument("outdir", nargs="?", default=None,
                   help="write the Chrome trace here")
    p.add_argument("K", nargs="?", type=int, default=64)
    p.add_argument("n_kf", nargs="?", type=int, default=8)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = run_device(args.device)
    if device.type == "cuda":
        print(f"card: {card_line()}")
    K = args.K

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()
    mapper = build_mapper(K, args.n_kf, device)
    t0 = time.perf_counter()
    mapper.initialize_mapper(cur_video_idx=args.n_kf - 1)
    sync()
    print(f"[mapopt] init {time.perf_counter() - t0:.1f} s, alive "
          f"{int(gm.num_alive(mapper.gaussians))}", flush=True)
    t0 = time.perf_counter()
    mapper.map_opt_online(mapper.current_window, iters=K)
    sync()
    print(f"[mapopt] first online segment ({K} it) "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        mapper.map_opt_online(mapper.current_window, iters=K)
        sync()
        best = min(best, time.perf_counter() - t0)
    print(f"[mapopt] warm segment: {best:.3f} s = {best / K * 1e3:.2f} ms "
          f"per iteration (bin_method={mapper.bin_method})", flush=True)
    out = profile_steps(
        lambda: mapper.map_opt_online(mapper.current_window, iters=K), K,
        args.outdir)
    out["warm_ms_per_iter"] = best / K * 1e3
    return out


if __name__ == "__main__":
    main()
