"""The whole system, timed phase by phase: ``SLAM.run()`` (tracking,
mapping and the final pipeline) on a synthetic TUM-format scene.

    python -m wildgs_slam_tpu_torch.scripts.profile_pipeline [--h 384
        --w 512 --frames 25 --out DIR --mapping_iters 60 --init_iters 128
        --final_refine 64 --capacity 131072 --fast_mode] [--device cuda|cpu]

The scene, the config edits (configs/wildgs_slam.yaml: every frame a
keyframe, warmup 8, frontend window 12 with 48 factors, online global BA
every 10 keyframes, render_list_capacity 512, window 8) and the constant
depth and feature functions are those of the JAX script; the frames are
written with the port's own PNG writer (colour at twice the output size,
depth 16-bit at 5000 per metre). A heartbeat line per frame read gives
the device memory allocated and its peak. At the end it prints the TIMER
table and writes it, with a ``_meta`` entry, to
DIR/profile_summary.json.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..config import load_config
from ..slam.system import SLAM
from ..utils.datasets import get_dataset
from ..utils.png import write_png
from ..utils.profiling import TIMER, card_line, run_device

REPO = Path(__file__).resolve().parents[2]


def make_tum_scene(root, n, H, W):
    """n frames of a drifting sinusoidal texture at 2H x 2W, depth
    (2 + 0.5 sin cos) m, ground truth moving 5 cm per frame along x."""
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_lines, depth_lines, gt_lines = [], [], []
    yy, xx = np.meshgrid(np.arange(H * 2), np.arange(W * 2), indexing="ij")
    depth = ((2.0 + 0.5 * np.sin(0.01 * xx) * np.cos(0.01 * yy))
             * 5000).astype(np.uint16)
    for i in range(n):
        t = 100.0 + i * 0.1
        img = np.stack([
            128 + 100 * np.sin(0.05 * (xx - 4 * i)),
            128 + 100 * np.cos(0.04 * (yy + 3 * i)),
            128 + 80 * np.sin(0.03 * (xx + yy - 2 * i)),
        ], -1).clip(0, 255).astype(np.uint8)
        # channel 0 first in the file's BGR order, as cv2.imwrite stores it
        write_png(os.path.join(root, "rgb", f"{t:.6f}.png"),
                  np.ascontiguousarray(img[..., ::-1]))
        write_png(os.path.join(root, "depth", f"{t:.6f}.png"), depth)
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        depth_lines.append(f"{t:.6f} depth/{t:.6f}.png")
        gt_lines.append(f"{t:.6f} {0.05 * i} 0 0 0 0 0 1")
    hdr = "# h\n# h\n# h\n"
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)):
        with open(os.path.join(root, name), "w") as f:
            f.write(hdr + "\n".join(lines))


class ProgressStream:
    """Dataset proxy printing a heartbeat per frame read, with the device
    memory allocated and its peak."""

    def __init__(self, stream):
        self._s = stream
        self.t0 = time.time()

    def __len__(self):
        return len(self._s)

    def __getitem__(self, i):
        mem = ""
        if torch.cuda.is_available():
            mem = (f"  allocated {torch.cuda.memory_allocated() / 2**30:.2f}"
                   f" GiB, peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                   " GiB")
        print(f"[profile] frame {i} +{time.time() - self.t0:.0f}s{mem}",
              flush=True)
        return self._s[i]

    def __getattr__(self, name):
        return getattr(self._s, name)


def pipeline_config(args, root):
    """configs/wildgs_slam.yaml with the JAX script's edits."""
    H, W = args.h, args.w
    cfg = load_config(str(REPO / "configs" / "wildgs_slam.yaml"))
    cfg["scene"] = "profile"
    if args.fast_mode:
        cfg["fast_mode"] = True
    cfg["dataset"] = "tumrgbd"
    cfg["data"]["input_folder"] = root
    cfg["data"]["output"] = os.path.join(args.out, "out")
    cfg["cam"].update(H=H * 2, W=W * 2, fx=W * 1.2, fy=W * 1.2, cx=W * 1.0,
                      cy=H * 1.0, H_out=H, W_out=W, H_edge=0, W_edge=0)
    t = cfg["tracking"]
    t["buffer"] = args.frames + 5
    t["warmup"] = 8
    t["force_keyframe_every_n_frames"] = 1
    t["motion_filter"]["thresh"] = 1e9
    t["frontend"].update(window=12, max_factors=48)
    t["backend"]["ba_freq"] = 10         # exercise online global BA
    m = cfg["mapping"]
    m["final_refine_iters"] = args.final_refine
    m["gaussian_capacity"] = args.capacity
    m["render_list_capacity"] = 512
    m["Training"].update(init_itr_num=args.init_iters,
                         mapping_itr_num=args.mapping_iters,
                         window_size=8)
    return cfg


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m wildgs_slam_tpu_torch.scripts.profile_pipeline")
    ap.add_argument("--h", type=int, default=384)
    ap.add_argument("--w", type=int, default=512)
    ap.add_argument("--frames", type=int, default=25)
    ap.add_argument("--out", type=str, default="output/profile_pipeline")
    ap.add_argument("--mapping_iters", type=int, default=60,
                    help="mapping iterations per keyframe (450 in the "
                         "reference config)")
    ap.add_argument("--init_iters", type=int, default=128)
    ap.add_argument("--final_refine", type=int, default=64)
    ap.add_argument("--capacity", type=int, default=131072)
    ap.add_argument("--fast_mode", action="store_true",
                    help="skip the per-frame render-based pose refinement "
                         "of the non-keyframes in the final evaluation")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = run_device(args.device)
    if device.type == "cuda":
        print(f"card: {card_line()}")
        torch.cuda.reset_peak_memory_stats()
    print(f"[profile] device={device}", flush=True)
    H, W = args.h, args.w
    root = os.path.join(args.out, "tum")
    if not os.path.exists(os.path.join(root, "rgb.txt")):
        make_tum_scene(root, n=args.frames, H=H, W=W)
    cfg = pipeline_config(args, root)

    rng = np.random.RandomState(0)
    feats = rng.rand(8, H // 14, W // 14, 384).astype(np.float32)

    def depth_fn(im):
        return np.full((H, W), 2.0, np.float32)

    def feat_fn(im):
        return feats[int(np.asarray(im).sum() * 1e3) % 8]

    TIMER.reset()
    stream = ProgressStream(get_dataset(cfg))
    t0 = time.time()
    SLAM(cfg, stream, depth_fn=depth_fn, feat_fn=feat_fn,
         device=device).run()
    wall = time.time() - t0

    print(f"\n[profile] {H}x{W}, {args.frames} frames, wall {wall:.1f}s")
    print(TIMER.report())
    summary = TIMER.summary()
    summary["_meta"] = {
        "H": H, "W": W, "frames": args.frames, "wall_s": wall,
        "mapping_iters": args.mapping_iters, "init_iters": args.init_iters,
        "final_refine": args.final_refine, "device": str(device),
        "device_name": (torch.cuda.get_device_name(0)
                        if device.type == "cuda" else "cpu"),
        "card": card_line() if device.type == "cuda" else None,
        "peak_allocated_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                               if device.type == "cuda" else None)}
    path = os.path.join(args.out, "profile_summary.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"[profile] wrote {path}")
    return summary


if __name__ == "__main__":
    main()
