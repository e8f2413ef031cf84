"""Aggregate the per-scene ATE of a sweep into a CSV (RMSE in cm per
scene and their average); the port's own copy of
``scripts/summarize_pose_eval.py``, writing the same file.

    python -m wildgs_slam_tpu_torch.scripts.summarize_pose_eval OUTPUT_ROOT
        [--metric_file traj/full_traj_metrics.txt] [--out_csv PATH]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def read_metrics(path):
    out = {}
    with open(path) as f:
        for line in f:
            if ":" in line:
                k, v = line.split(":", 1)
                try:
                    out[k.strip()] = float(v)
                except ValueError:
                    pass
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m wildgs_slam_tpu_torch.scripts.summarize_pose_eval")
    ap.add_argument("output_root", help="e.g. ./output/TUM_RGBD")
    ap.add_argument("--metric_file", default="traj/full_traj_metrics.txt")
    ap.add_argument("--out_csv", default=None)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    rows = []
    for scene_dir in sorted(glob.glob(os.path.join(args.output_root, "*"))):
        mpath = os.path.join(scene_dir, args.metric_file)
        if not os.path.exists(mpath):
            continue
        m = read_metrics(mpath)
        if "rmse" in m:
            rows.append((os.path.basename(scene_dir), m["rmse"] * 100))

    if not rows:
        print("no metrics found")
        return None

    csv = "scene,ate_rmse_cm\n"
    for name, rmse in rows:
        csv += f"{name},{rmse:.2f}\n"
    csv += f"average,{np.mean([r for _, r in rows]):.2f}\n"
    out = args.out_csv or os.path.join(args.output_root, "pose_eval.csv")
    with open(out, "w") as f:
        f.write(csv)
    print(csv)
    print(f"written to {out}")
    return out


if __name__ == "__main__":
    main()
