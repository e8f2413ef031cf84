"""A/B of the frontend's early exit, ``tracking.frontend.update_eps``,
under the oracle: keyframe ATE and the graph-update BA steps run.

    python -m wildgs_slam_tpu_torch.scripts.ab_update_eps [--out DIR]
        [--device cuda|cpu]

``update_n`` stops once the mean flow residual of an iteration is below
eps pixels; under the oracle (``FactorGraph.gt_injection``: ground-truth
reprojection targets in place of the update operator, the BA unchanged)
the residual is |target - reprojection| over the active edges
(``FactorGraph._update_n_oracle``). This runs ``SLAM.run()`` on a
view-consistent scene, 12 frames of one textured plane (world z = 2) seen
from a forward-moving, yawing camera at 128x160 (64x80 out), written as a
TUM sequence, at eps 0, 0.01 and 0.05, and prints each run's keyframe ATE
(read back from ``traj/kf_traj_metrics.txt``) and the BA steps the
frontend's graph ran over its oracle calls. The config: every frame a
keyframe, buffer 24, warmup 4, window 6, max_factors 32, loop closure on,
online global BA every 6 keyframes, fast mode, no uncertainty and no
metric-depth term; seeded DROID weights (the oracle replaces their
updates). Without a trained ``droid.pth`` this bounds the BA side of the
knob only: the network's flow is not judged.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..config import load_config
from ..ops import lie
from ..slam.system import SLAM
from ..utils.datasets import get_dataset
from ..utils.png import write_png
from ..utils.profiling import card_line, run_device

REPO = Path(__file__).resolve().parents[2]
H, W = 64, 80                   # output size; the frames are twice as large
N_FRAMES = 12
EPS = (0.0, 0.01, 0.05)


def gt_trajectory(n):
    """(n, 7) camera-to-world poses: forward translation, a gentle yaw and
    bob."""
    xi = torch.tensor([[0.06 * i, 0.02 * np.sin(0.4 * i), 0.01 * i, 0.0,
                        0.03 * i, 0.005 * i] for i in range(n)],
                      dtype=torch.float32)
    return lie.se3_exp(xi)


def write_scene(root, c2w7):
    """Every frame sees the same static textured plane (world z = 2) under
    its pose: colour PNGs in the file's BGR order (as cv2 writes them) and
    16-bit depth at 5000 per metre, with rgb.txt, depth.txt and
    groundtruth.txt."""
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    hf, wf = H * 2, W * 2
    fx = fy = 90.0
    cx, cy = W * 1.0, H * 1.0
    yy, xx = np.meshgrid(np.arange(hf), np.arange(wf), indexing="ij")
    dirs = np.stack([(xx - cx) / fx, (yy - cy) / fy, np.ones_like(xx)],
                    -1).astype(np.float64)
    rgb_lines, depth_lines, gt_lines = [], [], []
    for i in range(len(c2w7)):
        t = float(i)
        p = np.asarray(c2w7[i].cpu(), np.float64)
        rm = lie.se3_matrix(torch.as_tensor(p, dtype=torch.float32)
                            ).numpy().astype(np.float64)[:3, :3]
        o = p[:3]
        d_w = dirs @ rm.T
        s = (2.0 - o[2]) / d_w[..., 2]
        pw = o[None, None, :] + s[..., None] * d_w
        x, y = pw[..., 0], pw[..., 1]
        img = np.stack([
            128 + 100 * np.sin(7.0 * x) * np.cos(5.0 * y),
            128 + 100 * np.cos(6.0 * y + 2.0 * x),
            128 + 80 * np.sin(4.0 * (x + y)),
        ], -1).clip(0, 255).astype(np.uint8)
        write_png(os.path.join(root, "rgb", f"{t:.6f}.png"),
                  np.ascontiguousarray(img[..., ::-1]))
        depth = (s * 5000).clip(0, 65535).astype(np.uint16)
        write_png(os.path.join(root, "depth", f"{t:.6f}.png"), depth)
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        depth_lines.append(f"{t:.6f} depth/{t:.6f}.png")
        gt_lines.append(f"{t:.6f} " + " ".join(f"{v:.9f}" for v in p))
    hdr = "# h\n# h\n# h\n"
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)):
        with open(os.path.join(root, name), "w") as f:
            f.write(hdr + "\n".join(lines))


def eps_config(eps, root, outdir):
    """configs/wildgs_slam.yaml with the JAX script's edits."""
    cfg = load_config(str(REPO / "configs" / "wildgs_slam.yaml"))
    cfg["scene"] = f"eps{eps}"
    cfg["dataset"] = "tumrgbd"
    cfg["data"]["input_folder"] = root
    cfg["data"]["output"] = outdir
    cfg["cam"].update(H=H * 2, W=W * 2, fx=90.0, fy=90.0, cx=W * 1.0,
                      cy=H * 1.0, H_out=H, W_out=W, H_edge=0, W_edge=0)
    cfg["fast_mode"] = True
    t = cfg["tracking"]
    t["buffer"] = 24
    t["warmup"] = 4
    t["force_keyframe_every_n_frames"] = 1
    t["motion_filter"]["thresh"] = 1e9
    t["backend"]["metric_depth_reg"] = False
    t["uncertainty_params"]["activate"] = False
    cfg["mapping"]["uncertainty_params"]["activate"] = False
    t["frontend"].update(window=6, max_factors=32, enable_loop=True,
                         update_eps=eps)
    t["backend"]["ba_freq"] = 6
    m = cfg["mapping"]
    m["final_refine_iters"] = 2
    m["gaussian_capacity"] = 4096
    m["render_list_capacity"] = 512
    m["Training"].update(init_itr_num=4, mapping_itr_num=2, window_size=4,
                         init_gaussian_update=3, init_gaussian_reset=4)
    return cfg


def run_once(eps, root, outdir, device) -> dict:
    """SLAM.run() at update_eps eps; the scene is written to root first if
    it is not there. Returns {rmse (m), steps run, steps asked, calls,
    renders (the mapper's render_fused calls), forward_only (of them those
    without a backward)}."""
    c2w7 = gt_trajectory(N_FRAMES)
    w2c7 = lie.se3_inv(c2w7).to(device)
    if not os.path.exists(os.path.join(root, "rgb.txt")):
        write_scene(root, c2w7)
    cfg = eps_config(eps, root, outdir)
    stream = get_dataset(cfg)
    rng = np.random.RandomState(0)

    def depth_fn(image):
        return np.full((H, W), 2.0, np.float32)

    def feat_fn(image):
        return rng.rand(H // 14, W // 14, 384).astype(np.float32)
    slam = SLAM(cfg, stream, depth_fn=depth_fn, feat_fn=feat_fn,
                device=device)

    def gt_injection(store, counter):
        ts = torch.clamp(store.timestamp.long(), 0, N_FRAMES - 1)
        h, w = store.disps.shape[-2:]
        return w2c7[ts], torch.full((store.poses.shape[0], h, w), 0.5,
                                    device=store.poses.device)
    slam.frontend.graph.gt_injection = gt_injection
    slam.backend.gt_injection = gt_injection

    # the BA steps each oracle update_n ran, and those it was asked for
    done, asked = [], []
    graph = slam.frontend.graph
    orig = graph._update_n_oracle

    def counting(n, *a, **k):
        out = orig(n, *a, **k)
        done.append(int(out[0]))
        asked.append(int(n))
        return out
    graph._update_n_oracle = counting
    slam.run()

    metrics = os.path.join(outdir, f"eps{eps}", "traj", "kf_traj_metrics.txt")
    rmse = None
    with open(metrics) as f:
        for line in f.read().splitlines():
            if line.strip().startswith("rmse"):
                rmse = float(line.split()[-1])
    return {"rmse": rmse, "steps": sum(done), "asked": sum(asked),
            "calls": len(done), "renders": slam.mapper.fused_renders,
            "forward_only": slam.mapper.gui_renders}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m wildgs_slam_tpu_torch.scripts.ab_update_eps")
    p.add_argument("--out", default=None,
                   help="write the scene and the runs here (default: a "
                        "temporary directory)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def report(eps, r):
    print(f"[eps] update_eps={eps:<5}: kf ATE {r['rmse'] * 100:8.4f} cm, "
          f"BA steps executed {r['steps']} of {r['asked']} asked over "
          f"{r['calls']} update calls", flush=True)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = run_device(args.device)
    if device.type == "cuda":
        print(f"card: {card_line()}")
    res = {}
    with tempfile.TemporaryDirectory() as td:
        base = args.out or td
        root = os.path.join(base, "tum")
        for eps in EPS:
            r = run_once(eps, root, os.path.join(base, "out"), device)
            report(eps, r)
            res[eps] = r
    return res


if __name__ == "__main__":
    main()
