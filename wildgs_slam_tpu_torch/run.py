"""The port's entry point:

    python -m wildgs_slam_tpu_torch.run configs/Dynamic/TUM_RGBD/freiburg3_walking_xyz.yaml

The torch counterpart of the repository's ``run.py``, with the same flags
plus ``--device`` (default ``cuda``; without a CUDA device the run stops
unless ``--device cpu`` is given) and ``--pretrained`` (the directory of the
prior networks' checkpoints). It reads the dataset from disk, builds the
mono priors (DepthAnythingV2 under the Metric3D protocol and DINOv2 / FiT3D
features), and runs ``SLAM.run`` with checkpoints, the control channel and
the anomaly checks. If the priors cannot be built the run goes on without
them, as the reference does, after one line naming the reason and the three
switches that turns off: the mapper then maps the frontend's BA depth
(with no prior to fill its invalid pixels from), and tracking and mapping
run without uncertainty.

``build(argv)`` does everything up to the run and returns (cfg, slam,
resume_path), so that a caller can change the system (an oracle, another
prior) before ``slam.run(resume_path=resume_path)``; ``main`` runs it.
"""

from __future__ import annotations

import argparse
import os
import random
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m wildgs_slam_tpu_torch.run")
    p.add_argument("config", type=str, help="path to config yaml")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--fast_mode", action="store_true")
    p.add_argument("--trace_dir", type=str, default=None,
                   help="capture a torch.profiler trace of the whole run "
                        "into this directory")
    p.add_argument("--resume", action="store_true",
                   help="resume from the checkpoint in the output directory")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="save a resumable checkpoint every N keyframes "
                        "(0 = never)")
    p.add_argument("--debug", action="store_true",
                   help="anomaly detection: autograd's anomaly mode and "
                        "finite checks at the phase boundaries")
    p.add_argument("--mesh", type=int, default=None,
                   help="run the system over a mesh of the first N cards "
                        "(the frontend's updates edge-sharded); equals cfg "
                        "parallel.n_devices; raises when fewer are visible")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--pretrained", type=str, default="pretrained",
                   help="directory of the prior networks' checkpoints")
    return p.parse_args(argv)


def setup_seed(seed):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def build(argv=None):
    """Parse `argv`, read the config and the dataset, build the priors and
    the SLAM system. Returns (cfg, slam, resume_path or None)."""
    from .config import load_config
    from .models.priors import make_prior_fns
    from .slam.system import SLAM
    from .utils.datasets import get_dataset

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the "
                           "CPU")
    cfg = load_config(args.config)
    if args.max_frames is not None:
        cfg["max_frames"] = args.max_frames
    if args.fast_mode:
        cfg["fast_mode"] = True
    if args.mesh is not None:
        cfg.setdefault("parallel", {})["n_devices"] = args.mesh
    setup_seed(cfg.get("setup_seed", 43))

    if "scene" not in cfg:
        cfg["scene"] = os.path.splitext(os.path.basename(args.config))[0]
    output_dir = os.path.join(cfg["data"]["output"], str(cfg["scene"]))
    os.makedirs(output_dir, exist_ok=True)

    stream = get_dataset(cfg)
    print(f"[run] {len(stream)} frames from {cfg['dataset']}")

    depth_fn = feat_fn = None
    try:
        depth_fn, feat_fn = make_prior_fns(cfg, output_dir, args.pretrained,
                                           device=device)
    except Exception as e:   # the reference's behaviour: run without them
        print(f"[run] mono priors unavailable ({e}); turned off "
              "tracking.backend.metric_depth_reg, "
              "tracking.uncertainty_params.activate and "
              "mapping.uncertainty_params.activate")
        cfg["tracking"]["backend"]["metric_depth_reg"] = False
        cfg["tracking"]["uncertainty_params"]["activate"] = False
        cfg["mapping"]["uncertainty_params"]["activate"] = False

    if args.checkpoint_every:
        cfg["checkpoint_every"] = args.checkpoint_every
    if args.debug:
        cfg.setdefault("debug", {})["detect_anomaly"] = True
    resume_path = None
    if args.resume:
        resume_path = os.path.join(output_dir, "checkpoint.npz")
        if not os.path.exists(resume_path):
            print(f"[run] --resume: no checkpoint at {resume_path}; "
                  "starting fresh")
            resume_path = None

    slam = SLAM(cfg, stream, depth_fn=depth_fn, feat_fn=feat_fn,
                device=device)
    return cfg, slam, resume_path


def main(argv=None):
    from .utils.profiling import trace

    args = parse_args(argv)
    _, slam, resume_path = build(argv)
    t0 = time.time()
    with trace(args.trace_dir):
        slam.run(resume_path=resume_path)
    print(f"[run] total wall time: {(time.time() - t0) / 60:.1f} min")


if __name__ == "__main__":
    main()
