"""torch.profiler over the bench step: the device operations by their own
time, the counterpart of the JAX script's per-op table.

    python -m wildgs_slam_tpu_torch.scripts.profile_rasterizer [outdir]
        [--iters 10] [--device cuda|cpu]

Builds ``bench.py``'s scene, runs one warm pass of `iters` chained bench
steps (``wildgs_slam_tpu_torch.bench.step``: render_fused forward and
backward with the pose gradient, the SGD step), then one pass under
torch.profiler, and prints wall and device ms per step and the top device
operations. With `outdir`, the Chrome trace is written there.
"""

from __future__ import annotations

import argparse

from .. import bench
from ..utils.profiling import card_line, profile_steps, run_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m wildgs_slam_tpu_torch.scripts.profile_rasterizer")
    p.add_argument("outdir", nargs="?", default=None,
                   help="write the Chrome trace here")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = run_device(args.device)
    if device.type == "cuda":
        print(f"card: {card_line()}")
    scene = bench.to_device(bench.make_scene(), device)
    print(f"[raster] bench step: N={bench.N_GAUSS} {bench.H}x{bench.W} "
          f"capacity {bench.CAPACITY} chunk {bench.CHUNK} bin_kw "
          f"{bench.BIN_KW} {bench.BIN_METHOD}, {args.iters} steps per pass")
    bench.run_pass(scene, args.iters)                 # warm
    return profile_steps(lambda: bench.run_pass(scene, args.iters),
                         args.iters, args.outdir)


if __name__ == "__main__":
    main()
