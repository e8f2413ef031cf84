"""A/B of the sort binning's bbox window (``bin_kw``) on a densified map:
how many entries each window truncates, what that costs in colour, depth
and PSNR against kw 4, and ms per mapping iteration.

    python -m wildgs_slam_tpu_torch.scripts.ab_bin_kw [K] [--device cuda|cpu]

The scene is ``profile_map_opt``'s (384x512, 8 keyframes,
gaussian_capacity 131,072, render_list_capacity 512, window 8, K (64)
iterations): ``initialize_mapper``, then one ``map_opt_online`` of K
iterations densifies the map. On the middle keyframe's view it prints the
radius percentiles of the valid, alive Gaussians, then renders at kw 4, 3
and 2 (``render_fused``, K1 and K3, on the card; the plain ``render`` on
the CPU, as the mapper does) with each render's binning overflow, split
into the window's truncation and the drops of full tile lists, and, for
kw 3 and 2, max |dcolor|, max |ddepth| and PSNR against kw 4. Last it
times ``map_opt_online`` at kw 4 and 3: one warm pass, then the best of 3.
The port's mapper reads ``Mapper.bin_kw`` in every render of its
optimisation step, so that one attribute sets the window.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ops import rasterizer as tr
from ..slam import gaussian_map as gm
from ..utils.profiling import card_line, run_device
from .profile_map_opt import HT, WD, build_mapper

N_KF = 8
KWS = (4, 3, 2)
PERCENTILES = (50, 95, 99, 99.9)
WIDE_CAPACITY = 8192   # a tile list no view of the scene fills


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def build_scene(K, device, ht=HT, wd=WD, n_kf=N_KF):
    """profile_map_opt's mapper after initialize_mapper and one online
    segment of K iterations."""
    mapper = build_mapper(K, n_kf, device, ht, wd)
    mapper.initialize_mapper(cur_video_idx=n_kf - 1)
    mapper.map_opt_online(mapper.current_window, iters=K)
    _sync(mapper.device)
    return mapper


def view_inputs(mapper):
    """The render inputs of the map on the middle keyframe's view:
    (means, scales, rotations xyzw, opacities, SH, w2c, intrinsics, alive)."""
    p = mapper.gaussians.params
    w2c = mapper.state.store.poses[mapper.state.counter // 2]
    return (p.xyz, gm.get_scaling(p), gm.get_rotation_xyzw(p),
            gm.get_opacity(p), gm.get_sh(p), w2c, mapper.intrinsics_full,
            mapper.gaussians.aux.alive)


@torch.no_grad()
def radius_stats(mapper) -> dict:
    """Pixel radius percentiles and max of the valid, alive Gaussians."""
    *args, alive = view_inputs(mapper)
    proj = tr.project_gaussians(*args, mapper.image_size)
    rad = proj.radius[proj.valid & alive].cpu().numpy()
    out = {f"p{q:g}": float(np.percentile(rad, q)) for q in PERCENTILES}
    out["max"] = int(rad.max())
    out["n"] = int(rad.size)
    return out


@torch.no_grad()
def render_ab(mapper, kws=KWS):
    """({kw: {overflow, of it the window's truncation and the lists' drops,
    and against the first kw: dcolor, ddepth, psnr}}, {kw: render}). The
    first kw is the reference."""
    *args, alive = view_inputs(mapper)
    render = tr.render_fused if mapper.device.type == "cuda" else tr.render
    proj = tr.project_gaussians(*args, mapper.image_size)
    res, outs = {}, {}
    for kw in kws:
        out = render(*args, mapper.image_size, alive=alive,
                     capacity=mapper.render_list_capacity, chunk=64,
                     bin_kw=kw)
        outs[kw] = out
        # binned again with room for every entry: what overflows is the
        # window's truncation alone
        wide = tr.bin_gaussians(proj.mean2d, proj.radius, proj.depth,
                                proj.valid & alive, mapper.image_size,
                                capacity=WIDE_CAPACITY, kw=kw)
        if int(wide.counts.max()) >= WIDE_CAPACITY:
            raise ValueError(f"a tile holds {int(wide.counts.max())} entries "
                             f"at kw {kw}: raise WIDE_CAPACITY")
        r = {"overflow": int(out.overflow), "truncated": int(wide.overflow),
             "max_count": int(wide.counts.max())}
        r["dropped"] = r["overflow"] - r["truncated"]
        if kw != kws[0]:
            ref = outs[kws[0]]
            r["dcolor"] = float((out.color - ref.color).abs().max())
            r["ddepth"] = float((out.depth - ref.depth).abs().max())
            mse = float(((out.color - ref.color) ** 2).mean())
            r["psnr"] = float(10 * np.log10(1.0 / max(mse, 1e-20)))
        res[kw] = r
    return res, outs


def time_segment(mapper, kw, K, reps=3) -> float:
    """ms per iteration of map_opt_online at bin_kw kw: one warm pass, then
    the best of `reps`."""
    mapper.bin_kw = kw
    mapper.map_opt_online(mapper.current_window, iters=K)
    _sync(mapper.device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        mapper.map_opt_online(mapper.current_window, iters=K)
        _sync(mapper.device)
        best = min(best, time.perf_counter() - t0)
    return best / K * 1e3


def print_ab(res):
    ref = None
    for kw, r in res.items():
        split = (f"(window truncation {r['truncated']}, list drops "
                 f"{r['dropped']}; longest list {r['max_count']})")
        if ref is None:
            ref = kw
            print(f"[kw] kw={kw}: overflow={r['overflow']} {split}",
                  flush=True)
        else:
            print(f"[kw] kw={kw}: overflow={r['overflow']} {split} "
                  f"max|dcolor|={r['dcolor']:.2e} "
                  f"max|ddepth|={r['ddepth']:.2e} "
                  f"PSNR-vs-kw{ref}={r['psnr']:.1f} dB", flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m wildgs_slam_tpu_torch.scripts.ab_bin_kw")
    p.add_argument("K", nargs="?", type=int, default=64)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = run_device(args.device)
    if device.type == "cuda":
        print(f"card: {card_line()}")
    mapper = build_scene(args.K, device)
    print(f"[kw] alive={gm.num_alive(mapper.gaussians)}", flush=True)
    rad = radius_stats(mapper)
    print(f"[kw] radius px: p50={rad['p50']:.1f} p95={rad['p95']:.1f} "
          f"p99={rad['p99']:.1f} p99.9={rad['p99.9']:.1f} max={rad['max']}",
          flush=True)
    res, _ = render_ab(mapper, KWS)
    print_ab(res)
    ms = {}
    for kw in (4, 3):
        ms[kw] = time_segment(mapper, kw, args.K)
        print(f"[kw] opt segment kw={kw}: {ms[kw]:.1f} ms/iter", flush=True)
    return {"radius": rad, "renders": res, "ms_per_iter": ms}


if __name__ == "__main__":
    main()
