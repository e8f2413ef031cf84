"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. the card (name and power limit as nvidia-smi gives them), torch and
     CUDA versions (the global TF32 flags stay at PyTorch's defaults: the
     port pins its own convolutions to float32);
  2. build of the CUDA kernels from csrc/ (nvcc, one per source, in
     parallel), with what ptxas reports, and one resource line for each of
     K1's and K4's kernels;
  3. each kernel against its plain PyTorch version at mapping shapes
     (T=768 tiles, K=512 slots, chunk 64, N=262,144 Gaussians), on a table
     made by the port's own projection and binning of a seeded scene: K1/K2
     (composite), K3 (table gather, exact) and K4 (its scatter-add, with
     random cotangents in every slot); and K2 where exp(power) overflows
     (indefinite conics in an open chunk, a saturated one and past a
     count): NaN where its plain version has NaN, the rest within max-rel
     1e-5;
  4. each kernel's time on the device per call (torch.profiler over 20
     calls; the median of CUDA-event rounds of back-to-back calls beside
     it, which includes any wait for the host) beside its bound, its plain
     version's time and, where one exists, one library call's device time;
     K4's zero fill and its add apart;
  5. the mapper's keyframe path through Mapper's entry points
     (initialize_mapper, then on_keyframe) at the full widths of
     configs/Dynamic/TUM_RGBD/tum_dynamic.yaml on a seeded synthetic scene,
     with the kernels' launch counts, which must equal the mapping steps run,
     and a torch.profiler summary;
  6. the tracking frontend at the same widths, frame by frame through
     MotionFilter.track and Frontend.__call__: an oracle run (ground-truth
     reprojection targets through the real BA) that hands its keyframes to
     Mapper.initialize_mapper at warmup, then Frontend.initialize_second_stage,
     and must keep the keyframe ATE under 1 cm, raise the keyframes' mean
     PSNR by more than 10 dB over the seeded map's to above 35 dB and launch
     K1-K4 once per mapping step; then a
     run with the seeded random DROID weights to 8
     frontend updates, with its times, memory and a torch.profiler summary,
     and one Backend.dense_ba(2) on its 20 keyframes (global BA with the
     on-the-fly correlation at full width: ms per update_lowmem step, peak
     memory);
  7. the whole system through SLAM.run() at the same widths on 48 frames of
     the tracking scene at half its motion per frame, every frame a
     keyframe, under the oracle (loop
     closure, online global BA every 20 keyframes, final global BA, final
     map refinement, the trajectory filler and the render-based pose
     refinement of every frame, fast_mode off); depth cut (printed). Gates:
     keyframe ATE < 1 cm and full ATE <= max(1.5 x its fast_mode value,
     1 cm), both read back from the metrics files terminate wrote; the
     refinement ran once per frame; the final map's keyframe PSNR >= 16 dB;
     K1-K4 each launched once per render_fused call on the path;
  8. the user's entry point. (a) The default priors at full width, built
     by make_prior_fns from seeded checkpoints in upstream names that the
     script writes under build/: metric3d_vit_large (the DepthAnythingV2
     ViT-L stand-in under the 616x1064 canonical protocol) and
     dinov2_reg_small_fine, timed on 8 frames at 384x512, and the disk
     cache read back. (b) wildgs_slam_tpu_torch.run's build() and
     SLAM.run() on 24 frames of the system phase's scene written as a TUM
     sequence at 480x640 (PNGs from the script's own writer): invocation A
     --max_frames 16 --fast_mode --checkpoint_every 8, then B --resume to
     the end through a fresh build(); the oracle and the scene's exact depth
     prior are put in between build() and run(). Gates: the reader's first
     frame within one level of the written image's bilinear resize; A's
     checkpoint; B resumed at A's frame and keyframe count; B's keyframe
     ATE < 1 cm and full ATE <= max(1.5 x fast mode, 1 cm); B wrote the
     map, viewer, video, config and timing files; K1-K4 launched once per
     render_fused call in each invocation; build() never fell back to
     running without the priors;
  9. runs without metric depth. (a) wildgs_slam_tpu_torch.run's build()
     with an empty checkpoint directory (its one fallback line: no metric
     depth, no uncertainty) and gui on, then SLAM.run() on 16 frames of
     phase 8's TUM sequence under the oracle. (b) SLAM.run() in memory in
     the Splat-SLAM mode (metric_depth_reg off, uncertainty on) on 24
     frames of the system phase's scene, the depth prior (d + 1) / 2 with
     a hole cut in it, the features of phase 8's seeded DINOv2; its oracle
     writes the converged state and moves every earlier keyframe by 1 mm
     every 4 keyframes. Gates: keyframe ATE < 1 cm in both; the file GUI's
     index.html, map.json and render.png (decoded, 384x1024x3); at least
     one projective deformation and no invalid keyframe in (b); each
     fill's scale and shift against the truth and a float64 solve; K1 and
     K3 launched once per render_fused call, K2 and K4 once per call with
     a backward (the GUI's renders run none);
  10. the data path on the card's host. (a) The native library
     (wildgs_slam_tpu_torch/native: the port's own PNG and JPEG decoders,
     built with g++ in phase 2 beside nvcc): compiler, flags, seconds,
     size. (b) The fixtures of tests/data/torch_jpeg decoded and held
     equal to the cv2 decodes committed beside them. (c) The iPhone
     configuration (configs/Dynamic/Wild_SLAM_iPhone/horse.yaml: 1920x1440
     raw frames, 480x360 out, the RGB-folder reader) on 16 frames of the
     system phase's scene written as baseline 4:2:0 JPEGs by the script's
     own numpy encoder, through run.build() with phase 8's seeded prior
     checkpoints and SLAM.run() under the oracle (the scene's poses given
     to the reader, which has none). Gates: frame 0's decode at least
     35 dB PSNR from the rendered image, keyframe ATE < 1 cm, K1 and K3
     launched once per render_fused call and K2 and K4 once per call with
     a backward. (d) ms per frame of (c)'s reader and phase 8's PNG
     sequence, plain and through PrefetchingStream (2 workers, lookahead
     4; also with a pause before each frame), every prefetched frame
     bit-equal to the plain one;
  11. the multi-device mode (wildgs_slam_tpu_torch/parallel/) on meshes of
     2 and 8 shards on cuda:0 (make_mesh(devices=...); one process drives
     them, as the JAX package's one controller does; shards on one card
     measure correctness and the sharded path's extra launches, not
     scaling). (a) The Gaussian/tile-sharded renderer against render_fused
     on phase 3's scene at 384x512 (capacity_local 256 and 64, as the
     mapper sets it): forward and the gradients of means, scales, opacity,
     SH and pose_delta within tests/test_multichip.py's tolerances wherever
     no shard's tile list overflows (each shard's drops printed), ms per
     forward+backward, K1-K4 launched D times per render. (d) SLAM.run()
     on 16 frames of phase 8's TUM sequence with the seeded DROID weights
     (the frontend's updates through the edge-sharded step), with a 2-shard
     mesh killed at 8 frames and resumed from its checkpoint, and without
     a mesh: the same keyframe count, final_gs.ply written, the loop-end
     differences printed beside tests/test_mesh_e2e.py's tolerances. (b)
     make_sharded_ba against dba.ba, with and without the sensor term,
     and (c) the network update_n with and without a mesh, on the last
     window of (d)'s run without a mesh: one update within 1e-5 + 1e-4
     rel with cuDNN off in both (cuDNN's algorithm depends on the batch, a
     shard's smaller one rounds differently), eight with it on printed,
     ms per iteration and peak memory. (e)
     run.build(--mesh 2) raises make_mesh's message on one card;
  12. one JSON line describing every kernel;
  13. the card again, then the last line {"ok": true, "device": {...}}.

Any failure raises and exits non-zero. Without a CUDA device it exits
non-zero and prints no result. It finds the port package next to itself,
from any working directory.

    python3 chip_smoke.py --kernels-from DIR

runs phases 1-4 only, on the port package found in DIR (a checkout of
another commit, e.g. unpacked with `git archive`), and ends with one JSON
line of the kernels' times: an A/B of two commits' kernels by the same
script, run in turns in one call on one card.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import pickle
import shutil
import struct
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS_FROM = (os.path.abspath(sys.argv[sys.argv.index("--kernels-from") + 1])
                if "--kernels-from" in sys.argv else None)
sys.path.insert(0, KERNELS_FROM or HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from wildgs_slam_tpu_torch import kernels  # noqa: E402
from wildgs_slam_tpu_torch.config import load_config  # noqa: E402
from wildgs_slam_tpu_torch.models import droid_net  # noqa: E402
from wildgs_slam_tpu_torch.ops import lie  # noqa: E402
from wildgs_slam_tpu_torch.ops import rasterizer as tr  # noqa: E402
from wildgs_slam_tpu_torch.ops.rasterizer import composite_cuda as cc  # noqa
from wildgs_slam_tpu_torch.ops.rasterizer import table_gather as tg  # noqa
from wildgs_slam_tpu_torch.slam import depth_fill  # noqa: E402
from wildgs_slam_tpu_torch.slam import gaussian_map as gm  # noqa: E402
from wildgs_slam_tpu_torch.slam import keyframe_store as kstore  # noqa: E402
from wildgs_slam_tpu_torch.slam import system  # noqa: E402
from wildgs_slam_tpu_torch.slam.backend import Backend  # noqa: E402
from wildgs_slam_tpu_torch.slam.frontend import Frontend  # noqa: E402
from wildgs_slam_tpu_torch.slam.mapper import Mapper  # noqa: E402
from wildgs_slam_tpu_torch.slam.motion_filter import MotionFilter  # noqa
from wildgs_slam_tpu_torch.slam.state import SlamState  # noqa: E402
from wildgs_slam_tpu_torch.utils.eval_traj import (  # noqa: E402
    ape_statistics, read_metric)
from wildgs_slam_tpu_torch.utils.png import read_png, write_png  # noqa
from wildgs_slam_tpu_torch.utils.profiling import TIMER  # noqa: E402
from wildgs_slam_tpu_torch.utils.resample import resize_u8  # noqa: E402

CONFIG = os.path.join(HERE, "configs", "Dynamic", "TUM_RGBD",
                      "tum_dynamic.yaml")
FP32_OPS_PER_S = 67e12      # H100 SXM, fp32 outside the tensor cores
BYTES_PER_S = 3.35e12       # H100 SXM HBM3
# fp32 operations that K1/K2 need per (slot, pixel) pair: every live pair of
# an open chunk the geometry that finds it dead or alive (dx, dy, power, exp
# counted as one, raw and the two tests); each alive pair (alpha >= 1/255
# and t_after >= 1e-4) the rest: blending and the four sums (K1), or g, the
# suffix, dalpha, the 10 gradients and their sums (K2)
OPS_PER_LIVE_PAIR = 15
FWD_OPS_PER_ALIVE_PAIR = 15
BWD_OPS_PER_ALIVE_PAIR = 55
N_INIT_KEYFRAMES = 5     # keyframes at initialize_mapper
N_ONLINE_KEYFRAMES = 3   # on_keyframe calls after it
TOL = dict(color=1e-5, depth=1e-4, alpha=1e-5, tfin=1e-5, tentry=1e-5)
BWD_MAX_REL = 1e-5
SCATTER_MAX_REL = 1e-5   # K4: the atomics sum in another order
KERNELS = {   # wrapper name -> the wrapper, whose .launches counts
    "composite_fwd": cc.composite_fwd, "composite_bwd": cc.composite_bwd,
    "table_gather": tg.table_gather, "table_scatter_add": tg.table_scatter_add}
TRACK_STEP = 0.25        # the tracking scene's motion per frame, in units of
                         # the mapping scene's motion per keyframe
TRACK_UPDATES = 8        # frontend updates each tracking run must reach
ATE_MAX = 0.01           # m, the bar of tests/test_integrated_ate.py
PSNR_GAIN_MIN = 10.0     # dB, the handoff's mean keyframe PSNR must rise by
PSNR_MIN = 35.0          # more than this, to above this
ORACLE_FRAMES = 40       # frames each tracking run may take at most
NETWORK_FRAMES = 400
SYSTEM_FRAMES = 48       # frames of the system phase, every one a keyframe
SYSTEM_STEP = TRACK_STEP / 2   # its motion per frame: frames 21 apart lie
                               # 18 px apart, under loop_thresh (25), so
                               # loop closure finds pairs and runs its BA
SYSTEM_CUTS = {"init_itr_num": 150, "mapping_itr_num": 40,
               "final_refine_iters": 600}   # depth only
SYSTEM_PSNR_MIN = 16.0   # dB, the bar of tests/test_integrated_ate.py


def card_line(query="name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(
        ).splitlines()[0]


def t32(a, dev):
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


# ---------------------------------------------------------------------------
# phase 3/4: kernels against their plain versions, and their times
# ---------------------------------------------------------------------------

def mapping_scene(dev, n=262144, h=384, w=512, seed=0):
    """A seeded random scene of n Gaussians in front of an h x w camera:
    [means, scales, rotations, opacities, SH], w2c, intrinsics."""
    rng = np.random.RandomState(seed)
    f = 0.9 * w
    means = np.concatenate([rng.uniform(-1.2, 1.2, (n, 1)) * w / f,
                            rng.uniform(-1.2, 1.2, (n, 1)) * h / f,
                            np.ones((n, 1))], -1)
    means *= 2.0 + 3.0 * rng.uniform(size=(n, 1))
    scales = np.exp(rng.uniform(np.log(0.004), np.log(0.03), (n, 3)))
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=-1, keepdims=True)
    gauss = [t32(a, dev) for a in (
        means, scales, rots, 0.2 + 0.75 * rng.uniform(size=n),
        rng.uniform(-1, 1, (n, 1, 3)))]
    return (gauss, t32([0, 0, 0, 0, 0, 0, 1], dev),
            t32([f, f, w / 2, h / 2], dev))


def mapping_table(dev, n=262144, h=384, w=512, capacity=512, seed=0):
    """Counts and packed table of mapping_scene through the port's
    projection, binning and table gather."""
    gauss, w2c, intr = mapping_scene(dev, n, h, w, seed)
    proj = tr.project_gaussians(*gauss, w2c, intr, (h, w))
    bins = tr.bin_gaussians(proj.mean2d, proj.radius, proj.depth, proj.valid,
                            (h, w), capacity=capacity)
    z = torch.zeros_like(proj.depth)
    attrs = torch.stack([proj.mean2d[:, 0], proj.mean2d[:, 1],
                         proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
                         proj.color[:, 0], proj.color[:, 1], proj.color[:, 2],
                         proj.opacity, proj.depth] + [z] * 6, 1)
    ids = bins.ids.to(torch.int32).contiguous()
    return (bins.counts, tg.table_gather_plain(attrs, ids).contiguous(),
            int(bins.overflow), -(-w // 16), attrs.contiguous(), ids)


def time_rounds(fn, reps, warmup=3, rounds=1):
    """ms per call in each of `rounds` rounds of `reps` calls, timed with
    CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_round = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        per_round.append(a.elapsed_time(b) / reps)
    return per_round


def time_ms(fn, reps, warmup=3, rounds=1):
    """ms per call: the median of time_rounds."""
    return float(np.median(time_rounds(fn, reps, warmup, rounds)))


def reset_launches():
    for fn in KERNELS.values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in KERNELS.items()}


def bound(ops, nbytes):
    t_ops, t_bytes = ops / FP32_OPS_PER_S * 1e3, nbytes / BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), t_ops, t_bytes


def ptxas_resources(log, entries):
    """{entry: ptxas's registers, shared memory and spills} for the kernels
    whose mangled names contain one of `entries`, from the build log."""
    found = {}
    for info in log.values():
        entry, spill = None, ""
        for line in info["ptxas"].splitlines():
            if "Compiling entry function" in line:
                entry = next((e for e in entries if e in line), None)
            elif entry and "spill" in line:
                spill = line.strip()
            elif entry and "Used" in line:
                found[entry] = f"{line.split(':', 1)[1].strip()}; {spill}"
                entry, spill = None, ""
    return found


def device_ms(fn, reps=20):
    """Device time per call of fn: the summed durations of the device
    operations (kernels, memsets) that torch.profiler records over `reps`
    calls, and {operation name: ms per call}. Unlike CUDA events around
    back-to-back calls, it leaves out the gaps in which the device waits
    for the host to launch the next call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    _, total_us, n_ops, by_name = device_summary(prof)
    if n_ops == 0:
        raise AssertionError("torch.profiler recorded no device operation")
    return total_us / 1e3 / reps, {k: us / 1e3 / reps
                                   for k, (us, _) in by_name.items()}


def timed_row(name, fn, plain, rounds, reps, plain_reps, plain_rounds):
    """Time one wrapper: device ms per call (torch.profiler), the median of
    CUDA-event rounds of back-to-back calls, and its plain version's median.
    Prints the rounds; returns (device ms, by name, plain ms)."""
    per_round = time_rounds(fn, reps, rounds=rounds)
    b2b = float(np.median(per_round))
    dev, by_name = device_ms(fn)
    plain_ms = time_ms(plain, plain_reps, warmup=1, rounds=plain_rounds)
    print(f"{name}: device {dev:.4f} ms per call (torch.profiler, 20 calls); "
          f"back to back {b2b:.4f} ms, median of {rounds} rounds of {reps} "
          f"(rounds {min(per_round):.4f}-{max(per_round):.4f}); plain "
          f"{plain_ms:.4f} ms")
    return dev, by_name, plain_ms


def table_kernel_rows(attrs, ids, dev):
    """K3/K4 against their plain versions, timed beside their bounds, their
    plain versions and the library calls the port used before them."""
    N = attrs.shape[0]
    T, K = ids.shape
    live = ids >= 0
    g = torch.Generator(device=dev).manual_seed(2)
    gt = torch.randn(T, K, 16, device=dev, generator=g)   # every slot
    k_t = tg.table_gather(attrs, ids)
    p_t = tg.table_gather_plain(attrs, ids)
    gather_err = float((k_t - p_t).abs().max())
    if not bool(torch.equal(k_t, p_t)):
        raise AssertionError(f"K3 differs from its plain version: max-abs "
                             f"{gather_err}")
    k_s = tg.table_scatter_add(gt, ids, N)
    p_s = tg.table_scatter_add_plain(gt, ids, N)
    torch.cuda.synchronize()
    scat_abs = float((k_s - p_s).abs().max())
    scat_rel = scat_abs / float(p_s.abs().max())
    print(f"K3 table_gather vs plain: equal (max-abs {gather_err}); K4 "
          f"table_scatter_add vs plain (random cotangents in all {T * K} "
          f"slots, {int(live.sum())} live): max-abs {scat_abs:.3e} max-rel "
          f"{scat_rel:.3e}")
    if not scat_rel < SCATTER_MAX_REL:
        raise AssertionError(f"K4 max-rel {scat_rel} >= {SCATTER_MAX_REL}")

    safe = torch.clamp(ids, min=0).reshape(-1).long()
    gflat = gt.reshape(T * K, 16)

    def lib_gather():
        return attrs.index_select(0, safe)

    def lib_scatter():
        return torch.zeros(N, 16, device=dev).index_add_(0, safe, gflat)
    n_rows = int(torch.unique(safe).numel())
    n_live = int(live.sum())
    f4 = 4
    # K3 reads every slot's row (row 0 for an empty one), K4 only the live
    # slots' cotangents: it skips an empty slot before reading its row
    gather_bytes = n_rows * 16 * f4 + T * K * f4 + T * K * 16 * f4
    scatter_bytes = n_live * 16 * f4 + T * K * f4 + N * 16 * f4
    print(f"K3 work: {n_rows} distinct rows read, {T * K} slots written; "
          f"K4 work: {n_live} live cotangent rows read, {N} rows written "
          f"once; bound = bytes at {BYTES_PER_S / 1e12:.2f} TB/s; K4's "
          f"library call (index_add_ on the clamped ids) adds every empty "
          f"slot's cotangent into row 0, the same function only where those "
          f"are zero, as on the mapping path")
    rows = []
    for name, fn, plain, lib, nbytes, err in (
            ("table_gather", lambda: tg.table_gather(attrs, ids),
             lambda: tg.table_gather_plain(attrs, ids), lib_gather,
             gather_bytes, gather_err),
            ("table_scatter_add", lambda: tg.table_scatter_add(gt, ids, N),
             lambda: tg.table_scatter_add_plain(gt, ids, N), lib_scatter,
             scatter_bytes, scat_abs)):
        ms, by_name, plain_ms = timed_row(name, fn, plain, 9, 50, 20, 5)
        lib_ms = device_ms(lib)[0]
        b, by, _, t_bytes = bound(0, nbytes)
        print(f"{name}: library {lib_ms:.4f} ms (device); bound {b:.4f} ms "
              f"by {by}: {nbytes / 1e6:.2f} MB; {b / ms * 100:.1f}% of bound; "
              f"SM clock, max SM clock now: "
              f"{card_line('clocks.sm,clocks.max.sm')}")
        if name == "table_scatter_add":
            fill = sum(v for k, v in by_name.items() if "emset" in k)
            print(f"K4 apart: zero fill of {N * 64 / 1e6:.2f} MB {fill:.4f} "
                  f"ms, add kernel {ms - fill:.4f} ms per call (device)")
        rows.append(dict(
            name=name, route="cuda",
            source="wildgs_slam_tpu_torch/csrc/table_gather.cu",
            replaces=("scripts/microbench_gather.py:75" if name ==
                      "table_gather" else "scripts/microbench_gather.py:102"),
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b, bound_by=by, library_ms=lib_ms))
    return rows


def k2_overflow_check(counts, table, tw, ck, dev):
    """K2 against its plain version where exp(power) overflows: phase 3's
    table with one tile's front made opaque (so that a chunk below its
    count saturates) and indefinite conics (a = c = -2, b = 0: power =
    dx^2 + dy^2, inf past ~9.4 px) in a live slot of an open chunk, a live
    slot of the saturated chunk and a slot past a count inside an open
    chunk. NaN positions must be equal, every other value within max-rel
    BWD_MAX_REL."""
    T, K, _ = table.shape
    tab = table.clone()
    cnt = counts.clone()
    order = torch.argsort(cnt, descending=True).tolist()
    sat_t, open_t = order[0], order[1]          # the two fullest tiles
    past_t = next(t for t in order if 0 < int(cnt[t]) % ck and t not in (
        sat_t, open_t))

    def centre(t):
        return ((t % tw) * 16.0 + 7.5, (t // tw) * 16.0 + 7.5)
    cx, cy = centre(sat_t)
    tab[sat_t, :12, 0], tab[sat_t, :12, 1] = cx, cy
    tab[sat_t, :12, 2] = tab[sat_t, :12, 4] = 1 / 144
    tab[sat_t, :12, 3] = 0.0
    tab[sat_t, :12, 8] = 0.995
    slots = [(open_t, 5), (sat_t, ck + 3), (past_t, int(cnt[past_t]))]
    for t, k in slots:
        cx, cy = centre(t)
        tab[t, k, 0], tab[t, k, 1] = cx, cy
        tab[t, k, 2] = tab[t, k, 4] = -2.0
        tab[t, k, 3] = 0.0
    tid = torch.arange(T, dtype=torch.int32, device=dev)
    bg = torch.tensor([0.1, 0.5, 0.9], device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    gc = torch.randn(T, 256, 3, device=dev, generator=g)
    gd, ga, gt = (torch.randn(T, 256, device=dev, generator=g)
                  for _ in range(3))
    _, _, _, tfin, tentry = cc.composite_fwd_plain(cnt, tid, tab, bg, tw, ck)
    saturated = bool(tentry[sat_t, 1].amax() < 1e-4) and int(cnt[sat_t]) > ck
    if not (saturated and bool(tentry[open_t, 0].amax() >= 1e-4)):
        raise AssertionError("K2 overflow table: chunk 1 of the opaque tile "
                             "is not saturated, or chunk 0 of the open one "
                             "is")
    args = (cnt, tid, tab, bg, tentry, tfin, gc, gd, ga, gt, tw, ck)
    k_d = cc.composite_bwd(*args)
    p_d = cc.composite_bwd_plain(*args)
    torch.cuda.synchronize()
    nan_k, nan_p = torch.isnan(k_d), torch.isnan(p_d)
    n_nan = int(nan_p.sum())
    rel = float((k_d[~nan_p] - p_d[~nan_p]).abs().max()
                / p_d[~nan_p].abs().max())
    print(f"K2 where exp overflows (tiles/slots {slots}: open chunk, "
          f"saturated chunk, past the count): NaN positions "
          f"{'equal' if torch.equal(nan_k, nan_p) else 'DIFFER'} "
          f"({int(nan_k.sum())} kernel, {n_nan} plain, {len(slots) * 6} "
          f"expected), the rest max-rel {rel:.3e}")
    if not (torch.equal(nan_k, nan_p) and n_nan == len(slots) * 6
            and rel < BWD_MAX_REL):
        raise AssertionError("K2 disagrees with its plain version where "
                             "exp overflows")


def kernel_phase(dev):
    counts, table, overflow, tw, attrs, ids = mapping_table(dev)
    T, K, _ = table.shape
    ck = 64
    n_chunks = K // ck
    print(f"parity scene: N={mapping_table.__defaults__[0]} T={T} K={K} ck={ck} "
          f"counts mean={float(counts.float().mean()):.1f} "
          f"max={int(counts.max())} overflow={overflow}")
    tid = torch.arange(T, dtype=torch.int32, device=dev)
    bg = torch.tensor([0.1, 0.5, 0.9], device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    gc = torch.randn(T, 256, 3, device=dev, generator=g)
    gd, ga, gt = (torch.randn(T, 256, device=dev, generator=g)
                  for _ in range(3))

    k_out = cc.composite_fwd(counts, tid, table, bg, tw, ck)
    p_out = cc.composite_fwd_plain(counts, tid, table, bg, tw, ck)
    fwd_err = {}
    for name, a, b in zip(TOL, k_out, p_out):
        fwd_err[name] = float((a - b).abs().max())
        if not fwd_err[name] <= TOL[name]:
            raise AssertionError(f"K1 {name}: max-abs {fwd_err[name]} > "
                                 f"{TOL[name]}")
    print("K1 max-abs err vs plain:", json.dumps(fwd_err))
    tentry, tfin = p_out[4], p_out[3]
    bargs = (counts, tid, table, bg, tentry, tfin, gc, gd, ga, gt, tw, ck)
    k_d = cc.composite_bwd(*bargs)
    p_d = cc.composite_bwd_plain(*bargs)
    bwd_abs = float((k_d - p_d).abs().max())
    bwd_rel = bwd_abs / float(p_d.abs().max())
    print(f"K2 dattrs vs plain: max-abs {bwd_abs:.3e} max-rel {bwd_rel:.3e}")
    if not bwd_rel < BWD_MAX_REL:
        raise AssertionError(f"K2 max-rel {bwd_rel} >= {BWD_MAX_REL}")
    if not KERNELS_FROM:
        k2_overflow_check(counts, table, tw, ck, dev)

    # the work these inputs need: live slots of the chunks a tile opens, and
    # of their slot-pixel pairs those alive (alpha >= 1/255, t_after >= 1e-4)
    starts = torch.arange(n_chunks, device=dev) * ck
    opened = (starts[None] < counts[:, None]) & (tentry.amax(-1) >= 1e-4)
    live = torch.clamp(counts[:, None].long() - starts[None], 0, ck)
    slots = int((live * opened).sum())
    slot_pixels = slots * 256
    px, py = cc.tile_pixel_coords(tid, tw)
    alive = 0
    for c in range(n_chunks):
        sl = slice(c * ck, (c + 1) * ck)
        a_c, _, _, _, _, dead = cc._chunk_geometry(
            table[:, sl], cc._chunk_live(counts, c, ck), px, py)
        one_m = torch.clamp(1.0 - a_c, min=cc.ONE_M_MIN)
        t_after = tentry[:, c][:, None, :] * torch.cumprod(one_m, dim=1)
        alive += int((~dead & (t_after >= 1e-4) & opened[:, c, None, None]
                      ).sum())
    f4 = 4
    fwd_bytes = (slots * 16 * f4 + T * 8
                 + T * 256 * 6 * f4 + T * n_chunks * 256 * f4)
    bwd_bytes = (slots * 16 * f4 + T * 8 + T * n_chunks * 256 * f4
                 + T * 256 * 5 * f4 + T * K * 16 * f4)
    fwd_ops = (OPS_PER_LIVE_PAIR * slot_pixels
               + FWD_OPS_PER_ALIVE_PAIR * alive)
    bwd_ops = (OPS_PER_LIVE_PAIR * slot_pixels
               + BWD_OPS_PER_ALIVE_PAIR * alive)
    print(f"work: {slots} live slots in {int(opened.sum())} open chunks; "
          f"{slot_pixels} live slot-pixels, of them {alive} alive "
          f"({alive / slot_pixels * 100:.2f}%: alpha >= 1/255 and t_after >= "
          f"1e-4); bound counting: {OPS_PER_LIVE_PAIR} fp32 ops per live "
          f"slot-pixel plus {FWD_OPS_PER_ALIVE_PAIR} (fwd) / "
          f"{BWD_OPS_PER_ALIVE_PAIR} (bwd) per alive one at "
          f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s, bytes of live table rows, "
          f"tables and outputs read or written once at "
          f"{BYTES_PER_S / 1e12:.2f} TB/s")

    rows = table_kernel_rows(attrs, ids, dev)
    for name, fn, plain, ops, nbytes, err, src, line in (
            ("composite_fwd",
             lambda: cc.composite_fwd(counts, tid, table, bg, tw, ck),
             lambda: cc.composite_fwd_plain(counts, tid, table, bg, tw, ck),
             fwd_ops, fwd_bytes,
             max(fwd_err.values()), "composite_fwd.cu", 118),
            ("composite_bwd", lambda: cc.composite_bwd(*bargs),
             lambda: cc.composite_bwd_plain(*bargs),
             bwd_ops, bwd_bytes, bwd_abs,
             "composite_bwd.cu", 182)):
        ms, _, plain_ms = timed_row(name, fn, plain, 5, 50, 3, 1)
        b, by, t_ops, t_bytes = bound(ops, nbytes)
        print(f"{name}: bound {b:.4f} ms by {by}: {ops / 1e9:.3f} G fp32 ops "
              f"-> {t_ops:.4f} ms, {nbytes / 1e6:.2f} MB -> {t_bytes:.4f} ms; "
              f"{b / ms * 100:.1f}% of bound")
        rows.append(dict(
            name=name, route="cuda",
            source=f"wildgs_slam_tpu_torch/csrc/{src}",
            replaces=f"wildgs_slam_tpu/ops/rasterizer/pallas_composite.py:"
                     f"{line}",
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b, bound_by=by, library_ms=None))
    return rows


def small_render_check(dev):
    """render_fused (kernels) against the per-pixel oracle on a small
    scene: finite, right shape, and equal within the kernel tolerances."""
    rng = np.random.RandomState(2)
    n, h, w = 200, 48, 64
    means = np.concatenate([rng.uniform(-1, 1, (n, 2)),
                            2 + 2 * rng.uniform(size=(n, 1))], -1)
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=-1, keepdims=True)
    args = [t32(a, dev) for a in (
        means, 0.02 + 0.08 * rng.uniform(size=(n, 3)), rots,
        0.3 + 0.6 * rng.uniform(size=n), rng.uniform(size=(n, 1, 3)),
        [0, 0, 0, 0, 0, 0, 1], [55.0, 55.0, w / 2, h / 2])]
    with torch.no_grad():
        a = tr.render_fused(*args, (h, w), capacity=256, chunk=64)
        b = tr.render_reference(*args, (h, w))
    err = {k: float((getattr(a, k) - getattr(b, k)).abs().max())
           for k in ("color", "depth", "alpha")}
    print("render_fused vs render_reference (48x64, 200 Gaussians):",
          json.dumps(err))
    if tuple(a.color.shape) != (h, w, 3) or not bool(
            torch.isfinite(a.color).all()):
        raise AssertionError("render_fused output malformed")
    if err["color"] > 1e-5 or err["alpha"] > 1e-5 or err["depth"] > 1e-4:
        raise AssertionError(f"render_fused disagrees with the oracle: {err}")


# ---------------------------------------------------------------------------
# phase 5: the mapper's keyframe path
# ---------------------------------------------------------------------------

def room_scene(cfg, n_kf, seed=0, step=1.0, camera=None, first=0,
               dino=True):
    """A textured box room seen by a camera moving through it: per keyframe
    an image, an exact metric depth and a world->camera pose, plus random
    DINO features (None without `dino`); all from numpy with a seed. `step`
    scales the motion between consecutive frames; the frames are first,
    first + 1, ... of the trajectory. `camera` ((H, W), (fx, fy, cx, cy))
    renders at that size and those intrinsics instead of the config's
    output camera."""
    cam = cfg["cam"]
    if camera is None:
        H, W = cam["H_out"], cam["W_out"]
        sx = W / (cam["W"] - 2 * cam["W_edge"])
        sy = H / (cam["H"] - 2 * cam["H_edge"])
        fx, fy = cam["fx"] * sx, cam["fy"] * sy
        cx = (cam["cx"] - cam["W_edge"]) * sx
        cy = (cam["cy"] - cam["H_edge"]) * sy
    else:
        (H, W), (fx, fy, cx, cy) = camera
    intr = np.array([fx, fy, cx, cy], np.float32)
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    rays_c = np.stack([(xx - cx) / fx, (yy - cy) / fy, np.ones_like(xx)], -1)
    half = np.array([3.0, 2.0, 5.0])
    frames = []
    for i in range(first, first + n_kf):
        u = step * i
        xi = np.array([0.08 * u, 0.02 * np.sin(u), 0.04 * u,
                       0.02 * np.cos(u), 0.12 * u, 0.0], np.float32)
        w2c = lie.se3_exp(torch.as_tensor(xi)).numpy()
        c2w = lie.se3_inv(torch.as_tensor(w2c)).numpy()
        R = lie.quat_to_matrix(torch.as_tensor(c2w[3:])).numpy()
        o = c2w[:3]
        d = rays_c @ R.T
        # distance along each ray to the box walls
        with np.errstate(divide="ignore", invalid="ignore"):
            tw = np.where(d > 0, (half - o) / d, (-half - o) / d)
        tw = np.where(np.isfinite(tw) & (tw > 0), tw, np.inf)
        t = tw.min(-1)
        p = o + t[..., None] * d
        depth = (t * rays_c[..., 2]).astype(np.float32)
        img = np.stack([0.5 + 0.35 * np.sin(3.1 * p[..., 0] + 1.7 * p[..., 1]),
                        0.5 + 0.35 * np.cos(2.3 * p[..., 2] - 1.1 * p[..., 0]),
                        0.5 + 0.25 * np.sin(4.0 * p[..., 1] + 0.7 * p[..., 2])
                        * np.cos(1.3 * p[..., 0])], -1)
        img = np.clip(img + 0.01 * rng.normal(size=img.shape), 0, 1)
        feats = (rng.normal(size=(H // 14, W // 14, 384)).astype(np.float32)
                 if dino else None)
        frames.append((w2c, depth, img.astype(np.float32), feats))
    return (H, W), intr, frames


def device_summary(prof):
    """From a torch.profiler trace: the device's busy time (the union of its
    operations' intervals, so that overlapping operations count once), the
    sum of the operations' own times, their count, and {name: [us, n]}."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            s = by_name.setdefault(e.name, [0.0, 0])
            s[0] += e.time_range.elapsed_us()
            s[1] += 1
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    total = sum(us for us, _ in by_name.values())
    return busy, total, len(spans), by_name


def profile_steps(mapper, n_steps):
    """torch.profiler over n_steps mapping iterations: wall and device time
    per step, device-busy share, kernel count and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    pool = np.array(mapper.current_window)
    probs = np.full(len(pool), 1.0 / len(pool))
    mapper._opt_steps(2, pool, probs, 20, False)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mapper._opt_steps(n_steps, pool, probs, 20, False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, dev_us, n_kernels, by_name = device_summary(prof)
    print(f"profile: {n_steps} steps, wall {wall / n_steps * 1e3:.2f} "
          f"ms/step, device {dev_us / 1e3 / n_steps:.2f} ms/step, busy "
          f"{busy_us / 1e6 / wall * 100:.1f}%, {n_kernels / n_steps:.0f} "
          f"device ops/step")
    for name, (us, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :12]:
        print(f"  {us / 1e3 / n_steps:8.3f} ms/step  x{cnt // n_steps:<4d} "
              f"{name[:90]}")


@torch.no_grad()
def keyframe_psnr(mapper, frames, render_fn=tr.render_fused):
    """PSNR of each keyframe's render (exposure applied) against its
    image."""
    p = mapper.gaussians.params
    out = []
    for v, (_, _, img, _) in enumerate(frames):
        r = render_fn(
            p.xyz, gm.get_scaling(p), gm.get_rotation_xyzw(p),
            gm.get_opacity(p), gm.get_sh(p), mapper.vstore.w2c[v],
            mapper.intrinsics_full, mapper.image_size,
            alive=mapper.gaussians.aux.alive,
            capacity=mapper.render_list_capacity, chunk=64)
        e = mapper.vstore.exposure[v]
        col = torch.clamp(torch.exp(e[0]) * r.color + e[1], 0, 1)
        mse = float(((col - torch.as_tensor(img, device=col.device)) ** 2
                     ).mean())
        out.append(-10 * np.log10(max(mse, 1e-12)))
    return out


@torch.no_grad()
def overflow_breakdown(mapper):
    """Split the final map's binning overflow, per keyframe view, into
    capacity drops and kw-window truncation."""
    p = mapper.gaussians.params
    rows = []
    for v in mapper.video_idxs:
        proj = tr.project_gaussians(
            p.xyz, gm.get_scaling(p), gm.get_rotation_xyzw(p),
            gm.get_opacity(p), gm.get_sh(p), mapper.vstore.w2c[v],
            mapper.intrinsics_full, mapper.image_size)
        valid = proj.valid & mapper.gaussians.aux.alive
        args = (proj.mean2d, proj.radius, proj.depth, valid,
                mapper.image_size)
        full = tr.bin_gaussians(*args, capacity=mapper.render_list_capacity)
        wide = tr.bin_gaussians(*args, capacity=8192)
        rows.append((v, int(full.overflow), int(wide.overflow),
                     int(wide.counts.max())))
    print("slice: final binning per view (view, overflow, of which window "
          "truncation, max tile count):", json.dumps(rows))


def slice_phase(dev):
    cfg = load_config(CONFIG)
    n_init = N_INIT_KEYFRAMES
    n_kf = n_init + N_ONLINE_KEYFRAMES
    reduced = {}
    reduced["tracking.buffer"] = f"{cfg['tracking']['buffer']} -> {n_kf}"
    reduced["keyframes"] = (f"{n_init} at initialize_mapper, then "
                            f"{N_ONLINE_KEYFRAMES} on_keyframe calls")
    reduced["scene"] = ("synthetic textured box room, seed 0; metric depth "
                        "prior = exact depth")
    reduced["dino_feats"] = "random normal (numpy seed 0)"
    reduced["uncertainty MLP"] = "flax-style init from torch seed 1"
    print("reduced:", json.dumps(reduced))
    cfg["tracking"]["buffer"] = n_kf

    (H, W), intr, frames = room_scene(cfg, n_kf)
    state = SlamState.create(cfg, H, W, intr, buffer=n_kf, device=dev)
    for i, (w2c, depth, img, dino) in enumerate(frames):
        kstore.append(state.store, i, float(i), pose=torch.as_tensor(w2c),
                      mono_depth_up=torch.as_tensor(depth))
        state.append_host(i, img, dino, float(i))
    mapper = Mapper(state, cfg, rng_seed=0, device=dev)
    mc = cfg["mapping"]
    print(f"slice state: {n_kf} keyframes {H}x{W}, DINO ({H // 14}, "
          f"{W // 14}, 384), capacity {mc['gaussian_capacity']}, list "
          f"capacity {mc['render_list_capacity']}, bin {mapper.bin_method} "
          f"kw {mapper.bin_kw}, chunk 64")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    TIMER.reset()
    reset_launches()
    t0 = time.perf_counter()
    mapper.initialize_mapper(n_init - 1)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_init_steps = len(mapper.step_losses)
    alive_init = gm.num_alive(mapper.gaussians)
    t1 = time.perf_counter()
    for v in range(n_init, n_kf):
        mapper.on_keyframe(v, v)
    torch.cuda.synchronize()
    t_online = time.perf_counter() - t1
    launches = read_launches()
    steps = len(mapper.step_losses)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    ls = np.asarray(mapper.step_losses)
    alive = gm.num_alive(mapper.gaussians)
    print(f"slice: {steps} steps ({n_init_steps} init + "
          f"{steps - n_init_steps} online); init {t_init:.2f} s, online "
          f"{t_online:.2f} s; ms/iteration {(t_init + t_online) / steps * 1e3:.2f}"
          f" overall, {t_online / max(steps - n_init_steps, 1) * 1e3:.2f} "
          f"online (both include densify, seeding and covisibility renders)")
    print(f"slice: alive Gaussians {alive_init} after init, {alive} at end; "
          f"overflow events {mapper.overflow_events}, max dropped entries "
          f"{mapper.max_overflow}; peak device memory {peak:.2f} GiB")
    print(f"slice: loss first {ls[0]:.4f}, mean first 20 "
          f"{ls[:20].mean():.4f}, mean last 20 {ls[-20:].mean():.4f}, last "
          f"{ls[-1]:.4f}")
    print("slice: launches", json.dumps(launches))
    print("phases:\n" + TIMER.report())
    if any(n != steps for n in launches.values()):
        raise AssertionError(f"kernel launches {launches} != {steps} steps")
    p = mapper.gaussians.params
    if not (np.all(np.isfinite(ls)) and all(
            bool(torch.isfinite(x).all()) for x in p.tensors())):
        raise AssertionError("non-finite loss or parameters")
    init_ls = ls[:n_init_steps]
    if not init_ls[-20:].mean() < init_ls[:20].mean():
        raise AssertionError("the initial map optimization did not lower "
                             "the loss")
    psnr = keyframe_psnr(mapper, frames)
    print("slice: PSNR per keyframe [dB]:",
          json.dumps([round(x, 2) for x in psnr]))
    overflow_breakdown(mapper)
    profile_steps(mapper, 8)
    return launches


# ---------------------------------------------------------------------------
# phase 6: the tracking frontend, handing its keyframes to the mapper
# ---------------------------------------------------------------------------

def profile_window(fn, label):
    """torch.profiler over fn(): wall and device time, device-busy share and
    the top device operations."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, dev_us, n_ops, by_name = device_summary(prof)
    print(f"{label} profile: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms ({busy_us / 1e6 / wall * 100:.1f}%; the "
          f"operations' own times sum to {dev_us / 1e3:.1f} ms), {n_ops} "
          f"device ops")
    for name, (us, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :12]:
        print(f"  {us / 1e3:8.3f} ms  x{cnt:<5d} {name[:90]}")


def run_tracking(cfg, intr, frames, model, dev, oracle):
    """Feed frames through MotionFilter.track and Frontend.__call__ as the
    system's frame loop does, handing the warmup keyframes to
    Mapper.initialize_mapper (oracle run only) before
    Frontend.initialize_second_stage; stop once TRACK_UPDATES frontend
    updates have run. Returns the run's record."""
    t = cfg["tracking"]
    H, W = frames[0][1].shape
    state = SlamState.create(cfg, H, W, intr, buffer=t["buffer"], device=dev)
    mapper = Mapper(state, cfg, rng_seed=0, device=dev)
    train_frac = cfg["mapping"]["uncertainty_params"]["train_frac_fix"]
    frontend = Frontend(
        state, model, cfg, uncertainty_update_fn=lambda: (
            system.uncertainty_update(state, mapper.uncer_mlp, train_frac)))
    cur = [0]
    mf = MotionFilter(
        state, model, thresh=1e9 if oracle else t["motion_filter"]["thresh"],
        force_keyframe_every_n_frames=(
            1 if oracle else t["force_keyframe_every_n_frames"]),
        depth_fn=lambda im: frames[cur[0]][1],
        feat_fn=lambda im: frames[cur[0]][3])
    graph = frontend.graph
    if oracle:
        sh, sw = kstore.slice_hw(H, W)
        poses_gt = torch.as_tensor(np.stack([f[0] for f in frames]),
                                   device=dev)
        disps_gt = torch.as_tensor(np.stack([1.0 / f[1][sh, sw]
                                             for f in frames]), device=dev)

        def gt_injection(store, counter):
            ts = store.timestamp.long().clamp(0, len(frames) - 1)
            return poses_gt[ts], disps_gt[ts]
        graph.gt_injection = gt_injection

    upd = {"calls": 0, "iters": 0, "s": 0.0}
    update_n = graph.update_n

    def timed_update_n(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = update_n(*a, **k)
        torch.cuda.synchronize()
        upd["s"] += time.perf_counter() - t0
        upd["calls"] += 1
        upd["iters"] += out[0] if out else 0
        return out
    graph.update_n = timed_update_n

    rec = dict(mapper=mapper, state=state, frontend=frontend)
    frame_s, last_kf = [], [0]

    def step(i):
        """One frame of the system's loop; its time excludes the mapper."""
        cur[0] = i
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frontend(mf.track(float(i), frames[i][2]))
        kf = state.counter - 1
        t_map = 0.0
        if (kf != last_kf[0] and frontend.is_initialized
                and state.counter == frontend.warmup):
            if oracle:
                kf_frames = [frames[int(state.timestamps[v])]
                             for v in range(kf + 1)]
                opt = mapper.initialize_map_opt

                def fit_before_opt():
                    # the keyframes are seeded: the map's fit before any
                    # step, rendered with the plain composite (no kernel
                    # launches inside the counted handoff)
                    rec["psnr_seeded"] = keyframe_psnr(mapper, kf_frames,
                                                       tr.render)
                    opt()
                mapper.initialize_map_opt = fit_before_opt
                t1 = time.perf_counter()
                mapper.initialize_mapper(kf)
                torch.cuda.synchronize()
                t_map = time.perf_counter() - t1
                rec.update(map_s=t_map, map_steps=len(mapper.step_losses),
                           psnr_init=keyframe_psnr(mapper, kf_frames,
                                                   tr.render))
            frontend.initialize_second_stage()
        last_kf[0] = kf
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0 - t_map)

    n_frames = 0
    reset_launches()
    while n_frames < len(frames) and frontend.n_updates < TRACK_UPDATES:
        step(n_frames)
        n_frames += 1
    rec["launches"] = read_launches()
    if frontend.n_updates < TRACK_UPDATES:
        raise AssertionError(f"only {frontend.n_updates} frontend updates in "
                             f"{n_frames} frames")
    rec.update(frames=n_frames, frame_s=frame_s, upd=upd, step=step)
    return rec


def tracking_report(rec, label):
    state, fe = rec["state"], rec["frontend"]
    g = fe.graph
    upd = rec["upd"]
    n = state.counter
    p = state.store.poses[:n]
    d = state.store.disps[:n]
    deg = np.bincount(np.concatenate([g.ii, g.ii_inac]).astype(np.int64))
    print(f"{label}: {rec['frames']} frames -> {n} keyframes, "
          f"{fe.n_updates} frontend updates; {g.E} edges "
          f"({len(g.ii_inac)} inactive), largest source-frame degree "
          f"{int(deg.max())}; {np.mean(rec['frame_s']) * 1e3:.1f} ms per "
          f"frame (max {np.max(rec['frame_s']) * 1e3:.1f}), "
          f"{upd['s'] / max(upd['iters'], 1) * 1e3:.2f} ms per update_n "
          f"iteration ({upd['iters']} iterations in {upd['calls']} calls)")
    if not (bool(torch.isfinite(p).all()) and bool(torch.isfinite(d).all())):
        raise AssertionError(f"{label}: non-finite poses or disparities")
    return n


def tracking_phase(dev):
    """Phase 6 at the full widths of tum_dynamic.yaml."""
    cfg = load_config(CONFIG)
    t = cfg["tracking"]
    (H, W), intr, frames = room_scene(cfg, ORACLE_FRAMES, seed=3,
                                      step=TRACK_STEP)
    model = droid_net.init_droid_net(torch.Generator().manual_seed(0),
                                     device=dev)
    reduced = {
        "tracking": (f"buffer {t['buffer']}, warmup {t['warmup']}, window "
                     f"{t['frontend']['window']}, max_factors "
                     f"{t['frontend']['max_factors']} (not cut)"),
        "scene": (f"synthetic textured box room, motion per frame "
                  f"{TRACK_STEP} of the mapping scene's; metric depth prior = "
                  f"exact depth; DINO features random normal (numpy seed 3)"),
        "DROID weights": "flax-style init from torch seed 0 (no droid.pth)",
        "oracle run": ("motion filter thresh 3.0 -> 1e9 and "
                       "force_keyframe_every_n_frames 9 -> 1 (every frame a "
                       "keyframe, as tests/test_integrated_ate.py); update "
                       "operator -> ground-truth targets (gt_injection)"),
        "mapper": ("initialize_mapper at the warmup handoff only (its "
                   "configured iterations); no on_keyframe, backend, loop "
                   "closure, online BA or evaluation"),
        "frames": (f"until {TRACK_UPDATES} frontend updates (at most "
                   f"{ORACLE_FRAMES} oracle, {NETWORK_FRAMES} network)"),
    }
    print("tracking reduced:", json.dumps(reduced))

    # --- oracle run ---
    rec = run_tracking(cfg, intr, frames, model, dev, oracle=True)
    n = tracking_report(rec, "tracking oracle")
    state = rec["state"]
    ts = state.store.timestamp[:n].long().cpu().numpy()
    est = lie.se3_inv(state.store.poses[:n]).cpu().numpy()[:, :3]
    gt = lie.se3_inv(torch.as_tensor(np.stack(
        [frames[k][0] for k in ts]))).numpy()[:, :3]
    ate = ape_statistics(est.astype(np.float64), gt.astype(np.float64))
    ls = np.asarray(rec["mapper"].step_losses)
    steps = rec["map_steps"]
    before, after = np.mean(rec["psnr_seeded"]), np.mean(rec["psnr_init"])
    print(f"tracking oracle: keyframe ATE rmse {ate['rmse'] * 100:.4f} cm "
          f"(max {ate['max'] * 100:.4f} cm, scale {ate['scale']:.5f}, "
          f"{ate['n']} keyframes); mapper init {steps} steps in "
          f"{rec['map_s']:.2f} s; launches in the run "
          f"{json.dumps(rec['launches'])}")
    seg_means = [round(float(ls[a:a + 150].mean()), 4)
                 for a in range(0, len(ls), 150)]
    print(f"tracking oracle: mapper init loss, mean of each 150 steps: "
          f"{json.dumps(seg_means)}")
    print(f"tracking oracle: keyframe PSNR [dB], mean {before:.2f} seeded -> "
          f"{after:.2f} after init; per keyframe "
          f"{json.dumps([round(x, 2) for x in rec['psnr_init']])}")
    if not ate["rmse"] < ATE_MAX:
        raise AssertionError(f"oracle keyframe ATE {ate['rmse']} m >= "
                             f"{ATE_MAX} m")
    # the total loss is no measure of fit to compare across steps: its
    # uncertainty terms (log sigma, DINO regularisation) move with the MLP,
    # and the opacity reset at iteration 500 spikes it; the photometric
    # error of every keyframe's render is
    if not (np.all(np.isfinite(ls)) and after - before > PSNR_GAIN_MIN
            and after > PSNR_MIN):
        raise AssertionError(
            f"the mapper's initial optimization did not fit the keyframes: "
            f"mean PSNR {before:.2f} -> {after:.2f} dB (must rise by more "
            f"than {PSNR_GAIN_MIN} dB, to above {PSNR_MIN} dB)")
    # the frontend launches none of K1-K4; the handoff one of each per step
    if any(v != steps for v in rec["launches"].values()):
        raise AssertionError(f"tracking run launches {rec['launches']} != "
                             f"{steps} mapping steps")
    launches = rec["launches"]
    del rec, state
    gc.collect()

    # --- network run ---
    _, _, frames_net = room_scene(cfg, NETWORK_FRAMES, seed=4,
                                  step=TRACK_STEP)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = run_tracking(cfg, intr, frames_net, model, dev, oracle=False)
    tracking_report(rec, "tracking network")
    print(f"tracking network: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    fe = rec["frontend"]
    i0 = rec["frames"]

    def more_frames():
        k = i0
        n0 = fe.n_updates
        while fe.n_updates == n0 and k < len(frames_net):
            rec["step"](k)
            k += 1
    profile_window(more_frames, "tracking network (frames to the next "
                   "frontend update)")
    network_dense_ba(rec, model, cfg, dev)
    return launches


def lowmem_steps(label):
    """ms per update_lowmem step from the TIMER's track.lowmem.step phase
    (each step ends in a device sync)."""
    st = TIMER.stats.get("track.lowmem.step")
    if st is None or st.count == 0:
        raise AssertionError(f"{label}: no update_lowmem step ran")
    print(f"{label}: {st.count} update_lowmem steps, {st.total / st.count * 1e3:.1f}"
          f" ms per step (first {st.first * 1e3:.1f}, warm mean "
          f"{st.warm_mean * 1e3:.1f}, min {st.min * 1e3:.1f}, max "
          f"{st.max * 1e3:.1f})")


def network_dense_ba(rec, model, cfg, dev):
    """One Backend.dense_ba(2) on the network run's keyframes: the global
    BA with the on-the-fly correlation (alt_corr) at full width."""
    state = rec["state"]
    train_frac = cfg["mapping"]["uncertainty_params"]["train_frac_fix"]
    backend = Backend(state, model, cfg, uncertainty_update_fn=lambda: (
        system.uncertainty_update(state, rec["mapper"].uncer_mlp,
                                  train_frac)))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    TIMER.reset()
    t0 = time.perf_counter()
    n, n_edges = backend.dense_ba(2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lowmem_steps("tracking network dense_ba(2)")
    print(f"tracking network dense_ba(2): {n} keyframes, {n_edges} edges, "
          f"{wall * 1e3:.1f} ms in all; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    p = state.store.poses[:n]
    if not (n_edges > 0 and bool(torch.isfinite(p).all())):
        raise AssertionError("network dense_ba: no edges or non-finite poses")


# ---------------------------------------------------------------------------
# phase 7: the whole system through SLAM.run()
# ---------------------------------------------------------------------------

class SceneStream:
    """room_scene's frames as the stream SLAM reads: (index, image, None,
    camera-to-world 4x4); depth_fn and feat_fn give each image's exact depth
    and its DINO features."""

    def __init__(self, intr, frames):
        self.intrinsic = np.asarray(intr, np.float64)
        self.frames = frames
        self.by_id = {id(f[2]): f for f in frames}
        self.poses = lie.se3_matrix(lie.se3_inv(torch.as_tensor(np.stack(
            [f[0] for f in frames])))).numpy().astype(np.float64)

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return i, self.frames[i][2], None, self.poses[i]

    def depth_fn(self, image):
        return self.by_id[id(image)][1]

    def feat_fn(self, image):
        return self.by_id[id(image)][3]


def system_phase(dev):
    """SLAM.run() on the tracking scene, under the oracle; returns the
    kernels' launches."""
    n_frames, cuts = SYSTEM_FRAMES, SYSTEM_CUTS
    cfg = load_config(CONFIG)
    cfg["scene"] = "system_phase"
    cfg["data"]["output"] = os.path.join(HERE, "build", "chip_smoke")
    cfg["verbose"] = False
    t = cfg["tracking"]
    t["force_keyframe_every_n_frames"] = 1
    t["motion_filter"]["thresh"] = 1e9
    tr_cfg = cfg["mapping"]["Training"]
    reduced = {k: f"{(cfg['mapping'] if k == 'final_refine_iters' else tr_cfg)[k]}"
               f" -> {v}" for k, v in cuts.items()}
    cfg["mapping"]["final_refine_iters"] = cuts["final_refine_iters"]
    tr_cfg.update(init_itr_num=cuts["init_itr_num"],
                  mapping_itr_num=cuts["mapping_itr_num"])
    reduced["pose_refine_iters"] = f"{tr_cfg.get('pose_refine_iters', 100)} (not cut)"
    reduced["frames"] = (f"{n_frames} of the tracking scene (seed 3) at half "
                         f"its motion per frame ({SYSTEM_STEP} of the mapping "
                         f"scene's), every one a keyframe "
                         f"(force_keyframe_every_n_frames 1, motion filter "
                         f"thresh 1e9, as tests/test_integrated_ate.py)")
    reduced["oracle"] = ("gt_injection on the frontend's graph and the "
                         "backend: ground-truth targets for the update "
                         "operator; the trajectory filler runs the network")
    reduced["DROID weights"] = "flax-style init from torch seed 0"
    print("system reduced:", json.dumps(reduced))
    print(f"system config: {cfg['cam']['H_out']}x{cfg['cam']['W_out']}, "
          f"buffer {t['buffer']}, capacity "
          f"{cfg['mapping']['gaussian_capacity']}, list capacity "
          f"{cfg['mapping']['render_list_capacity']}, window "
          f"{t['frontend']['window']}, max_factors "
          f"{t['frontend']['max_factors']}, enable_loop "
          f"{t['frontend']['enable_loop']}, enable_online_ba "
          f"{t['frontend']['enable_online_ba']} (ba_freq "
          f"{t['backend']['ba_freq']}), final_ba {t['backend']['final_ba']}, "
          f"fast_mode {cfg['fast_mode']}, metric_depth_reg "
          f"{t['backend']['metric_depth_reg']}, uncertainty "
          f"{t['uncertainty_params']['activate']}")

    (H, W), intr, frames = room_scene(cfg, n_frames, seed=3, step=SYSTEM_STEP)
    stream = SceneStream(intr, frames)
    model = droid_net.init_droid_net(torch.Generator().manual_seed(0),
                                     device=dev)
    slam = system.SLAM(cfg, stream, depth_fn=stream.depth_fn,
                       feat_fn=stream.feat_fn, model=model, device=dev)
    sh, sw = kstore.slice_hw(H, W)
    poses_gt = torch.as_tensor(np.stack([f[0] for f in frames]), device=dev)
    disps_gt = torch.as_tensor(np.stack([1.0 / f[1][sh, sw] for f in frames]),
                               device=dev)

    def gt_injection(store, counter):
        ts = store.timestamp.long().clamp(0, n_frames - 1)
        return poses_gt[ts], disps_gt[ts]
    slam.frontend.graph.gt_injection = gt_injection
    slam.backend.gt_injection = gt_injection

    mapper = slam.mapper
    loops = []
    loop_ba = slam.backend.loop_ba

    def counted_loop_ba(*a, **k):
        out = loop_ba(*a, **k)
        loops.append(out[1])
        return out
    slam.backend.loop_ba = counted_loop_ba
    # a profiler window (device activity) over the loop's last frame:
    # tracking, loop closure, the mapper's keyframe step; closed before
    # terminate
    from torch.profiler import ProfilerActivity, profile

    marks = {}
    window = profile(activities=[ProfilerActivity.CUDA])
    track = slam.motion_filter.track

    def windowed_track(tstamp, image):
        if int(tstamp) == n_frames - 1:
            torch.cuda.synchronize()
            window.__enter__()
            marks["window"] = time.perf_counter()
        return track(tstamp, image)
    slam.motion_filter.track = windowed_track
    terminate = slam.terminate

    def timed_terminate():
        torch.cuda.synchronize()
        marks["loop_end"] = time.perf_counter()
        marks["loop_peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
        window.__exit__(None, None, None)
        terminate()
    slam.terminate = timed_terminate

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    TIMER.reset()
    reset_launches()
    t0 = time.perf_counter()
    slam.run()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = read_launches()
    renders = mapper.fused_renders
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t_loop = marks["loop_end"] - t0

    print(f"system: {n_frames} frames -> {slam.state.counter} keyframes; "
          f"run {t_end - t0:.2f} s: frame loop {t_loop:.2f} s "
          f"({t_loop / n_frames * 1e3:.1f} ms per frame), terminate "
          f"{t_end - marks['loop_end']:.2f} s; peak device memory "
          f"{marks['loop_peak']:.2f} GiB through the loop, {peak:.2f} GiB in "
          f"all")
    busy_us, dev_us, n_ops, _ = device_summary(window)
    wall = marks["loop_end"] - marks["window"]
    print(f"system loop profile (last frame): wall {wall * 1e3:.1f} ms, "
          f"device busy {busy_us / 1e3:.1f} ms ({busy_us / 1e6 / wall * 100:.1f}"
          f"%), {n_ops} device ops (the profiler's own cost included)")
    print("system phases:\n" + TIMER.report())
    st = TIMER.stats.get("final.nonkf_pose_refine")
    steps = mapper.refine_steps
    print(f"system refinement: {mapper.refine_calls} calls, {steps} steps "
          f"({steps / max(mapper.refine_calls, 1):.1f} per frame, at most "
          f"{tr_cfg.get('pose_refine_iters', 100)}), {steps} host syncs "
          f"(one per step), "
          f"{st.total / max(steps, 1) * 1e3 if st else float('nan'):.2f} ms "
          f"per step (the phase's time over its steps, the trajectory "
          f"filler's features reused)")
    lowmem_steps("system (oracle) update_lowmem")
    print(f"system loop closure: {len(loops)} loop_ba calls, "
          f"{sum(n > 0 for n in loops)} ran their BA (edges "
          f"{min(loops, default=0)}-{max(loops, default=0)})")
    print(f"system: render_fused calls {renders}; launches "
          f"{json.dumps(launches)}")

    out = os.path.join(cfg["data"]["output"], cfg["scene"], "traj")
    metrics = {}
    for name in ("kf_traj", "full_traj"):
        path = os.path.join(out, f"{name}_metrics.txt")
        if not os.path.exists(path):
            raise AssertionError(f"terminate wrote no {path}")
        metrics[name] = read_metric(path)
    ply = os.path.join(cfg["data"]["output"], cfg["scene"], "final_gs.ply")
    if not os.path.getsize(ply) > 0:
        raise AssertionError(f"no map written to {ply}")
    slam.cfg["fast_mode"] = True
    fast = slam.full_traj_eval(os.path.join(out, "full_traj_fast"))["rmse"]
    psnr = keyframe_psnr(mapper, frames)
    print(f"system: keyframe ATE rmse {metrics['kf_traj'] * 100:.4f} cm, full "
          f"ATE rmse {metrics['full_traj'] * 100:.4f} cm (fast_mode "
          f"{fast * 100:.4f} cm); final map keyframe PSNR mean "
          f"{np.mean(psnr):.2f} dB (min {np.min(psnr):.2f}, max "
          f"{np.max(psnr):.2f}); {gm.num_alive(mapper.gaussians)} Gaussians")
    print("system: final map PSNR per keyframe [dB]:",
          json.dumps([round(x, 2) for x in psnr]))
    if not metrics["kf_traj"] < ATE_MAX:
        raise AssertionError(f"system keyframe ATE {metrics['kf_traj']} m >= "
                             f"{ATE_MAX} m")
    if not metrics["full_traj"] <= max(1.5 * fast, ATE_MAX):
        raise AssertionError(f"system full ATE {metrics['full_traj']} m > "
                             f"max(1.5 x {fast}, {ATE_MAX}) m")
    if mapper.refine_calls != n_frames:
        raise AssertionError(f"refinement ran {mapper.refine_calls} times "
                             f"for {n_frames} frames")
    if not np.mean(psnr) >= SYSTEM_PSNR_MIN:
        raise AssertionError(f"final map PSNR {np.mean(psnr):.2f} dB < "
                             f"{SYSTEM_PSNR_MIN} dB")
    if any(v != renders for v in launches.values()):
        raise AssertionError(f"system launches {launches} != {renders} "
                             f"render_fused calls")
    poses = slam.state.store.poses

    def refine_two():
        for k in (n_frames - 2, n_frames - 1):
            mapper.refine_pose_non_key_frame(
                stream[k][1], poses[k].cpu().numpy(),
                features=stream.feat_fn(stream[k][1]))
    profile_window(refine_two, "system refinement (2 frames)")
    return launches


# ---------------------------------------------------------------------------
# phase 8: the user's entry point, python -m wildgs_slam_tpu_torch.run
# ---------------------------------------------------------------------------

ENTRY_DIR = os.path.join(HERE, "build", "chip_smoke", "entry")
PRIOR_FRAMES = 8         # 384x512 frames through each prior at full width
ENTRY_FRAMES = 24        # frames of the TUM sequence written to disk
ENTRY_KILL = 16          # invocation A's --max_frames; B resumes there
ENTRY_CUTS = {"init_itr_num": 150, "mapping_itr_num": 40,
              "final_refine_iters": 200}   # depth only
FALLBACK_LINE = "mono priors unavailable"   # run.build's line without priors
ALL_FILTERS = (0, 1, 2, 3, 4)   # PNG row filters: None, Sub, Up, Avg, Paeth


def seeded_state(model, seed, dev):
    """Every parameter drawn from N(0, 0.02) (norm and LayerScale scales
    around 1, the unused mask token zero) from a seeded generator; the
    state_dict on the host, in the module's (upstream) names."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("mask_token"):
                continue
            base = 1.0 if name.endswith(("gamma", "norm1.weight",
                                         "norm2.weight", "norm.weight")) \
                else 0.0
            p.copy_(base + 0.02 * torch.randn(p.shape, generator=gen,
                                              device=dev))
    return {k: v.cpu() for k, v in model.state_dict().items()}


def synced_ms(fn, *a):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def priors_phase(dev):
    """8a: the default priors built by make_prior_fns from seeded .pth
    files, on PRIOR_FRAMES frames; returns the checkpoint directory."""
    from wildgs_slam_tpu_torch.models import dinov2, dpt, priors

    cfg = load_config(CONFIG)
    mp = cfg["mono_prior"]
    ckpt = os.path.join(ENTRY_DIR, "pretrained")
    os.makedirs(ckpt, exist_ok=True)
    t0 = time.perf_counter()
    stand_in = priors.METRIC3D_STAND_IN[mp["depth"]]
    with torch.device(dev):
        da2 = dpt.DepthAnythingV2(stand_in.split("_")[1], 20.0)
        dino = dinov2.make_dinov2("vits", num_register_tokens=4)
    n_da2 = sum(p.numel() for p in da2.parameters())
    n_dino = sum(p.numel() for p in dino.parameters())
    files = {priors.dpt_checkpoint_name(stand_in): (da2, 1),
             f"fit3d_{mp['feature_extractor']}.pth": (dino, 2)}
    for name, (model, seed) in files.items():
        torch.save(seeded_state(model, seed, dev), os.path.join(ckpt, name))
    del da2, dino
    gc.collect()
    torch.cuda.empty_cache()
    print(f"entry priors: seeded checkpoints {json.dumps(sorted(files))} "
          f"({n_da2 / 1e6:.1f} M and {n_dino / 1e6:.1f} M parameters, "
          f"{os.path.getsize(os.path.join(ckpt, sorted(files)[0])) / 2 ** 20:.0f}"
          f" MiB) written in {time.perf_counter() - t0:.1f} s")
    out = os.path.join(ENTRY_DIR, "priors_out")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    (depth_fn, feat_fn), t_build = synced_ms(
        priors.make_prior_fns, cfg, out, ckpt, dev)
    trunk = depth_fn.fn.model
    print(f"entry priors: depth {mp['depth']} = the DepthAnythingV2 "
          f"{stand_in} stand-in ({len(trunk.pretrained.blocks)} blocks of "
          f"width "
          f"{trunk.pretrained.embed_dim}) under the canonical "
          f"{depth_fn.fn.CANONICAL[0]}x{depth_fn.fn.CANONICAL[1]} protocol "
          f"({depth_fn.fn.CANONICAL[0] // 14}x{depth_fn.fn.CANONICAL[1] // 14}"
          f" patches); features {mp['feature_extractor']} = ViT-S/14 with "
          f"{feat_fn.fn.model.num_register_tokens} registers; built by "
          f"make_prior_fns in {t_build / 1e3:.2f} s")
    _, _, frames = room_scene(cfg, PRIOR_FRAMES, seed=5)
    depth_ms, feat_ms, first = [], [], None
    for _, _, img, _ in frames:
        d, td = synced_ms(depth_fn, img)
        f, tf = synced_ms(feat_fn, img)
        depth_ms.append(td)
        feat_ms.append(tf)
        first = (d, f) if first is None else first
        if not (d.shape == img.shape[:2] and f.shape == (
                img.shape[0] // 14, img.shape[1] // 14, 384)
                and np.isfinite(d).all() and np.isfinite(f).all()):
            raise AssertionError(f"priors: shapes {d.shape} {f.shape} or "
                                 "non-finite values")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"entry priors: {PRIOR_FRAMES} frames at {img.shape[0]}x"
          f"{img.shape[1]}: depth {depth_ms[0]:.1f} ms first call, "
          f"{np.mean(depth_ms[1:]):.1f} ms per call after (min "
          f"{min(depth_ms[1:]):.1f}); features {feat_ms[0]:.1f} ms first, "
          f"{np.mean(feat_ms[1:]):.2f} ms per call after; outputs {d.shape} "
          f"{d.dtype}, {f.shape} {f.dtype}; depth range "
          f"{float(d.min()):.3f}-{float(d.max()):.3f} m (seeded weights); "
          f"peak device memory {peak:.2f} GiB (the prior phase alone)")
    again = priors.CachingPredictor(depth_fn.fn, depth_fn.cache_dir)
    d0, t_cached = synced_ms(again, frames[0][2])
    if not np.array_equal(d0, first[0]):
        raise AssertionError("priors: the cache did not return call 0's "
                             "depth")
    print(f"entry priors: a fresh cache on the same directory reads call "
          f"0's depth back from {again.cache_dir}/00000.npy in "
          f"{t_cached:.2f} ms (equal)")
    del depth_fn, feat_fn, trunk, again
    gc.collect()
    torch.cuda.empty_cache()
    return ckpt


def write_tum_sequence(cfg, root):
    """The system phase's room scene at the camera of the config's raw
    frames, as TUM writes it: rgb/ and depth/ PNGs (depth 16-bit, scaled by
    png_depth_scale), rgb.txt, depth.txt, groundtruth.txt."""
    cam = cfg["cam"]
    _, _, frames = room_scene(
        cfg, ENTRY_FRAMES, seed=3, step=SYSTEM_STEP,
        camera=((cam["H"], cam["W"]),
                (cam["fx"], cam["fy"], cam["cx"], cam["cy"])))
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    lines = {"rgb.txt": [], "depth.txt": [], "groundtruth.txt": []}
    rgb0 = None
    for i, (w2c, depth, img, _) in enumerate(frames):
        t = f"{1305031100.0 + i / 30:.6f}"
        rgb = np.round(img * 255).astype(np.uint8)
        rgb0 = rgb if rgb0 is None else rgb0
        # the five row filters in turn, so that the reader undoes each
        write_png(os.path.join(root, "rgb", f"{t}.png"), rgb,
                  ALL_FILTERS)
        write_png(os.path.join(root, "depth", f"{t}.png"), np.round(
            depth * cam["png_depth_scale"]).astype(np.uint16), ALL_FILTERS)
        c2w = lie.se3_inv(torch.as_tensor(w2c)).numpy()
        lines["rgb.txt"].append(f"{t} rgb/{t}.png")
        lines["depth.txt"].append(f"{t} depth/{t}.png")
        lines["groundtruth.txt"].append(
            f"{t} " + " ".join(f"{v:.9f}" for v in c2w))   # tx ty tz qx..qw
    for name, ls in lines.items():
        with open(os.path.join(root, name), "w") as fh:
            fh.write("# written by chip_smoke.py\n# \n# \n" + "\n".join(ls))
    return rgb0


def run_entry(argv, label, cfg, dev, priors=True, n_frames=ENTRY_FRAMES,
              give_poses=False):
    """run.build(argv), the oracle (and with `priors` the scene's exact
    depth prior; with `give_poses` the scene's poses as the reader's ground
    truth) put in between, then SLAM.run() on the first `n_frames` frames
    of the scene; returns (slam, resume_path, record). Without `priors`
    build must print its one fallback line."""
    from wildgs_slam_tpu_torch import run as entry

    wall0 = time.time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, slam, resume = entry.build(argv)
    text = buf.getvalue()
    print(text, end="")
    fallbacks = text.count(FALLBACK_LINE)
    if fallbacks != (0 if priors else 1):
        raise AssertionError(f"{label}: {fallbacks} '{FALLBACK_LINE}' lines")
    H, W = cfg["cam"]["H_out"], cfg["cam"]["W_out"]
    _, _, truth = room_scene(cfg, n_frames, seed=3, step=SYSTEM_STEP,
                             camera=((H, W), tuple(slam.stream.intrinsic)))
    if give_poses:
        slam.stream.poses = [lie.se3_matrix(lie.se3_inv(torch.as_tensor(
            f[0]))).numpy() for f in truth]
    if priors:
        # the depth prior: the scene's depth of the frame being tracked
        # (the reader's timestamps are the frame indices)
        mf = slam.motion_filter
        track, frame = mf.track, {}

        def tracked(tstamp, image):
            frame["i"] = int(tstamp)
            return track(tstamp, image)
        mf.track = tracked
        mf.depth_fn = lambda image: truth[frame["i"]][1]
    sh, sw = kstore.slice_hw(H, W)
    poses_gt = torch.as_tensor(np.stack([f[0] for f in truth]), device=dev)
    disps_gt = torch.as_tensor(np.stack([1.0 / f[1][sh, sw] for f in truth]),
                               device=dev)

    def gt_injection(store, counter):
        ts = store.timestamp.long().clamp(0, n_frames - 1)
        return poses_gt[ts], disps_gt[ts]
    slam.frontend.graph.gt_injection = slam.backend.gt_injection = \
        gt_injection
    marks = {}
    terminate = slam.terminate

    def timed_terminate():
        torch.cuda.synchronize()
        marks["loop_end"] = time.perf_counter()
        terminate()
    slam.terminate = timed_terminate
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    TIMER.reset()
    reset_launches()
    t0 = time.perf_counter()
    slam.run(resume_path=resume)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    rec = dict(launches=read_launches(), renders=slam.mapper.fused_renders,
               forward_only=slam.mapper.gui_renders, wall0=wall0, t_loop=marks["loop_end"] - t0,
               t_term=t_end - marks["loop_end"],
               peak=torch.cuda.max_memory_allocated() / 2 ** 30,
               stats={k: (v.count, v.total, v.first, v.warm_mean)
                      for k, v in TIMER.stats.items()})
    st = rec["stats"]
    n = st["data.load"][0]
    loop = rec["t_loop"] - st.get("checkpoint.load", (0, 0.0))[1]
    pri = st.get("track.mf.priors", (1, 0.0))
    print(f"{label}: {n} frames -> {slam.state.counter} keyframes; loop "
          f"{loop:.2f} s ({loop / n * 1e3:.1f} ms per frame; a checkpoint "
          f"load before it apart), terminate {rec['t_term']:.2f} s; data.load "
          f"{st['data.load'][1] / n * 1e3:.1f} ms per frame (first "
          f"{st['data.load'][2] * 1e3:.1f}); track.mf.priors "
          f"{pri[1] / max(pri[0], 1) * 1e3:.1f} ms per keyframe over "
          f"{pri[0]}; peak device memory {rec['peak']:.2f} GiB")
    print(f"{label} phases:\n" + TIMER.report())
    launch_gate(label, rec["launches"], rec["renders"], rec["forward_only"])
    return slam, resume, rec


def launch_gate(label, launches, renders, forward_only=0):
    """K1 and K3 launch once per render_fused call; K2 and K4 once per call
    with a backward (all but the GUI's forward renders)."""
    want = {"composite_fwd": renders, "table_gather": renders,
            "composite_bwd": renders - forward_only,
            "table_scatter_add": renders - forward_only}
    print(f"{label}: render_fused calls {renders} ({forward_only} without a "
          f"backward); launches {json.dumps(launches)}")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} != {want}")


def entry_phase(dev, ckpt):
    """8b: wildgs_slam_tpu_torch.run's build() and SLAM.run() on a TUM
    sequence on disk, killed after ENTRY_KILL frames (invocation A) and
    resumed by a fresh build (B); returns the kernels' launches."""
    cfg = load_config(CONFIG)
    cam = cfg["cam"]
    seq = os.path.join(ENTRY_DIR, "tum_sequence")
    out = os.path.join(ENTRY_DIR, "out")
    for d in (seq, out):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    rgb0 = write_tum_sequence(cfg, seq)
    print(f"entry: {ENTRY_FRAMES} frames of the system phase's room scene "
          f"written as a TUM sequence ({cam['H']}x{cam['W']} RGB and 16-bit "
          f"depth PNGs, depth scale {cam['png_depth_scale']}) in "
          f"{time.perf_counter() - t0:.1f} s")
    tr_cfg = cfg["mapping"]["Training"]
    reduced = {k: f"{(cfg['mapping'] if k == 'final_refine_iters' else tr_cfg)[k]}"
               f" -> {v}" for k, v in ENTRY_CUTS.items()}
    reduced["frames"] = (f"{ENTRY_FRAMES}, every one a keyframe (as phase "
                         f"7); A --max_frames {ENTRY_KILL} --fast_mode "
                         f"--checkpoint_every 8, B --resume to the end")
    reduced["priors"] = ("features: the seeded DINOv2 of 8a through "
                         "make_prior_fns; depth: the scene's exact depth, "
                         "set on the motion filter after build() (a seeded "
                         "DepthAnythingV2 predicts meaningless depth; 8a "
                         "times it at full width)")
    reduced["oracle"] = "gt_injection on the frontend's graph and backend"
    print("entry reduced:", json.dumps(reduced))
    spec = {"inherit_from": CONFIG, "scene": "entry", "verbose": False,
            "data": {"input_folder": seq, "output": out},
            "tracking": {"force_keyframe_every_n_frames": 1,
                         "motion_filter": {"thresh": 1e9}},
            "mapping": {"final_refine_iters": ENTRY_CUTS[
                "final_refine_iters"],
                "Training": {k: ENTRY_CUTS[k] for k in (
                    "init_itr_num", "mapping_itr_num")}}}
    cfg_path = os.path.join(ENTRY_DIR, "entry.yaml")
    with open(cfg_path, "w") as fh:
        json.dump(spec, fh)          # JSON is YAML
    base = [cfg_path, "--device", str(dev), "--pretrained", ckpt]
    scene_dir = os.path.join(out, "entry")
    ckpt_path = os.path.join(scene_dir, "checkpoint.npz")

    a, _, rec_a = run_entry(base + ["--checkpoint_every", "8",
                                    "--max_frames", str(ENTRY_KILL),
                                    "--fast_mode"], "entry A", cfg, dev)
    frame0 = a.stream[0][1]
    ref = torch.nn.functional.interpolate(
        torch.as_tensor(rgb0, dtype=torch.float32).permute(2, 0, 1)[None],
        size=(a.stream.H_out_with_edge, a.stream.W_out_with_edge),
        mode="bilinear", align_corners=False)[0].permute(1, 2, 0).numpy()
    ref = ref[cam["H_edge"]:-cam["H_edge"], cam["W_edge"]:-cam["W_edge"]]
    err = float(np.abs(frame0 - ref / 255.0).max())
    print(f"entry: the reader's frame 0 {frame0.shape} against the written "
          f"image resized by F.interpolate (bilinear): max |diff| "
          f"{err * 255:.3f} levels (tolerance 1)")
    if not err <= 1.0 / 255 + 1e-6:
        raise AssertionError(f"reader frame 0 off by {err * 255} levels")
    if not os.path.exists(ckpt_path):
        raise AssertionError("invocation A wrote no checkpoint")
    with np.load(ckpt_path) as z:
        meta = pickle.loads(z["__meta__"].tobytes())
    ck = rec_a["stats"]["checkpoint.save"]
    print(f"entry A: {ck[0]} checkpoints, checkpoint.save "
          f"{ck[1] / ck[0] * 1e3:.1f} ms each (first {ck[2] * 1e3:.1f}); "
          f"checkpoint.npz {os.path.getsize(ckpt_path) / 2 ** 20:.1f} MiB, "
          f"next_frame {meta['loop_state']['next_frame']}, "
          f"{meta['counter']} keyframes; keyframe ATE "
          f"{read_metric(os.path.join(scene_dir, 'traj', 'kf_traj_metrics.txt')) * 100:.4f} cm")
    kf_a, next_a = a.state.counter, meta["loop_state"]["next_frame"]
    del a
    gc.collect()

    feat_dir = os.path.join(scene_dir, "mono_priors", "features")
    cached = len(os.listdir(feat_dir))
    b, resume, rec_b = run_entry(base + ["--resume"], "entry B", cfg, dev)
    print(f"entry B: its feature cache restarted its call count at 0 and "
          f"read {min(cached, rec_b['stats']['track.mf.priors'][0])} of its "
          f"keyframes' features from A's {cached} files (ROADMAP Queue 3 "
          f"(a), as the JAX package)")
    n_b = rec_b["stats"]["data.load"][0]
    ld = rec_b["stats"]["checkpoint.load"]
    print(f"entry B: resumed from {resume} at frame {next_a} with {kf_a} "
          f"keyframes (checkpoint.load {ld[1] * 1e3:.1f} ms), read "
          f"{n_b} frames, ended with {b.state.counter} keyframes")
    if not (resume == ckpt_path and meta["counter"] == kf_a
            and next_a == ENTRY_KILL and n_b == ENTRY_FRAMES - next_a
            and b.state.counter == ENTRY_FRAMES):
        raise AssertionError("invocation B did not resume where A stopped")
    for f in ("final_gs.ply", "map_viewer.html", "video.npz", "cfg.yaml",
              "profile.txt", "traj/kf_traj_metrics.txt",
              "traj/full_traj_metrics.txt"):
        path = os.path.join(scene_dir, f)
        if not (os.path.exists(path) and os.path.getsize(path) > 0
                and os.path.getmtime(path) >= rec_b["wall0"] - 1.0):
            raise AssertionError(f"invocation B did not write {path}")
    kf = read_metric(os.path.join(scene_dir, "traj", "kf_traj_metrics.txt"))
    full = read_metric(os.path.join(scene_dir, "traj",
                                    "full_traj_metrics.txt"))
    b.cfg["fast_mode"] = True
    fast = b.full_traj_eval(os.path.join(scene_dir, "traj",
                                         "full_traj_fast"))["rmse"]
    print(f"entry B: keyframe ATE rmse {kf * 100:.4f} cm, full ATE rmse "
          f"{full * 100:.4f} cm (fast_mode {fast * 100:.4f} cm); "
          f"{gm.num_alive(b.mapper.gaussians)} Gaussians")
    if not kf < ATE_MAX:
        raise AssertionError(f"entry keyframe ATE {kf} m >= {ATE_MAX} m")
    if not full <= max(1.5 * fast, ATE_MAX):
        raise AssertionError(f"entry full ATE {full} m > max(1.5 x {fast}, "
                             f"{ATE_MAX}) m")
    return {k: rec_a["launches"][k] + rec_b["launches"][k] for k in KERNELS}


# ---------------------------------------------------------------------------
# phase 9: runs without metric depth (the mono-depth fill, projective
# deformation), the no-priors entry point with the file GUI
# ---------------------------------------------------------------------------

NONMETRIC_DIR = os.path.join(HERE, "build", "chip_smoke", "nonmetric")
NOPRIOR_FRAMES = 16      # 9a: --max_frames on the TUM sequence of phase 8
SPLAT_FRAMES = 24        # 9b: frames of the system scene, in memory
PRIOR_SCALE, PRIOR_SHIFT = 2.0, -1.0   # 9b's prior is (depth + 1) / 2
PRIOR_HOLE = (slice(100, 180), slice(150, 300))   # cut out of 9b's prior
SHIFT_M = 1e-3           # 9b's oracle moves earlier keyframes by this
SHIFT_EVERY = 4          # new keyframes between two moves
# the fitted prior's largest depth difference over its range of values,
# over the median depth: against s (2 mono - 1) (the BA depth is the
# 1/8-resolution disparity upsampled), and against a float64 solve of the
# same least squares (float32 sums over 196,608 pixels feed a 2x2 system
# that cancels); measured up to 3.1e-3 and 1.7e-3 on an NVIDIA H100 80GB
# HBM3, 700 W
FILL_TRUTH_TOL = 2e-2
FILL_F64_TOL = 5e-3


def gui_files(scene_dir):
    gui = os.path.join(scene_dir, "gui")
    files = sorted(os.listdir(gui)) if os.path.isdir(gui) else []
    print(f"no-priors: files under gui/: {json.dumps(files)}")
    for f in ("index.html", "map.json", "render.png"):
        if f not in files or not os.path.getsize(os.path.join(gui, f)):
            raise AssertionError(f"the file GUI wrote no {f}")
    return read_png(os.path.join(gui, "render.png"))


def noprior_phase(dev, cfg):
    """9a: wildgs_slam_tpu_torch.run's build() with an empty checkpoint
    directory (the fallback to no mono priors: no metric depth, no
    uncertainty) and gui on, then SLAM.run() on phase 8's TUM sequence
    under the oracle; returns the kernels' launches."""
    seq = os.path.join(ENTRY_DIR, "tum_sequence")
    if not os.path.exists(os.path.join(seq, "groundtruth.txt")):
        shutil.rmtree(seq, ignore_errors=True)
        write_tum_sequence(cfg, seq)
    out = os.path.join(NONMETRIC_DIR, "out")
    empty = os.path.join(NONMETRIC_DIR, "no_checkpoints")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(empty, exist_ok=True)
    spec = {"inherit_from": CONFIG, "scene": "noprior", "verbose": False,
            "gui": True, "data": {"input_folder": seq, "output": out},
            "tracking": {"force_keyframe_every_n_frames": 1,
                         "motion_filter": {"thresh": 1e9}},
            "mapping": {"final_refine_iters": ENTRY_CUTS[
                "final_refine_iters"],
                "Training": {k: ENTRY_CUTS[k] for k in (
                    "init_itr_num", "mapping_itr_num")}}}
    cfg_path = os.path.join(NONMETRIC_DIR, "noprior.yaml")
    with open(cfg_path, "w") as fh:
        json.dump(spec, fh)          # JSON is YAML
    slam, _, rec = run_entry(
        [cfg_path, "--device", str(dev), "--pretrained", empty,
         "--max_frames", str(NOPRIOR_FRAMES), "--fast_mode"],
        "no-priors", cfg, dev, priors=False)
    m, st = slam.mapper, rec["stats"]
    n = st["data.load"][0]
    if slam.state.metric_depth_reg or slam.uncertainty_aware:
        raise AssertionError("no-priors: metric depth or uncertainty on")
    rs = st.get("map.kf_resync_deform", (0, 0.0))
    gp = st.get("map.gui_push", (0, 0.0))
    fl = st.get("map.depth_fill", (0, 0.0))
    print(f"no-priors: {n} frames, {slam.state.counter} keyframes; "
          f"map.kf_resync_deform {rs[1] / max(rs[0], 1) * 1e3:.1f} ms per "
          f"call over {rs[0]}; fills {m.fills} "
          f"({fl[1] / max(fl[0], 1) * 1e3:.2f} ms each), invalid keyframes "
          f"{m.invalid_keyframes}, projective deformations "
          f"{m.projective_deforms}; GUI push {gp[1] / max(gp[0], 1) * 1e3:.1f}"
          f" ms per keyframe over {gp[0]} (a forward render, the PNG panels "
          f"and map.json); {card_line()}")
    scene_dir = os.path.join(out, "noprior")
    render = gui_files(scene_dir)
    H, W = cfg["cam"]["H_out"], cfg["cam"]["W_out"]
    if render.shape != (H, 2 * W, 3):
        raise AssertionError(f"render.png is {render.shape}")
    kf = read_metric(os.path.join(scene_dir, "traj", "kf_traj_metrics.txt"))
    print(f"no-priors: keyframe ATE rmse {kf * 100:.4f} cm; render.png "
          f"{render.shape}; {gm.num_alive(m.gaussians)} Gaussians")
    if not kf < ATE_MAX:
        raise AssertionError(f"no-priors keyframe ATE {kf} m >= {ATE_MAX} m")
    if m.gui_renders != gp[0]:
        raise AssertionError(f"{m.gui_renders} GUI renders for {gp[0]} "
                             "pushes")
    return rec["launches"]


def splat_slam_phase(dev, ckpt):
    """9b: SLAM.run() in memory without metric depth (the Splat-SLAM mode)
    and with uncertainty, on the system scene: the depth prior is the
    scene's depth under the affine map (d + 1) / 2 with a hole cut in it,
    the features phase 8's seeded DINOv2; the oracle moves every earlier
    keyframe by SHIFT_M every SHIFT_EVERY keyframes, so that BA moves them
    and the mapper fills and deforms them again; returns the launches.

    Without metric depth nothing fixes the scale of a monocular BA (its
    first disparity starts at 1): its depth is s d for some s, so the fill
    should recover scale 2 s and shift -s, with s the least-squares ratio
    of the BA depth to the scene's depth over the fill's weights (where the
    prior is exact, d = 2 mono - 1). The oracle puts the state a converged
    BA reaches (the scene's poses, moved as above, and disparities) in the
    store, so s is 1 up to the bilinear upsampling of the 1/8-resolution
    disparities. Each fill's float32 solution is held against a float64
    solve of the same least squares, and each keyframe's last one against
    (2 s, -s); both as the largest depth difference over the prior's range
    of values, over the median depth."""
    from wildgs_slam_tpu_torch.models import priors

    cfg = load_config(CONFIG)
    cfg["scene"] = "splat_slam"
    cfg["data"]["output"] = NONMETRIC_DIR
    cfg["verbose"] = False
    cfg["fast_mode"] = True
    t = cfg["tracking"]
    t["force_keyframe_every_n_frames"] = 1
    t["motion_filter"]["thresh"] = 1e9
    t["backend"]["metric_depth_reg"] = False
    cfg["mapping"]["final_refine_iters"] = ENTRY_CUTS["final_refine_iters"]
    cfg["mapping"]["Training"].update(
        init_itr_num=ENTRY_CUTS["init_itr_num"],
        mapping_itr_num=ENTRY_CUTS["mapping_itr_num"])
    print(f"splat-slam config: {cfg['cam']['H_out']}x{cfg['cam']['W_out']}, "
          f"capacity {cfg['mapping']['gaussian_capacity']}, list capacity "
          f"{cfg['mapping']['render_list_capacity']}, metric_depth_reg "
          f"{t['backend']['metric_depth_reg']}, uncertainty "
          f"{t['uncertainty_params']['activate']}, {SPLAT_FRAMES} frames, "
          f"prior (depth - {PRIOR_SHIFT}) / {PRIOR_SCALE} with rows "
          f"{PRIOR_HOLE[0].start}-{PRIOR_HOLE[0].stop} x cols "
          f"{PRIOR_HOLE[1].start}-{PRIOR_HOLE[1].stop} cut out, oracle "
          f"moves of {SHIFT_M * 1e3:.0f} mm every {SHIFT_EVERY} keyframes")
    (H, W), intr, frames = room_scene(cfg, SPLAT_FRAMES, seed=3,
                                      step=SYSTEM_STEP)
    stream = SceneStream(intr, frames)
    feat_pred = priors.Fit3DFeaturePredictor(
        cfg["mono_prior"]["feature_extractor"], ckpt, device=dev)

    def depth_prior(image):
        d = (stream.depth_fn(image) - PRIOR_SHIFT) / PRIOR_SCALE
        d[PRIOR_HOLE] = 0.0
        return d
    model = droid_net.init_droid_net(torch.Generator().manual_seed(0),
                                     device=dev)
    slam = system.SLAM(cfg, stream, depth_fn=depth_prior, feat_fn=feat_pred,
                       model=model, device=dev)
    sh, sw = kstore.slice_hw(H, W)
    poses_gt = torch.as_tensor(np.stack([f[0] for f in frames]), device=dev)
    disps_gt = torch.as_tensor(np.stack([1.0 / f[1][sh, sw] for f in frames]),
                               device=dev)

    def gt_injection(store, counter):
        ts = store.timestamp.long().clamp(0, SPLAT_FRAMES - 1)
        poses = poses_gt[ts].clone()
        sign = 1.0 if (counter // SHIFT_EVERY) % 2 else -1.0
        earlier = torch.arange(len(ts), device=dev) < counter - 1
        poses[earlier, 0] += sign * SHIFT_M
        # the state a converged BA reaches: without metric depth nothing
        # else fixes the monocular scale, whose first disparity is 1
        store.poses[:counter] = poses[:counter]
        store.disps[:counter] = disps_gt[ts[:counter]]
        return poses, disps_gt[ts]
    slam.frontend.graph.gt_injection = slam.backend.gt_injection = \
        gt_injection

    solves, current = [], {}
    align = depth_fill.align_scale_and_shift
    filled = slam.mapper._filled_depth

    def recorded_fill(video_idx, est_depth, mask):
        current["kf"] = video_idx
        return filled(video_idx, est_depth, mask)
    slam.mapper._filled_depth = recorded_fill

    def recorded_align(mono, est, w):
        scale, shift, err = align(mono, est, w)
        m, e, ww = (x.double().cpu().numpy() for x in (mono, est, w))
        A = np.array([[(ww * m * m).sum(), (ww * m).sum()],
                      [(ww * m).sum(), ww.sum()]])
        b = np.array([(ww * m * e).sum(), (ww * e).sum()])
        d = PRIOR_SCALE * m + PRIOR_SHIFT      # the scene's depth where w > 0
        s_ba = (ww * e * d).sum() / (ww * d * d).sum()
        on = ww > 0
        solves.append((current["kf"], float(scale), float(shift),
                       *np.linalg.solve(A, b), s_ba, m[on].min(),
                       m[on].max(), np.median(e[on])))
        return scale, shift, err
    depth_fill.align_scale_and_shift = recorded_align
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    TIMER.reset()
    reset_launches()
    t0 = time.perf_counter()
    try:
        slam.run()
    finally:
        depth_fill.align_scale_and_shift = align
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = read_launches()
    m = slam.mapper
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st = TIMER.stats
    fl, rs = st.get("map.depth_fill"), st.get("map.kf_resync_deform")
    print("splat-slam phases:\n" + TIMER.report())
    print(f"splat-slam: {SPLAT_FRAMES} frames -> {slam.state.counter} "
          f"keyframes in {t_run:.2f} s; fills {m.fills} at "
          f"{fl.total / max(fl.count, 1) * 1e3:.2f} ms each (host clock, "
          f"synchronized; {fl.total:.2f} s in all), invalid keyframes "
          f"{m.invalid_keyframes}, projective deformations "
          f"{m.projective_deforms}; map.kf_resync_deform "
          f"{rs.total / max(rs.count, 1) * 1e3:.1f} ms per call over "
          f"{rs.count}; peak device memory {peak:.2f} GiB; {card_line()}")
    if not solves:
        raise AssertionError("splat-slam: no fill reached the least squares")
    sol = np.array(solves)
    kf, s32, q32, s64, q64, s_ba, m_lo, m_hi, e_med = sol.T

    def depth_gap(ds, dq):
        """max |ds m + dq| over the prior's values, over the median depth"""
        return np.maximum(np.abs(ds * m_lo + dq), np.abs(ds * m_hi + dq)
                          ) / e_med
    f64_err = depth_gap(s32 - s64, q32 - q64)
    truth_err = depth_gap(s32 - PRIOR_SCALE * s_ba, q32 - PRIOR_SHIFT * s_ba)
    last = [i for _, i in sorted({int(k): i for i, k in enumerate(kf)}
                                 .items())]
    print("splat-slam: last fill per keyframe [keyframe, scale, shift, "
          "float64 scale, float64 shift, s (BA depth / scene depth), gap to "
          "s (2 mono - 1), gap to float64]:",
          json.dumps([[int(kf[i])] + [round(float(x), 6) for x in sol[i, 1:6]]
                      + [float(f"{truth_err[i]:.3e}"),
                         float(f"{f64_err[i]:.3e}")] for i in last]))
    print(f"splat-slam: {len(sol)} fills through the scale/shift least "
          f"squares, s {s_ba.min():.4f}-{s_ba.max():.4f}; the fitted prior's "
          f"largest depth gap over the median depth: to s (2 mono - 1) "
          f"{truth_err[last].max():.3e} over the keyframes' last fills "
          f"({truth_err.max():.3e} over all fills), to the float64 solve's "
          f"{f64_err.max():.3e} (tolerances {FILL_TRUTH_TOL}, "
          f"{FILL_F64_TOL}); last fills' scale {s32[last].min():.4f}-"
          f"{s32[last].max():.4f}, shift {q32[last].min():.4f}-"
          f"{q32[last].max():.4f} (2 and -1 at s = 1)")
    launch_gate("splat-slam", launches, m.fused_renders, m.gui_renders)
    kf = read_metric(os.path.join(NONMETRIC_DIR, "splat_slam", "traj",
                                  "kf_traj_metrics.txt"))
    print(f"splat-slam: keyframe ATE rmse {kf * 100:.4f} cm; "
          f"{gm.num_alive(m.gaussians)} Gaussians")
    if not kf < ATE_MAX:
        raise AssertionError(f"splat-slam keyframe ATE {kf} m >= {ATE_MAX}")
    if m.projective_deforms < 1:
        raise AssertionError("splat-slam ran no projective deformation")
    if m.invalid_keyframes:
        raise AssertionError(f"splat-slam: {m.invalid_keyframes} invalid "
                             "keyframes")
    if not (truth_err[last].max() < FILL_TRUTH_TOL
            and f64_err.max() < FILL_F64_TOL):
        raise AssertionError("splat-slam: scale/shift off")
    return launches


def nonmetric_phase(dev, ckpt):
    """Phase 9: 9a and 9b; returns their launches, summed."""
    cfg = load_config(CONFIG)
    tr_cfg = cfg["mapping"]["Training"]
    reduced = {k: f"{(cfg['mapping'] if k == 'final_refine_iters' else tr_cfg)[k]}"
               f" -> {v}" for k, v in ENTRY_CUTS.items()}
    reduced["frames"] = (f"9a {NOPRIOR_FRAMES} of phase 8's TUM sequence, "
                         f"9b {SPLAT_FRAMES} of the system scene; every one "
                         f"a keyframe; fast_mode")
    reduced["oracle"] = ("gt_injection on the frontend's graph and backend; "
                         "9b's also writes the converged state and moves "
                         f"earlier keyframes by {SHIFT_M * 1e3:.0f} mm every "
                         f"{SHIFT_EVERY} keyframes")
    print("nonmetric reduced:", json.dumps(reduced))
    t0 = time.perf_counter()
    a = noprior_phase(dev, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    b = splat_slam_phase(dev, ckpt)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"nonmetric: 9a {t1 - t0:.1f} s, 9b {time.perf_counter() - t1:.1f}"
          f" s")
    return {k: a[k] + b[k] for k in KERNELS}


# ---------------------------------------------------------------------------
# phase 10: the data path on the card's host (the native library's own PNG
# and JPEG decoders, the prefetching loader), the iPhone configuration read
# from JPEGs
# ---------------------------------------------------------------------------

JPEG_DIR = os.path.join(HERE, "build", "chip_smoke", "jpeg")
FIXTURES = os.path.join(HERE, "tests", "data", "torch_jpeg")
IPHONE_CONFIG = os.path.join(HERE, "configs", "Dynamic", "Wild_SLAM_iPhone",
                             "horse.yaml")
IPHONE_FRAMES = 16       # frames of the system scene at 1920x1440 as JPEGs
JPEG_QUALITY = 95
JPEG_PSNR_MIN = 35.0     # dB, frame 0's decode against the rendered image
PREFETCH = dict(n_threads=2, lookahead=4)
LOOP_PAUSE_S = 0.25      # other work between two frames (a sleep)

# ITU-T T.81 Annex K: the example quantization tables (natural order),
# scaled by quality as libjpeg's jpeg_quality_scaling, and the Huffman
# tables K.3-K.6 (code counts per length 1-16, then the symbols)
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50,
    43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63])
_AC_SYMBOLS_LUMA = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_SYMBOLS_CHROMA = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
_HUFFMAN = {   # (class, table id): (counts, symbols)
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], bytes(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], bytes(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d],
             _AC_SYMBOLS_LUMA),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
             _AC_SYMBOLS_CHROMA),
}
_BIT_LENGTH = np.array([int(i).bit_length() for i in range(2048)])


def _huffman_codes(counts, symbols):
    """Canonical codes: symbol -> (code, length) as arrays over 0..255."""
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


def jpeg_encode(rgb: np.ndarray, quality: int = JPEG_QUALITY) -> bytes:
    """A baseline 4:2:0 JFIF file of a uint8 RGB image, as libjpeg writes
    one at `quality` with the standard tables: BT.601 YCbCr, 2x2 box
    chroma, an orthonormal float DCT, all in numpy (vectorised over the
    blocks, the Huffman symbols and the bit packing)."""
    h, w = rgb.shape[:2]
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    qt = [np.clip((q * scale + 50) // 100, 1, 255) for q in (_Q_LUMA,
                                                              _Q_CHROMA)]
    x = np.pad(rgb.astype(np.float64), ((0, -h % 16), (0, -w % 16), (0, 0)),
               mode="edge")
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
              0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    H, W = x.shape[:2]
    for c in (1, 2):
        planes[c] = planes[c].reshape(H // 2, 2, W // 2, 2).mean((1, 3))
    k = np.arange(8)
    C = np.sqrt(np.where(k == 0, 1 / 8, 2 / 8))[:, None] * np.cos(
        (2 * k[None] + 1) * k[:, None] * np.pi / 16)

    def quantised(plane, q):
        """(ph/8, pw/8, 64) quantised DCT coefficients in zigzag order:
        C X C^T of each block as two large products."""
        ph, pw = plane.shape
        blk = (plane - 128).reshape(ph // 8, 8, pw // 8, 8).transpose(
            0, 2, 1, 3).reshape(-1, 8, 8)
        d = (blk.reshape(-1, 8) @ C.T).reshape(-1, 8, 8)          # X C^T
        d = (d.transpose(0, 2, 1).reshape(-1, 8) @ C.T).reshape(
            -1, 8, 8).transpose(0, 2, 1)                          # C (X C^T)
        d = d.reshape(ph // 8, pw // 8, 64)
        return np.round(d / q).astype(np.int64)[..., _ZIGZAG]
    my, mx = H // 16, W // 16
    y = quantised(planes[0], qt[0]).reshape(my, 2, mx, 2, 64).transpose(
        0, 2, 1, 3, 4).reshape(my * mx, 4, 64)
    cb = quantised(planes[1], qt[1]).reshape(my * mx, 1, 64)
    cr = quantised(planes[2], qt[1]).reshape(my * mx, 1, 64)
    comp = np.array([0, 0, 0, 0, 1, 2])
    Z = np.concatenate([y, cb, cr], 1)                    # MCU order
    for c in range(3):                                    # DC differences
        dc = Z[:, comp == c, 0].reshape(-1)
        Z[:, comp == c, 0] = np.diff(dc, prepend=0).reshape(my * mx, -1)
    Z = Z.reshape(-1, 64)
    cls = np.tile(np.minimum(comp, 1), my * mx)           # luma 0, chroma 1
    codes = {key: _huffman_codes(*v) for key, v in _HUFFMAN.items()}

    def coded(tc, tables, sym, value):
        """(Huffman code of sym, then `s` bits of value) as one word."""
        s = _BIT_LENGTH[np.abs(value)]
        extra = np.where(value >= 0, value, value + (1 << s) - 1)
        code = np.choose(tables, [codes[(tc, 0)][0][sym],
                                  codes[(tc, 1)][0][sym]])
        length = np.choose(tables, [codes[(tc, 0)][1][sym],
                                    codes[(tc, 1)][1][sym]])
        return (code << s) | extra, length + s
    nb = len(Z)
    events = []                                 # (block, order, word, bits)
    s_dc = _BIT_LENGTH[np.abs(Z[:, 0])]
    events.append((np.arange(nb), np.zeros(nb, np.int64),
                   *coded(0, cls, s_dc, Z[:, 0])))
    bi, ki = np.nonzero(Z[:, 1:])
    kk = ki + 1
    first = np.r_[True, bi[1:] != bi[:-1]]
    prev = np.where(first, 0, np.r_[0, kk[:-1]])
    run = kk - prev - 1
    v = Z[bi, kk]
    sym = (run % 16) * 16 + _BIT_LENGTH[np.abs(v)]
    events.append((bi, 2 * kk, *coded(1, cls[bi], sym, v)))
    n_zrl = run // 16
    zb = np.repeat(bi, n_zrl)
    events.append((zb, np.repeat(2 * kk - 1, n_zrl),
                   *coded(1, cls[zb], np.full(len(zb), 0xF0), np.zeros(
                       len(zb), np.int64))))
    last = np.zeros(nb, np.int64)
    last[bi] = kk                                   # kk ascends in a block
    eb = np.flatnonzero(last < 63)
    events.append((eb, np.full(len(eb), 200), *coded(
        1, cls[eb], np.zeros(len(eb), np.int64), np.zeros(len(eb),
                                                          np.int64))))
    block, order, word, nbits = (np.concatenate(a) for a in zip(*events))
    o = np.lexsort((order, block))
    word, nbits = word[o], nbits[o]
    ev = np.repeat(np.arange(len(nbits)), nbits)
    bit = np.arange(int(nbits.sum())) - np.repeat(np.cumsum(nbits) - nbits,
                                                  nbits)
    bits = ((word[ev] >> (nbits[ev] - 1 - bit)) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.uint8)])
    data = np.packbits(bits)
    data = np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()

    def segment(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body
    out = b"\xff\xd8" + segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    for i, q in enumerate(qt):
        out += segment(0xDB, bytes([i]) + q[_ZIGZAG].astype(np.uint8)
                       .tobytes())
    out += segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                   + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for (tc, th), (counts, symbols) in _HUFFMAN.items():
        out += segment(0xC4, bytes([tc << 4 | th] + counts) + symbols)
    out += segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return out + data + b"\xff\xd9"


def write_iphone_sequence(cfg, root):
    """IPHONE_FRAMES frames of the system phase's room scene rendered at
    the configuration's raw camera (1920x1440) and written as baseline
    4:2:0 JPEGs by jpeg_encode under rgb/, several frames at once on
    threads. Returns frame 0's rendered RGB, the seconds and the bytes."""
    from concurrent.futures import ThreadPoolExecutor

    cam = cfg["cam"]
    os.makedirs(os.path.join(root, "rgb"))
    camera = ((cam["H"], cam["W"]),
              (cam["fx"], cam["fy"], cam["cx"], cam["cy"]))

    def frame(i):
        _, _, [(_, _, img, _)] = room_scene(cfg, 1, seed=3 + i,
                                            step=SYSTEM_STEP, camera=camera,
                                            first=i, dino=False)
        rgb = np.round(img * 255).astype(np.uint8)
        data = jpeg_encode(rgb)
        with open(os.path.join(root, "rgb", f"{i:05d}.jpg"), "wb") as fh:
            fh.write(data)
        return rgb if i == 0 else None, len(data)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        out = list(pool.map(frame, range(IPHONE_FRAMES)))
    return out[0][0], time.perf_counter() - t0, sum(n for _, n in out)


def fixture_check():
    """10(b): the committed fixtures decoded on this host against the cv2
    decodes beside them (read back by the numpy PNG decoder)."""
    from wildgs_slam_tpu_torch import native

    with open(os.path.join(FIXTURES, "manifest.json")) as fh:
        entries = json.load(fh)
    for e in entries:
        ref = read_png(os.path.join(FIXTURES, e["decode"])).reshape(
            e["shape"]).astype(e["dtype"])
        path = os.path.join(FIXTURES, e["file"])
        got = (native.read_color(path) if e["mode"] == "color"
               else native.read_image(path))
        if not (got.dtype == ref.dtype and got.shape == ref.shape
                and np.array_equal(got, ref)):
            raise AssertionError(f"fixture {e['file']}: the native decode "
                                 "differs from the committed cv2 decode")
    print(f"native: {len(entries)} fixtures equal their committed cv2 "
          f"decodes: {json.dumps([e['file'] for e in entries])}")


def loader_times(label, ds):
    """10(d): ms per frame of the reader, then of PrefetchingStream over it
    (a tight loop, and with LOOP_PAUSE_S of other work, a sleep, before
    each frame: the wait only); every prefetched frame bit-equal to the
    reader's."""
    from wildgs_slam_tpu_torch.utils.datasets import PrefetchingStream

    n = len(ds)

    def timed(get, pause=0.0):
        frames, ms = [], []
        for i in range(n):
            if pause:
                time.sleep(pause)
            t0 = time.perf_counter()
            frames.append(get(i))
            ms.append((time.perf_counter() - t0) * 1e3)
        return frames, ms
    plain, ms_plain = timed(ds.__getitem__)
    rows = {"plain": ms_plain}
    for name, pause in (("prefetch", 0.0), ("prefetch_paused", LOOP_PAUSE_S)):
        stream = PrefetchingStream(ds, **PREFETCH)
        frames, rows[name] = timed(stream.__getitem__, pause)
        stream.close()
        for a, b in zip(frames, plain):
            if not (a[0] == b[0] and all(
                    (x is None and y is None) or np.array_equal(x, y)
                    for x, y in zip(a[1:], b[1:]))):
                raise AssertionError(f"{label}: {name} frame {a[0]} differs "
                                     "from the reader's")
    out = {k: (round(v[0], 3), round(float(np.mean(v[1:])), 3))
           for k, v in rows.items()}
    print(f"data.load {label}: {n} frames, ms per frame [first, mean of the "
          f"rest]: {json.dumps(out)} (prefetch: {PREFETCH['n_threads']} "
          f"workers, lookahead {PREFETCH['lookahead']}; paused: "
          f"{LOOP_PAUSE_S} s of sleep before each frame, the wait timed; "
          f"every prefetched frame equal to the reader's)")


def jpeg_phase(dev, ckpt):
    """Phase 10: the native build, the fixtures, the iPhone configuration
    from JPEGs through run.build() and SLAM.run(), and the loaders' times;
    returns the kernels' launches."""
    from wildgs_slam_tpu_torch import native
    from wildgs_slam_tpu_torch.utils import datasets as tds

    info = native.build_library()
    print(f"native build: {info['compiler']}; flags {info['flags']}; "
          f"{info['seconds']:.2f} s (phase 2, beside nvcc); "
          f"{os.path.basename(info['path'])} {info['bytes']} bytes")
    fixture_check()

    cfg = load_config(IPHONE_CONFIG)
    cam = cfg["cam"]
    seq = os.path.join(JPEG_DIR, "iphone")
    out = os.path.join(JPEG_DIR, "out")
    for d in (seq, out):
        shutil.rmtree(d, ignore_errors=True)
    rgb0, t_write, nbytes = write_iphone_sequence(cfg, seq)
    first = native.read_color(os.path.join(seq, "rgb", "00000.jpg"))
    mse = float(np.mean((first.astype(np.float64) - rgb0) ** 2))
    psnr = 10 * np.log10(255.0 ** 2 / mse)
    print(f"iphone: {IPHONE_FRAMES} frames of the system scene at "
          f"{cam['W']}x{cam['H']} (fx {cam['fx']:.1f}) written as baseline "
          f"4:2:0 JPEGs (quality {JPEG_QUALITY}, the script's encoder) in "
          f"{t_write:.1f} s, {nbytes / 2 ** 20:.2f} MiB; frame 0 decoded "
          f"{first.shape}, PSNR {psnr:.2f} dB against the rendered image "
          f"(gate {JPEG_PSNR_MIN})")
    if first.shape != rgb0.shape or not psnr >= JPEG_PSNR_MIN:
        raise AssertionError(f"iphone frame 0: {first.shape}, {psnr} dB")
    tr_cfg = cfg["mapping"]["Training"]
    reduced = {k: f"{(cfg['mapping'] if k == 'final_refine_iters' else tr_cfg)[k]}"
               f" -> {v}" for k, v in ENTRY_CUTS.items()}
    reduced["frames"] = (f"{IPHONE_FRAMES}, every one a keyframe; "
                         "--fast_mode")
    reduced["poses"] = ("the RGB-folder layout has no ground truth: the "
                        "scene's poses are given to the reader after build()")
    reduced["priors"] = "as phase 8 (seeded DINOv2, the scene's exact depth)"
    print("iphone reduced:", json.dumps(reduced))
    spec = {"inherit_from": IPHONE_CONFIG, "scene": "iphone",
            "verbose": False, "data": {"input_folder": seq, "output": out},
            "tracking": {"force_keyframe_every_n_frames": 1,
                         "motion_filter": {"thresh": 1e9}},
            "mapping": {"final_refine_iters": ENTRY_CUTS[
                "final_refine_iters"],
                "Training": {k: ENTRY_CUTS[k] for k in (
                    "init_itr_num", "mapping_itr_num")}}}
    cfg_path = os.path.join(JPEG_DIR, "iphone.yaml")
    with open(cfg_path, "w") as fh:
        json.dump(spec, fh)          # JSON is YAML
    slam, _, rec = run_entry(
        [cfg_path, "--device", str(dev), "--pretrained", ckpt,
         "--fast_mode"], "iphone", cfg, dev, n_frames=IPHONE_FRAMES,
        give_poses=True)
    stream = slam.stream
    if not (type(stream).__name__ == "RGB_NoPose" and len(stream)
            == IPHONE_FRAMES and stream[0][1].shape == (
                cam["H_out"], cam["W_out"], 3)):
        raise AssertionError("iphone: not the RGB-folder reader at 360x480")
    # terminate evaluates no trajectory for the RGB-folder reader (as the
    # JAX package and upstream): the port's own evaluation, on the poses
    # given to the reader
    kf = slam.kf_traj_eval(os.path.join(out, "iphone", "kf_traj"))["rmse"]
    print(f"iphone: {stream.W}x{stream.H} -> {stream.W_out}x{stream.H_out}; "
          f"keyframe ATE rmse {kf * 100:.4f} cm (SLAM.kf_traj_eval); "
          f"{gm.num_alive(slam.mapper.gaussians)} Gaussians; {card_line()}")
    if not kf < ATE_MAX:
        raise AssertionError(f"iphone keyframe ATE {kf} m >= {ATE_MAX} m")
    del slam
    gc.collect()
    torch.cuda.empty_cache()

    tum = os.path.join(ENTRY_DIR, "tum_sequence")
    if not os.path.exists(os.path.join(tum, "groundtruth.txt")):
        shutil.rmtree(tum, ignore_errors=True)
        write_tum_sequence(load_config(CONFIG), tum)
    tum_cfg = load_config(CONFIG)
    tum_cfg["data"]["input_folder"] = tum
    loader_times(f"iphone {cam['W']}x{cam['H']} JPEG -> "
                 f"{cam['W_out']}x{cam['H_out']}", stream)
    split = []
    for path in stream.color_paths:
        t0 = time.perf_counter()
        rgb = native.read_color(path)
        t1 = time.perf_counter()
        resize_u8(rgb, (stream.H_out_with_edge, stream.W_out_with_edge))
        split.append((t1 - t0, time.perf_counter() - t1))
    dec, rs = (np.mean(x) * 1e3 for x in zip(*split))
    print(f"data.load iphone, plain, its two parts: decode {dec:.2f} ms "
          f"(native.read_color) and resize {rs:.2f} ms (resize_u8, torch "
          f"with {torch.get_num_threads()} threads) per frame")
    loader_times("phase 8 TUM 640x480 PNG (+ depth) -> 512x384",
                 tds.get_dataset(tum_cfg))
    return rec["launches"]


# ---------------------------------------------------------------------------
# phase 11: the multi-device mode, meshes of shards on one card
# ---------------------------------------------------------------------------

MESH_SHARDS = (2, 8)     # shards of the meshes, all on cuda:0
MESH_FRAMES = 16         # (d): frames of phase 8's TUM sequence
MESH_KILL = 8            # (d): leg A's --max_frames; B resumes there
MESH_BUFFER = 32         # (d): keyframe buffer (the config's 350)
MESH_WARMUP = 4          # (d): keyframes before the frontend starts (12)
MESH_CUTS = {"init_itr_num": 60, "mapping_itr_num": 20,
             "final_refine_iters": 100}   # (d): depth only
MESH_UPDATES = 8         # (c): updates compared, not gated
FWD_TOL = (2e-5, 1e-4)   # atol, rtol of tests/test_multichip.py
GRAD_TOL = (5e-4, 1e-3)
STEP_TOL = (1e-5, 1e-4)  # test_sharded_track_step_matches_update_core
E2E_TOL = {"poses": 2e-3, "disps": 5e-3}   # tests/test_mesh_e2e.py


def within(a, b, tol):
    """(max |a - b|, |a - b| <= atol + rtol |b| everywhere)."""
    atol, rtol = tol
    a, b = a.detach(), b.detach()
    d = (a - b).abs()
    return float(d.max()), bool((d <= atol + rtol * b.abs()).all())


def capacity_drops(mean2d, radius, depth, valid, image_size, capacity):
    """Entries that tile lists of `capacity` drop (the window truncation
    past kw tiles apart), the first tiles that drop some, and the longest
    list: the binning's overflow at `capacity` less its overflow with room
    for every entry."""
    tight = tr.bin_gaussians(mean2d, radius, depth, valid, image_size,
                             capacity=capacity)
    room = tr.bin_gaussians(mean2d, radius, depth, valid, image_size,
                            capacity=4096)
    over = torch.nonzero(room.counts > capacity).squeeze(1).tolist()
    return (int(tight.overflow - room.overflow), over[:8],
            int(room.counts.max()))


def mesh_render_check(dev, pmesh, sraster, h=384, w=512):
    """(a) the sharded renderer against render_fused on phase 3's scene at
    h x w, forward and gradients, at each mesh; returns the launches of
    one forward+backward per mesh."""
    gauss, w2c, intr = mapping_scene(dev, h=h, w=w)
    N = gauss[0].shape[0]
    cap, ck = 512, 64
    wc = torch.rand(h, w, 3, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)

    def fwd_bwd(fn):
        leaves = [gauss[i].clone().requires_grad_(True) for i in (0, 1, 3, 4)]
        pd = torch.zeros(6, device=dev, requires_grad=True)
        out = fn(leaves[0], leaves[1], gauss[2], leaves[2], leaves[3], w2c,
                 intr, pose_delta=pd, bg=bg)
        loss = ((out.color * wc).sum() + 0.5 * out.depth.sum()
                + 0.25 * out.alpha.sum())
        return out, torch.autograd.grad(loss, leaves + [pd])

    def single(*a, **k):
        return tr.render_fused(*a[:7], (h, w), capacity=cap, chunk=ck, **k)
    ref, ref_g = fwd_bwd(single)
    proj = tr.project_gaussians(*gauss, w2c, intr, (h, w))
    drop1 = capacity_drops(proj.mean2d, proj.radius, proj.depth, proj.valid,
                           (h, w), cap)
    ms1 = time_ms(lambda: fwd_bwd(single), 5, warmup=1, rounds=3)
    print(f"mesh (a): render_fused at capacity {cap}: forward+backward "
          f"{ms1:.2f} ms; overflow {int(ref.overflow)} (capacity drops "
          f"{drop1[0]}, longest list {drop1[2]})")
    launches = {k: 0 for k in KERNELS}
    names = ("means", "scales", "opacity", "sh", "pose_delta")
    for D in MESH_SHARDS:
        mesh = pmesh.make_mesh(devices=[dev] * D, axis="g")
        cap_loc = max(64, -(-cap // D))            # as the mapper sets it
        fn = sraster.make_sharded_render(mesh, (h, w), capacity_local=cap_loc,
                                         chunk=ck)
        drops = []
        for d in range(D):
            sl = slice(d * N // D, (d + 1) * N // D)
            pj = tr.project_gaussians(*[x[sl] for x in gauss], w2c, intr,
                                      (h, w))
            drops.append(capacity_drops(pj.mean2d, pj.radius, pj.depth,
                                        pj.valid, (h, w), cap_loc))
        reset_launches()
        out, grads = fwd_bwd(fn)
        torch.cuda.synchronize()
        got = read_launches()
        for k in KERNELS:
            launches[k] += got[k]
        ms = time_ms(lambda: fwd_bwd(fn), 5, warmup=1, rounds=3)
        errs = {k: within(getattr(out, k), getattr(ref, k), FWD_TOL)
                for k in ("color", "depth", "alpha")}
        errs.update({n: within(a, b, GRAD_TOL)
                     for n, a, b in zip(names, grads, ref_g)})
        print(f"mesh (a) D={D}: capacity_local {cap_loc} (merged "
              f"{D * cap_loc}); per-shard capacity drops "
              f"{[x[0] for x in drops]}, longest per-shard list "
              f"{max(x[2] for x in drops)}; overflow {int(out.overflow)} "
              f"(single {int(ref.overflow)}); forward+backward {ms:.2f} ms "
              f"(single {ms1:.2f} ms; shards share one card, so this is the "
              f"cost of the sharded path's extra launches, not scaling); "
              f"launches {json.dumps(got)}")
        print(f"mesh (a) D={D} max |sharded - single|: " + json.dumps(
            {k: v[0] for k, v in errs.items()}) + f" (forward atol/rtol "
            f"{FWD_TOL}, gradients {GRAD_TOL})")
        if any(v != D for v in got.values()):
            raise AssertionError(f"sharded render D={D}: launches {got}, "
                                 f"not {D} each")
        if drop1[0] or any(x[0] for x in drops):
            where = {d: x[1] for d, x in enumerate(drops) if x[0]}
            print(f"mesh (a) D={D}: NOT GATED: a tile list overflowed "
                  f"(shard: first tiles {json.dumps(where)}; single "
                  f"{drop1[1]})")
        elif not all(v[1] for v in errs.values()):
            raise AssertionError(f"sharded render D={D} disagrees: {errs}")
    return launches


def graph_snapshot(state, g):
    st = state.store
    return ({k: getattr(st, k).clone() for k in ("poses", "disps",
                                                 "disps_up")},
            {k: getattr(g, k).clone() for k in ("net", "target", "weight",
                                                "damping")}, g.age.copy())


def graph_restore(state, g, snap):
    store, edges, age = snap
    for k, v in store.items():
        getattr(state.store, k).copy_(v)
    for k, v in edges.items():
        setattr(g, k, v.clone())
    g.age = age.copy()


def mesh_tracking_check(dev, pmesh, sdba, col, st, g):
    """(b) make_sharded_ba against dba.ba and (c) the network update_n with
    and without a mesh, on the last window of a seeded network run (state
    `st`, frontend graph `g`)."""
    from wildgs_slam_tpu_torch.ops import dba
    from wildgs_slam_tpu_torch.slam import factor_graph as fg

    store = st.store
    F = store.poses.shape[0]
    n = st.counter

    # (b) the BA of the window, with and without the sensor term
    t0, t1, sel, ii_all, jj_all = g._window(None, None, True)
    tgt = torch.cat([g.target, g.target_inac[sel]])
    wgt = torch.cat([g.weight, g.weight_inac[sel]])
    if st.uncertainty_aware:
        wgt = wgt * store.uncertainties_inv[ii_all][..., None]
    eta = 0.2 * g.damping + fg.EP_DAMP
    sh, sw = kstore.slice_hw(*store.mono_disps_up.shape[-2:])
    sensor = (store.mono_disps, store.mono_mask_up[:, sh, sw])
    ii_np, jj_np = ii_all.cpu().numpy(), jj_all.cpu().numpy()
    degree = max(fg.GROUP_DEGREE, int(np.bincount(ii_np).max()))
    bcfg = dba.BAConfig(lm=1e-4, ep=0.1)
    print(f"mesh (b): window [{t0}, {t1}) of {n} keyframes, {len(ii_np)} "
          f"edges ({len(sel)} inactive), largest source-frame degree "
          f"{int(np.bincount(ii_np).max())}")
    for use_sensor in (False, True):
        ref = dba.ba(store.poses, store.disps, store.intrinsics, tgt, wgt,
                     eta, ii_all, jj_all, t0, t1, iters=2, cfg=bcfg,
                     sensor_disps=sensor[0] if use_sensor else None,
                     sensor_valid=sensor[1] if use_sensor else None)
        for D in MESH_SHARDS:
            mesh = pmesh.make_mesh(devices=[dev] * D, axis="edge")
            meta = sdba.shard_edges_by_frame(ii_np, jj_np, D, F, degree)
            e = sdba.gather_edges([tgt, wgt, ii_all, jj_all], meta["perm"])
            e.append(torch.as_tensor(meta["valid"].reshape(-1), device=dev))
            shards = [col.shard_rows(x, mesh.devices) for x in e]
            fn = sdba.make_sharded_ba(mesh, t1 - t0, cfg=bcfg,
                                      use_sensor=use_sensor, iters=2)
            torch.cuda.synchronize()
            t_0 = time.perf_counter()
            p, d = fn(store.poses, store.disps, store.intrinsics, shards[0],
                      shards[1], eta, *shards[2:], meta["groups"],
                      meta["owner"], t0, t1, *sensor)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t_0) * 1e3
            ep, okp = within(p, ref[0], STEP_TOL)
            ed, okd = within(d, ref[1], STEP_TOL)
            print(f"mesh (b) D={D} sensor={use_sensor}: max |sharded - "
                  f"dba.ba| poses {ep:.3e} disps {ed:.3e} (atol/rtol "
                  f"{STEP_TOL}); {ms:.1f} ms for 2 iterations")
            if not (okp and okd):
                raise AssertionError(f"sharded BA D={D} sensor={use_sensor} "
                                     f"disagrees with dba.ba")

    # (c) the network update_n with and without a mesh, same state. The
    # gate runs both with cuDNN off: cuDNN picks its convolution algorithm
    # by batch size, so a shard's smaller batch rounds differently (the GRU
    # state moved by up to 1.3e-5 after one update with cuDNN, 0 without,
    # on an NVIDIA H100 80GB HBM3), which the JAX test's CPU tolerance does
    # not allow for. With cuDNN on, the differences are printed and timed.
    snap = graph_snapshot(st, g)
    keys = ("net", "target", "weight", "poses", "disps")

    def updates(mesh, k, cudnn=True):
        graph_restore(st, g, snap)
        g.mesh = mesh
        torch.backends.cudnn.enabled = cudnn
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t_0 = time.perf_counter()
            g.update_n(k, use_inactive=True)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.enabled = True
            g.mesh = None
        return dict(ms=(time.perf_counter() - t_0) * 1e3 / k,
                    peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                    poses=store.poses.clone(), disps=store.disps.clone(),
                    net=g.net.clone(), target=g.target.clone(),
                    weight=g.weight.clone())
    exact = updates(None, 1, cudnn=False)
    one = updates(None, 1)
    many = updates(None, MESH_UPDATES)
    print(f"mesh (c) single device: {one['ms']:.1f} ms for 1 update, "
          f"{many['ms']:.1f} ms per iteration over {MESH_UPDATES}; peak "
          f"{many['peak']:.2f} GiB")
    for D in MESH_SHARDS:
        mesh = pmesh.make_mesh(devices=[dev] * D, axis="g")
        a = updates(mesh, 1, cudnn=False)
        errs = {k: within(a[k], exact[k], STEP_TOL) for k in keys}
        a = updates(mesh, 1)
        noisy = {k: float((a[k] - one[k]).abs().max()) for k in keys}
        b = updates(mesh, MESH_UPDATES)
        drift = {k: float((b[k] - many[k]).abs().max()) for k in keys}
        print(f"mesh (c) D={D}: after 1 update, cuDNN off, max |sharded - "
              f"single| " + json.dumps({k: v[0] for k, v in errs.items()})
              + f" (atol/rtol {STEP_TOL}); cuDNN on " + json.dumps(noisy)
              + f"; after {MESH_UPDATES}, cuDNN on (not gated: float32 "
              f"summation order compounds through the GRU) "
              + json.dumps(drift) + f"; {a['ms']:.1f} ms for 1 update, "
              f"{b['ms']:.1f} ms per iteration, peak {b['peak']:.2f} GiB "
              f"(shards share one card)")
        if not all(v[1] for v in errs.values()):
            raise AssertionError(f"sharded update_n D={D} disagrees: {errs}")
    graph_restore(st, g, snap)


def mesh_slam_run(cfg, dev, mesh, label, resume=None, terminate=True):
    """SLAM.run() on phase 8's TUM sequence with the seeded DROID weights
    (no oracle: the frontend's updates are the network's), the scene's
    exact depth as the prior and seeded random DINO features; returns
    (slam, the state at the loop's end, seconds)."""
    from wildgs_slam_tpu_torch.utils.datasets import get_dataset

    stream = get_dataset(cfg)
    H, W = cfg["cam"]["H_out"], cfg["cam"]["W_out"]
    _, _, truth = room_scene(cfg, MESH_FRAMES, seed=3, step=SYSTEM_STEP,
                             camera=((H, W), tuple(stream.intrinsic)),
                             dino=False)

    def feat_fn(image):
        seed = int(np.asarray(image, np.float64).sum() * 1e3) % 2 ** 31
        return np.random.RandomState(seed).normal(
            size=(H // 14, W // 14, 384)).astype(np.float32)
    slam = system.SLAM(cfg, stream, depth_fn=lambda im: None,
                       feat_fn=feat_fn, device=dev, mesh=mesh)
    mf = slam.motion_filter
    track, frame = mf.track, {}

    def tracked(tstamp, image):
        frame["i"] = int(tstamp)
        return track(tstamp, image)
    mf.track = tracked
    mf.depth_fn = lambda image: truth[frame["i"]][1]
    end = {}
    term = slam.terminate

    def at_loop_end():
        """The loop's result, before terminate's final BA moves it."""
        torch.cuda.synchronize()
        n = slam.state.counter
        end.update(t=time.perf_counter(), n=n,
                   poses=slam.state.store.poses[:n].clone(),
                   disps=slam.state.store.disps[:n].clone(),
                   alive=gm.num_alive(slam.mapper.gaussians))
        if terminate:
            term()
    slam.terminate = at_loop_end
    torch.cuda.synchronize()
    TIMER.reset()
    t0 = time.perf_counter()
    slam.run(resume_path=resume)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = TIMER.stats["data.load"].count
    upd = TIMER.stats.get("track.frontend")
    term_s = (f"terminate {wall - end['t'] + t0:.2f} s" if terminate
              else "no terminate")
    print(f"{label}: {n} frames -> {slam.state.counter} keyframes; loop "
          f"{(end['t'] - t0) / n * 1e3:.1f} ms per frame, {term_s}"
          f"; track.frontend {upd.total / max(upd.count, 1) * 1e3:.1f} ms "
          f"per frame; sharded update_n built "
          f"{len(slam.frontend.graph._sharded_steps)} step function(s)")
    return slam, end, wall


def mesh_system_check(dev, pmesh):
    """(d) SLAM.run() with a 2-shard mesh on one card, killed and resumed,
    against the run without a mesh. Returns the run without a mesh (its
    loop ended, no terminate) and the mesh legs' launches."""
    seq = os.path.join(ENTRY_DIR, "tum_sequence")     # phase 8 wrote it
    out = os.path.join(ENTRY_DIR, "mesh_out")
    shutil.rmtree(out, ignore_errors=True)

    def cfg_for(tag, **extra):
        cfg = load_config(CONFIG)
        cfg.update(scene=f"mesh_{tag}", fast_mode=True, verbose=False,
                   max_frames=MESH_FRAMES, **extra)
        cfg["data"].update(input_folder=seq, output=out)
        t = cfg["tracking"]
        t["buffer"] = MESH_BUFFER
        t["warmup"] = MESH_WARMUP
        t["force_keyframe_every_n_frames"] = 1
        t["motion_filter"]["thresh"] = 1e9
        cfg["mapping"]["final_refine_iters"] = MESH_CUTS["final_refine_iters"]
        for k in ("init_itr_num", "mapping_itr_num"):
            cfg["mapping"]["Training"][k] = MESH_CUTS[k]
        return cfg
    reduced = {"frames": (f"{MESH_FRAMES} of phase 8's TUM sequence, every "
                          f"one a keyframe; the mesh leg killed at "
                          f"{MESH_KILL} with a checkpoint and resumed"),
               "tracking.buffer": f"350 -> {MESH_BUFFER}",
               "tracking.warmup": (f"12 -> {MESH_WARMUP} (test_mesh_e2e.py's; "
                                   f"leg A must pass it to checkpoint)"),
               "iterations": json.dumps(MESH_CUTS),
               "priors": "the scene's exact depth; seeded random features",
               "DROID weights": "seeded (no droid.pth); no oracle"}
    print("mesh (d) reduced:", json.dumps(reduced))
    one, end1, wall1 = mesh_slam_run(cfg_for("single"), dev, None,
                                     "mesh (d) no mesh", terminate=False)
    mesh = pmesh.make_mesh(devices=[dev] * 2, axis="g")
    reset_launches()
    a, _, wall_a = mesh_slam_run(
        cfg_for("mesh", checkpoint_every=MESH_KILL) | {
            "max_frames": MESH_KILL}, dev, mesh, "mesh (d) 2 shards, leg A",
        terminate=False)
    renders = a.mapper.fused_renders
    del a
    ckpt = os.path.join(out, "mesh_mesh", "checkpoint.npz")
    if not os.path.exists(ckpt):
        raise AssertionError("mesh leg A wrote no checkpoint")
    b, end_b, wall_b = mesh_slam_run(cfg_for("mesh"), dev, mesh,
                                     "mesh (d) 2 shards, leg B", resume=ckpt)
    renders += b.mapper.fused_renders
    launches = read_launches()
    launch_gate("mesh (d) legs A + B", launches, renders)
    n = end1["n"]
    dp = float((end_b["poses"] - end1["poses"]).abs().max())
    dd = float((end_b["disps"] - end1["disps"]).abs().max())
    print(f"mesh (d) at the loops' end: keyframes {end_b['n']} (mesh) vs "
          f"{n}; max |mesh - single| keyframe poses {dp:.3e}, disparities "
          f"{dd:.3e}; alive {end_b['alive']} vs {end1['alive']} "
          f"(test_mesh_e2e.py's tolerances {json.dumps(E2E_TOL)}, equal "
          f"alive; printed, not gated); mesh capacity {b.mapper.capacity}; "
          f"{wall1:.1f} s without a mesh (no terminate), "
          f"{wall_a + wall_b:.1f} s with (A + B, B's terminate included)")
    ply = os.path.join(out, "mesh_mesh", "final_gs.ply")
    if not (end_b["n"] == n and os.path.exists(ply)
            and len(b.frontend.graph._sharded_steps) > 0):
        raise AssertionError("mesh (d): the mesh run did not reach the same "
                             "keyframe count through the sharded step, or "
                             "wrote no final_gs.ply")
    del b
    gc.collect()
    torch.cuda.empty_cache()
    return one, launches


def mesh_entry_check(dev):
    """(e) run.build(--mesh 2) on this machine: make_mesh's message when it
    has one card."""
    from wildgs_slam_tpu_torch import run as entry

    seq = os.path.join(ENTRY_DIR, "tum_sequence")
    out = os.path.join(ENTRY_DIR, "mesh_out")
    spec = {"inherit_from": CONFIG, "scene": "mesh_entry", "verbose": False,
            "data": {"input_folder": seq, "output": out}}
    cfg_path = os.path.join(ENTRY_DIR, "mesh_entry.yaml")
    with open(cfg_path, "w") as fh:
        json.dump(spec, fh)
    empty = os.path.join(ENTRY_DIR, "no_checkpoints")
    os.makedirs(empty, exist_ok=True)
    argv = [cfg_path, "--device", "cuda", "--mesh", "2", "--pretrained",
            empty]
    cards = torch.cuda.device_count()
    msg = f"parallel.n_devices=2 but only {cards} devices visible"
    if cards < 2:
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                entry.build(argv)
        except ValueError as e:
            if str(e) != msg:
                raise
            print(f"mesh (e): run.build(--mesh 2) with {cards} card raised "
                  f"ValueError('{e}')")
        else:
            raise AssertionError("run.build(--mesh 2) did not raise on one "
                                 "card")
    else:
        with contextlib.redirect_stdout(io.StringIO()):
            _, slam, _ = entry.build(argv)
        print(f"mesh (e): {cards} cards: run.build(--mesh 2) built a mesh of "
              f"{slam.mesh.size}")


def mesh_phase(dev):
    """Phase 11: the multi-device mode at the widths of tum_dynamic.yaml,
    meshes of 2 and 8 shards on one card."""
    from wildgs_slam_tpu_torch.parallel import collectives as col
    from wildgs_slam_tpu_torch.parallel import mesh as pmesh
    from wildgs_slam_tpu_torch.parallel import sharded_dba as sdba
    from wildgs_slam_tpu_torch.parallel import sharded_raster as sraster

    t0 = time.perf_counter()
    render_launches = mesh_render_check(dev, pmesh, sraster)
    t1 = time.perf_counter()
    print(f"mesh (a): {t1 - t0:.1f} s")
    one, slam_launches = mesh_system_check(dev, pmesh)
    t2 = time.perf_counter()
    print(f"mesh (d): {t2 - t1:.1f} s")
    mesh_tracking_check(dev, pmesh, sdba, col, one.state,
                        one.frontend.graph)
    del one
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    print(f"mesh (b, c): {t3 - t2:.1f} s")
    mesh_entry_check(dev)
    print(f"mesh (e): {time.perf_counter() - t3:.1f} s")
    return {k: render_launches[k] + slam_launches[k] for k in KERNELS}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"port package: {os.path.dirname(kernels.CSRC)}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    native_build = None
    if not KERNELS_FROM:   # the native library builds beside nvcc
        from concurrent.futures import ThreadPoolExecutor

        from wildgs_slam_tpu_torch import native
        native_build = ThreadPoolExecutor(1).submit(native.build_library)
    log = kernels.build_kernels()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    if native_build is not None:
        info = native_build.result()
        print(f"native build: {info['seconds']:.2f} s ({info['compiler']})")
    for src, info in log.items():
        print(f"  {src}: {info['seconds']:.2f} s\n    "
              + info["ptxas"].replace("\n", "\n    "))
    for entry, used in ptxas_resources(
            log, ("composite_fwd_kernel", "table_scatter_add_kernel")).items():
        print(f"ptxas {entry}: {used}")

    rows = kernel_phase(dev)
    if KERNELS_FROM:
        print(json.dumps({"kernels_from": KERNELS_FROM, "ms": {
            r["name"]: r["ms"] for r in rows}}))
        return
    small_render_check(dev)
    launches = slice_phase(dev)
    track_launches = tracking_phase(dev)
    system_launches = system_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = priors_phase(dev)
    entry_launches = entry_phase(dev, ckpt)
    gc.collect()
    torch.cuda.empty_cache()
    nonmetric_launches = nonmetric_phase(dev, ckpt)
    gc.collect()
    torch.cuda.empty_cache()
    t_jpeg = time.perf_counter()
    jpeg_launches = jpeg_phase(dev, ckpt)
    print(f"phase 10: {time.perf_counter() - t_jpeg:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t_mesh = time.perf_counter()
    mesh_launches = mesh_phase(dev)
    print(f"phase 11: {time.perf_counter() - t_mesh:.1f} s")
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["launches_by_path"] = {
            "mapping": launches[row["name"]],
            "tracking": track_launches[row["name"]],
            "system": system_launches[row["name"]],
            "entry": entry_launches[row["name"]],
            "nonmetric": nonmetric_launches[row["name"]],
            "jpeg": jpeg_launches[row["name"]],
            "mesh": mesh_launches[row["name"]]}
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
