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
     random cotangents in every slot);
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
  9. one JSON line describing every kernel;
  10. the card again, then the last line {"ok": true, "device": {...}}.

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
import zlib

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
from wildgs_slam_tpu_torch.utils.profiling import TIMER  # noqa: E402

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

def mapping_table(dev, n=262144, h=384, w=512, capacity=512, seed=0):
    """Counts and packed table of a seeded random scene through the port's
    projection, binning and table gather."""
    rng = np.random.RandomState(seed)
    f = 0.9 * w
    means = np.concatenate([rng.uniform(-1.2, 1.2, (n, 1)) * w / f,
                            rng.uniform(-1.2, 1.2, (n, 1)) * h / f,
                            np.ones((n, 1))], -1)
    means *= 2.0 + 3.0 * rng.uniform(size=(n, 1))
    scales = np.exp(rng.uniform(np.log(0.004), np.log(0.03), (n, 3)))
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=-1, keepdims=True)
    proj = tr.project_gaussians(
        t32(means, dev), t32(scales, dev), t32(rots, dev),
        t32(0.2 + 0.75 * rng.uniform(size=n), dev),
        t32(rng.uniform(-1, 1, (n, 1, 3)), dev),
        t32([0, 0, 0, 0, 0, 0, 1], dev), t32([f, f, w / 2, h / 2], dev),
        (h, w))
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

def room_scene(cfg, n_kf, seed=0, step=1.0, camera=None):
    """A textured box room seen by a camera moving through it: per keyframe
    an image, an exact metric depth and a world->camera pose, plus random
    DINO features; all from numpy with a seed. `step` scales the motion
    between consecutive frames. `camera` ((H, W), (fx, fy, cx, cy)) renders
    at that size and those intrinsics instead of the config's output
    camera."""
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
    for i in range(n_kf):
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
        dino = rng.normal(size=(H // 14, W // 14, 384))
        frames.append((w2c, depth, img.astype(np.float32),
                       dino.astype(np.float32)))
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


def write_png(path, a):
    """A uint8 (H, W, 3) RGB or uint16 (H, W) grey image as a PNG, the five
    row filters taken in turn, so that the reader undoes each."""
    h, w = a.shape[:2]
    depth, ctype = (16, 0) if a.dtype == np.uint16 else (8, 2)
    x = np.ascontiguousarray(a.astype(">u2") if depth == 16 else a).view(
        np.uint8).reshape(h, -1).astype(np.int16)
    bpp = x.shape[1] // w
    up = np.concatenate([np.zeros_like(x[:1]), x[:-1]])
    left = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]
    upleft = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    preds = [np.zeros_like(x), left, up, (left + up) >> 1,
             np.where((pa <= pb) & (pa <= pc), left,
                      np.where(pb <= pc, up, upleft))]
    f = np.arange(h) % 5
    pred = np.stack([preds[k][r] for r, k in enumerate(f)])
    body = np.concatenate([f[:, None], (x - pred) & 255], 1).astype(np.uint8)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                              0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(body.tobytes(), 6))
                 + chunk(b"IEND", b""))


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
        write_png(os.path.join(root, "rgb", f"{t}.png"), rgb)
        write_png(os.path.join(root, "depth", f"{t}.png"), np.round(
            depth * cam["png_depth_scale"]).astype(np.uint16))
        c2w = lie.se3_inv(torch.as_tensor(w2c)).numpy()
        lines["rgb.txt"].append(f"{t} rgb/{t}.png")
        lines["depth.txt"].append(f"{t} depth/{t}.png")
        lines["groundtruth.txt"].append(
            f"{t} " + " ".join(f"{v:.9f}" for v in c2w))   # tx ty tz qx..qw
    for name, ls in lines.items():
        with open(os.path.join(root, name), "w") as fh:
            fh.write("# written by chip_smoke.py\n# \n# \n" + "\n".join(ls))
    return rgb0


def run_entry(argv, label, cfg, dev):
    """run.build(argv), the scene's exact depth prior and the oracle put in
    between, then SLAM.run(); returns (slam, resume_path, record)."""
    from wildgs_slam_tpu_torch import run as entry

    wall0 = time.time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, slam, resume = entry.build(argv)
    text = buf.getvalue()
    print(text, end="")
    if FALLBACK_LINE in text:
        raise AssertionError(f"{label}: build ran without the priors")
    H, W = cfg["cam"]["H_out"], cfg["cam"]["W_out"]
    _, _, truth = room_scene(cfg, ENTRY_FRAMES, seed=3, step=SYSTEM_STEP,
                             camera=((H, W), tuple(slam.stream.intrinsic)))
    # the depth prior: the scene's depth of the frame being tracked (the
    # reader's timestamps are the frame indices)
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
        ts = store.timestamp.long().clamp(0, ENTRY_FRAMES - 1)
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
               wall0=wall0, t_loop=marks["loop_end"] - t0,
               t_term=t_end - marks["loop_end"],
               peak=torch.cuda.max_memory_allocated() / 2 ** 30,
               stats={k: (v.count, v.total, v.first, v.warm_mean)
                      for k, v in TIMER.stats.items()})
    st = rec["stats"]
    n = st["data.load"][0]
    loop = rec["t_loop"] - st.get("checkpoint.load", (0, 0.0))[1]
    print(f"{label}: {n} frames -> {slam.state.counter} keyframes; loop "
          f"{loop:.2f} s ({loop / n * 1e3:.1f} ms per frame; a checkpoint "
          f"load before it apart), terminate {rec['t_term']:.2f} s; data.load "
          f"{st['data.load'][1] / n * 1e3:.1f} ms per frame (first "
          f"{st['data.load'][2] * 1e3:.1f}); track.mf.priors "
          f"{st['track.mf.priors'][1] / st['track.mf.priors'][0] * 1e3:.1f} "
          f"ms per keyframe over {st['track.mf.priors'][0]}; peak device "
          f"memory {rec['peak']:.2f} GiB")
    print(f"{label} phases:\n" + TIMER.report())
    print(f"{label}: render_fused calls {rec['renders']}; launches "
          f"{json.dumps(rec['launches'])}")
    if any(v != rec["renders"] for v in rec["launches"].values()):
        raise AssertionError(f"{label}: launches {rec['launches']} != "
                             f"{rec['renders']} render_fused calls")
    return slam, resume, rec


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
    log = kernels.build_kernels()
    print(f"build: {time.perf_counter() - t0:.2f} s")
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
    entry_launches = entry_phase(dev, priors_phase(dev))
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["launches_by_path"] = {
            "mapping": launches[row["name"]],
            "tracking": track_launches[row["name"]],
            "system": system_launches[row["name"]],
            "entry": entry_launches[row["name"]]}
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
