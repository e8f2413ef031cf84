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
     frontend updates, with its times, memory and a torch.profiler summary;
  7. one JSON line describing every kernel;
  8. the card again, then the last line {"ok": true, "device": {...}}.

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

import gc
import json
import os
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
from wildgs_slam_tpu_torch.slam import gaussian_map as gm  # noqa: E402
from wildgs_slam_tpu_torch.slam import keyframe_store as kstore  # noqa: E402
from wildgs_slam_tpu_torch.slam import system  # noqa: E402
from wildgs_slam_tpu_torch.slam.frontend import Frontend  # noqa: E402
from wildgs_slam_tpu_torch.slam.mapper import Mapper  # noqa: E402
from wildgs_slam_tpu_torch.slam.motion_filter import MotionFilter  # noqa
from wildgs_slam_tpu_torch.slam.state import SlamState  # noqa: E402
from wildgs_slam_tpu_torch.utils.eval_traj import ape_statistics  # noqa
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

def room_scene(cfg, n_kf, seed=0, step=1.0):
    """A textured box room seen by a camera moving through it: per keyframe
    an image, an exact metric depth and a world->camera pose, plus random
    DINO features; all from numpy with a seed. `step` scales the motion
    between consecutive frames."""
    cam = cfg["cam"]
    H, W = cam["H_out"], cam["W_out"]
    sx = W / (cam["W"] - 2 * cam["W_edge"])
    sy = H / (cam["H"] - 2 * cam["H_edge"])
    fx, fy = cam["fx"] * sx, cam["fy"] * sy
    cx, cy = (cam["cx"] - cam["W_edge"]) * sx, (cam["cy"] - cam["H_edge"]) * sy
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
    return launches


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
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["launches_by_path"] = {"mapping": launches[row["name"]],
                                   "tracking":
                                   track_launches[row["name"]]}
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
