"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. the card (name and power limit as nvidia-smi gives them), torch and
     CUDA versions; TF32 off for matmuls and cuDNN convolutions;
  2. build of the CUDA kernels from csrc/ (nvcc, one per source, in
     parallel), with what ptxas reports;
  3. each kernel against its plain PyTorch version at mapping shapes
     (T=768 tiles, K=512 slots, chunk 64), on a table made by the port's
     own projection and binning of a seeded scene;
  4. each kernel's time (CUDA events) beside its bound and its plain
     version's time;
  5. the mapper's keyframe path through Mapper's entry points
     (initialize_mapper, then on_keyframe) at the full widths of
     configs/Dynamic/TUM_RGBD/tum_dynamic.yaml on a seeded synthetic scene,
     with the kernels' launch counts, which must equal the mapping steps run,
     and a torch.profiler summary;
  6. one JSON line describing every kernel;
  7. the card again, then the last line {"ok": true, "device": {...}}.

Any failure raises and exits non-zero. Without a CUDA device it exits
non-zero and prints no result. It finds the port package next to itself,
from any working directory.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from wildgs_slam_tpu_torch.config import load_config  # noqa: E402
from wildgs_slam_tpu_torch.ops import lie  # noqa: E402
from wildgs_slam_tpu_torch.ops import rasterizer as tr  # noqa: E402
from wildgs_slam_tpu_torch.ops.rasterizer import composite_cuda as cc  # noqa
from wildgs_slam_tpu_torch.slam import gaussian_map as gm  # noqa: E402
from wildgs_slam_tpu_torch.slam import keyframe_store as kstore  # noqa: E402
from wildgs_slam_tpu_torch.slam.mapper import Mapper  # noqa: E402
from wildgs_slam_tpu_torch.slam.state import SlamState  # noqa: E402
from wildgs_slam_tpu_torch.utils.profiling import TIMER  # noqa: E402

CONFIG = os.path.join(HERE, "configs", "Dynamic", "TUM_RGBD",
                      "tum_dynamic.yaml")
FP32_OPS_PER_S = 67e12      # H100 SXM, fp32 outside the tensor cores
BYTES_PER_S = 3.35e12       # H100 SXM HBM3
# fp32 operations per live (slot, pixel) pair that each function needs
# (the forward's geometry, exp counted as one operation, blending and the
# four sums; the backward's geometry, g, the suffix, dalpha, the 10
# gradients and their sums)
FWD_OPS_PER_SLOT_PIXEL = 30
BWD_OPS_PER_SLOT_PIXEL = 70
N_INIT_KEYFRAMES = 5     # keyframes at initialize_mapper
N_ONLINE_KEYFRAMES = 3   # on_keyframe calls after it
TOL = dict(color=1e-5, depth=1e-4, alpha=1e-5, tfin=1e-5, tentry=1e-5)
BWD_MAX_REL = 1e-5


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


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
    return (bins.counts, tr.gather_table(attrs, bins.ids).contiguous(),
            int(bins.overflow), -(-w // 16))


def time_ms(fn, reps, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def kernel_phase(dev):
    counts, table, overflow, tw = mapping_table(dev)
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

    # the work these inputs need: live slots of the chunks a tile opens
    starts = torch.arange(n_chunks, device=dev) * ck
    opened = (starts[None] < counts[:, None]) & (tentry.amax(-1) >= 1e-4)
    live = torch.clamp(counts[:, None].long() - starts[None], 0, ck)
    slots = int((live * opened).sum())
    slot_pixels = slots * 256
    f4 = 4
    fwd_bytes = (slots * 16 * f4 + T * 8
                 + T * 256 * 6 * f4 + T * n_chunks * 256 * f4)
    bwd_bytes = (slots * 16 * f4 + T * 8 + T * n_chunks * 256 * f4
                 + T * 256 * 5 * f4 + T * K * 16 * f4)
    print(f"work: {slots} live slots in {int(opened.sum())} open chunks "
          f"({slot_pixels / 1e6:.1f} M slot-pixels); bound counting: "
          f"{FWD_OPS_PER_SLOT_PIXEL} (fwd) / {BWD_OPS_PER_SLOT_PIXEL} (bwd) "
          f"fp32 ops per live slot-pixel at {FP32_OPS_PER_S / 1e12:.0f} "
          f"TFLOP/s, bytes of live table rows, tables and outputs read or "
          f"written once at {BYTES_PER_S / 1e12:.2f} TB/s")

    rows = []
    for name, fn, plain, ops, nbytes, err, src, line in (
            ("composite_fwd",
             lambda: cc.composite_fwd(counts, tid, table, bg, tw, ck),
             lambda: cc.composite_fwd_plain(counts, tid, table, bg, tw, ck),
             FWD_OPS_PER_SLOT_PIXEL * slot_pixels, fwd_bytes,
             max(fwd_err.values()), "composite_fwd.cu", 118),
            ("composite_bwd", lambda: cc.composite_bwd(*bargs),
             lambda: cc.composite_bwd_plain(*bargs),
             BWD_OPS_PER_SLOT_PIXEL * slot_pixels, bwd_bytes, bwd_abs,
             "composite_bwd.cu", 182)):
        ms = time_ms(fn, 50)
        plain_ms = time_ms(plain, 3, warmup=1)
        t_ops, t_bytes = ops / FP32_OPS_PER_S * 1e3, nbytes / BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"{name}: {ms:.4f} ms (plain {plain_ms:.2f} ms); bound "
              f"{bound:.4f} ms by {by}: {ops / 1e9:.3f} G fp32 ops -> "
              f"{t_ops:.4f} ms, {nbytes / 1e6:.2f} MB -> {t_bytes:.4f} ms; "
              f"{bound / ms * 100:.1f}% of bound")
        rows.append(dict(
            name=name, route="cuda",
            source=f"wildgs_slam_tpu_torch/csrc/{src}",
            replaces=f"wildgs_slam_tpu/ops/rasterizer/pallas_composite.py:"
                     f"{line}",
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None))
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

def room_scene(cfg, n_kf, seed=0):
    """A textured box room seen by a camera moving through it: per keyframe
    an image, an exact metric depth and a world->camera pose, plus random
    DINO features; all from numpy with a seed."""
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
        xi = np.array([0.08 * i, 0.02 * np.sin(i), 0.04 * i,
                       0.02 * np.cos(i), 0.12 * i, 0.0], np.float32)
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


def profile_steps(mapper, n_steps):
    """torch.profiler over n_steps mapping iterations: wall and device time
    per step, device-busy share, kernel count and the top kernels."""
    from torch.autograd import DeviceType
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
    dev_us, n_kernels, by_name = 0.0, 0, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            dev_us += us
            n_kernels += 1
            s = by_name.setdefault(e.name, [0.0, 0])
            s[0] += us
            s[1] += 1
    busy = dev_us / 1e6 / wall
    print(f"profile: {n_steps} steps, wall {wall / n_steps * 1e3:.2f} "
          f"ms/step, device {dev_us / 1e3 / n_steps:.2f} ms/step, busy "
          f"{busy * 100:.1f}%, {n_kernels / n_steps:.0f} device ops/step")
    for name, (us, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :12]:
        print(f"  {us / 1e3 / n_steps:8.3f} ms/step  x{cnt // n_steps:<4d} "
              f"{name[:90]}")


@torch.no_grad()
def keyframe_psnr(mapper, frames):
    """PSNR of each keyframe's render (exposure applied) against its
    image."""
    p = mapper.gaussians.params
    out = []
    for v, (_, _, img, _) in enumerate(frames):
        r = tr.render_fused(
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
    cc.composite_fwd.launches = 0
    cc.composite_bwd.launches = 0
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
    launches = {"composite_fwd": cc.composite_fwd.launches,
                "composite_bwd": cc.composite_bwd.launches}
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
    if launches["composite_fwd"] != steps or launches["composite_bwd"] != steps:
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    log = cc.build_kernels()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for src, info in log.items():
        print(f"  {src}: {info['seconds']:.2f} s\n    "
              + info["ptxas"].replace("\n", "\n    "))

    rows = kernel_phase(dev)
    small_render_check(dev)
    launches = slice_phase(dev)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
