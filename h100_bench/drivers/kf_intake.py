"""The keyframe-intake driver: frames one after the other through the
motion filter, each when the previous has returned, every frame a
keyframe.

Per frame, as ``slam/system.py`` calls it: ``MotionFilter.track`` with the
keyframe force interval at the traffic's ``force_keyframe_every`` (1: every
frame), so each frame runs fnet, the flow check against the last keyframe,
the context encoder, the metric depth prior, the DINO feature prior, the
append and the priors' disk caches. No frontend runs (``track_stream``
measures it). The priors are what ``run.py`` builds: ``make_prior_fns`` on
the configuration's ``mono_prior``, given the two networks built and
seeded (``seeded_priors.py``) in place of their checkpoints; the caches go
to a fresh directory under ``build/`` that the run removes. The DROID
network's weights come from the seed (``seeded.py``).

Set-up runs ``warm_frames`` frames. The window then takes frames until
``seconds`` have passed or the keyframe store is full, whichever comes
first, and lets the frame in flight finish; it takes at least the frames
drawn for the check and, traced, the profiled stretch.

What is compared: for ``check_keyframes`` keyframes drawn from the seed
among the window's first ``check_within``, forward hooks capture the
networks' inputs as the timed path built them, the depth encoder's tapped
layers, the depth head's map before the sigmoid (with random weights a
sigmoid can saturate and hide a difference) and the DINO features; the
reference (``reference/priors.py``) recomputes each from the captured
input. Numbers: ``encoder_gap``, ``depth_logit_gap``, ``feat_gap``, each
the worst relative norm of the difference over the keyframes drawn (and
the tapped layers). A frame fails if its cached depth or features are
missing or not finite.

    python3 -m h100_bench.drivers.kf_intake --seeds 1,2,3 [--control 3] \
        [--fault 3] [--seconds 20]

prints the readings the cell's limits are set from, as
``h100_bench.readings`` does for the other cells: one JSON line per seed
and side (the program; the control, the reference in TF32; planted faults:
the reference with upstream's positional-embedding resize, and with the
middle block's second LayerScale dropped).
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from wildgs_slam_tpu_torch.models import priors
from wildgs_slam_tpu_torch.models.droid_net import DroidNet
from wildgs_slam_tpu_torch.slam.motion_filter import MotionFilter
from wildgs_slam_tpu_torch.slam.state import SlamState
from wildgs_slam_tpu_torch.utils.profiling import TIMER

from .. import scene, seeded, seeded_priors, trace
from ..counts import priors as pcount
from ..reference import priors as ref
from .tracking import _rel

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FEATURE_ENCODER = "vits"
WORKLOAD = "tum_dynamic_priors.kf_intake"


class PriorCapture:
    """Forward hooks on the two networks. While armed (one frame), they
    record the depth network's input, its encoder's tapped layers (patch
    tokens), its head's map before the sigmoid, the feature network's input
    and its features. The depth input's shape is kept for every call."""

    def __init__(self, depth_net, feat_net):
        self.records, self._cur = [], None
        self.depth_shape = None

        def keep(key, fn):
            def hook(module, args, out=None):
                if self._cur is not None:
                    self._cur[key] = fn(args, out)
            return hook

        def depth_in(module, args):
            self.depth_shape = tuple(args[0].shape)
            keep("depth_x", lambda a, o: a[0].clone())(module, args)
        head = depth_net.depth_head.scratch.output_conv2[2]
        self._handles = [
            depth_net.register_forward_pre_hook(depth_in),
            depth_net.pretrained.register_forward_hook(keep(
                "taps", lambda a, o: [p.clone() for p, _ in o])),
            head.register_forward_hook(keep(
                "logit", lambda a, o: o[:, 0].clone())),
            feat_net.register_forward_pre_hook(keep(
                "feat_x", lambda a, o: a[0].clone())),
            feat_net.register_forward_hook(keep(
                "feat", lambda a, o: o[0][0].clone()))]

    def arm(self, frame):
        self._cur = dict(frame=frame)

    def disarm(self):
        if self._cur is not None:
            self.records.append(self._cur)
            self._cur = None

    def close(self):
        for h in self._handles:
            h.remove()


def _encoder(cfg) -> str:
    mp = cfg["mono_prior"]["depth"]
    return priors.METRIC3D_STAND_IN.get(mp, mp).split("_")[1]


class IntakeCell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg = copy.deepcopy(cfg)
        self.traffic = traffic
        self.seed = int(seed)
        self.dev = torch.device(device)
        build = os.path.join(ROOT, "build")
        os.makedirs(build, exist_ok=True)
        self.out_dir = tempfile.mkdtemp(prefix="kf_intake_", dir=build)
        self.depth_net, self.feat_net, self.weights = seeded_priors.networks(
            self.cfg, seed, self.dev)
        self.depth_fn, self.feat_fn = priors.make_prior_fns(
            self.cfg, self.out_dir, device=self.dev,
            models={"depth": self.depth_net, "feat": self.feat_net})
        t = self.cfg["tracking"]
        (H, W), intr = scene.camera(self.cfg)
        self.state = SlamState.create(
            self.cfg, H, W, np.asarray(intr, np.float32), buffer=t["buffer"],
            device=self.dev)
        self.model = DroidNet().eval()
        seeded.load(self.model, seed, 23, self.dev)
        self.mf = MotionFilter(
            self.state, self.model, thresh=t["motion_filter"]["thresh"],
            force_keyframe_every_n_frames=traffic["force_keyframe_every"],
            depth_fn=self.depth_fn, feat_fn=self.feat_fn)
        self.capture = PriorCapture(self.depth_net, self.feat_net)
        self.next_frame = 0

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def step(self):
        i = self.next_frame
        self.next_frame += 1
        image = scene.make_frame(self.cfg, self.traffic, self.seed, i,
                                 self.dev).image.cpu().numpy()
        self.mf.track(float(i), image)

    def setup(self):
        for _ in range(self.traffic["warm_frames"]):
            self.step()
        self._sync()

    def window(self, seconds, wanted, profile):
        """Frames until `seconds` have passed or the store is full, the
        frames `wanted` (window frame numbers) captured; with `profile`,
        frames profile["start"] to + "frames" traced."""
        st, cap = self.state, self.capture
        slots = len(st.timestamps)
        stretch = trace.Stretch(self.dev) if profile else None
        calls0 = self.depth_fn._counter, self.feat_fn._counter
        kf0 = st.counter
        TIMER.reset()
        self._sync()
        t0 = time.perf_counter()
        frames, ends = 0, []
        while st.counter < slots:
            if profile and frames == profile["start"]:
                stretch.start()
            if frames in wanted:
                cap.arm(frames)
            self.step()
            cap.disarm()
            frames += 1
            ends.append(time.perf_counter())
            if profile and stretch.wall_s is None and stretch.prof and (
                    frames == profile["start"] + profile["frames"]):
                stretch.stop()
            if (time.perf_counter() - t0 >= seconds and frames > max(wanted)
                    and not (profile and stretch.wall_s is None)):
                break
        self._sync()
        wall = time.perf_counter() - t0
        timer = TIMER.summary()
        host_s = _prior_host_s(timer)
        failed = self._failed(calls0, (self.depth_fn._counter,
                                       self.feat_fn._counter))
        net, head = self.depth_net.pretrained, self.depth_net.depth_head
        h, w = self.capture.depth_shape[1:3]
        out = dict(attempted=frames, failed=failed, window_s=wall,
                   window_start=t0, frames=frames,
                   keyframes=st.counter - kf0,
                   e2e={"track_ms_per_frame": wall * 1e3 / frames},
                   timer=timer, prior_host_s=host_s, records=cap.records,
                   wanted=sorted(wanted),
                   unit_s=list(np.diff([t0] + ends)),
                   prior_ops=pcount.depth_call(
                       h // ref.PATCH, w // ref.PATCH, net.embed_dim,
                       len(net.blocks), head.scratch.layer1_rn.out_channels,
                       [p.out_channels for p in head.projects],
                       1 + net.num_register_tokens))
        if profile:
            if stretch.wall_s is None:
                raise RuntimeError("the window ended before its profiled "
                                   "stretch")
            out["stretch"] = stretch.summary()
            out["stretch"]["frames"] = profile["frames"]
            if self.dev.type == "cpu":
                out["stretch"].update(_spans_busy(stretch))
        return out

    def _failed(self, calls0, calls1) -> int:
        """Window frames whose cached depth or features are missing or not
        finite."""
        bad = set()
        for fn, c0, c1 in ((self.depth_fn, calls0[0], calls1[0]),
                           (self.feat_fn, calls0[1], calls1[1])):
            for k in range(c0, c1):
                path = os.path.join(fn.cache_dir, f"{k:05d}.npy")
                if not (os.path.exists(path)
                        and np.isfinite(np.load(path)).all()):
                    bad.add(k - c0)
        return len(bad)

    def release(self):
        self.capture.close()
        self.state = self.mf = self.model = None
        self.depth_fn = self.feat_fn = self.depth_net = self.feat_net = None
        shutil.rmtree(self.out_dir, ignore_errors=True)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def _prior_host_s(timer) -> float:
    """Host seconds of the priors outside their networks' launches and the
    waits for the device: the self time of ``prior.depth`` and
    ``prior.feat``, the ``prior.depth.io`` and ``prior.feat.io`` spans from
    the later of their start on the host and on the device (before that,
    a copy to or from the device waits for the work queued ahead of it),
    and ``prior.cache``."""
    out = sum((timer.get(n) or {}).get("self_s", 0.0)
              for n in ("prior.depth", "prior.feat", "prior.cache"))
    for sp in TIMER.records:
        if sp.name in ("prior.depth.io", "prior.feat.io"):
            start = sp.t0 if sp.d0 is None else max(sp.t0, sp.d0)
            out += max(sp.t1 - start, 0) / 1e9
    return out


def _spans_busy(stretch) -> dict:
    """On the CPU, where the profiler sees no device and a device-marked
    span's device interval is its host interval (``utils/profiling.py``):
    the stretch's busy time as the union of those intervals, and their
    count as its operations."""
    t0 = round(stretch._t0 * 1e9)
    t1 = t0 + round(stretch.wall_s * 1e9)
    spans = sorted((sp.d0, sp.d1) for sp in TIMER.records
                   if sp.d0 is not None and t0 <= sp.t0 and sp.t1 <= t1)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return dict(busy_s=busy / 1e9, n_ops=len(spans))


# --------------------------------------------------------------------------
# the comparison with the reference
# --------------------------------------------------------------------------

def reference_numbers(out, weights, encoder, tf32=False, fault=None) -> dict:
    """The numbers compared, of the program (or, with `tf32`, of the
    reference computed with TF32; with `fault`, of the reference with a
    planted fault) against the reference. A keyframe drawn but never
    captured reads inf."""
    inf = float("inf")
    if len(out["records"]) < len(out["wanted"]):
        return dict(encoder_gap=inf, depth_logit_gap=inf, feat_gap=inf)
    wd, wf = weights["depth"], weights["feat"]
    if fault == "ls2":      # the middle block's second LayerScale dropped
        name = (f"pretrained.blocks.{ref.depth_of(wd, 'pretrained.') // 2}"
                ".ls2.gamma")
        wd = dict(wd, **{name: torch.ones_like(wd[name])})
    pos = (ref.resize_pos_embed_upstream if fault == "upstream_pos"
           else ref.resize_pos_embed)
    layers, heads = ref.INTERMEDIATE[encoder], ref.HEADS[encoder]
    fheads = ref.HEADS[FEATURE_ENCODER]
    enc = logit = feat = 0.0
    for rec in out["records"]:
        r = ref.depth_anything(weights["depth"], rec["depth_x"], layers,
                               heads)
        f = ref.features(wf, rec["feat_x"], fheads)
        if tf32 or fault:
            side = ref.depth_anything(wd, rec["depth_x"], layers, heads,
                                      tf32=tf32, pos_resize=pos)
            rec = dict(rec, taps=side["taps"], logit=side["logit"],
                       feat=ref.features(wf, rec["feat_x"], fheads,
                                         tf32=tf32, pos_resize=pos))
        enc = max([enc] + [_rel(a, b) for a, b in zip(rec["taps"],
                                                       r["taps"])])
        logit = max(logit, _rel(rec["logit"], r["logit"]))
        feat = max(feat, _rel(rec["feat"], f))
        del r, f
    return dict(encoder_gap=enc, depth_logit_gap=logit, feat_gap=feat)


def draw_frames(seed: int, traffic: dict):
    """The window frames whose priors the check compares, drawn from the
    seed: `check_keyframes` distinct ones among the first
    `check_within`."""
    rng = np.random.RandomState(seeded.sub_seed(seed, 31) % (2 ** 32))
    return sorted(rng.choice(traffic["check_within"],
                             traffic["check_keyframes"], replace=False)
                  .tolist())


def run(cfg, traffic, seed, seconds, trace_on, device, t_start=None):
    """Set-up, window and check of one run (as ``tracking.run``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = IntakeCell(cfg, traffic, seed, device)
    try:
        cell.setup()
        out = cell.window(seconds, draw_frames(seed, traffic),
                          traffic.get("profile") if trace_on else None)
        out["memory_peak_bytes"] = (
            torch.cuda.max_memory_allocated(cell.dev)
            if cell.dev.type == "cuda" else None)
        weights = cell.weights
    finally:
        cell.release()
    out["setup_s"] = out["window_start"] - t_start
    t0 = time.perf_counter()
    out["numbers"] = reference_numbers(out, weights, _encoder(cfg))
    out["reference_s"] = time.perf_counter() - t0
    out.pop("records")
    return out


def main(argv=None):
    from .. import run as hr

    p = argparse.ArgumentParser(description="readings of the cell's limits")
    p.add_argument("--workload", default=WORKLOAD)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--fault", type=int, default=3)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    spec = hr.load_json(hr.ROOT, "BENCHMARK.json")
    cell = next(w for w in spec["workloads"] if w["name"] == args.workload)
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = hr.load_json(hr.ROOT, conf["file"])["config"]
    mix = hr.load_json(hr.HERE, "traffic", f"{cell['traffic']}.json")
    encoder = _encoder(cfg)
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        c = IntakeCell(cfg, mix, seed, args.device)
        try:
            c.setup()
            t_setup = time.perf_counter() - t0
            out = c.window(args.seconds, draw_frames(seed, mix), None)
            weights = c.weights
        finally:
            c.release()
        sides = [("program", {})]
        if k < args.control:
            sides.append(("control_tf32", dict(tf32=True)))
        if k < args.fault:
            sides += [("fault_upstream_pos", dict(fault="upstream_pos")),
                      ("fault_ls2", dict(fault="ls2"))]
        streams = []
        rec = out["records"][0]
        with ref.precision(), torch.no_grad():
            ref.vit(weights["depth"], rec["depth_x"], (), ref.HEADS[encoder],
                    "pretrained.", streams=streams)
        moves = [_rel(b, a) for a, b in zip(streams[:-1], streams[1:])]
        del streams
        for name, kw in sides:
            print(json.dumps(dict(
                workload=args.workload, seed=seed, side=name,
                numbers=reference_numbers(out, weights, encoder, **kw),
                block_moves=[min(moves), max(moves)],
                setup_s=t_setup, frames=out["frames"],
                wanted=out["wanted"],
                ms_per_frame=out["e2e"]["track_ms_per_frame"],
                memory_peak_bytes=(torch.cuda.max_memory_allocated()
                                   if c.dev.type == "cuda" else None))),
                flush=True)
        del out, weights
        if c.dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
