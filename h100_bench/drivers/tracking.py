"""The tracking driver: the tracker's half of ``SLAM.run``'s frame loop,
one frame after the other, each when the previous has returned.

Per frame, as ``slam/system.py`` does with the mapper's calls left out:
``MotionFilter.track``, ``Frontend.__call__``, at the warmup's last
keyframe ``Frontend.initialize_second_stage``, and ``Backend.dense_ba(2)``
every ``ba_freq`` keyframes. The frontend is built without a backend, so
its loop-closure BA stays off (a cell of its own drives it). Set-up runs
the frames up to the frontend's second-stage initialisation; the window
then takes frames until ``seconds`` have passed and lets the frame in
flight finish.

The DROID network's and the uncertainty MLP's weights come from the seed
(``seeded.py``), the metric depth prior is the frames' exact depth and the
DINO features the frames' own.

What is compared: a sample, drawn from the seed, of the window's graph
update iterations (each the update operator's delta, weight and damping,
and the poses and disparities that the iteration's BA leaves), recomputed
by the reference from the state the iteration started from; the
encoders' features of the window's first keyframe, recomputed from its
image; and one motion-filter call drawn from the seed (the new frame's
features and the update operator's flow against the last keyframe, both
recomputed from the two frames' images). A unit drawn for the check that
the window did not reach is waited for after the window has closed.
"""

from __future__ import annotations

import copy
import gc
import time

import numpy as np
import torch

from wildgs_slam_tpu_torch.models.droid_net import DroidNet
from wildgs_slam_tpu_torch.ops import dba
from wildgs_slam_tpu_torch.slam import motion_filter as mf_mod
from wildgs_slam_tpu_torch.slam import system
from wildgs_slam_tpu_torch.slam.backend import Backend
from wildgs_slam_tpu_torch.slam.frontend import Frontend
from wildgs_slam_tpu_torch.slam.motion_filter import MotionFilter
from wildgs_slam_tpu_torch.slam.state import SlamState
from wildgs_slam_tpu_torch.utils.profiling import TIMER

from .. import scene, seeded, trace
from ..counts import tracker as tcount
from ..reference import tracking as ref

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
EP_DAMP = 1e-7
LATE_S = 120.0    # how long after the window a unit drawn is waited for


class IterationCapture:
    """While armed, records graph update iterations of one FactorGraph:
    the update operator's inputs and outputs (a forward hook) and the BA's
    inputs and outputs (``dba.ba`` wrapped), for the iterations whose
    number (from 0, counted from arming) is in `wanted`; the motion
    filter's call number `mf_wanted` (``motion_filter._flow_magnitude``
    wrapped; `frames()` gives the frame it works on and the last
    keyframe's)."""

    def __init__(self, graph, model, wanted, mf_wanted, frames):
        self.graph, self.wanted = graph, set(wanted)
        self.count = 0
        self.records = []
        self.edges = []          # (active, all) edges of every iteration
        self.new_edges = 0       # edges whose correlation volumes were built
        self._cur = None
        self._active = False
        self._orig_ba = dba.ba
        self.mf_count, self.mf = 0, None
        self._mf_on = False
        self._orig_flow = mf_mod._flow_magnitude

        def flow_magnitude(model_, fmap_last, gmap, net, inp):
            take = self.mf_count == mf_wanted
            self.mf_count += 1
            self._mf_on = take
            try:
                out = self._orig_flow(model_, fmap_last, gmap, net, inp)
            finally:
                self._mf_on = False
            if take:
                frame, kf_frame = frames()
                self.mf = dict(self.mf or {}, frame=frame,
                               kf_frame=kf_frame, gmap=gmap.clone())
            return out
        mf_mod._flow_magnitude = flow_magnitude
        update_n, store_corr = graph.update_n, graph._store_corr

        def graph_update_n(*a, **k):
            self._active = True
            try:
                return update_n(*a, **k)
            finally:
                self._active = False

        def graph_store_corr(ii, jj, off):
            self.new_edges += int(ii.shape[0])
            return store_corr(ii, jj, off)
        graph.update_n, graph._store_corr = graph_update_n, graph_store_corr

        def pre(module, args):
            if self._active and self.count in self.wanted:
                st = graph.state.store
                net, inp, corr, flow, ii = args
                self._cur = dict(
                    poses=st.poses.clone(), disps=st.disps.clone(),
                    fmaps=st.fmaps[:graph.state.counter].clone(),
                    intr=st.intrinsics.clone(),
                    net=net.clone(), inp=inp.clone(), flow=flow.clone(),
                    ii_e=ii.clone(), jj_e=torch.as_tensor(
                        graph.jj, device=ii.device).clone(),
                    target_prev=graph.target.clone(),
                    damping=graph.damping.clone(),
                    uinv=st.uncertainties_inv.clone())

        def post(module, args, out):
            if self._mf_on:
                self.mf = dict(delta=out[1].clone())
            if self._cur is not None:
                _, delta, weight, frames, eta, _ = out
                self._cur.update(delta=delta.clone(), weight=weight.clone(),
                                 frames=frames.clone(), eta=eta.clone())

        def ba(poses, disps, intrinsics, target, weight, eta, ii, jj, groups,
               t0, t1, iters=2, cfg=dba.BAConfig(), sensor_disps=None,
               sensor_valid=None, motion_only=False):
            out = self._orig_ba(poses, disps, intrinsics, target, weight, eta,
                                ii, jj, groups, t0, t1, iters, cfg,
                                sensor_disps, sensor_valid, motion_only)
            if not self._active:
                return out
            E = self.graph.E
            self.edges.append((E, int(ii.shape[0]), int(t1) - int(t0),
                               int(iters), int(np.unique(self.graph.ii).size)))
            if self._cur is not None:
                self._cur.update(
                    ii_all=ii.clone(), jj_all=jj.clone(), t0=int(t0),
                    t1=int(t1), iters=int(iters), lm=cfg.lm, ep=cfg.ep,
                    alpha=cfg.alpha, motion_only=bool(motion_only),
                    target_inac=target[E:].clone(),
                    weighted_inac=weight[E:].clone(),
                    sensor_disps=sensor_disps.clone(),
                    sensor_valid=sensor_valid.clone(),
                    poses_out=out[0].clone(), disps_out=out[1].clone())
                self.records.append(self._cur)
                self._cur = None
            self.count += 1
            return out
        self._handles = [model.update.register_forward_pre_hook(pre),
                         model.update.register_forward_hook(post)]
        dba.ba = ba

    def complete(self) -> bool:
        """Whether every unit drawn for the check has come."""
        return (len(self.records) == len(self.wanted)
                and self.mf is not None and "gmap" in self.mf
                and "delta" in self.mf)

    def close(self):
        dba.ba = self._orig_ba
        mf_mod._flow_magnitude = self._orig_flow
        del self.graph.update_n, self.graph._store_corr
        for h in self._handles:
            h.remove()


class TrackingCell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg = copy.deepcopy(cfg)
        self.traffic = traffic
        self.seed = int(seed)
        self.dev = torch.device(device)
        t = self.cfg["tracking"]
        (H, W), intr = scene.camera(self.cfg)
        self.hw = (H, W)
        self.state = SlamState.create(
            self.cfg, H, W, np.asarray(intr, np.float32),
            buffer=t["buffer"], device=self.dev)
        self.model = DroidNet().eval()
        self.weights = seeded.load(self.model, seed, 23, self.dev)
        up = self.cfg["mapping"]["uncertainty_params"]
        self.mlp = seeded.uncertainty_mlp(seed, up["feature_dim"], self.dev)
        frac = up["train_frac_fix"]

        def uncertainty():
            system.uncertainty_update(self.state, self.mlp, frac)
        self.frontend = Frontend(self.state, self.model, self.cfg,
                                 uncertainty_update_fn=uncertainty)
        self.backend = Backend(self.state, self.model, self.cfg,
                               uncertainty_update_fn=uncertainty)
        self.ba_freq = t["backend"]["ba_freq"]
        self.cur = None
        self.mf = MotionFilter(
            self.state, self.model, thresh=t["motion_filter"]["thresh"],
            force_keyframe_every_n_frames=t["force_keyframe_every_n_frames"],
            depth_fn=lambda im: self.cur.depth,
            feat_fn=lambda im: self.cur.dino.cpu().numpy())
        self.next_frame = 0
        self.prev_kf = -1
        self.prev_ba = 0

    def frame(self, i):
        return scene.make_frame(self.cfg, self.traffic, self.seed, i,
                                self.dev)

    def step(self, spans=None):
        """One frame of the loop; returns whether it made a keyframe. With
        `spans`, the motion filter's and the frontend's synced times are
        added to it."""
        i = self.next_frame
        self.next_frame += 1
        self.cur = self.frame(i)
        image = self.cur.image.cpu().numpy()
        if spans is None:
            self.frontend(self.mf.track(float(i), image))
        else:
            t0 = time.perf_counter()
            force = self.mf.track(float(i), image)
            if self.dev.type == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            self.frontend(force)
            if self.dev.type == "cuda":
                torch.cuda.synchronize()
            t2 = time.perf_counter()
            spans["mf_s"] += t1 - t0
            spans["last_fe_s"] = t2 - t1
        st, fe = self.state, self.frontend
        kf = st.counter - 1
        new = kf != self.prev_kf
        if new and fe.is_initialized:
            if st.counter == fe.warmup:
                fe.initialize_second_stage()
            elif kf >= self.prev_ba + self.ba_freq:
                self.backend.dense_ba(2)
                self.prev_ba = kf
        self.prev_kf = kf
        return new

    def setup(self):
        fe = self.frontend
        while not (fe.is_initialized and self.state.counter >= fe.warmup):
            self.step()
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def _frames(self):
        """The frame in work and the last keyframe's frame."""
        st = self.state
        return self.next_frame - 1, int(st.timestamps[st.counter - 1])

    def window(self, seconds, wanted, profile):
        """Frames until `seconds` have passed, with `wanted` = (graph
        iterations, motion-filter call) captured; with `profile`, frames
        profile["start"] to + "frames" traced. Then, untimed, frames on
        until every unit drawn has come, for at most ``LATE_S`` seconds."""
        st = self.state
        wanted, mf_wanted = wanted
        cap = IterationCapture(
            self.frontend.graph, self.model, wanted, mf_wanted, self._frames)
        enc = None
        stretch = trace.Stretch(self.dev) if profile else None
        updates0 = self.frontend.n_updates
        spans = dict(mf_s=0.0, fe_kf_s=0.0, last_fe_s=0.0)
        kfs, frames = 0, 0
        TIMER.reset()
        it0 = cap.count
        sync = torch.cuda.synchronize if self.dev.type == "cuda" else (
            lambda: None)
        sync()
        t0 = time.perf_counter()
        ends = []
        while True:
            if profile and frames == profile["start"]:
                stretch.start()
                log0, new0 = len(cap.edges), cap.new_edges
                upd_p0, kf_p0 = self.frontend.n_updates, kfs
            n_before = st.counter
            new = self.step(spans if profile else None)
            frames += 1
            ends.append(time.perf_counter())
            if new and st.counter > n_before:
                kfs += 1
                if profile:
                    spans["fe_kf_s"] += spans["last_fe_s"]
                if enc is None:
                    k = st.counter - 1
                    enc = dict(k=k, image=self.cur.image.clone(),
                               fmap=st.store.fmaps[k].clone(),
                               net=st.store.nets[k].clone(),
                               inp=st.store.inps[k].clone())
            if profile and stretch.wall_s is None and stretch.prof and (
                    frames == profile["start"] + profile["frames"]):
                stretch.stop()
                prof = dict(frames=profile["frames"],
                            edge_log=cap.edges[log0:],
                            new_edges=cap.new_edges - new0,
                            updates=self.frontend.n_updates - upd_p0,
                            keyframes=kfs - kf_p0)
            if time.perf_counter() - t0 >= seconds and not (
                    profile and stretch.wall_s is None):
                break
        sync()
        wall = time.perf_counter() - t0
        late = time.perf_counter()
        while not cap.complete() and time.perf_counter() - late < LATE_S:
            self.step()
        late = time.perf_counter() - late
        cap.close()
        mf = cap.mf if cap.mf and "gmap" in cap.mf else None
        if mf is not None:
            mf.update(image=self.frame(mf["frame"]).image,
                      kf_image=self.frame(mf["kf_frame"]).image)
        # a keyframe whose pose or disparities are not finite failed, and
        # with it every frame since the first such keyframe was made
        n = st.counter
        bad = ~(torch.isfinite(st.store.poses[:n]).all(-1)
                & torch.isfinite(st.store.disps[:n]).flatten(1).all(-1))
        failed = frames if bool(bad.any()) else 0
        timer = TIMER.summary()
        out = dict(attempted=frames, failed=failed, window_s=wall,
                   window_start=t0, frames=frames, keyframes=kfs,
                   iterations=cap.count - it0,
                   updates=self.frontend.n_updates - updates0,
                   e2e={"track_ms_per_frame": wall * 1e3 / frames},
                   timer=timer, records=cap.records, encoder=enc,
                   mf=mf, late_s=late,
                   wanted=sorted(wanted), spans=spans if profile else None,
                   unit_s=list(np.diff([t0] + ends)))
        if profile:
            if stretch.wall_s is None:
                raise RuntimeError("the window ended before its profiled "
                                   "stretch")
            out["stretch"] = stretch.summary()
            out["stretch"].update(
                frames=prof["frames"], iterations=len(prof["edge_log"]),
                updates=prof["updates"], keyframes=prof["keyframes"],
                ops=tcount.stretch_ops(self.hw, prof["frames"],
                                       prof["keyframes"], prof["edge_log"],
                                       prof["new_edges"]))
        return out

    def release(self):
        self.state = self.frontend = self.backend = self.mf = None
        self.model = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# the comparison with the reference
# --------------------------------------------------------------------------

def _rel(a, b, scale=None) -> float:
    d = float(torch.linalg.norm((a - b).double().reshape(-1)))
    s = float(torch.linalg.norm((b if scale is None else scale).double()
                                .reshape(-1)))
    return d / max(s, 1e-30)


def _normalise(image):
    mean = torch.tensor(IMAGENET_MEAN, device=image.device)
    std = torch.tensor(IMAGENET_STD, device=image.device)
    return (image - mean) / std


def reference_iteration(rec, w):
    """The reference's iteration from the state `rec` started from:
    {delta, weight, eta, poses, disps}."""
    ii, jj = rec["ii_e"], rec["jj_e"]
    h, wd = rec["disps"].shape[-2:]
    yy, xx = torch.meshgrid(torch.arange(h, device=ii.device),
                            torch.arange(wd, device=ii.device),
                            indexing="ij")
    coords0 = torch.stack([xx, yy], -1).to(torch.float32)
    coords1, _ = ref.reproject(rec["poses"], rec["disps"], rec["intr"], ii,
                               jj)
    flow = torch.clamp(torch.cat([coords1 - coords0,
                                  rec["target_prev"] - coords1], -1),
                       -64.0, 64.0)
    levels = [v.to(torch.bfloat16).to(torch.float32) for v in
              ref.corr_levels(rec["fmaps"][ii], rec["fmaps"][jj])]
    corr = ref.lookup(levels, coords1)
    del levels
    _, delta, weight, frames, eta = ref.update_operator(
        w, rec["net"], rec["inp"], corr, flow, ii)
    damping = rec["damping"].clone()
    damping[frames] = eta
    target = torch.cat([coords1 + delta, rec["target_inac"]])
    ii_all, jj_all = rec["ii_all"], rec["jj_all"]
    E = ii.shape[0]
    wall = torch.cat([weight * rec["uinv"][ii_all[:E]][..., None],
                      rec["weighted_inac"]])
    poses, disps = rec["poses"], rec["disps"]
    for _ in range(rec["iters"]):
        poses, disps = ref.ba_iteration(
            poses, disps, rec["intr"], target, wall,
            0.2 * damping + EP_DAMP, ii_all, jj_all, rec["t0"], rec["t1"],
            rec["sensor_disps"], rec["sensor_valid"], rec["alpha"],
            rec["lm"], rec["ep"])
    return dict(delta=delta, weight=weight, frames=frames, eta=eta,
                poses=poses, disps=disps)


def iteration_numbers(rec, r) -> dict:
    """The update operator's gap (delta, weight, damping, each over the
    reference's norm), and the BA's: the reprojections of every BA edge
    through the two sides' poses and disparities (their difference, and the
    reference's move from the reprojections the iteration began with, over
    the points valid after it), and the raw pose and disparity differences
    and moves beside them."""
    inf = float("inf")
    if not torch.equal(rec["frames"], r["frames"]):
        return dict(update_gap=inf, ba=(inf, 1.0), raw=(inf, 1.0, inf, 1.0))
    upd = max(_rel(rec["delta"], r["delta"]), _rel(rec["weight"], r["weight"]),
              _rel(rec["eta"], r["eta"]))

    def norm(x):
        return float(torch.linalg.norm(x.double().reshape(-1)))

    def coords(poses, disps):
        return ref.reproject(poses, disps, rec["intr"], rec["ii_all"],
                             rec["jj_all"])
    c_in, _ = coords(rec["poses"], rec["disps"])
    c_r, valid = coords(r["poses"], r["disps"])
    c_p, _ = coords(rec["poses_out"], rec["disps_out"])
    return dict(update_gap=upd,
                ba=(norm((c_p - c_r) * valid), norm((c_r - c_in) * valid)),
                raw=(norm(rec["poses_out"] - r["poses"]),
                     norm(r["poses"] - rec["poses"]),
                     norm(rec["disps_out"] - r["disps"]),
                     norm(r["disps"] - rec["disps"])))


def ba_gap(moves) -> float:
    """The worst sampled iteration's gap of the BA's reprojections, over
    the larger of the reference's move in that iteration and its mean move
    over the sampled ones (an iteration late in an update moves little).
    Reprojections, not the poses and disparities themselves: the float32
    normal equations leave directions that barely change a reprojection
    at the round-off of the solve (1e-4-1e-3 of a step for sound runs)."""
    if not moves:
        return 0.0
    mean = float(np.mean([m[1] for m in moves]))
    return max(d / max(s, mean, 1e-30) for d, s in moves)


def reference_mf(rec, w) -> dict:
    """The motion filter's call from the two frames' images: the new
    frame's features and the update operator's delta at the pixel grid
    against the last keyframe, at zero flow."""
    x, xk = _normalise(rec["image"]), _normalise(rec["kf_image"])
    gmap = ref.encoder(w, "fnet", x, True)
    fmap_kf = ref.encoder(w, "fnet", xk, True)
    net, inp = ref.context(w, xk)
    h, wd = gmap.shape[:2]
    yy, xx = torch.meshgrid(torch.arange(h, device=x.device),
                            torch.arange(wd, device=x.device), indexing="ij")
    coords0 = torch.stack([xx, yy], -1).to(torch.float32)[None]
    corr = ref.lookup(ref.corr_levels(fmap_kf[None], gmap[None]), coords0)
    flow = torch.zeros((1, h, wd, 4), device=x.device)
    ii = torch.zeros(1, dtype=torch.int64, device=x.device)
    _, delta, _, _, _ = ref.update_operator(w, net[None], inp[None], corr,
                                            flow, ii)
    return dict(gmap=gmap, delta=delta)


def encoder_gap(enc, w) -> float:
    x = _normalise(enc["image"])
    fmap = ref.encoder(w, "fnet", x, True)
    net, inp = ref.context(w, x)
    return max(_rel(enc["fmap"], fmap), _rel(enc["net"], net),
               _rel(enc["inp"], inp))


def reference_numbers(out, weights, tf32=False) -> dict:
    """The numbers compared, of the program (or, with `tf32`, of the
    reference computed with TF32, as the control) against the reference.
    An update iteration that was drawn but never came reads inf."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    try:
        upd, moves, raw = 0.0, [], []
        for rec in out["records"]:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            r = reference_iteration(rec, weights)
            if tf32:
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
                c = reference_iteration(rec, weights)
                rec = dict(rec, delta=c["delta"], weight=c["weight"],
                           eta=c["eta"], frames=c["frames"],
                           poses_out=c["poses"], disps_out=c["disps"])
            n = iteration_numbers(rec, r)
            upd = max(upd, n["update_gap"])
            moves.append(n["ba"])
            raw.append(n["raw"])
        gaps = dict(update_gap=upd, ba_gap=ba_gap(moves))
        if len(out["records"]) < len(out["wanted"]):
            gaps = dict(update_gap=float("inf"), ba_gap=float("inf"))
        enc = out["encoder"]
        if enc is None:
            e = float("inf")
        else:
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            if tf32:
                x = _normalise(enc["image"])
                net, inp = ref.context(weights, x)
                enc = dict(enc, fmap=ref.encoder(weights, "fnet", x, True),
                           net=net, inp=inp)
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
            e = encoder_gap(enc, weights)
        mf = out["mf"]
        if mf is None:
            mf_gap = float("inf")
        else:
            if tf32:
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
                mf = dict(mf, **reference_mf(mf, weights))
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            r = reference_mf(mf, weights)
            mf_gap = max(_rel(mf["gmap"], r["gmap"]),
                         _rel(mf["delta"], r["delta"]))
        return dict(gaps, encoder_gap=e, mf_gap=mf_gap, ba_moves=moves,
                    ba_raw=raw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]


def draw_iterations(seed: int, traffic: dict):
    """The window's units the check compares, drawn from the seed:
    `check_iterations` distinct update iterations among its first
    `check_within`, and one motion-filter call among the window's frames
    `check_mf_frames` [from, to)."""
    rng = np.random.RandomState(seeded.sub_seed(seed, 29) % (2 ** 32))
    its = sorted(rng.choice(traffic["check_within"],
                            traffic["check_iterations"], replace=False)
                 .tolist())
    lo, hi = traffic["check_mf_frames"]
    return its, int(rng.randint(lo, hi))


def run(cfg, traffic, seed, seconds, trace_on, device, t_start=None):
    """Set-up, window and check of one run (as ``mapping.run``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = TrackingCell(cfg, traffic, seed, device)
    cell.setup()
    out = cell.window(seconds, draw_iterations(seed, traffic),
                      traffic.get("profile") if trace_on else None)
    out["setup_s"] = out["window_start"] - t_start
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(cell.dev)
                                if cell.dev.type == "cuda" else None)
    weights = cell.weights
    cell.release()
    t0 = time.perf_counter()
    out["numbers"] = reference_numbers(out, weights)
    out["reference_s"] = time.perf_counter() - t0
    for k in ("records", "encoder", "mf"):
        out.pop(k)
    return out
