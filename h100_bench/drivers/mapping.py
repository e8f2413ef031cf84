"""The mapping driver: the mapper's keyframe path, one keyframe after the
other, as ``SLAM.run`` hands them to ``Mapper.on_keyframe``.

Set-up writes the traffic's first ``init_keyframes`` frames into the
keyframe store and runs ``Mapper.initialize_mapper`` on them (the
configuration's ``init_itr_num``), then takes one more keyframe through
``Mapper.on_keyframe``: the window's own call, which warms every shape the
window uses. The window then takes keyframes one by one, each when the
previous call has returned, until ``seconds`` have passed, and lets the
keyframe in flight finish.

What is compared comes from the window's first keyframe: the Gaussians
its seeding adds, and three consecutive optimisation steps at a place
drawn from the seed (``draw_step``), clear of the profiled stretch, of the
freeze after a densification and of any densification or opacity reset
between them.

The uncertainty MLP's weights and every random draw of the mapper (the
seeding priorities and the split samples) come from generators seeded by
the run's seed, on the device; the view schedule comes from the mapper's
own ``np.random.RandomState`` seeded by it.
"""

from __future__ import annotations

import copy
import gc
import math
import time

import numpy as np
import torch

from wildgs_slam_tpu_torch.ops.rasterizer import composite_cuda
from wildgs_slam_tpu_torch.slam import gaussian_map as gm
from wildgs_slam_tpu_torch.slam import keyframe_store as kstore
from wildgs_slam_tpu_torch.slam.mapper import Mapper
from wildgs_slam_tpu_torch.slam.state import SlamState
from wildgs_slam_tpu_torch.utils.profiling import TIMER

from .. import scene, seeded, trace
from ..counts import mapping_step, rasterizer as rcount
from ..reference import mapping as ref

CAPTURED_STEPS = 3
GAUSS_LEAVES = ("xyz", "f_dc", "opacity", "scaling", "rotation")
EXCLUDE_BELOW = 1e-3   # a leaf whose reference gradient is under this
                       # share of the median leaf's moves by round-off alone
FREEZE_AFTER = 20      # Mapper.map_opt_online's freeze after a densification
COMPARED = ("loss_gap", "grad_gap", "change_gap", "change_gap_worst_leaf",
            "seed_gap")


def snapshot(mapper) -> dict:
    g, vs, mlp = mapper.gaussians, mapper.vstore, mapper.uncer_mlp
    names = [n for n, _ in mlp.named_parameters()]
    return dict(
        params={n: t.detach().clone() for n, t in
                zip(gm.PARAM_NAMES, g.params.tensors())},
        mu={n: t.clone() for n, t in zip(gm.PARAM_NAMES, g.mu.tensors())},
        nu={n: t.clone() for n, t in zip(gm.PARAM_NAMES, g.nu.tensors())},
        count=g.count, alive=g.aux.alive.clone(), kf_id=g.aux.kf_id.clone(),
        exposure=vs.exposure.clone(), exp_mu=vs.exposure_mu.clone(),
        exp_nu=vs.exposure_nu.clone(), exp_count=vs.exposure_count.clone(),
        mlp={n: p.detach().clone() for n, p in mlp.named_parameters()},
        mlp_mu={n: m.clone() for n, m in zip(names, mapper.uncer_adam.mu)},
        mlp_nu={n: m.clone() for n, m in zip(names, mapper.uncer_adam.nu)},
        mlp_count=mapper.uncer_adam.count)


class StepHook:
    """Wraps ``mapper._opt_step`` on the instance until `close`, and calls
    each listener's `before(i, args)` and `after(i, out)` around the i-th
    call (from 0, counted from the hook's start)."""

    def __init__(self, mapper):
        self.mapper, self.i, self.listeners = mapper, 0, []
        orig = mapper._opt_step

        def hooked(idx, freeze, d_base, d_samples, it_count, initialization,
                   render_fn=None):
            i = self.i
            args = dict(idx=int(idx), freeze=bool(freeze), d_base=int(d_base),
                        d_samples=d_samples, it_count=int(it_count),
                        initialization=bool(initialization))
            for before, _ in self.listeners:
                before(i, args)
            out = orig(idx, freeze, d_base, d_samples, it_count,
                       initialization, render_fn)
            for _, after in self.listeners:
                after(i, out)
            self.i += 1
            return out
        mapper._opt_step = hooked

    def listen(self, before, after):
        self.listeners.append((before, after))

    def close(self):
        del self.mapper._opt_step


def draw_step(seed: int, mapper, traffic: dict) -> int | None:
    """Where in the window's first keyframe the three compared steps start
    (its step number, from 0), drawn from the seed among the places whose
    steps are past the keyframe's first ``FREEZE_AFTER`` steps (where the
    Gaussians it has just seeded, still isotropic, take rotation gradients
    that are nought to rounding) and past the freeze after a
    densification, have no densification or opacity reset between them
    and lie outside the profiled stretch; None where no place
    qualifies."""
    m = mapper
    n = m.mapping_itr_num
    it0, after0 = m.iteration_count, m.iters_after_densify
    prof = traffic.get("profile") or {"start": 0, "steps": 0}
    p0, p1 = prof["start"], prof["start"] + prof["steps"]

    def event_after(t):   # a densification or reset follows step t
        c = t + 1
        return (c % m.gaussian_update_every == m.gaussian_update_offset
                or c % m.gaussian_reset == 0)
    frozen, after = [], after0
    for j in range(n):
        frozen.append(after < FREEZE_AFTER)
        after = 0 if event_after(it0 + j) else after + 1
    places = [
        j for j in range(FREEZE_AFTER, n - CAPTURED_STEPS + 1)
        if not any(frozen[j:j + CAPTURED_STEPS])
        and not any(event_after(it0 + j + k)
                    for k in range(CAPTURED_STEPS - 1))
        and (j + CAPTURED_STEPS <= p0 or j >= p1)]
    if not places:
        return None
    rng = np.random.RandomState(seeded.sub_seed(seed, 31) % (2 ** 32))
    return int(places[rng.randint(len(places))])


class Capture:
    """What the check compares, taken in the window's first keyframe
    `kf`: the rows its seeding added, with the exposure and the draws it
    was seeded with, at the keyframe's first step; the state before step
    `at`, the arguments and losses of steps `at` .. `at` + 2, the moments
    after the first of them and the parameters after the last."""

    def __init__(self, cell, hook, kf, at):
        mapper = cell.mapper
        self.kf, self.at = kf, at
        self.args, self.losses = [], []
        self.s0 = self.s1 = self.s3 = None
        self.seeded = self.seed_exposure = self.seed_draws = None

        def before(i, args):
            if i == 0:
                g = mapper.gaussians
                rows = (g.aux.kf_id == kf) & g.aux.alive
                self.seeded = {n: t[rows].clone() for n, t in
                               zip(gm.PARAM_NAMES, g.params.tensors())
                               if n in GAUSS_LEAVES}
                self.seed_exposure = mapper.vstore.exposure[kf].clone()
                self.seed_draws = cell.seed_draws
            if at is not None and at <= i < at + CAPTURED_STEPS:
                if i == at:
                    self.s0 = snapshot(mapper)
                self.args.append(dict(args, d_samples=args["d_samples"]
                                      .clone()))

        def after(i, out):
            if at is not None and at <= i < at + CAPTURED_STEPS:
                self.losses.append(float(out[0]))
                if i == at:
                    self.s1 = snapshot(mapper)
                if i == at + CAPTURED_STEPS - 1:
                    self.s3 = snapshot(mapper)
        hook.listen(before, after)

    def complete(self) -> bool:
        """Whether the steps came as drawn: all three, one after the
        other."""
        its = [a["it_count"] for a in self.args]
        return (self.s3 is not None and self.seeded is not None
                and its == list(range(its[0], its[0] + CAPTURED_STEPS)))


class K1Stash:
    """While on, keeps each K1 launch's counts, table and entering
    transmittance (the table's tiles per row beside them)."""

    def __init__(self):
        self.launches = []
        self._orig = None

    def on(self):
        orig = self._orig = composite_cuda.composite_fwd

        def stashed(counts, tile_ids, attrs, bg, tw, ck):
            out = orig(counts, tile_ids, attrs, bg, tw, ck)
            self.launches.append((counts, attrs, out[4], tw, ck))
            return out
        stashed.launches = orig.launches
        composite_cuda.composite_fwd = stashed

    def off(self):
        self._orig.launches = composite_cuda.composite_fwd.launches
        composite_cuda.composite_fwd = self._orig


class MappingCell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg = copy.deepcopy(cfg)
        self.traffic = traffic
        self.seed = int(seed)
        self.dev = torch.device(device)
        (H, W), intr = scene.camera(self.cfg)
        self.hw = (H, W)
        self.state = SlamState.create(
            self.cfg, H, W, np.asarray(intr, np.float32),
            buffer=self.cfg["tracking"]["buffer"], device=self.dev)
        self.gen = torch.Generator(device=self.dev).manual_seed(
            seeded.sub_seed(seed, 17))
        self.seed_draws = None
        mc = self.cfg["mapping"]
        self.mapper = Mapper(
            self.state, self.cfg,
            uncer_mlp=seeded.uncertainty_mlp(seed, mc["uncertainty_params"][
                "feature_dim"], self.dev),
            rng_seed=self.seed % (2 ** 32), device=self.dev,
            draw_fn=self._draw)
        self.next_kf = 0
        self.capture = None

    def _draw(self, kind, shape):
        if kind == "seed":
            self.seed_draws = torch.rand(shape, generator=self.gen,
                                         device=self.dev)
            return self.seed_draws
        return torch.randn(shape, generator=self.gen, device=self.dev)

    def frame(self, k):
        return scene.make_frame(self.cfg, self.traffic, self.seed, k,
                                self.dev)

    def add_keyframe(self):
        """Write the next keyframe into the store; returns its index."""
        k = self.next_kf
        f = self.frame(k)
        kstore.append(self.state.store, k, float(k), pose=f.w2c,
                      mono_depth_up=f.depth)
        self.state.append_host(k, f.image.cpu().numpy(),
                               f.dino.cpu().numpy(), float(k))
        self.next_kf += 1
        return k

    def setup(self):
        n0 = self.traffic["init_keyframes"]
        for _ in range(n0):
            self.add_keyframe()
        self.mapper.initialize_mapper(n0 - 1)
        k = self.add_keyframe()
        self.mapper.on_keyframe(k, k)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float, profile: dict | None):
        """Keyframes until `seconds` have passed; the check's steps are
        captured in the first (``self.capture``). With `profile`, the
        window's steps profile["start"] to profile["start"] + profile[
        "steps"] are traced."""
        m = self.mapper
        hook = StepHook(m)
        self.capture = Capture(self, hook, self.next_kf,
                               draw_step(self.seed, m, self.traffic))
        stretch, stash, prof_args = None, None, []
        if profile:
            stretch, stash = trace.Stretch(self.dev), K1Stash()
            a, n = profile["start"], profile["steps"]

            def before(i, args):
                if i == a:
                    stash.on()
                    stretch.start()
                if a <= i < a + n:
                    prof_args.append(args)

            def after(i, out):
                if i == a + n - 1:
                    stretch.stop()
                    stash.off()
                    # no densification inside the stretch: one count
                    self._stretch_alive = gm.num_alive(m.gaussians)
            hook.listen(before, after)
        TIMER.reset()
        it0 = m.iteration_count
        attempted = failed = 0
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ends = []
        while True:
            k = self.add_keyframe()
            n_loss = len(m.step_losses)
            m.on_keyframe(k, k)
            ends.append(time.perf_counter())
            attempted += 1
            failed += not bool(np.all(np.isfinite(m.step_losses[n_loss:])))
            if time.perf_counter() - t0 >= seconds:
                break
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hook.close()
        if not all(bool(torch.isfinite(p).all())
                   for p in m.gaussians.params.tensors()):
            failed = max(failed, 1)
        iters = m.iteration_count - it0
        out = dict(attempted=attempted, failed=failed, window_s=wall,
                   window_start=t0,
                   iterations=iters, keyframes=attempted,
                   e2e={"map_ms_per_iter": wall * 1e3 / max(iters, 1)},
                   timer=TIMER.summary(),
                   unit_s=list(np.diff([t0] + ends)))
        if profile:
            if stretch.wall_s is None:
                raise RuntimeError("the window ended before its profiled "
                                   "stretch")
            out["stretch"] = stretch.summary()
            out["stretch"]["steps"] = len(prof_args)
            out["stretch_work"] = self._stretch_work(stash, prof_args)
        return out

    def _stretch_work(self, stash, prof_args):
        """Per profiled step: the compositing kernels' work from K1's own
        tables, and the step's operations."""
        mc = self.cfg["mapping"]
        fh, fw = self.hw[0] // scene.PATCH, self.hw[1] // scene.PATCH
        stride = mc["uncertainty_params"]["reg_stride"]
        n_reg = max(1, 5 * fh * fw // (stride ** 4))
        rows = []
        for (counts, table, tentry, tw, ck), args in zip(stash.launches,
                                                          prof_args):
            slots, slot_px, alive = rcount.table_work(counts, table, tentry,
                                                      tw, ck)
            T, K, _ = table.shape
            k1 = rcount.k1_ops(slot_px, alive)
            k2 = rcount.k2_ops(slot_px, alive)
            rows.append(dict(
                slots=slots, slot_pixels=slot_px, alive=alive, k1_ops=k1,
                k2_ops=k2, k1_bytes=rcount.k1_bytes(slots, T, K // ck),
                k2_bytes=rcount.k2_bytes(slots, T, K, K // ck),
                step_ops=mapping_step.step_ops(
                    self._stretch_alive, k1, k2, self.hw, (fh, fw), n_reg,
                    args["freeze"])))
        stash.launches.clear()
        return rows

    def release(self):
        """Free the program's state (the capture stays)."""
        self.mapper = self.state = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# the comparison with the reference
# --------------------------------------------------------------------------

def _views(cell_cfg, traffic, seed, n_views, n_feat, device):
    """The reference's own copy of keyframes 0 .. n_views - 1, made again
    from the seed: colour and features held in bfloat16 as the
    configuration states, depth through the store's inverse and back,
    features of keyframes not yet taken in left at zero."""
    (H, W), intr = scene.camera(cell_cfg)
    frames = [scene.make_frame(cell_cfg, traffic, seed, k, device)
              for k in range(n_views)]
    feats = torch.zeros((n_feat, H // scene.PATCH, W // scene.PATCH,
                         scene.FEATURE_DIM), device=device)
    feats[:n_views] = torch.stack([f.dino for f in frames]).to(
        torch.bfloat16).float()

    def inv(x):
        return torch.where(x > 0, 1.0 / torch.where(x > 0, x,
                                                    torch.ones_like(x)),
                           torch.zeros_like(x))
    depth = torch.stack([inv(inv(f.depth)) for f in frames])
    return dict(colour=torch.stack([f.image for f in frames]).to(
        torch.bfloat16).float(), depth=depth,
        depth_med=torch.stack([ref.median(d) for d in depth]),
        features=feats, w2c=torch.stack([f.w2c for f in frames]),
        intr=torch.tensor(intr, dtype=torch.float32, device=device))


def _leaves(s: dict, which: str) -> dict:
    out = {n: s[which][n] for n in GAUSS_LEAVES}
    out["exposure"] = s["exposure" if which == "params" else
                        {"mu": "exp_mu", "nu": "exp_nu"}[which]]
    for n in s["mlp"]:
        out[f"mlp.{n}"] = s[{"params": "mlp", "mu": "mlp_mu",
                             "nu": "mlp_nu"}[which]][n]
    return out


def _first_grads(s0, s1):
    """The gradient each leaf's optimiser took at the first step, worked
    out from its first moment before and after it (b1 = 0.9)."""
    m0, m1 = _leaves(s0, "mu"), _leaves(s1, "mu")
    return {n: (m1[n] - 0.9 * m0[n]) / 0.1 for n in m0}


def _changes(s0, s3):
    p0, p3 = _leaves(s0, "params"), _leaves(s3, "params")
    return {n: p3[n] - p0[n] for n in p0}


def reference_run(cap, cfg, traffic, seed, device, tf32=False,
                  fault=None):
    """The reference's three steps from the captured state and its seeding
    of the captured keyframe: {losses, grads, changes, seeded}. `tf32`
    computes it with TF32 matmuls and convolutions (the control); `fault`
    "half" leaves out the lower half of every image (a fault for the
    limits' readings)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        n_feat = max(a["d_base"] for a in cap.args) + 5
        full = views = _views(cfg, traffic, seed, cap.kf + 1,
                              max(n_feat, cap.kf + 1), device)
        if fault == "half":
            h = views["colour"].shape[1] // 2
            views = dict(views, colour=views["colour"][:, :h],
                         depth=views["depth"][:, :h])
        st = {k: (copy.deepcopy(v) if isinstance(v, (dict, int)) else
                  v.clone()) for k, v in cap.s0.items()}
        losses, s1 = [], None
        for i, args in enumerate(cap.args):
            losses.append(ref.step(st, views, args, cfg))
            if i == 0:
                s1 = {k: (copy.deepcopy(v) if isinstance(v, (dict, int))
                          else v.clone()) for k, v in st.items()}
        mc = cfg["mapping"]
        e = cap.seed_exposure
        colour = torch.clamp(torch.exp(e[0]) * full["colour"][cap.kf]
                             + e[1], 0.0, 1.0)
        seeded, sel = ref.seed_gaussians(
            colour, full["depth"][cap.kf], full["w2c"][cap.kf],
            full["intr"], mc["pcd_downsample"], mc["point_size"],
            cap.seed_draws)
        seeded = {n: v[sel] for n, v in seeded.items()}
        return dict(losses=losses, grads=_first_grads(cap.s0, s1),
                    changes=_changes(cap.s0, st), seeded=seeded)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]


def program_run(cap) -> dict:
    return dict(losses=list(cap.losses), grads=_first_grads(cap.s0, cap.s1),
                changes=_changes(cap.s0, cap.s3), seeded=cap.seeded)


def _norm(x) -> float:
    return float(torch.linalg.norm(x.double().reshape(-1)))


def _leaf_gaps(side, ref_side, keep) -> list:
    """Each kept leaf's gap between the two sides' norms, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    r = {n: _norm(ref_side[n]) for n in keep}
    med = float(np.median(list(r.values())))
    return [abs(_norm(side[n]) - r[n]) / max(r[n], med, 1e-30) for n in keep]


def numbers(run: dict, reference: dict) -> dict:
    """The numbers compared, of one side (the program, or the control)
    against the reference: each step's loss (over the larger of its own
    size and the three steps' mean size: a loss can pass near zero, its
    uncertainty term being a log), the worst leaf's first gradient, the
    median leaf's change over the three steps (the worst leaf's is
    reported beside it: a leaf whose gradient is nearly nought, as the
    rotations of fresh isotropic Gaussians, moves by the sign of its
    round-off under Adam's 1e-15 epsilon), and the seeded Gaussians."""
    g_ref = {n: _norm(v) for n, v in reference["grads"].items()}
    med = float(np.median(list(g_ref.values())))
    keep = [n for n, v in g_ref.items() if v >= EXCLUDE_BELOW * med]
    scale = float(np.mean(np.abs(reference["losses"])))
    loss = max(abs(a - b) / max(abs(b), scale, 1e-30) for a, b in
               zip(run["losses"], reference["losses"]))
    seed_gap = 0.0
    for n, r in reference["seeded"].items():
        p = run["seeded"][n]
        if p.shape != r.shape:
            seed_gap = math.inf
            break
        seed_gap = max(seed_gap, _norm(p - r) / max(_norm(r), 1e-30))
    changes = _leaf_gaps(run["changes"], reference["changes"], keep)
    return dict(loss_gap=loss,
                grad_gap=max(_leaf_gaps(run["grads"], reference["grads"],
                                        keep)),
                change_gap=float(np.median(changes)),
                seed_gap=seed_gap,
                change_gap_worst_leaf=max(changes),
                leaves_compared=len(keep),
                leaves_left_out=sorted(set(g_ref) - set(keep)))


def run(cfg, traffic, seed, seconds, trace_on, device, t_start=None):
    """Set-up, window and check of one run. Returns the driver's result:
    e2e values, attempted / failed, the numbers compared, what the
    per-layer metrics read, and times (set-up from `t_start`, a
    time.perf_counter reading)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = MappingCell(cfg, traffic, seed, device)
    cell.setup()
    out = cell.window(seconds, traffic.get("profile") if trace_on else None)
    out["setup_s"] = out["window_start"] - t_start
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(cell.dev)
                                if cell.dev.type == "cuda" else None)
    cap = cell.capture
    cell.release()
    t0 = time.perf_counter()
    if cap.complete():
        got = numbers(program_run(cap), reference_run(cap, cfg, traffic,
                                                      seed, cell.dev))
    else:   # the steps drawn never came, or not one after the other
        got = dict.fromkeys(COMPARED, math.inf)
    out["reference_s"] = time.perf_counter() - t0
    out["numbers"] = got
    out["peaks_hw"] = cell.hw
    return out
