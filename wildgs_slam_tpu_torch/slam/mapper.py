"""Mapper: online Gaussian-map optimization with uncertainty training.

Torch port of ``wildgs_slam_tpu/slam/mapper.py`` (the keyframe path):

- host orchestration as there: keyframe intake, the covisibility window
  (Szymkiewicz-Simpson overlap + inverse-distance eviction), the
  densify/prune and opacity-reset schedule, keyframe re-sync after BA with
  rigid Gaussian deformation;
- without metric depth (``tracking.backend.metric_depth_reg`` off, the
  Splat-SLAM mode and the run without mono priors): each keyframe's
  frontend depth is filled with its aligned mono prior
  (``depth_fill.splat_slam_fill``), a keyframe with fewer than 100 valid
  depths is skipped, and a keyframe that BA moved is filled again and its
  Gaussians deformed projectively (rescaled along their rays by the
  depth's change);
- the optimization segment: where the JAX package scans a jitted step over
  pre-drawn view indices, here a Python loop runs the same step (render,
  the uncertainty-aware mapping loss + DINO regularization + isotropic
  loss, then the three Adam updates) and reads the tile-binning overflow
  and the losses back once per segment.

On a CUDA map the step renders through ``render_fused`` (the CUDA composite
kernels); on a CPU map through the plain ``render``. The view schedule is
drawn from ``np.random.RandomState(rng_seed)`` exactly as in the JAX
package, so the two draw the same views.

``refine_pose_non_key_frame`` refines a non-keyframe's pose against the
map as the JAX ``_refine_pose_core`` does (Adam on the twist and the
exposure, the pose re-anchored each step, stop once |delta| < 1e-4) in
a Python loop.

With ``gui`` set, each keyframe ends with a snapshot pushed to the file
GUI (``gui/file_gui.py``): a forward render of the keyframe, its
uncertainty, the keyframe trajectory and a host copy of the map.

Counters: ``fused_renders`` counts the renders through ``render_fused``
(each one P1 -> K3 -> K1, and K2 -> K4 -> P2 in its backward; ``TIMER``'s
``map.proj.kernel`` counts those that took P1/P2), ``gui_renders`` those of
them without a backward (the GUI's), ``refine_calls`` the refined frames
and ``refine_steps`` their steps, each of which reads |delta| back to the
host once; ``fills`` the depth fills, ``invalid_keyframes`` the keyframes
skipped for too few valid depths, ``projective_deforms`` the projective
deformations. ``TIMER`` spans: the intake phases, ``map.opt_segment`` and
each step's ``map.step`` with its render, loss, backward and optim parts,
all for the keyframe being taken in; the counter ``map.live_slots``.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..gui.file_gui import FileGui, GaussianPacket
from ..models.uncertainty import UncertaintyMLP, init_uncertainty_mlp
from ..ops import lie
from ..ops.rasterizer import render, render_fused
from ..ops.sh import sh_to_rgb
from ..ops.ssim import median
from ..utils.precision import float32_convs
from ..utils.printer import PRINTER, FontColor
from ..utils.profiling import TIMER
from . import depth_fill
from . import gaussian_map as gm
from . import keyframe_store as kstore
from . import losses, pcd, viewpoints


def _np_quat_to_rot(q):
    """(..., 4) xyzw unit quaternions -> (..., 3, 3) rotation matrices."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3), np.float64)
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def _np_rel_translation_norms(poses):
    """(M, 7) SE3 -> (M, M) norms of trans(P_i ∘ P_j^-1)."""
    t = poses[:, :3].astype(np.float64)
    q = poses[:, 3:7].astype(np.float64)
    qc = q * np.array([-1.0, -1.0, -1.0, 1.0])
    x1, y1, z1, w1 = q[:, None, 0], q[:, None, 1], q[:, None, 2], q[:, None, 3]
    x2, y2, z2, w2 = (qc[None, :, 0], qc[None, :, 1], qc[None, :, 2],
                      qc[None, :, 3])
    q_rel = np.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], axis=-1)
    R = _np_quat_to_rot(q_rel)
    t_rel = t[:, None, :] - np.einsum("ijab,jb->ija", R, t)
    return np.linalg.norm(t_rel, axis=-1)


def _moved_rotation(p: gm.GaussianParams, mask, T):
    """The (w, x, y, z) rotations premultiplied by T's where mask is set."""
    q = gm.get_rotation_xyzw(p)
    newq = lie.quat_mul(T[3:7].expand_as(q), q)
    return torch.where(mask, torch.cat([newq[:, 3:4], newq[:, :3]], -1),
                       p.rotation)


@torch.no_grad()
def _deform_rigid(gmap: gm.GaussianMap, kf_id: int, w2c_new, w2c_old):
    """Rigidly move the Gaussians anchored at keyframe kf_id to its new
    pose, in place; zeroes the xyz and rotation Adam moments."""
    T = lie.se3_inv(lie.se3_mul(lie.se3_inv(w2c_old), w2c_new))
    p = gmap.params
    mask = ((gmap.aux.kf_id == kf_id) & gmap.aux.alive)[:, None]
    xyz = torch.where(mask, lie.se3_act(T[None], p.xyz), p.xyz)
    p.rotation.copy_(_moved_rotation(p, mask, T))
    p.xyz.copy_(xyz)
    for moments in (gmap.mu, gmap.nu):
        moments.xyz.zero_()
        moments.rotation.zero_()


@torch.no_grad()
def _deform_projective(gmap: gm.GaussianMap, kf_id: int, w2c_new, w2c_old,
                       depth_new, depth_old, intrinsics):
    """Move the Gaussians anchored at keyframe kf_id to its new pose and
    depth, in place: each centre is scaled along its ray by 1 + (new depth
    - old depth) / z at its pixel (round half to even) and its log-scales
    shifted by the log of that factor; rigid where either depth is 0 or the
    factor is not positive. Zeroes the xyz, rotation and scaling Adam
    moments."""
    p = gmap.params
    mask = ((gmap.aux.kf_id == kf_id) & gmap.aux.alive)[:, None]
    H, W = depth_new.shape
    fx, fy, cx, cy = intrinsics.unbind()
    cam_old = lie.se3_act(w2c_old[None], p.xyz)
    z = torch.clamp(cam_old[:, 2], min=1e-6)
    px = torch.clamp(torch.round(fx * cam_old[:, 0] / z + cx).long(), 0, W - 1)
    py = torch.clamp(torch.round(fy * cam_old[:, 1] / z + cy).long(), 0, H - 1)
    d_new, d_old = depth_new[py, px], depth_old[py, px]
    rescale = 1.0 + (d_new - d_old) / z
    rigid = (d_new == 0) | (d_old == 0) | (rescale <= 0)
    rescale = torch.where(rigid, 1.0, rescale)

    world_scaled = lie.se3_act(lie.se3_inv(w2c_old)[None],
                               cam_old * rescale[:, None])
    T = lie.se3_inv(lie.se3_mul(lie.se3_inv(w2c_old), w2c_new))
    xyz = torch.where(mask, lie.se3_act(T[None], world_scaled), p.xyz)
    scaling = torch.where(mask, p.scaling + torch.log(rescale)[:, None],
                          p.scaling)
    p.rotation.copy_(_moved_rotation(p, mask, T))
    p.xyz.copy_(xyz)
    p.scaling.copy_(scaling)
    for moments in (gmap.mu, gmap.nu):
        moments.xyz.zero_()
        moments.rotation.zero_()
        moments.scaling.zero_()


class _MLPAdam:
    """torch.optim.Adam(lr, weight_decay) semantics on the MLP, written out
    as the JAX package's ``_uncer_adam`` (the decay is added to the grad)."""

    def __init__(self, mlp: UncertaintyMLP):
        self.params = list(mlp.parameters())
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads, lr, wd=1e-5, b1=0.9, b2=0.999, eps=1e-8):
        self.count += 1
        c1, c2 = gm.bias_corrections(b1, b2, self.count)
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            g = g + wd * p
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + eps))


class Mapper:
    """The mapper's keyframe path. ``draw_fn(kind, shape)``, if given,
    supplies the random draws in place of the mapper's torch.Generator:
    kind "seed" wants (H*W,) uniforms for a keyframe's seeding, kind
    "split" (2, C, 3) standard normals for a densification."""

    def __init__(self, state, cfg, uncer_mlp: Optional[UncertaintyMLP] = None,
                 rng_seed: int = 0, device="cuda",
                 draw_fn: Optional[Callable] = None, mesh=None):
        self.state = state
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        mc = cfg["mapping"]
        self.mc = mc
        tr = mc["Training"]
        self.cameras_extent = 6.0
        self.init_itr_num = tr["init_itr_num"]
        self.init_gaussian_update = tr["init_gaussian_update"]
        self.init_gaussian_reset = tr["init_gaussian_reset"]
        self.init_gaussian_th = tr["init_gaussian_th"]
        self.init_gaussian_extent = self.cameras_extent * tr[
            "init_gaussian_extent"]
        self.mapping_itr_num = tr["mapping_itr_num"]
        self.gaussian_update_every = tr["gaussian_update_every"]
        self.gaussian_update_offset = tr["gaussian_update_offset"]
        self.gaussian_th = tr["gaussian_th"]
        self.gaussian_extent = self.cameras_extent * tr["gaussian_extent"]
        self.gaussian_reset = tr["gaussian_reset"]
        self.size_threshold = tr["size_threshold"]
        self.window_size = tr["window_size"]
        self.kf_cutoff = tr.get("kf_cutoff", 0.4)
        self.uncertainty_aware = mc["uncertainty_params"]["activate"]
        self.deform_gaussians = mc["deform_gaussians"]
        self.capacity = mc.get("gaussian_capacity", 65536)
        self.render_list_capacity = mc.get("render_list_capacity", 2048)
        self.bin_method = mc.get("bin_method", "sort_norev")
        if self.bin_method not in ("sort", "sort_norev"):
            raise ValueError(f"bin_method {self.bin_method!r} is not ported; "
                             "the port bins by sort")
        self.bin_kw = mc.get("bin_kw", 4)
        self.rng = np.random.RandomState(rng_seed)
        self.gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        self.draw_fn = draw_fn

        ht, wd = state.images.shape[1:3]
        self.image_size = (ht, wd)
        self.intrinsics_full = state.store.intrinsics.to(self.device) * 8.0

        sh_deg = 3 if tr.get("spherical_harmonics", False) else 0
        # mesh mode, as the JAX mapper: the capacity padded to a multiple of
        # the shards, the Gaussian/tile-sharded renderer built (per-shard
        # lists of max(64, list capacity / D) slots, rounded up so that the
        # merged list is a multiple of the 64-slot chunk; the JAX rounding
        # misses that for D = 5 or 7 and raises) and the map made ready for
        # the mesh. As in the JAX package, _opt_segment does not render
        # through mesh_render_fn: the optimization renders the whole map
        # with render_fused.
        self.mesh_render_fn = None
        if mesh is not None:
            from ..parallel import mesh as pmesh

            D = mesh.size
            self.capacity = pmesh.pad_gaussian_capacity(self.capacity, D)
            step = 64 // math.gcd(64, D)
            cap_loc = -(-max(64, -(-self.render_list_capacity // D))
                        // step) * step
            self.mesh_render_fn = pmesh.make_gsharded_render_fn(
                mesh, self.image_size, capacity_local=cap_loc, chunk=64,
                sh_degree=sh_deg, bin_kw=self.bin_kw)
        self.gaussians = gm.create(self.capacity, max_sh_degree=sh_deg,
                                   device=self.device)
        if mesh is not None:
            self.gaussians = pmesh.shard_gaussian_map(self.gaussians, mesh)
        fd = mc["uncertainty_params"]["feature_dim"]
        self.vstore = viewpoints.create(
            state.store.poses.shape[0], ht, wd, (ht // 14, wd // 14), fd,
            device=self.device)
        if uncer_mlp is None:
            uncer_mlp = init_uncertainty_mlp(
                torch.Generator().manual_seed(1), in_dim=fd,
                device=self.device)
        self.uncer_mlp = uncer_mlp.to(self.device)
        self.uncer_adam = _MLPAdam(self.uncer_mlp)

        self.loss_cfg = dict(
            alpha=tr["alpha"],
            rgb_boundary_threshold=tr["rgb_boundary_threshold"],
            ssim_loss=tr["ssim_loss"],
            lambda_dssim=mc["opt_params"]["lambda_dssim"],
            uncertainty_params=mc["uncertainty_params"],
            opt_params=mc["opt_params"])

        self.iteration_count = 0
        self.iters_after_densify = 0
        self.overflow_events = 0
        self.max_overflow = 0
        self.step_losses: List[float] = []
        self.current_window: List[int] = []
        self.occ_aware_visibility: Dict[int, torch.Tensor] = {}
        self.is_kf: Dict[int, bool] = {}
        self.depth_dict: Dict[int, torch.Tensor] = {}
        self.video_idxs: List[int] = []
        self.frame_idxs: List[int] = []
        self.cam_w2c_old: Dict[int, np.ndarray] = {}
        self.fused_renders = self.gui_renders = 0
        self.refine_calls = self.refine_steps = 0
        self.fills = self.invalid_keyframes = self.projective_deforms = 0

        self.gui = None
        if cfg.get("gui", False):
            out = cfg.get("data", {}).get("output", "./output")
            self.gui = FileGui(os.path.join(out, str(cfg.get("scene",
                                                             "scene"))),
                               http_port=cfg.get("_gui_http_port"))

    # ------------------------------------------------------------------

    def _draw(self, kind: str, shape) -> torch.Tensor:
        if self.draw_fn is not None:
            return torch.as_tensor(self.draw_fn(kind, shape),
                                   dtype=torch.float32, device=self.device)
        if kind == "seed":
            return torch.rand(shape, generator=self.gen, device=self.device)
        return torch.randn(shape, generator=self.gen, device=self.device)

    def _make_viewpoint(self, video_idx: int) -> bool:
        """Write keyframe video_idx into the view store. Returns True if
        the keyframe is invalid (without metric depth: too few valid
        frontend depths), and then writes nothing."""
        store = self.state.store
        depth, mask, c2w = kstore.get_depth_and_pose(
            store, video_idx, self.state.metric_depth_reg)
        w2c = lie.se3_inv(c2w)
        if not self.state.metric_depth_reg:
            depth, invalid = self._filled_depth(video_idx, depth, mask)
            if invalid:
                self.invalid_keyframes += 1
                return True
        color = torch.as_tensor(self.state.images[video_idx],
                                dtype=torch.float32, device=self.device)
        feats = (torch.as_tensor(self.state.dino_feats[video_idx],
                                 dtype=torch.float32, device=self.device)
                 if self.state.dino_feats is not None else None)
        viewpoints.set_view(self.vstore, video_idx, color, depth, w2c, feats,
                            edge_threshold=self.mc["Training"][
                                "edge_threshold"])
        self.cam_w2c_old[video_idx] = w2c.cpu().numpy()
        self.depth_dict[video_idx] = depth
        return False

    def _filled_depth(self, video_idx: int, est_depth, mask):
        """The Splat-SLAM fill of one keyframe's frontend depth with its
        mono prior (1 / mono_disps_up where that is > 0); a valid fill's
        scale and shift go into the store. Returns (depth (H, W),
        invalid)."""
        store = self.state.store
        with TIMER.phase("map.depth_fill", sync=True):
            filled, invalid, scale, shift = depth_fill.splat_slam_fill(
                est_depth, mask, kstore._inv_pos(
                    store.mono_disps_up[video_idx]))
        self.fills += 1
        if not invalid:
            store.depth_scale[video_idx] = scale
            store.depth_shift[video_idx] = shift
        return filled, invalid

    # ------------------------------------------------------------------
    # covisibility window
    # ------------------------------------------------------------------

    def _add_to_window(self, cur_idx, cur_visibility, window):
        N_dont_touch = 2
        window = [cur_idx] + window
        cur_vis = cur_visibility.cpu().numpy()
        to_remove = []
        for i in range(N_dont_touch, len(window)):
            kf_idx = window[i]
            occ = self.occ_aware_visibility[kf_idx].cpu().numpy()
            inter = np.logical_and(cur_vis, occ).sum()
            denom = min(cur_vis.sum(), occ.sum())
            if inter / max(denom, 1) <= self.kf_cutoff:
                to_remove.append(kf_idx)
        if to_remove:
            window.remove(to_remove[-1])

        if len(window) > self.window_size:
            w2c = self.vstore.w2c.cpu().numpy()
            cand = np.array(window[N_dont_touch:])
            sel = w2c[np.concatenate([cand, [window[0]]])]
            D = _np_rel_translation_norms(sel)
            L = len(cand)
            k = np.sqrt(D[:L, L])
            off = D[:L, :L] + np.eye(L)
            dsum = (1.0 / (off + 1e-6)).sum(1) - 1.0 / (1.0 + 1e-6)
            window.remove(window[N_dont_touch + int(np.argmax(k * dsum))])
        return window

    @torch.no_grad()
    def _render_ntouched(self, video_idx: int) -> torch.Tensor:
        p = self.gaussians.params
        out = render(p.xyz, gm.get_scaling(p), gm.get_rotation_xyzw(p),
                     gm.get_opacity(p), gm.get_sh(p),
                     self.vstore.w2c[video_idx], self.intrinsics_full,
                     self.image_size, alive=self.gaussians.aux.alive,
                     capacity=self.render_list_capacity, chunk=64,
                     bin_kw=self.bin_kw)
        return out.n_touched

    def _update_occ_aware_visibility(self, window):
        with TIMER.phase("map.occ_vis", sync=True):
            self.occ_aware_visibility = {
                kf_idx: self._render_ntouched(kf_idx) > 0
                for kf_idx in window}

    def _seed_gaussians(self, video_idx: int, init: bool = False):
        factor = (self.mc["pcd_downsample_init"] if init
                  else self.mc["pcd_downsample"])
        H, W = self.image_size
        draws = self._draw("seed", (H * W,))
        with torch.no_grad():
            exp = self.vstore.exposure[video_idx]
            color = self.vstore.colors[video_idx].to(torch.float32)
            color = torch.clamp(torch.exp(exp[0]) * color + exp[1], 0.0, 1.0)
            params, valid = pcd.seed_gaussians_from_depth(
                color, self.vstore.depths[video_idx],
                self.vstore.w2c[video_idx], self.intrinsics_full, factor,
                self.mc["point_size"], self.gaussians.params.f_rest.shape[1],
                isotropic=False,
                adaptive_pointsize=self.mc["adaptive_pointsize"], draws=draws)
            dropped = gm.extend(self.gaussians, params, valid,
                                kf_id=video_idx)
        if dropped > 0:
            PRINTER.print(f"WARNING: dropped {dropped} gaussians "
                          f"(capacity {self.capacity})", FontColor.MAPPER)

    def _densify(self, min_opacity, extent, max_screen_size):
        draws = self._draw("split", (2, self.capacity, 3))
        with TIMER.phase("map.densify", sync=True):
            gm.densify_and_prune(
                self.gaussians,
                self.loss_cfg["opt_params"]["densify_grad_threshold"],
                min_opacity, extent, max_screen_size,
                self.loss_cfg["opt_params"]["percent_dense"], draws=draws)

    # ------------------------------------------------------------------
    # optimization driver
    # ------------------------------------------------------------------

    def _run_opt(self, n_iters, view_pool, probs, freeze_after, init_phase):
        """Run n_iters with densify/reset events at the reference's
        schedule boundaries. Returns whether the map was split/reset."""
        it = 0
        gaussian_split = False
        while it < n_iters:
            seg = n_iters - it
            if init_phase:
                next_dens = self.init_gaussian_update - (
                    it % self.init_gaussian_update)
            else:
                phase = self.iteration_count % self.gaussian_update_every
                next_dens = ((self.gaussian_update_offset - phase)
                             % self.gaussian_update_every)
                if next_dens == 0:
                    next_dens = self.gaussian_update_every
            next_reset = self.gaussian_reset - (
                self.iteration_count % self.gaussian_reset)
            if init_phase:
                nr = self.init_gaussian_reset - self.iteration_count
                next_reset = nr if nr > 0 else next_reset
            seg = max(1, min(seg, next_dens, next_reset))

            self._opt_steps(seg, view_pool, probs, freeze_after, init_phase)
            it += seg

            if init_phase and it % self.init_gaussian_update == 0:
                self._densify(self.init_gaussian_th, self.init_gaussian_extent,
                              None)
                self.iters_after_densify = 0
                gaussian_split = True
            elif (not init_phase and self.iteration_count
                  % self.gaussian_update_every == self.gaussian_update_offset):
                self._densify(self.gaussian_th, self.gaussian_extent,
                              self.size_threshold)
                self.iters_after_densify = 0
                gaussian_split = True
            if init_phase and self.iteration_count == self.init_gaussian_reset:
                with TIMER.phase("map.reset_opacity", sync=True):
                    gm.reset_opacity(self.gaussians)
                self.iters_after_densify = 0
            elif (not init_phase
                  and self.iteration_count % self.gaussian_reset == 0):
                with TIMER.phase("map.reset_opacity", sync=True):
                    vis = self._render_ntouched(view_pool[-1]) > 0
                    gm.reset_opacity_nonvisible(self.gaussians, vis)
                self.iters_after_densify = 0
                gaussian_split = True
        return gaussian_split

    def _opt_steps(self, K, view_pool, probs, freeze_after,
                   initialization=False):
        """K iterations as segments of at most mapping.max_segment_iters
        (64), the JAX package's dispatch unit; the draws follow it."""
        max_k = int(self.mc.get("max_segment_iters", 64))
        while K > max_k:
            self._opt_segment(max_k, view_pool, probs, freeze_after,
                              initialization)
            K -= max_k
        self._opt_segment(K, view_pool, probs, freeze_after, initialization)

    @float32_convs()   # the loss's backward convolves too
    def _opt_segment(self, K, view_pool, probs, freeze_after,
                     initialization=False, render_fn=None):
        """K mapping iterations on views drawn from view_pool. render_fn,
        if given, replaces the render: (params, alive, w2c, intrinsics,
        mean2d_offset) -> RenderOutput (the JAX ``_opt_segment`` hook, e.g.
        ``parallel.mesh.make_gsharded_render_fn``)."""
        fh, fw = self.vstore.features.shape[1:3]
        stride = self.loss_cfg["uncertainty_params"]["reg_stride"]
        n_samples = max(1, 5 * fh * fw // (stride ** 4))
        # the JAX package draws for its compile-size bucket Kb >= K; draw
        # the same numbers so both packages see the same schedule
        Kb = next(b for b in (8, 16, 32, 64, 128, 256, 512) if K <= b)
        idxs = self.rng.choice(view_pool, size=K, p=probs)
        freeze = [self.iters_after_densify + i < freeze_after
                  for i in range(K)]
        B = self.vstore.features.shape[0]
        d_base = np.clip(idxs - 2, 0, max(B - 5, 0))
        d_samples = self.rng.randint(0, 5 * fh * fw, size=(Kb, n_samples))
        d_samples = torch.as_tensor(d_samples[:K], device=self.device)

        ovf = torch.zeros((), dtype=torch.int64, device=self.device)
        seg_losses = []
        with TIMER.phase("map.opt_segment"):   # ends in the .cpu() read
            for i in range(K):
                loss, overflow = self._opt_step(
                    int(idxs[i]), freeze[i], int(d_base[i]), d_samples[i],
                    self.iteration_count + i, initialization, render_fn)
                seg_losses.append(loss)
                ovf = torch.maximum(ovf, overflow)
            ls = torch.stack(seg_losses).cpu().tolist()
            ovf = int(ovf)
        self.step_losses.extend(ls)
        if ovf > 0:
            self.overflow_events += 1
            self.max_overflow = max(self.max_overflow, ovf)
            if self.overflow_events <= 5 or self.overflow_events % 100 == 0:
                PRINTER.print(
                    f"WARNING: tile-binning overflow ({ovf} entries dropped; "
                    f"event #{self.overflow_events}); raise "
                    f"mapping.render_list_capacity "
                    f"(={self.render_list_capacity}) or mapping.bin_kw "
                    f"(={self.bin_kw})", FontColor.MAPPER)
        self.iteration_count += K
        self.iters_after_densify += K
        return ls

    def _opt_step(self, idx, freeze, d_base, d_samples, it_count,
                  initialization, render_fn=None):
        """One mapping iteration on view idx: render, losses, three Adams.
        Returns (loss, overflow) as device tensors. Host spans (the step is
        launch-bound): ``map.step`` holding ``.render``, ``.loss``,
        ``.backward`` and ``.optim``; the counter ``map.live_slots`` sums
        the render's live tile-list entries on the device."""
        with TIMER.phase("map.step"):
            g = self.gaussians
            up = self.loss_cfg["uncertainty_params"]
            opt = self.loss_cfg["opt_params"]
            with TIMER.phase("map.step.render"):
                leaves = gm.GaussianParams(*[t.detach().requires_grad_(True)
                                             for t in g.params.tensors()])
                exposure = self.vstore.exposure[idx].clone().requires_grad_(
                    True)
                m2d = torch.zeros(self.capacity, 2, device=self.device,
                                  requires_grad=True)
                if render_fn is not None:
                    out = render_fn(leaves, g.aux.alive, self.vstore.w2c[idx],
                                    self.intrinsics_full, mean2d_offset=m2d)
                else:
                    out = self._render_fn()(
                        leaves.xyz, gm.get_scaling(leaves),
                        gm.get_rotation_xyzw(leaves), gm.get_opacity(leaves),
                        gm.get_sh(leaves), self.vstore.w2c[idx],
                        self.intrinsics_full, self.image_size,
                        alive=g.aux.alive,
                        capacity=self.render_list_capacity, chunk=64,
                        mean2d_offset=m2d, bin_kw=self.bin_kw)
                if out.tile_counts is not None:
                    TIMER.count("map.live_slots", out.tile_counts)

            with TIMER.phase("map.step.loss"):
                gt = self.vstore.colors[idx].to(torch.float32)
                ref_depth = self.vstore.depths[idx]
                mlp_params = list(self.uncer_mlp.parameters())
                if self.uncertainty_aware:
                    fh, fw, fd = self.vstore.features.shape[1:]
                    sigma = self.uncer_mlp(
                        self.vstore.features[idx].to(torch.float32))
                    lo = losses.mapping_loss_uncertainty(
                        out.color, out.depth, gt, ref_depth, sigma, out.alpha,
                        exposure[0], exposure[1],
                        train_frac=up["train_frac_fix"],
                        ssim_frac=up["train_frac_fix"], cfg=self.loss_cfg,
                        initialization=initialization,
                        ref_depth_median=self.vstore.depth_med[idx])
                    total = lo.total
                    if freeze:
                        u = lo.uncer_loss.mean()
                        total = (total - up["ssim_mult"] * u
                                 + up["ssim_mult"] * u.detach())
                    else:
                        nb = self.vstore.features[d_base:d_base + 5].to(
                            torch.float32)
                        samp = nb.reshape(5 * fh * fw, fd)[d_samples]
                        reg = losses.dino_regularization_loss(
                            self.uncer_mlp(samp), samp)
                        total = total + up["reg_mult"] * reg
                else:
                    total = losses.mapping_loss_rgbd(
                        out.color, out.depth, gt, ref_depth, exposure[0],
                        exposure[1], cfg_alpha=self.loss_cfg["alpha"],
                        rgb_boundary_threshold=self.loss_cfg[
                            "rgb_boundary_threshold"],
                        use_ssim=self.loss_cfg["ssim_loss"],
                        lambda_dssim=self.loss_cfg["lambda_dssim"],
                        initialization=initialization)
                total = total + 10.0 * losses.isotropic_loss(leaves.scaling,
                                                             g.aux.alive)

            with TIMER.phase("map.step.backward"):
                inputs = leaves.tensors() + [exposure, m2d] + mlp_params
                grads = torch.autograd.grad(total, inputs, allow_unused=True)
                grads = [torch.zeros_like(x) if gr is None else gr
                         for x, gr in zip(inputs, grads)]
            g_params = gm.GaussianParams(*grads[:6])
            g_exp, g_m2d, g_mlp = grads[6], grads[7], grads[8:]

            with TIMER.phase("map.step.optim"):
                gm.add_densification_stats(g, g_m2d, out.radii)
                xyz_lr = gm.expon_lr(it_count, opt["position_lr_init"] * 6.0,
                                     opt["position_lr_final"] * 6.0,
                                     opt["position_lr_delay_mult"],
                                     opt["position_lr_max_steps"])
                gm.adam_step(g, g_params, dict(
                    xyz=xyz_lr, f_dc=opt["feature_lr"],
                    f_rest=opt["feature_lr"] / 20.0,
                    opacity=opt["opacity_lr"],
                    scaling=opt["scaling_lr"] * 6.0,
                    rotation=opt["rotation_lr"]))
                if idx != 0:  # frame 0's exposure stays fixed
                    viewpoints.exposure_adam_step(self.vstore, idx, g_exp,
                                                  lr=0.01)
                if self.uncertainty_aware:
                    self.uncer_adam.step(g_mlp, lr=up["lr"],
                                         wd=up["weight_decay"])
        return total.detach(), out.overflow

    def _render_fn(self, backward=True):
        """The optimizing render: render_fused (its kernels) on the card,
        the plain render on the CPU; counts the fused calls, and apart
        those that run no backward."""
        if self.device.type != "cuda":
            return render
        self.fused_renders += 1
        self.gui_renders += not backward
        return render_fused

    # ------------------------------------------------------------------
    # non-keyframe pose refinement
    # ------------------------------------------------------------------

    def refine_pose_non_key_frame(self, color, w2c_init, features=None):
        """Refine a non-keyframe pose against the current map. color (H, W,
        3) in [0, 1], w2c_init (7,); features (h14, w14, D) DINO features
        or None. Returns the refined w2c (7,)."""
        tr = self.mc["Training"]
        color = torch.as_tensor(np.ascontiguousarray(color, np.float32),
                                device=self.device)
        use_unc = self.uncertainty_aware and features is not None
        grad_mask, uncer_pix = self._refine_prep(
            color, torch.as_tensor(np.asarray(features, np.float32),
                                   device=self.device) if use_unc else None)
        self.refine_calls += 1
        return self._refine_pose_core(
            torch.as_tensor(np.asarray(w2c_init, np.float32),
                            device=self.device), color, grad_mask, uncer_pix,
            tr["lr"]["cam_rot_delta"], tr["lr"]["cam_trans_delta"],
            tr["rgb_boundary_threshold"],
            iters=int(tr.get("pose_refine_iters", 100)))

    @torch.no_grad()
    def _refine_prep(self, color, features):
        """The edge mask of the image and, given features, the per-pixel
        annealed uncertainty (the MLP's sigma, floored, resampled)."""
        grad_mask = losses.compute_grad_mask(
            color, self.mc["Training"]["edge_threshold"])
        if features is None:
            return grad_mask, None
        sigma = torch.clamp(self.uncer_mlp(features), min=0.1) + 1e-3
        big = kstore.resize_bilinear(sigma[None], self.image_size)[0]
        data_rate = 1 + 1 * losses.compute_bias_factor(
            self.mc["uncertainty_params"]["train_frac_fix"], 0.8)
        return grad_mask, (big - 0.1) * data_rate + 0.1

    def _refine_pose_core(self, w2c, gt_color, grad_mask, uncer_pix, lr_rot,
                          lr_trans, rgb_boundary_threshold, iters=100):
        """Adam (0.9, 0.999, 1e-8) on the twist (rho, theta) and the
        exposure (a, b); each step renders at delta = 0, retracts the pose
        by the step's delta and keeps the moments; stops after `iters`
        steps or once |delta| < 1e-4."""
        g = self.gaussians
        p = g.params
        geo = (p.xyz, gm.get_scaling(p), gm.get_rotation_xyzw(p),
               gm.get_opacity(p), gm.get_sh(p))
        dev = self.device
        lr = torch.tensor([lr_trans] * 3 + [lr_rot] * 3 + [0.01] * 2,
                          device=dev)
        m = torch.zeros(8, device=dev)
        v = torch.zeros(8, device=dev)
        exposure = torch.zeros(2, device=dev)
        for cnt in range(1, iters + 1):
            delta = torch.zeros(6, device=dev, requires_grad=True)
            expo = exposure.clone().requires_grad_(True)
            out = self._render_fn()(
                *geo, w2c, self.intrinsics_full, self.image_size,
                alive=g.aux.alive, capacity=self.render_list_capacity,
                chunk=64, pose_delta=delta, bin_kw=self.bin_kw)
            loss = losses.tracking_loss_rgb(
                out.color, gt_color, out.alpha, grad_mask, expo[0], expo[1],
                rgb_boundary_threshold, uncertainty_pix=uncer_pix)
            gd, ge = torch.autograd.grad(loss, (delta, expo))
            with torch.no_grad():
                grad = torch.cat([gd, ge])
                m = 0.9 * m + 0.1 * grad
                v = 0.999 * v + 0.001 * grad * grad
                step = lr * (m / (1 - 0.9 ** cnt)) / (
                    torch.sqrt(v / (1 - 0.999 ** cnt)) + 1e-8)
                exposure = exposure - step[6:]
                w2c = lie.se3_retr(w2c, -step[:6])
                self.refine_steps += 1
                if float(torch.linalg.norm(step[:6])) < 1e-4:
                    break
        return w2c

    def map_opt_online(self, window, iters):
        """50% of the view probability mass on the current window."""
        pool = [v for v in self.video_idxs if self.is_kf.get(v, False)]
        if not pool:
            return False
        probs = np.full(len(pool), 0.0)
        in_win = np.array([v in window for v in pool])
        n_win = in_win.sum()
        if n_win and len(pool) > n_win and n_win <= len(pool) / 2.0:
            probs[in_win] = 0.5 / n_win
            probs[~in_win] = 0.5 / (len(pool) - n_win)
        else:
            probs[:] = 1.0 / len(pool)
        probs /= probs.sum()
        split = self._run_opt(iters, np.array(pool), probs, freeze_after=20,
                              init_phase=False)
        self._update_occ_aware_visibility(window)
        return split

    def initialize_map_opt(self):
        pool = list(self.current_window)
        if not pool:
            PRINTER.print("no valid keyframes at initialization — skipping "
                          "map optimization", FontColor.MAPPER)
            return
        probs = np.full(len(pool), 1.0 / len(pool))
        self._run_opt(self.init_itr_num, np.array(pool), probs,
                      freeze_after=0, init_phase=True)
        self._update_occ_aware_visibility(self.current_window)

    def final_refine(self, iters=26000):
        self._update_keyframes_from_frontend()
        pool = [v for v in self.video_idxs if self.is_kf.get(v, False)]
        probs = np.full(len(pool), 1.0 / len(pool))
        self._run_opt(iters, np.array(pool), probs, freeze_after=200,
                      init_phase=False)

    # ------------------------------------------------------------------
    # keyframe intake
    # ------------------------------------------------------------------

    def initialize_mapper(self, cur_video_idx: int):
        """Full reset, then re-anchor the map on keyframes 0..cur."""
        self.iteration_count = 0
        self.iters_after_densify = 0
        self.occ_aware_visibility = {}
        self.current_window = []
        self.is_kf = {}
        self.depth_dict = {}
        self.video_idxs = []
        self.frame_idxs = []
        gm.prune_points(self.gaussians, torch.ones_like(
            self.gaussians.aux.alive))

        for video_idx in range(cur_video_idx + 1):
            self.frame_idxs.append(int(self.state.timestamps[video_idx]))
            self.video_idxs.append(video_idx)
            if self._make_viewpoint(video_idx):
                self.is_kf[video_idx] = False
                continue
            self.is_kf[video_idx] = True
            self._seed_gaussians(video_idx, init=True)
            self.current_window.append(video_idx)
            viewpoints.reset_exposure_adam(self.vstore, video_idx)

        self.initialize_map_opt()
        self.current_window = self.current_window[-self.window_size:]

    def on_keyframe(self, video_idx: int, frame_idx: int):
        """Per-keyframe mapping step; its spans work for unit
        `video_idx`."""
        with TIMER.unit(video_idx):
            if self._make_viewpoint(video_idx):
                self.is_kf[video_idx] = False
                return
            with TIMER.phase("map.kf_resync_deform", sync=True):
                self._update_keyframes_from_frontend()
            self.frame_idxs.append(frame_idx)
            self.video_idxs.append(video_idx)

            with TIMER.phase("map.window_update", sync=True):
                curr_vis = self._render_ntouched(video_idx) > 0
                self.current_window = self._add_to_window(video_idx, curr_vis,
                                                          self.current_window)
            self.is_kf[video_idx] = True
            with TIMER.phase("map.seed_gaussians", sync=True):
                self._seed_gaussians(video_idx, init=False)

            for v in self.current_window:
                if v != 0:
                    viewpoints.reset_exposure_adam(self.vstore, v)

            split = self.map_opt_online(self.current_window,
                                        iters=self.mapping_itr_num)
            if split:
                self.map_opt_online(self.current_window, iters=1)
            if self.gui is not None:
                with TIMER.phase("map.gui_push", sync=True):
                    self._send_to_gui(video_idx)

    @torch.no_grad()
    def _send_to_gui(self, video_idx: int):
        """Push one snapshot to the file GUI: keyframe video_idx and its
        forward render, the MLP's uncertainty on its features, the
        keyframes' camera centres and the alive map."""
        p = self.gaussians.params
        out = self._render_fn(backward=False)(
            p.xyz, gm.get_scaling(p), gm.get_rotation_xyzw(p),
            gm.get_opacity(p), gm.get_sh(p), self.vstore.w2c[video_idx],
            self.intrinsics_full, self.image_size,
            alive=self.gaussians.aux.alive,
            capacity=self.render_list_capacity, chunk=64, bin_kw=self.bin_kw)
        unc = None
        if self.uncertainty_aware:
            unc = self.uncer_mlp(self.vstore.features[video_idx].to(
                torch.float32)).cpu().numpy()
        kfs = [v for v in self.video_idxs if self.is_kf.get(v, False)]
        traj = (lie.se3_inv(self.vstore.w2c[kfs])[:, :3].cpu().numpy()
                if kfs else None)
        alive = self.gaussians.aux.alive
        self.gui.push(GaussianPacket(
            frame_idx=video_idx,
            gt_color=self.vstore.colors[video_idx].to(
                torch.float32).cpu().numpy(),
            rendered_color=out.color.cpu().numpy(),
            rendered_depth=out.depth.cpu().numpy(),
            uncertainty=unc, traj_xyz=traj,
            window=list(self.current_window),
            n_gaussians=gm.num_alive(self.gaussians),
            map_xyz=p.xyz[alive].cpu().numpy(),
            map_rgb=sh_to_rgb(p.f_dc[:, 0])[alive].cpu().numpy(),
            map_scale=gm.get_scaling(p).mean(-1)[alive].cpu().numpy()))

    def _update_keyframes_from_frontend(self):
        """Re-sync moved keyframe poses and deform their Gaussians; without
        metric depth each moved keyframe is filled again, and its depth,
        median and deformation follow the new fill (a keyframe whose fill
        is now invalid keeps its depth and deforms rigidly)."""
        # a copy: rows are kept as the old poses, and BA moves the store
        poses_host = self.state.store.poses.cpu().numpy().copy()
        for video_idx in self.video_idxs:
            if not self.is_kf.get(video_idx, False):
                continue
            w2c_old = self.cam_w2c_old[video_idx]
            if np.allclose(poses_host[video_idx], w2c_old, atol=1e-6):
                continue
            w2c_new = torch.as_tensor(poses_host[video_idx],
                                      device=self.device)
            w2c_old = torch.as_tensor(w2c_old, device=self.device)
            depth_new = None
            if not self.state.metric_depth_reg:
                d, m, _ = kstore.get_depth_and_pose(self.state.store,
                                                    video_idx, False)
                filled, invalid = self._filled_depth(video_idx, d, m)
                depth_new = None if invalid else filled
            viewpoints.update_pose(self.vstore, video_idx, w2c_new)
            if self.deform_gaussians and depth_new is None:
                _deform_rigid(self.gaussians, video_idx, w2c_new, w2c_old)
            elif self.deform_gaussians:
                _deform_projective(self.gaussians, video_idx, w2c_new,
                                   w2c_old, depth_new,
                                   self.depth_dict[video_idx],
                                   self.intrinsics_full)
                self.projective_deforms += 1
            if depth_new is not None:
                # the depth follows the fill whether or not the Gaussians
                # deform, as in the reference
                self.vstore.depths[video_idx] = depth_new
                self.vstore.depth_med[video_idx] = median(depth_new)
                self.depth_dict[video_idx] = depth_new
            self.cam_w2c_old[video_idx] = poses_host[video_idx]
