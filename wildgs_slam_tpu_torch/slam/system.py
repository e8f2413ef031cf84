"""SLAM system: one host loop over tracking and mapping; torch port of
``wildgs_slam_tpu/slam/system.py``.

``SLAM.run`` feeds every frame through the motion filter and the frontend
(which runs loop closure through the backend), hands the warmup keyframes
to ``Mapper.initialize_mapper``, runs online global BA every ``ba_freq``
keyframes and ``Mapper.on_keyframe`` on every later keyframe, then
``terminate``: the final global BA, the keyframe store's video, the
depth-L1 evaluation (``eval_depth_l1``), the keyframe ATE, the final map
refinement, every frame's pose (the trajectory filler, then the
render-based refinement unless ``fast_mode``), the full ATE, the map's PLY
and HTML viewer and the uncertainty MLP's weights.

Between frames ``run`` polls the control channel (``gui/control.py``:
pause, stop, checkpoint on request), writes a checkpoint every
``checkpoint_every`` keyframes, and with ``resume_path`` continues a run
from its checkpoint (``utils/checkpoint.py``). With anomaly detection on
(``utils/debug.py``) it checks the store after the frontend and the map
after each keyframe's mapping.

``uncertainty_update`` refreshes the BA weights from the mapper's
uncertainty MLP over the DINO features of every live keyframe before each
BA (no device feature mirror, no frame-count buckets).

The stream is any object with ``__len__``, ``__getitem__(i) -> (index,
image (H, W, 3) float in [0, 1], depth or None, c2w (4, 4) or None)``,
``intrinsic`` (fx, fy, cx, cy at the output resolution) and ``poses``
(None when there is no ground truth); ``utils/datasets.py`` reads them
from disk.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import save_config
from ..gui.control import ControlChannel
from ..models import droid_net
from ..ops import lie
from ..utils import checkpoint
from ..utils import debug
from ..utils import eval_traj
from ..utils.datasets import RGB_NoPose
from ..utils.printer import PRINTER, FontColor
from ..utils.profiling import TIMER
from . import gaussian_map as gm
from . import keyframe_store as kstore
from .backend import Backend
from .frontend import Frontend
from .mapper import Mapper
from .motion_filter import MotionFilter
from .state import SlamState
from .trajectory_filler import PoseTrajectoryFiller


@torch.no_grad()
def uncertainty_update(state, mlp, train_frac_fix: float):
    """Run `mlp` over the DINO features of keyframes 0..counter-1 into
    ``state.store.uncertainties_inv``."""
    if not state.uncertainty_aware or state.counter == 0:
        return
    n = state.counter
    dev = state.store.poses.device
    feats = torch.as_tensor(state.dino_feats[:n], device=dev)
    kstore.update_uncertainties(state.store, mlp, feats,
                                torch.arange(n, device=dev), train_frac_fix)


class SLAM:
    """depth_fn / feat_fn: image -> metric depth (H, W) / DINO features
    (H/14, W/14, D). model: a DroidNet (default: ``tracking.pretrained``,
    else seeded random weights). uncer_mlp and draw_fn go to the Mapper.

    Mesh mode (``parallel.n_devices`` > 1, ``run.py --mesh N``): a mesh of
    the first N cards (``parallel.mesh.make_mesh``, which raises when fewer
    are visible) routes the frontend's network updates through the
    edge-sharded track step and gives the mapper its padded capacity and
    sharded renderer, as the JAX system does. ``mesh`` passes an explicit
    mesh instead (e.g. two shards on one card); it wins over the config."""

    def __init__(self, cfg, stream, depth_fn=None, feat_fn=None, model=None,
                 uncer_mlp=None, draw_fn=None, device="cuda", mesh=None):
        self.cfg = cfg
        self.stream = stream
        self.device = torch.device(device)
        self.save_dir = os.path.join(cfg["data"]["output"],
                                     str(cfg.get("scene", "scene")))
        os.makedirs(self.save_dir, exist_ok=True)
        save_config(cfg, os.path.join(self.save_dir, "cfg.yaml"))

        t = cfg["tracking"]
        up = cfg["mapping"]["uncertainty_params"]
        self.uncertainty_aware = t["uncertainty_params"]["activate"]
        if self.uncertainty_aware and not up["activate"]:
            raise ValueError("uncertainty-aware tracking needs "
                             "uncertainty-aware mapping")
        n_dev = int(cfg.get("parallel", {}).get("n_devices", 0) or 0)
        if mesh is None and n_dev > 1:
            from ..parallel.mesh import make_mesh

            mesh = make_mesh(n_dev, axis="g")
        self.mesh = mesh
        if mesh is not None:
            PRINTER.print(f"mesh mode: {mesh.size} shards on "
                          f"{[str(d) for d in mesh.devices]}", FontColor.INFO)
        debug.maybe_enable_from_cfg(cfg)
        # pause / stop / checkpoint requests; the HTTP endpoint only when
        # asked for (gui_http_port, or gui on), its port published for the
        # file GUI's buttons
        self.control = ControlChannel(
            self.save_dir, http_port=cfg.get(
                "gui_http_port", 0 if cfg.get("gui", False) else None))
        cfg["_gui_http_port"] = self.control.http_port
        ht, wd = cfg["cam"]["H_out"], cfg["cam"]["W_out"]
        self.state = SlamState.create(
            cfg, ht, wd, np.asarray(stream.intrinsic, np.float64),
            buffer=t["buffer"], uncertainty_aware=self.uncertainty_aware,
            metric_depth_reg=t["backend"]["metric_depth_reg"],
            feature_dim=up["feature_dim"], device=self.device)

        if model is None:
            ckpt = t.get("pretrained")
            if ckpt and os.path.exists(ckpt):
                model = droid_net.load_droid_checkpoint(ckpt, self.device)
            else:
                PRINTER.print(f"WARNING: droid checkpoint {ckpt} not found — "
                              "using random weights (tracking quality will "
                              "suffer)", FontColor.ERROR)
                model = droid_net.init_droid_net(
                    torch.Generator().manual_seed(0), device=self.device)
        self.model = model

        self.mapper = Mapper(self.state, cfg, uncer_mlp=uncer_mlp,
                             rng_seed=cfg.get("setup_seed", 43),
                             device=self.device, draw_fn=draw_fn, mesh=mesh)
        train_frac = up["train_frac_fix"]

        def update_uncertainty():
            uncertainty_update(self.state, self.mapper.uncer_mlp, train_frac)
        self.uncertainty_update = update_uncertainty
        self.backend = Backend(self.state, model, cfg,
                               uncertainty_update_fn=update_uncertainty)
        self.frontend = Frontend(self.state, model, cfg, backend=self.backend,
                                 uncertainty_update_fn=update_uncertainty,
                                 mesh=mesh)
        self.feat_fn = feat_fn
        self.motion_filter = MotionFilter(
            self.state, model, thresh=t["motion_filter"]["thresh"],
            force_keyframe_every_n_frames=t["force_keyframe_every_n_frames"],
            depth_fn=depth_fn, feat_fn=feat_fn)
        self.traj_filler = PoseTrajectoryFiller(
            self.state, model, feat_fn=feat_fn,
            uncer_apply=self.mapper.uncer_mlp if self.uncertainty_aware
            else None, train_frac_fix=train_frac)
        self.ba_freq = t["backend"]["ba_freq"]
        self.enable_online_ba = t["frontend"]["enable_online_ba"]

    # ------------------------------------------------------------------

    def run(self, resume_path=None):
        """Track and map every stride-th frame, then terminate.
        resume_path: a checkpoint of an earlier run of this config, which
        the run continues from the frame after it."""
        cfg = self.cfg
        stride = cfg.get("stride", 1)
        max_frames = cfg.get("max_frames", -1)
        n_frames = (len(self.stream) if max_frames < 0
                    else min(len(self.stream), max_frames))
        PRINTER.configure(total_frames=len(range(0, n_frames, stride)),
                          verbose=cfg.get("verbose", True))
        PRINTER.pbar_ready()
        prev_kf_idx = prev_ba_idx = start_i = 0
        ckpt_every = int(cfg.get("checkpoint_every", 0))
        ckpt_path = os.path.join(self.save_dir, "checkpoint.npz")
        if resume_path:
            with TIMER.phase("checkpoint.load", sync=True):
                loop = checkpoint.load_slam_checkpoint(resume_path, self)
            start_i = loop.get("next_frame", 0)
            prev_kf_idx = loop.get("prev_kf_idx", 0)
            prev_ba_idx = loop.get("prev_ba_idx", 0)
            PRINTER.print(f"resumed from {resume_path}: frame {start_i}, "
                          f"{self.state.counter} keyframes", FontColor.INFO)
        t_start = time.time()
        for i in range(start_i, n_frames, stride):
            cmd = self.control.poll()
            if cmd["stop"]:
                PRINTER.print(f"stop requested at frame {i}", FontColor.INFO)
                break
            if cmd["pause"]:
                PRINTER.print(f"paused at frame {i} (control channel)",
                              FontColor.INFO)
                self.control.wait_if_paused()
                PRINTER.print("resumed", FontColor.INFO)
            if self.control.consume_checkpoint_request():
                with TIMER.phase("checkpoint.save", sync=True):
                    checkpoint.save_slam_checkpoint(ckpt_path, self, dict(
                        next_frame=i, prev_kf_idx=prev_kf_idx,
                        prev_ba_idx=prev_ba_idx))
                PRINTER.print(f"checkpoint saved (control channel) -> "
                              f"{ckpt_path}", FontColor.INFO)
            with TIMER.phase("data.load"):
                timestamp, image, _, _ = self.stream[i]
            with TIMER.phase("track.motion_filter", sync=True):
                force = self.motion_filter.track(float(timestamp), image)
            with TIMER.phase("track.frontend", sync=True):
                self.frontend(force)
            debug.anomaly_check("track.frontend", self.state.store.poses,
                                self.state.store.disps)
            curr_kf_idx = self.state.counter - 1
            if curr_kf_idx != prev_kf_idx and self.frontend.is_initialized:
                if self.state.counter == self.frontend.warmup:
                    with TIMER.phase("map.initialize", sync=True):
                        self.mapper.initialize_mapper(curr_kf_idx)
                    self.frontend.initialize_second_stage()
                else:
                    if (self.enable_online_ba
                            and curr_kf_idx >= prev_ba_idx + self.ba_freq):
                        with TIMER.phase("track.online_global_ba", sync=True):
                            self.backend.dense_ba(2)
                        prev_ba_idx = curr_kf_idx
                    with TIMER.phase("map.keyframe", sync=True):
                        self.mapper.on_keyframe(curr_kf_idx, int(timestamp))
                    debug.anomaly_check("map.keyframe",
                                        self.mapper.gaussians.params)
            new_kf = curr_kf_idx != prev_kf_idx
            prev_kf_idx = curr_kf_idx
            PRINTER.update_pbar(1)
            if (ckpt_every > 0 and new_kf and self.frontend.is_initialized
                    and self.state.counter % ckpt_every == 0):
                with TIMER.phase("checkpoint.save", sync=True):
                    checkpoint.save_slam_checkpoint(ckpt_path, self, dict(
                        next_frame=i + stride, prev_kf_idx=prev_kf_idx,
                        prev_ba_idx=prev_ba_idx))
        self.terminate()
        PRINTER.terminate()
        PRINTER.print(f"done in {time.time() - t_start:.1f}s, "
                      f"{self.state.counter} keyframes", FontColor.TRACKER)

    # ------------------------------------------------------------------

    def final_ba(self):
        """Two global BAs (7 and 12 steps) without the metric-depth
        prior."""
        was = self.state.metric_depth_reg
        self.state.metric_depth_reg = False
        self.backend.dense_ba(7)
        self.backend.dense_ba(12)
        self.state.metric_depth_reg = was

    def save_video(self, path):
        """The live keyframes' timestamps, poses and depths (npz)."""
        n = self.state.counter
        s = self.state.store
        np.savez(path, **{k: getattr(s, f)[:n].cpu().numpy() for k, f in (
            ("timestamps", "timestamp"), ("poses", "poses"),
            ("disps", "disps"), ("disps_up", "disps_up"),
            ("mono_disps", "mono_disps"),
            ("valid_depth_masks", "valid_depth_mask"))})

    def _gt(self, frames):
        out = []
        for i in frames:
            pose = self.stream[int(i)][3]
            out.append(np.full((4, 4), np.nan) if pose is None
                       else np.asarray(pose))
        return np.stack(out)

    @staticmethod
    def _c2w(poses_w2c):
        return lie.se3_matrix(lie.se3_inv(torch.as_tensor(
            poses_w2c, dtype=torch.float32))).cpu().numpy()

    def kf_traj_eval(self, out_prefix):
        """The keyframe trajectory's ATE against the stream's poses."""
        n = self.state.counter
        ts = self.state.store.timestamp[:n].cpu().numpy().astype(int)
        est_c2w = self._c2w(self.state.store.poses[:n].cpu())
        gt = self._gt(ts)
        stats = eval_traj.evaluate_ate(est_c2w, gt)
        eval_traj.save_traj_tum(out_prefix + "_est.txt", ts, est_c2w)
        eval_traj.write_metrics(out_prefix + "_metrics.txt", stats,
                                label="keyframe trajectory ATE")
        good = np.isfinite(gt.reshape(len(gt), -1)).all(1)
        try:
            eval_traj.plot_trajectory(
                out_prefix + "_plot.png",
                eval_traj.poses_c2w_to_xyz(est_c2w[good]),
                eval_traj.poses_c2w_to_xyz(gt[good]), stats)
        except ImportError as e:
            PRINTER.print(f"trajectory plot skipped ({e})", FontColor.EVAL)
        return stats

    def full_traj_eval(self, out_prefix):
        """Every frame's pose (filled, then refined unless fast_mode; the
        keyframes' own poses win) and its ATE."""
        stride = self.cfg.get("stride", 1)
        with TIMER.phase("final.traj_fill", sync=True):
            poses_w2c = self.traj_filler(self.stream, stride=stride)
        if not self.cfg.get("fast_mode"):
            with TIMER.phase("final.nonkf_pose_refine", sync=True):
                poses_w2c = self._refine_full_traj(poses_w2c, stride)
        poses_w2c = np.array(poses_w2c, copy=True)
        n = self.state.counter
        ts = self.state.store.timestamp[:n].cpu().numpy().astype(int)
        pos = ts // stride
        ok = (ts % stride == 0) & (pos < len(poses_w2c))
        poses_w2c[pos[ok]] = self.state.store.poses[:n].cpu().numpy()[ok]
        est_c2w = self._c2w(poses_w2c)
        gt = self._gt(range(0, len(self.stream), stride))[:len(est_c2w)]
        stats = eval_traj.evaluate_ate(est_c2w, gt)
        eval_traj.save_traj_tum(out_prefix + "_est.txt",
                                np.arange(len(est_c2w)), est_c2w)
        eval_traj.write_metrics(out_prefix + "_metrics.txt", stats,
                                label="full trajectory ATE")
        return stats

    def _refine_full_traj(self, poses_w2c, stride):
        """Refine every frame's pose against the final map, with the DINO
        features the trajectory filler kept for it."""
        poses = np.array(poses_w2c, copy=True)
        frames = list(range(0, len(self.stream), stride))[:len(poses)]
        cached = self.traj_filler.last_features
        for k, i in enumerate(frames):
            image = self.stream[i][1]
            if not (self.uncertainty_aware and self.feat_fn is not None):
                feats = None
            elif cached is not None and k < len(cached) \
                    and cached[k] is not None:
                feats = cached[k]
            else:
                feats = self.feat_fn(image)
            poses[k] = self.mapper.refine_pose_non_key_frame(
                image, poses[k], features=feats).cpu().numpy()
        return poses

    def terminate(self):
        """Final BA, evaluation and export; evaluation errors are printed,
        not raised."""
        cfg = self.cfg
        traj_dir = os.path.join(self.save_dir, "traj")
        os.makedirs(traj_dir, exist_ok=True)
        has_gt = (not isinstance(self.stream, RGB_NoPose)
                  and getattr(self.stream, "poses", None) is not None)
        final_ba = cfg["tracking"]["backend"]["final_ba"]
        if final_ba:
            with TIMER.phase("final.global_ba", sync=True):
                self.final_ba()
        self.save_video(os.path.join(self.save_dir, "video.npz"))
        if cfg.get("eval_depth_l1", False) and has_gt:
            from ..utils.eval_depth import eval_depth_l1
            try:
                l1, l1_4m, cov = eval_depth_l1(
                    self.state.store, self.state.counter, self.stream)
                msg = (f"depth L1: {l1:.4f} m, depth L1 (<4m): {l1_4m:.4f} "
                       f"m, mask coverage: {cov:.3f}")
                PRINTER.print(msg, FontColor.EVAL)
                with open(os.path.join(traj_dir, "depth_l1.txt"), "w") as f:
                    f.write(msg + "\n")
            except Exception as e:
                PRINTER.print(f"depth L1 eval failed: {e}", FontColor.ERROR)
        if has_gt:
            try:
                stats = self.kf_traj_eval(os.path.join(traj_dir, "kf_traj"))
                PRINTER.print(f"keyframe ATE-RMSE: {stats['rmse']*100:.2f} cm",
                              FontColor.EVAL)
            except Exception as e:
                PRINTER.print(f"kf eval failed: {e}", FontColor.ERROR)
        if final_ba:
            iters = cfg["mapping"]["final_refine_iters"]
            if cfg.get("fast_mode"):
                iters = min(iters, 3000)
            with TIMER.phase("final.refine", sync=True):
                self.mapper.final_refine(iters=iters)
        if has_gt:
            try:
                stats = self.full_traj_eval(os.path.join(traj_dir,
                                                         "full_traj"))
                PRINTER.print(f"full ATE-RMSE: {stats['rmse']*100:.2f} cm",
                              FontColor.EVAL)
            except Exception as e:
                PRINTER.print(f"full traj eval failed: {e}", FontColor.ERROR)
        n = gm.save_ply(self.mapper.gaussians,
                        os.path.join(self.save_dir, "final_gs.ply"))
        PRINTER.print(f"saved {n} gaussians", FontColor.PCL)
        try:
            from ..gui.html_viewer import export_viewer_from_map
            export_viewer_from_map(
                os.path.join(self.save_dir, "map_viewer.html"),
                self.mapper.gaussians)
        except Exception as e:
            PRINTER.print(f"viewer export failed: {e}", FontColor.ERROR)
        if self.uncertainty_aware:
            torch.save({k: v.cpu() for k, v in
                        self.mapper.uncer_mlp.state_dict().items()},
                       os.path.join(self.save_dir,
                                    "uncertainty_mlp_weight.pth"))
        with open(os.path.join(self.save_dir, "profile.txt"), "w") as f:
            f.write(TIMER.report() + "\n")
        if cfg.get("verbose", True):
            PRINTER.print("phase timings:\n" + TIMER.report(), FontColor.INFO)
        self.control.close()
