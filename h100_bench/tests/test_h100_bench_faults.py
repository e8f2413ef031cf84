"""A run with the timed path broken underneath comes out not correct: the
rest of a run (set-up, window, check) at a small size on the CPU, past the
look for a card, once for each fault a cell can have. The cells run on one
card, so no exchange between cards can be left out."""

import pytest
import torch

from h100_bench import run as hr
from h100_bench.drivers import mapping as dm
from h100_bench.drivers import tracking as dm_tracking
from h100_bench.tests import small
from wildgs_slam_tpu_torch.models import droid_net
from wildgs_slam_tpu_torch.ops import dba
from wildgs_slam_tpu_torch.slam import gaussian_map as gm
from wildgs_slam_tpu_torch.slam import losses
from wildgs_slam_tpu_torch.slam import mapper as mapper_mod
from wildgs_slam_tpu_torch.slam import motion_filter
from wildgs_slam_tpu_torch.slam import viewpoints


def verdict_of(workload="tum_dynamic.map_online", seed=2 ** 31 + 99):
    s = small.spec()
    cell = next(w for w in s["workloads"] if w["name"] == workload)
    out = dm.run(small.config(cell["config"]), small.traffic(cell["traffic"]),
                 seed, 0.05, False, "cpu")
    return hr.verdict(out["numbers"],
                      hr.load_json(hr.HERE, "limits", f"{workload}.json"),
                      out["failed"])


def test_sound_run_is_correct():
    assert verdict_of()[0]


def test_step_that_leaves_the_state_unchanged(monkeypatch):
    monkeypatch.setattr(gm, "adam_step", lambda m, grads, lrs, **k: m)
    monkeypatch.setattr(viewpoints, "exposure_adam_step",
                        lambda vs, idx, grad, **k: vs)
    monkeypatch.setattr(mapper_mod._MLPAdam, "step",
                        lambda self, grads, lr, **k: None)
    ok, checks = verdict_of()
    assert not ok and checks["change_gap"]["value"] > 0.5


def test_one_leaf_stepped_double(monkeypatch):
    """The exposures' optimiser takes twice its step from sound moments:
    the first gradients hold, the worst leaf's change does not."""
    step = viewpoints.exposure_adam_step
    monkeypatch.setattr(viewpoints, "exposure_adam_step",
                        lambda vs, idx, grad, lr=0.01, **k: step(
                            vs, idx, grad, lr=2 * lr, **k))
    ok, checks = verdict_of()
    assert not ok and checks["grad_gap"]["value"] <= checks["grad_gap"][
        "limit"] and checks["change_gap_worst_leaf"]["value"] > checks[
        "change_gap_worst_leaf"]["limit"]


def test_half_of_the_pixels_left_out(monkeypatch):
    full = losses.mapping_loss_uncertainty

    def upper_half(img, depth, gt, ref_depth, unc, opacity, *a, **k):
        h = img.shape[0] // 2
        return full(img[:h], depth[:h], gt[:h], ref_depth[:h], unc,
                    opacity[:h], *a, **k)
    monkeypatch.setattr(losses, "mapping_loss_uncertainty", upper_half)
    ok, checks = verdict_of()
    assert not ok


def test_render_altered_where_it_is_produced(monkeypatch):
    plain = mapper_mod.render

    def brighter(*a, **k):
        out = plain(*a, **k)
        return out._replace(color=out.color * 1.01)
    monkeypatch.setattr(mapper_mod, "render", brighter)
    ok, checks = verdict_of()
    assert not ok and any(c["value"] > c["limit"] for c in checks.values())


@pytest.mark.gpu
def test_control_fails_on_the_card():
    """The control, the reference in TF32 put in the program's place, is
    not correct: at the small size on the card, for three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    limits = hr.load_json(hr.HERE, "limits", "tum_dynamic.map_online.json")
    cfg, mix = small.config("tum_dynamic"), small.traffic("map_online")
    for seed in (1, 2, 3):
        cell = dm.MappingCell(cfg, mix, seed, "cuda")
        cell.setup()
        cell.window(0.0, None)
        cap = cell.capture
        cell.release()
        dev = torch.device("cuda")
        ref = dm.reference_run(cap, cfg, mix, seed, dev)
        control = dm.reference_run(cap, cfg, mix, seed, dev, tf32=True)
        ok, _ = hr.verdict(dm.numbers(control, ref), limits, 0)
        assert not ok, seed


def tracking_verdict(seed=2 ** 31 + 77):
    workload = "tum_dynamic.track_stream"
    out = dm_tracking.run(small.config("tum_dynamic", "tracking"),
                          small.traffic("track_stream", profile=False), seed,
                          4.0, False, "cpu")
    return hr.verdict(out["numbers"],
                      hr.load_json(hr.HERE, "limits", f"{workload}.json"),
                      out["failed"])


def test_tracking_sound_run_is_correct():
    assert tracking_verdict()[0]


def test_tracking_ba_that_leaves_the_state_unchanged(monkeypatch):
    monkeypatch.setattr(dba, "ba", lambda poses, disps, *a, **k: (poses,
                                                                   disps))
    ok, checks = tracking_verdict()
    assert not ok and checks["ba_gap"]["value"] > 0.5


def test_tracking_ba_over_half_of_the_edges(monkeypatch):
    full = dba.ba

    def half(poses, disps, intr, target, weight, eta, ii, jj, groups, t0,
             t1, *a, **k):
        n = max(1, ii.shape[0] // 2)
        return full(poses, disps, intr, target[:n], weight[:n], eta, ii[:n],
                    jj[:n], dba.make_edge_groups(ii[:n].cpu().numpy(),
                                                 groups.shape[0],
                                                 groups.shape[1]),
                    t0, t1, *a, **k)
    monkeypatch.setattr(dba, "ba", half)
    assert not tracking_verdict()[0]


def test_tracking_motion_filter_features_altered(monkeypatch):
    encode = motion_filter._encode_fmap
    monkeypatch.setattr(motion_filter, "_encode_fmap",
                        lambda model, x: encode(model, x) * 1.01)
    ok, checks = tracking_verdict()
    assert not ok and checks["mf_gap"]["value"] > checks["mf_gap"]["limit"]


def test_tracking_delta_altered_where_it_is_produced(monkeypatch):
    forward = droid_net.UpdateModule.forward

    def altered(self, *a, **k):
        net, delta, weight, frames, eta, up = forward(self, *a, **k)
        return net, delta * 1.01, weight, frames, eta, up
    monkeypatch.setattr(droid_net.UpdateModule, "forward", altered)
    ok, checks = tracking_verdict()
    assert not ok and checks["update_gap"]["value"] > checks["update_gap"][
        "limit"]


@pytest.mark.gpu
def test_tracking_control_fails_on_the_card():
    """The tracking cell's control, the reference in TF32 put in the
    program's place, is not correct: at the small size on the card, for
    three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    limits = hr.load_json(hr.HERE, "limits", "tum_dynamic.track_stream.json")
    cfg = small.config("tum_dynamic", "tracking")
    mix = small.traffic("track_stream", profile=False)
    for seed in (1, 2, 3):
        cell = dm_tracking.TrackingCell(cfg, mix, seed, "cuda")
        cell.setup()
        out = cell.window(4.0, dm_tracking.draw_iterations(seed, mix), None)
        weights = cell.weights
        cell.release()
        ok, _ = hr.verdict(dm_tracking.reference_numbers(out, weights,
                                                         tf32=True),
                           limits, 0)
        assert not ok, seed
