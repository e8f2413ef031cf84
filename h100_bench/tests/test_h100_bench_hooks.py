"""The program's internals that the harness hooks or reads, each held to
the form the harness relies on. A change to one of them fails here with
the symbol's name, so that it shows as a dependency of the harness to
update with it, and not as a wrong program (a run would read inf gaps or
crash)."""

import inspect

import torch

from h100_bench.drivers import mapping as dm
from wildgs_slam_tpu_torch.models import droid_net
from wildgs_slam_tpu_torch.ops import dba
from wildgs_slam_tpu_torch.ops.rasterizer import composite_cuda
from wildgs_slam_tpu_torch.slam import factor_graph
from wildgs_slam_tpu_torch.slam import frontend
from wildgs_slam_tpu_torch.slam import gaussian_map as gm
from wildgs_slam_tpu_torch.slam import keyframe_store
from wildgs_slam_tpu_torch.slam import mapper as mapper_mod
from wildgs_slam_tpu_torch.slam import motion_filter
from wildgs_slam_tpu_torch.slam import viewpoints


def need(ok, symbol, what):
    assert ok, f"harness hook {symbol}: {what}; update h100_bench with it"


def params(fn):
    return list(inspect.signature(fn).parameters)


def calls(caller, text):
    return text in inspect.getsource(caller)


def test_mapper_opt_step():
    sym = "Mapper._opt_step"
    need(params(mapper_mod.Mapper._opt_step) == [
        "self", "idx", "freeze", "d_base", "d_samples", "it_count",
        "initialization", "render_fn"], sym,
         "drivers/mapping.py::StepHook wraps it with this signature")
    need(calls(mapper_mod.Mapper._opt_segment, "self._opt_step("), sym,
         "StepHook replaces it on the instance: _opt_segment has to call "
         "it through self")


def test_mapper_schedule_attributes():
    src = inspect.getsource(mapper_mod.Mapper)
    for name in ("mapping_itr_num", "iteration_count", "iters_after_densify",
                 "gaussian_update_every", "gaussian_update_offset",
                 "gaussian_reset", "step_losses"):
        need(f"self.{name} =" in src or f"self.{name}:" in src,
             f"Mapper.{name}", "drivers/mapping.py reads it")
    need(f"freeze_after={dm.FREEZE_AFTER}," in inspect.getsource(
        mapper_mod.Mapper.map_opt_online), "Mapper.map_opt_online",
         "draw_step keeps the compared steps out of its freeze")
    for phase in ("map.kf_resync_deform", "map.window_update",
                  "map.seed_gaussians"):
        need(f'"{phase}"' in src, f"TIMER phase {phase}",
             "metrics/map.intake_ms_per_kf.py reads it by name")


def test_composite_fwd():
    sym = "composite_cuda.composite_fwd"
    need(params(composite_cuda.composite_fwd) == [
        "counts", "tile_ids", "attrs", "bg", "tw", "ck"], sym,
         "drivers/mapping.py::K1Stash wraps it with this signature")
    need(hasattr(composite_cuda.composite_fwd, "launches"), sym,
         "K1Stash carries its launch counter")
    need(calls(composite_cuda.CompositeTiles.forward, "= composite_fwd("),
         sym, "K1Stash replaces the module attribute: CompositeTiles has "
         "to call it by its module-level name")


def test_state_that_snapshot_reads():
    fields = {
        "GaussianMap": (gm.GaussianMap, ("params", "aux", "mu", "nu",
                                         "count")),
        "GaussianAux": (gm.GaussianAux, ("alive", "kf_id")),
        "ViewpointStore": (viewpoints.ViewpointStore, (
            "exposure", "exposure_mu", "exposure_nu", "exposure_count")),
    }
    for name, (cls, want) in fields.items():
        have = set(getattr(cls, "__dataclass_fields__", {})) | set(
            getattr(cls, "__annotations__", {}))
        for f in want:
            need(f in have, f"{name}.{f}", "drivers/mapping.py::snapshot "
                 "reads it")
    need(all(f"self.{n} =" in inspect.getsource(mapper_mod._MLPAdam)
             for n in ("mu", "nu", "count")), "mapper._MLPAdam",
         "snapshot reads its mu, nu and count")
    need(all(f"self.{n} =" in inspect.getsource(mapper_mod.Mapper.__init__)
             for n in ("uncer_adam", "uncer_mlp", "gaussians", "vstore")),
         "Mapper.__init__", "snapshot reads uncer_adam, uncer_mlp, "
         "gaussians and vstore")


def test_first_moments_take_a_tenth_of_the_gradient():
    """_first_grads works the first gradient out of each optimiser's
    first moment before and after the step, with b1 = 0.9."""
    for sym, fn in (("gaussian_map.adam_step", gm.adam_step),
                    ("viewpoints.exposure_adam_step",
                     viewpoints.exposure_adam_step),
                    ("mapper._MLPAdam.step", mapper_mod._MLPAdam.step)):
        need(inspect.signature(fn).parameters["b1"].default == 0.9, sym,
             "_first_grads takes b1 = 0.9")
    m = gm.create(8, device="cpu")
    m.aux.alive[:4] = True
    grads = gm.GaussianParams(*[torch.ones_like(t)
                                for t in m.params.tensors()])
    gm.adam_step(m, grads, {n: 0.0 for n in gm.PARAM_NAMES})
    for n, mu in zip(gm.PARAM_NAMES, m.mu.tensors()):
        need(torch.allclose(mu[:4], torch.full_like(mu[:4], 0.1)),
             f"GaussianMap.mu.{n}", "_first_grads reads mu = 0.1 g after "
             "one step from zero")


def test_dba_ba():
    sym = "dba.ba"
    need(params(dba.ba)[:16] == [
        "poses", "disps", "intrinsics", "target", "weight", "eta", "ii",
        "jj", "groups", "t0", "t1", "iters", "cfg", "sensor_disps",
        "sensor_valid", "motion_only"], sym,
         "drivers/tracking.py::IterationCapture wraps it with this "
         "signature")
    need(calls(keyframe_store.ba, "dba.ba("), sym,
         "IterationCapture replaces the module attribute: keyframe_store.ba "
         "has to call it through the module")
    need(all(hasattr(dba.BAConfig(), n) for n in ("lm", "ep", "alpha")),
         "dba.BAConfig", "the reference's BA takes lm, ep and alpha from it")


def test_factor_graph():
    g = factor_graph.FactorGraph
    need(params(g._store_corr) == ["self", "ii", "jj", "off"],
         "FactorGraph._store_corr", "IterationCapture wraps it on the "
         "instance with this signature")
    need(calls(g, "self._store_corr("), "FactorGraph._store_corr",
         "it has to be called through self")
    need(calls(frontend.Frontend, ".update_n("), "FactorGraph.update_n",
         "IterationCapture wraps it on the frontend's graph instance")


def test_update_operator():
    sym = "DroidNet.update"
    need(isinstance(droid_net.DroidNet().update, torch.nn.Module), sym,
         "IterationCapture hooks its forward")
    need(params(type(droid_net.DroidNet().update).forward)[:6] == [
        "self", "net", "inp", "corr", "flow", "ii"], sym,
         "the forward hooks read (net, inp, corr, flow, ii)")


def test_motion_filter_flow():
    sym = "motion_filter._flow_magnitude"
    need(params(motion_filter._flow_magnitude) == [
        "model", "fmap_last", "gmap", "net", "inp"], sym,
         "IterationCapture wraps it with this signature")
    need(calls(motion_filter.MotionFilter.track, "_flow_magnitude("), sym,
         "MotionFilter.track has to call it by its module-level name")
