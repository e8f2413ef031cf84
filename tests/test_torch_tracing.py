"""The port's tracer, ``utils/profiling.py::PhaseTimer`` (``TIMER``), and
the benchmark's metrics that read its spans and counters.

- Spans: nesting, parent ids, unit ids inherited from ``unit()``, self
  time, the ring's bound with the aggregates still exact past it (on a
  fake clock that moves 1 us a reading); counters on the host and summed on
  the device, folded past a full buffer; ``reset()``.
- With ``enabled = False`` nothing is recorded and no CUDA event is built
  (``torch.cuda.Event`` raises, ``is_available`` says yes).
- Device markers resolved through fake CUDA events that read the host
  clock: the interval lands on the host span, events come from the pool.
- Spans whose work runs on the CPU take their host interval as device
  time, also where ``is_available`` says a card is there.
- The clock: under ``torch.profiler`` with CPU activity, a span around a
  ``torch.mm`` holds the ``aten::mm`` event once converted; ``trace()``
  writes ``spans.json`` on ``trace.json``'s time base.
- A small CPU mapping keyframe (the mapper test's 48x64 scene and sizes)
  and a CPU ``update_n`` (the frontend test's 48x64, warmup 5, 48
  factors): each of the nine new ``h100_bench/metrics`` reads a finite,
  positive number from ``TIMER.summary()``, and None without the spans;
  ``map.intake_ms_per_kf`` still reads its three phases.
- ``-m gpu`` (on the card): a ``torch.cuda._sleep`` kernel inside a
  device-marked span lies inside the marker interval converted to a
  CUDA-only profiler's clock, within 50 us at each end, and its
  ``cudaLaunchKernel`` inside the host span; a device counter adds one
  kernel launch.

No JAX here: the card's tests run from this file.
"""

import copy
import importlib.util
import inspect
import json
import math
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from wildgs_slam_tpu_torch.config import load_config
from wildgs_slam_tpu_torch.models.droid_net import DroidNet
from wildgs_slam_tpu_torch.models.uncertainty import UncertaintyMLP
from wildgs_slam_tpu_torch.ops import lie
from wildgs_slam_tpu_torch.slam import keyframe_store as kstore
from wildgs_slam_tpu_torch.slam import losses_cuda
from wildgs_slam_tpu_torch.slam.factor_graph import FactorGraph
from wildgs_slam_tpu_torch.slam.mapper import Mapper
from wildgs_slam_tpu_torch.slam.motion_filter import MotionFilter
from wildgs_slam_tpu_torch.slam.state import SlamState
from wildgs_slam_tpu_torch.utils import profiling
from wildgs_slam_tpu_torch.utils.profiling import TIMER, PhaseTimer

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
MAP_METRICS = ("map.render_host_ms_per_iter", "map.loss_host_ms_per_iter",
               "map.backward_host_ms_per_iter", "map.optim_host_ms_per_iter",
               "map.live_slots_per_iter")
TRACK_METRICS = ("track.operator_ms_per_kf", "track.corr_ms_per_kf",
                 "track.ba_ms_per_kf", "track.edges_per_iter")


def metric(name):
    path = ROOT / "h100_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"tracing_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def fake_clock(monkeypatch):
    """perf_counter_ns advancing 1,000 ns a reading."""
    ticks = iter(range(10 ** 6, 10 ** 12, 1000))
    monkeypatch.setattr(profiling.time, "perf_counter_ns",
                        lambda: next(ticks))


# ---------------------------------------------------------------------------
# spans, the ring and counters
# ---------------------------------------------------------------------------

def test_spans_nest_with_parents_units_and_self_time(fake_clock):
    tm = PhaseTimer()
    with tm.unit(7):
        with tm.phase("outer"):
            with tm.phase("inner"):
                pass
            with tm.phase("inner"):
                with tm.unit(8), tm.phase("leaf"):
                    pass
    with tm.phase("free"):
        pass
    recs = {(r.name, r.unit): r for r in tm.records}
    outer = recs[("outer", 7)]
    assert outer.parent is None and recs[("free", None)].parent is None
    inner = [r for r in tm.records if r.name == "inner"]
    assert [r.parent for r in inner] == [outer.id, outer.id]
    assert [r.unit for r in inner] == [7, 7]
    assert recs[("leaf", 8)].parent == inner[1].id
    s = tm.summary()
    # readings: outer 1, inner 2-3, inner 4, leaf 5-6, inner 7, outer 8
    assert s["outer"]["total_s"] == pytest.approx(7e-6)
    assert s["inner"]["total_s"] == pytest.approx(1e-6 + 3e-6)
    assert s["inner"]["self_s"] == pytest.approx(4e-6 - 1e-6)
    assert s["outer"]["self_s"] == pytest.approx(7e-6 - 4e-6)
    assert s["leaf"]["self_s"] == s["leaf"]["total_s"]
    assert s["inner"]["count"] == 2 and "device_s" not in s["inner"]
    assert sorted(r.id for r in tm.records) == list(range(5))


def test_ring_keeps_the_last_spans_and_exact_aggregates(fake_clock,
                                                       monkeypatch):
    monkeypatch.setattr(profiling, "RING", 8)
    tm = PhaseTimer()
    for k in range(20):
        with tm.phase("a" if k % 2 else "b"):
            pass
    assert len(tm.records) == 8
    assert [r.id for r in tm.records] == list(range(12, 20))
    s = tm.summary()
    assert s["a"]["count"] == s["b"]["count"] == 10
    assert s["a"]["total_s"] == pytest.approx(10e-6)
    assert s["a"]["first_s"] == pytest.approx(1e-6)
    assert s["a"]["warm_mean_ms"] == pytest.approx(1e-3)


def test_counters_and_reset(monkeypatch, tmp_path):
    monkeypatch.setattr(profiling, "COUNTER_SLOTS", 4)
    tm = PhaseTimer()
    for k in range(10):
        tm.count("host", k)
        tm.count("dev", torch.full((3, 2), k, dtype=torch.int32))
    tm.count("flt", torch.tensor([0.25, 0.5]))
    tm.count("calls")
    with tm.phase("p"):
        pass
    s = tm.summary()
    assert s["host"] == {"count": 10, "total": 45}
    assert s["dev"] == {"count": 10, "total": 6 * 45}
    assert isinstance(s["dev"]["total"], int)
    assert s["flt"] == {"count": 1, "total": 0.75}
    assert s["calls"] == {"count": 1, "total": 1}
    rep = tm.report()
    assert rep.splitlines()[0].split()[-2:] == ["self[s]", "device[s]"]
    assert re.search(r"^dev\s+10\s+270\s+27\s*$", rep, re.M)
    tm.write(str(tmp_path / "profile.txt"))
    assert (tmp_path / "profile.txt").read_text() == rep + "\n"
    tm.reset()
    assert tm.summary() == {} and not tm.records
    assert tm.report() == "(no phases recorded)"


def test_disabled_records_nothing_and_builds_no_event(monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("a CUDA event was built")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    tm = PhaseTimer()
    tm.enabled = False
    tm.reset()
    with tm.unit(3), tm.phase("a", device="cuda"):
        with tm.phase("b", device="cuda"):
            tm.count("c", torch.ones(4))
            tm.count("d", 2)
    assert tm.summary() == {} and not tm.records and not tm.stats


class FakeEvent:
    """A CUDA event that reads the host clock when recorded."""
    built = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.built += 1
        self.t = None

    def record(self):
        self.t = time.perf_counter_ns()

    def synchronize(self):
        pass

    def query(self):
        return True

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


def test_device_markers_resolve_on_the_host_clock(monkeypatch):
    """On a clock that moves 1 us a reading and 1 ms for each span's work,
    so that the host's scheduling cannot move the numbers."""
    now = [10 ** 6]

    def tick(ns=1000):
        now[0] += ns
        return now[0]
    monkeypatch.setattr(profiling.time, "perf_counter_ns", tick)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(profiling, "DRAIN", 4)
    FakeEvent.built = 0
    tm = PhaseTimer()
    tm.reset()
    anchors = FakeEvent.built
    assert anchors == 3
    for _ in range(10):
        with tm.phase("m", device="cuda"):
            tick(1_000_000)
        with tm.phase("h"):
            pass
    # the finished markers were resolved as they piled up, and their
    # events reused
    assert len(tm._pending) < 4
    assert FakeEvent.built - anchors <= 2 * 4
    s = tm.summary()
    assert not tm._pending
    assert "device_s" not in s["h"]
    assert s["m"]["device_s"] == pytest.approx(s["m"]["total_s"], rel=0.05)
    for r in tm.records:
        if r.name == "m":
            # the anchor's host time is the end of its record and wait
            assert r.t0 - 50_000 <= r.d0 <= r.d1 <= r.t1 + 50_000
        else:
            assert r.d0 is None


@pytest.mark.parametrize("card", [False, True])
def test_cpu_device_spans_take_their_host_interval(monkeypatch, card):
    """Work on the CPU gets its host interval, also on a machine with a
    card (`card`: ``is_available`` says yes, and no CUDA event or
    synchronize may happen)."""
    if card:
        def no_cuda(*a, **k):
            raise AssertionError("CUDA was used for CPU work")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
        monkeypatch.setattr(torch.cuda, "Event", no_cuda)
        monkeypatch.setattr(torch.cuda, "synchronize", no_cuda)
    tm = PhaseTimer()
    tm.reset()
    with tm.phase("m", device=torch.device("cpu")):
        torch.ones(8).sum()
    with tm.phase("s", sync=True, device="cpu"):
        pass
    r = tm.records[-2]
    assert (r.d0, r.d1) == (r.t0, r.t1)
    assert tm.summary()["m"]["device_s"] == tm.summary()["m"]["total_s"]


def test_span_holds_aten_mm_on_the_profiler_clock():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tm = PhaseTimer()
    a = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tm.phase("mm"):
            torch.mm(a, a)
    clock = tm.profiler_clock(prof)
    sp = tm.records[-1]
    mm = [e for e in prof.events()
          if e.name == "aten::mm" and e.device_type == DeviceType.CPU]
    assert len(mm) == 1
    assert clock(sp.t0) <= mm[0].time_range.start
    assert mm[0].time_range.end <= clock(sp.t1)


def test_trace_writes_spans_on_the_trace_time_base(tmp_path):
    TIMER.reset()
    a = torch.randn(96, 96)
    with profiling.trace(str(tmp_path)):
        with TIMER.unit(4), TIMER.phase("traced.mm"):
            torch.mm(a, a)
    torch_trace = json.loads((tmp_path / "trace.json").read_text())
    spans = json.loads((tmp_path / "spans.json").read_text())
    base = torch_trace.get("baseTimeNanoseconds", 0)
    assert spans["baseTimeNanoseconds"] == base
    mm = [e for e in torch_trace["traceEvents"] if e.get("name") == "aten::mm"]
    sp = [e for e in spans["traceEvents"] if e.get("name") == "traced.mm"]
    assert len(mm) == 1 and len(sp) == 1
    assert sp[0]["ph"] == "X" and sp[0]["args"]["unit"] == 4
    assert sp[0]["ts"] <= float(mm[0]["ts"])
    assert float(mm[0]["ts"]) + float(mm[0]["dur"]) <= (sp[0]["ts"]
                                                       + sp[0]["dur"])


def test_no_new_span_synchronizes():
    from wildgs_slam_tpu_torch.slam import factor_graph

    for fn in (Mapper._opt_step, Mapper._opt_segment,
               factor_graph.FactorGraph.update_n):
        assert "sync=True" not in inspect.getsource(fn), fn.__name__


# ---------------------------------------------------------------------------
# the program's spans and the metrics that read them
# ---------------------------------------------------------------------------

MAP_H, MAP_W = 48, 64


def map_cfg():
    """The mapper test's sizes (tests/test_torch_mapper.py::small_cfg)."""
    cfg = copy.deepcopy(load_config("configs/Dynamic/TUM_RGBD/"
                                    "tum_dynamic.yaml"))
    cfg["mapping"]["Training"].update(
        init_itr_num=16, init_gaussian_update=8, init_gaussian_reset=12,
        mapping_itr_num=8, gaussian_update_every=20, gaussian_update_offset=4,
        gaussian_th=0.005, window_size=3)
    cfg["mapping"]["gaussian_capacity"] = 2048
    cfg["mapping"]["render_list_capacity"] = 128
    cfg["tracking"]["buffer"] = 6
    return cfg


@pytest.fixture(scope="module")
def mapping_ctx():
    """One keyframe through Mapper.on_keyframe after initialize_mapper on
    the mapper test's slanted wall: the window's ctx."""
    cfg = map_cfg()
    rng = np.random.RandomState(0)
    intr = np.array([55.0, 55.0, MAP_W / 2, MAP_H / 2], np.float32)
    st = SlamState.create(cfg, MAP_H, MAP_W, intr, buffer=6, device="cpu")
    yy, xx = np.meshgrid(np.arange(MAP_H), np.arange(MAP_W), indexing="ij")
    for i in range(4):
        xi = torch.tensor([0.04 * i, 0.01 * i, 0.0, 0.0, 0.02 * i, 0.0])
        depth = (2.0 + 0.01 * xx + 0.004 * yy
                 + 0.05 * np.sin(0.2 * xx + i)).astype(np.float32)
        img = np.stack([0.5 + 0.4 * np.sin(0.3 * xx + 0.5 * i),
                        0.5 + 0.4 * np.cos(0.25 * yy),
                        0.5 + 0.3 * np.sin(0.2 * (xx + yy))], -1)
        img = np.clip(img + 0.02 * rng.normal(size=img.shape), 0, 1)
        kstore.append(st.store, i, float(i), pose=lie.se3_exp(xi),
                      mono_depth_up=torch.as_tensor(depth))
        st.append_host(i, img.astype(np.float32),
                       rng.normal(size=(MAP_H // 14, MAP_W // 14, 384))
                       .astype(np.float32), float(i))
    torch.manual_seed(1)
    m = Mapper(st, cfg, uncer_mlp=UncertaintyMLP(384), rng_seed=0,
               device="cpu")
    m.initialize_mapper(2)
    TIMER.reset()
    it0 = m.iteration_count
    m.on_keyframe(3, 3)
    ctx = dict(timer=TIMER.summary(), iterations=m.iteration_count - it0,
               keyframes=1)
    units = {r.unit for r in TIMER.records if r.name.startswith("map.")}
    return ctx, units


TRACK_H, TRACK_W = 48, 64


@pytest.fixture(scope="module")
def tracking_ctx():
    """Six frames through the motion filter (each a keyframe), a
    neighbourhood graph and one update_n of two iterations: the frontend
    test's sizes."""
    cfg = load_config("configs/wildgs_slam.yaml")
    cfg["tracking"].update(buffer=32, warmup=5)
    cfg["tracking"]["frontend"].update(window=8, max_factors=48,
                                       enable_loop=False)
    intr = np.array([40.0, 40.0, TRACK_W / 2, TRACK_H / 2])
    st = SlamState.create(cfg, TRACK_H, TRACK_W, intr, buffer=32,
                          device="cpu")
    torch.manual_seed(0)
    model = DroidNet().eval()
    y, x = np.meshgrid(np.arange(TRACK_H), np.arange(TRACK_W), indexing="ij")
    mf = MotionFilter(st, model, thresh=-1.0,
                      depth_fn=lambda im: np.full((TRACK_H, TRACK_W), 2.0,
                                                  np.float32))
    TIMER.reset()
    for t in range(6):
        img = np.stack([0.5 + 0.5 * np.sin(0.2 * (x - 3 * t)),
                        0.5 + 0.5 * np.cos(0.15 * (y + 2 * t)),
                        0.5 + 0.4 * np.sin(0.1 * (x + y - t))], -1)
        mf.track(float(t) + 0.5, np.clip(img, 0, 1).astype(np.float32))
    mf_units = {r.unit for r in TIMER.records if r.name.startswith("track.mf")}
    g = FactorGraph(st, model, max_factors=48)
    g.add_neighborhood_factors(0, 6, r=2)
    TIMER.reset()
    g.update_n(2, use_inactive=True)
    return dict(timer=TIMER.summary(), keyframes=1, iterations=2,
                edges=g.E), mf_units


def test_mapping_spans_cover_the_step(mapping_ctx):
    ctx, units = mapping_ctx
    t = ctx["timer"]
    assert t["map.step"]["count"] == ctx["iterations"] >= 8
    parts = sum(t[f"map.step.{k}"]["total_s"]
                for k in ("render", "loss", "backward", "optim"))
    assert parts + t["map.step"]["self_s"] == pytest.approx(
        t["map.step"]["total_s"])
    assert parts >= 0.9 * t["map.step"]["total_s"]
    assert t["map.live_slots"]["count"] == ctx["iterations"]
    assert units == {3}


def test_cpu_mapping_step_takes_the_plain_loss(mapping_ctx):
    """On the CPU the mapping loss runs as plain tensor code: no call is
    counted in map.loss.kernel, and the kernels' wrappers count none."""
    ctx, _ = mapping_ctx
    t = ctx["timer"]
    assert t["map.step.loss"]["count"] == ctx["iterations"] >= 8
    assert "map.loss.kernel" not in t
    assert losses_cuda.mapping_loss_fwd.launches == 0
    assert losses_cuda.mapping_loss_bwd.launches == 0


def test_intake_metric_reads_the_summary_unchanged(mapping_ctx):
    ctx, _ = mapping_ctx
    phases = ("map.kf_resync_deform", "map.window_update",
              "map.seed_gaussians")
    want = sum(ctx["timer"][p]["total_s"] for p in phases) * 1e3
    assert metric("map.intake_ms_per_kf").read(ctx) == pytest.approx(want)


def test_tracking_counters_and_units(tracking_ctx):
    ctx, mf_units = tracking_ctx
    t = ctx["timer"]
    assert t["track.update_iters"] == {"count": 2, "total": 2}
    assert t["track.edges"] == {"count": 2, "total": 2 * ctx["edges"]}
    for k in ("corr", "operator", "ba"):
        assert t[f"track.upd.{k}"]["count"] == 2
        assert t[f"track.upd.{k}"]["device_s"] > 0
    assert mf_units == {t_ + 0.5 for t_ in range(6)}


@pytest.mark.parametrize("name", MAP_METRICS + TRACK_METRICS)
def test_new_metric_reads_the_program(name, mapping_ctx, tracking_ctx):
    ctx = (mapping_ctx if name.startswith("map.") else tracking_ctx)[0]
    read = metric(name).read
    v = read(ctx)
    assert isinstance(v, float) and math.isfinite(v) and v > 0, v
    # the parent's program: none of the spans and counters
    bare = dict(ctx, timer={k: s for k, s in ctx["timer"].items()
                            if not k.startswith(("map.step", "map.live",
                                                 "track.upd", "track.edges",
                                                 "track.update"))})
    assert read(bare) is None
    assert read(dict(ctx, timer=None)) is None


def test_new_metrics_are_declared():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    by_name = {m["name"]: m for m in spec["per_layer"]}
    for name in MAP_METRICS + TRACK_METRICS:
        m = by_name[name]
        assert m["source"] == ("program_counter" if name.endswith(
            ("slots_per_iter", "edges_per_iter")) else "program_span")
        assert m["moves"] == ("map_ms_per_iter" if name.startswith("map.")
                              else "track_ms_per_frame")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_device_markers_align_with_the_profiler():
    """A CUDA-only profiler's kernel and runtime call against a
    device-marked span converted to its clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _card()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    tm = PhaseTimer()
    tm.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tm.phase("sleep", device="cuda"):
            torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize()
    tm.summary()
    clock = tm.profiler_clock(prof)
    sp = tm.records[-1]
    d0, d1, h0, h1 = (clock(x) for x in (sp.d0, sp.d1, sp.t0, sp.t1))
    ev = prof.events()
    kern = [e for e in ev if e.device_type == DeviceType.CUDA]
    launch = [e for e in ev if e.device_type == DeviceType.CPU
              and e.name.startswith("cudaLaunchKernel")]
    assert len(kern) == 1 and len(launch) == 1, [e.name for e in ev]
    ks, ke = kern[0].time_range.start, kern[0].time_range.end
    print(f"marker {d0:.1f}-{d1:.1f} us, kernel {ks:.1f}-{ke:.1f} us, "
          f"host span {h0:.1f}-{h1:.1f} us, launch "
          f"{launch[0].time_range.start:.1f}-{launch[0].time_range.end:.1f}")
    assert d0 - 50 <= ks and ke <= d1 + 50
    assert h0 <= launch[0].time_range.start
    assert launch[0].time_range.end <= h1


@pytest.mark.gpu
def test_device_counter_adds_one_launch():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _card()
    tm = PhaseTimer()
    counts = torch.arange(768, dtype=torch.int32, device="cuda")
    tm.count("slots", counts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tm.count("slots", counts)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(kernels) <= 1, [e.name for e in kernels]
    assert tm.summary()["slots"] == {"count": 2,
                                     "total": 2 * 767 * 768 // 2}

