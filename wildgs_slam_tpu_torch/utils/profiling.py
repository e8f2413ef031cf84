"""Per-phase timing and profiler tracing; the port's own copy of
``wildgs_slam_tpu/utils/profiling.py``.

- ``PhaseTimer``: named phases timed on the host clock, the first call kept
  apart from the warm calls. ``phase(name, sync=True)`` ends with
  ``torch.cuda.synchronize()`` where the JAX version blocked on its arrays,
  so the phase covers the device work it queued.
- ``trace(logdir)``: a ``torch.profiler`` capture of the CPU and CUDA
  activity, written as a Chrome trace into logdir.
- For the measuring programs (``bench.py``, ``scripts/``): ``run_device``
  (the card, or the CPU only when asked), ``card_line`` (the card's name and
  power limit as nvidia-smi reports them), ``device_summary`` and
  ``profile_steps`` (a torch.profiler trace's device time by operation).
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch


@dataclass
class PhaseStat:
    count: int = 0
    total: float = 0.0
    first: float = 0.0
    warm_total: float = 0.0
    min: float = float("inf")
    max: float = 0.0
    recent: List[float] = field(default_factory=list)

    @property
    def warm_count(self) -> int:
        return max(self.count - 1, 0)

    @property
    def warm_mean(self) -> float:
        return self.warm_total / self.warm_count if self.warm_count else 0.0

    def add(self, dt: float):
        self.count += 1
        self.total += dt
        if self.count == 1:
            self.first = dt
        else:
            self.warm_total += dt
            self.recent.append(dt)
            if len(self.recent) > 64:
                self.recent.pop(0)
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)


class PhaseTimer:
    def __init__(self):
        self.stats: Dict[str, PhaseStat] = {}
        self.enabled = True

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = False):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and torch.cuda.is_available():
                torch.cuda.synchronize()
            self.stats.setdefault(name, PhaseStat()).add(
                time.perf_counter() - t0)

    def add(self, name: str, dt: float):
        """Record one call of `dt` seconds timed elsewhere."""
        self.stats.setdefault(name, PhaseStat()).add(dt)

    def reset(self):
        self.stats.clear()

    def report(self) -> str:
        if not self.stats:
            return "(no phases recorded)"
        rows = [("phase", "calls", "first[s]", "warm mean[ms]",
                 "warm last10[ms]", "total[s]")]
        for name in sorted(self.stats, key=lambda n: -self.stats[n].total):
            s = self.stats[name]
            last10 = (sum(s.recent[-10:]) / len(s.recent[-10:]) * 1e3
                      if s.recent else 0.0)
            rows.append((name, str(s.count), f"{s.first:.3f}",
                         f"{s.warm_mean * 1e3:.2f}", f"{last10:.2f}",
                         f"{s.total:.2f}"))
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        lines = []
        for i, r in enumerate(rows):
            lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
            if i == 0:
                lines.append("-" * (sum(widths) + 2 * (len(widths) - 1)))
        return "\n".join(lines)

    def write(self, path: str):
        with open(path, "w") as f:
            f.write(self.report() + "\n")

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{phase: count, first_s, warm_mean_ms, total_s}."""
        return {
            name: {
                "count": s.count,
                "first_s": s.first,
                "warm_mean_ms": s.warm_mean * 1e3,
                "total_s": s.total,
            }
            for name, s in self.stats.items()
        }


# Process-global timer used by the mapper; tests and scripts may reset it.
TIMER = PhaseTimer()


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Capture a torch.profiler trace into logdir if set, else no-op."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def run_device(name: str) -> torch.device:
    """The device a measuring program runs on: `name` ("cuda" by default
    on its command line); stops with a message when CUDA is asked for and
    no card is visible."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this program measures the card; "
                         "pass --device cpu to run it on the CPU")
    return device


def card_line(query: str = "name,power.limit") -> str:
    """nvidia-smi's `query` fields of the first card, as one csv line."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(
        ).splitlines()[0]


def device_summary(prof):
    """From a torch.profiler trace: the device's busy time in us (the union
    of its operations' intervals, so that overlapping operations count
    once), the sum of the operations' own times, their count, and
    {name: [us, n]}."""
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


def profile_steps(fn, steps: int, outdir: Optional[str] = None,
                  top: int = 40):
    """Run fn() (which does `steps` steps) under torch.profiler; print the
    wall and device ms per step, the device's busy share and the `top`
    device operations by their own time (on the CPU: the top CPU
    operations, the device's numbers not measured). With `outdir`, the
    Chrome trace goes to outdir/trace.json. Returns {wall_ms, device_ms,
    busy_ms, device_ops} per step (the device's None on the CPU)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(outdir, "trace.json"))
    out = {"wall_ms": wall / steps * 1e3, "device_ms": None, "busy_ms": None,
           "device_ops": None}
    if not cuda:
        print(f"profile: {steps} steps, wall {out['wall_ms']:.3f} ms/step; "
              "device time not measured (CPU)")
        print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                        row_limit=top))
        return out
    busy, total, n_ops, by_name = device_summary(prof)
    if not n_ops:
        print(f"profile: {steps} steps, wall {out['wall_ms']:.3f} ms/step; "
              "torch.profiler recorded no device operation: device time "
              "not measured")
        return out
    out.update(device_ms=total / 1e3 / steps, busy_ms=busy / 1e3 / steps,
               device_ops=n_ops / steps)
    print(f"profile: {steps} steps, wall {out['wall_ms']:.3f} ms/step, "
          f"device {out['device_ms']:.3f} ms/step, busy "
          f"{busy / 1e6 / wall * 100:.1f}% of the wall time, "
          f"{out['device_ops']:.0f} device operations per step")
    print(f"{'device op':<72} {'ms/step':>9} {'n/step':>7} {'%':>6}")
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        print(f"{name[:72]:<72} {us / 1e3 / steps:9.3f} {n / steps:7.1f} "
              f"{100 * us / max(total, 1e-9):6.1f}")
    return out
