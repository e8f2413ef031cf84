"""Per-phase timing and profiler tracing; the port's own copy of
``wildgs_slam_tpu/utils/profiling.py``.

- ``PhaseTimer``: named phases timed on the host clock, the first call kept
  apart from the warm calls. ``phase(name, sync=True)`` ends with
  ``torch.cuda.synchronize()`` where the JAX version blocked on its arrays,
  so the phase covers the device work it queued.
- ``trace(logdir)``: a ``torch.profiler`` capture of the CPU and CUDA
  activity, written as a Chrome trace into logdir.
"""

from __future__ import annotations

import contextlib
import os
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
