"""Reading a torch.profiler trace of a stretch of the window.

``device_summary`` is a copy of ``wildgs_slam_tpu_torch/utils/profiling.py
::device_summary``: the device's busy time is the union of its operations'
intervals, so overlapping operations count once. ``Stretch`` starts the
profiler after a synchronisation and stops it after another, and ``summary``
reduces it to what the per-layer metrics and the result's ``breakdown``
read: busy and wall seconds, operation count, time by device operation, and
the longest idle gaps by the CUDA runtime call the host was in when each
began ("python" where it was in none: the host's own work between two
calls). The profiler records the CUDA activity alone, kernels and runtime
calls: recording every host operation of a launch-bound step as well
doubles the step's wall time (a chip run of the mapping step: 53.7 against
27.1 ms) and so the device's idle share.
"""

from __future__ import annotations

import time

import numpy as np
import torch

TOP = 10            # entries of each breakdown list
GAPS_LABELLED = 500  # the longest gaps, labelled by the host's operation


def device_summary(prof):
    """(busy us, summed us, operation count, {name: [us, n]}, sorted device
    intervals) of a torch.profiler trace."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            s = by_name.setdefault(e.name, [0.0, 0])
            s[0] += e.time_range.elapsed_us()
            s[1] += 1
    spans.sort()
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    total = sum(us for us, _ in by_name.values())
    return busy, total, len(spans), by_name, spans


def idle_gaps(prof, spans):
    """[[host call, seconds], ...]: the device's idle gaps between its
    first and last operation, the GAPS_LABELLED longest of them labelled by
    the innermost host event (a CUDA runtime call) running where the gap
    begins ("python" where none is), summed by label, the TOP largest."""
    from torch.autograd import DeviceType

    gaps, end = [], None
    for a, b in spans:
        if end is not None and a > end:
            gaps.append((a - end, end))
        end = b if end is None else max(end, b)
    if not gaps:
        return []
    cpu = [(e.time_range.start, e.time_range.end, e.name)
           for e in prof.events() if e.device_type == DeviceType.CPU]
    starts = np.array([c[0] for c in cpu], np.float64)
    ends = np.array([c[1] for c in cpu], np.float64)
    by_label = {}
    for length, at in sorted(gaps, reverse=True)[:GAPS_LABELLED]:
        cover = np.nonzero((starts <= at) & (ends >= at))[0]
        label = (cpu[cover[np.argmax(starts[cover])]][2] if cover.size
                 else "python")
        by_label[label] = by_label.get(label, 0.0) + length / 1e6
    return [[k, v] for k, v in sorted(by_label.items(),
                                      key=lambda kv: -kv[1])[:TOP]]


class Stretch:
    """A profiled stretch: ``start()`` and ``stop()`` synchronise the device
    and read the host clock, so that ``wall_s`` covers the work launched in
    between."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None
        self.wall_s = None
        self._t0 = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            acts = [ProfilerActivity.CUDA]
        self.prof = profile(activities=acts)
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.stop()

    def summary(self):
        busy, total, n_ops, by_name, spans = device_summary(self.prof)
        return dict(
            busy_s=busy / 1e6, device_sum_s=total / 1e6, n_ops=n_ops,
            wall_s=self.wall_s, by_name={k: v[0] / 1e6 for k, v in
                                         by_name.items()},
            device_ops=[[k, v[0] / 1e6] for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1][0])[:TOP]],
            idle_gaps=idle_gaps(self.prof, spans))


def kernel_seconds(by_name: dict, fragments) -> float:
    """Device seconds of the operations whose names hold one of
    `fragments`."""
    return sum(s for name, s in by_name.items()
               if any(f in name for f in fragments))
