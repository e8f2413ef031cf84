"""Spans, counters and profiler tracing of the port; grown from
``wildgs_slam_tpu/utils/profiling.py``'s phase timer.

- ``PhaseTimer`` (the process-global ``TIMER``) is the port's one tracer.
  ``phase(name)`` records a span on the host clock
  (``time.perf_counter_ns``) with its parent (the innermost open span; the
  port records spans from one thread) and the unit it works for
  (``unit(uid)``: the keyframe index in the mapper, the frame's timestamp
  in the tracker). Each name keeps
  exact aggregates: calls, the first call apart from the warm ones, the
  total and the self time (the total less its child spans' time). The
  records go into a ring of the last ``RING`` spans.

  - ``sync=True`` ends the span with ``torch.cuda.synchronize()`` (where
    CUDA is in use), so that it covers the device work it queued, at the
    price of a stall.
  - ``device=<the device the work runs on>`` adds the span's device
    interval. On a CUDA device it records a CUDA event pair (pooled) at the
    span's edges on the current stream and never synchronizes. ``reset()``
    synchronizes once and records an anchor event; a marker's time on the
    host clock is the anchor's host time plus its elapsed time from the
    anchor. Markers
    are resolved in ``summary()``, ``report()`` and ``write_trace()`` (and
    those already finished, without waiting, when many are pending).
    On the CPU, which runs each operation as it is issued, the device
    interval is the host interval, whether or not the machine has a card.
  - ``count(name, value)`` adds to a counter: a Python number on the host;
    a tensor is summed on its device in its own dtype, with one launch,
    into a slot of a device buffer, never read back until ``summary()``.
  - With ``enabled = False`` nothing is recorded and no CUDA event is
    created.

  ``summary()`` gives, per span name, ``count``, ``first_s``,
  ``warm_mean_ms``, ``total_s``, ``self_s`` and for spans given a device
  ``device_s``; per counter ``count`` (additions) and ``total``.
  ``unix_ns`` and ``profiler_clock`` put a host-clock reading on the Unix
  clock and on a torch.profiler trace's time base; ``write_trace`` writes
  the ring as Chrome-trace events that open beside torch's ``trace.json``.
- ``trace(logdir)``: a ``torch.profiler`` capture of the CPU and CUDA
  activity, written as a Chrome trace into logdir with the spans beside it.
- For the measuring programs (``bench.py``, ``scripts/``): ``run_device``
  (the card, or the CPU only when asked), ``card_line`` (the card's name and
  power limit as nvidia-smi reports them), ``device_summary`` and
  ``profile_steps`` (a torch.profiler trace's device time by operation).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import re
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

RING = 1 << 16          # span records kept
DRAIN = 1024            # pending markers that make the timer resolve the
                        # finished ones
COUNTER_SLOTS = 1024    # device sums a device counter holds before folding
HOST_TID, DEVICE_TID = 1 << 24, (1 << 24) + 1   # write_trace's tracks


@dataclass
class PhaseStat:
    count: int = 0
    total: float = 0.0
    first: float = 0.0
    warm_total: float = 0.0
    self_total: float = 0.0
    device: Optional[float] = None   # seconds between the device markers
    recent: List[float] = field(default_factory=list)

    @property
    def warm_count(self) -> int:
        return max(self.count - 1, 0)

    @property
    def warm_mean(self) -> float:
        return self.warm_total / self.warm_count if self.warm_count else 0.0

    def add(self, dt: float, self_dt: Optional[float] = None):
        self.count += 1
        self.total += dt
        self.self_total += dt if self_dt is None else self_dt
        if self.count == 1:
            self.first = dt
        else:
            self.warm_total += dt
            self.recent.append(dt)
            if len(self.recent) > 64:
                self.recent.pop(0)


class Span:
    """One span: the record the ring keeps, and the context manager that
    times it. Times are ``perf_counter_ns`` readings; ``d0``/``d1`` the
    device interval on the same clock once resolved (None before, and for
    spans without markers)."""

    __slots__ = ("name", "id", "parent", "unit", "t0", "t1", "child_ns",
                 "d0", "d1", "_timer", "_sync", "_marks")

    def __init__(self, timer, name, sync, device):
        self._timer, self.name, self._sync = timer, name, sync
        self._marks = device   # then: [ev0, ev1] on CUDA, () on the CPU,
                               # None without a device
        self.child_ns = 0
        self.d0 = self.d1 = None

    def __enter__(self):
        tm = self._timer
        stack = tm._stack
        self.parent = stack[-1].id if stack else None
        self.unit = tm._unit
        self.id = next(tm._ids)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        if self._marks is not None:
            self._marks = tm._mark_start(self._marks)
        return self

    def __exit__(self, *exc):
        tm = self._timer
        if self._marks:
            self._marks[1] = tm._event_recorded()
        if self._sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter_ns()
        stack = tm._stack
        stack.pop()
        dt = self.t1 - self.t0
        if stack:
            stack[-1].child_ns += dt
        tm._close(self, dt)
        return False


class _HostCounter:
    def __init__(self):
        self.records, self.value = 0, 0

    def add(self, v):
        self.records += 1
        self.value += v

    def total(self):
        return self.value


class _DeviceCounter:
    """Each addition sums its tensor, in its own dtype (a cast would be a
    launch of its own), into the next slot of a device buffer: one launch.
    A full buffer folds into a 64-bit running total (two launches per
    COUNTER_SLOTS additions)."""

    def __init__(self, like: torch.Tensor):
        self.buf = torch.zeros(COUNTER_SLOTS, dtype=like.dtype,
                               device=like.device)
        self.wide = (torch.float64 if like.is_floating_point()
                     else torch.int64)
        self.acc = torch.zeros((), dtype=self.wide, device=like.device)
        self.records = self.slot = 0

    def add(self, v: torch.Tensor):
        if self.slot == COUNTER_SLOTS:
            self.acc += self.buf.sum(dtype=self.wide)
            self.slot = 0
        torch.sum(v.reshape(-1), 0, dtype=self.buf.dtype,
                  out=self.buf[self.slot])
        self.slot += 1
        self.records += 1

    def total(self):
        return (self.acc + self.buf[:self.slot].sum(dtype=self.wide)).item()


def _clock_pair():
    """(perf_counter_ns, time_ns) read together."""
    p0 = time.perf_counter_ns()
    u = time.time_ns()
    return (p0 + time.perf_counter_ns()) // 2, u


class PhaseTimer:
    def __init__(self):
        self.stats: Dict[str, PhaseStat] = {}
        self.counters: Dict = {}
        self.records = collections.deque(maxlen=RING)
        self.enabled = True
        self._stack: List[Span] = []          # open spans, innermost last
        self._unit = None
        self._ids = itertools.count()
        self._pending = collections.deque()   # spans with markers to resolve
        self._drain_at = DRAIN
        self._pool: list = []                 # finished CUDA events
        self._anchor = None                   # (event, its perf_counter_ns)
        self._clock = _clock_pair()

    # ---- recording ---------------------------------------------------

    def phase(self, name: str, sync: bool = False, device=None):
        """A span named `name` around the `with` block; `device` (a
        ``torch.device`` or its name) is where its work runs."""
        if not self.enabled:
            return contextlib.nullcontext()
        return Span(self, name, sync, device)

    @contextlib.contextmanager
    def unit(self, uid):
        """Spans opened inside the block work for unit `uid`."""
        prev, self._unit = self._unit, uid
        try:
            yield
        finally:
            self._unit = prev

    def add(self, name: str, dt: float):
        """Record one call of `dt` seconds timed elsewhere."""
        self.stats.setdefault(name, PhaseStat()).add(dt)

    def count(self, name: str, value=1):
        """Add `value` (a number, or a tensor summed on its device) to the
        counter `name`."""
        if not self.enabled:
            return
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = (
                _DeviceCounter(value) if isinstance(value, torch.Tensor)
                else _HostCounter())
        c.add(value)

    def _close(self, span: Span, dt: int):
        st = self.stats.get(span.name)
        if st is None:
            st = self.stats[span.name] = PhaseStat()
        st.add(dt / 1e9, (dt - span.child_ns) / 1e9)
        self.records.append(span)
        marks = span._marks
        if marks == ():        # the CPU is the device
            span.d0, span.d1 = span.t0, span.t1
            st.device = (st.device or 0.0) + dt / 1e9
        elif marks:
            self._pending.append(span)
            if len(self._pending) >= self._drain_at:
                self._resolve(block=False)
                self._drain_at = len(self._pending) + DRAIN

    # ---- device markers ------------------------------------------------

    def _event_recorded(self):
        ev = (self._pool.pop() if self._pool
              else torch.cuda.Event(enable_timing=True))
        ev.record()
        return ev

    def _mark_start(self, device):
        if torch.device(device).type != "cuda":
            return ()
        if self._anchor is None:
            self._set_anchor()
        return [self._event_recorded(), None]

    def _set_anchor(self):
        """Synchronize, then record an event and wait for it, three times;
        the anchor is the try with the shortest record-and-wait, its host
        time the wait's return (the spinning wait returns within
        microseconds of the event; the record reaches the idle device tens
        of microseconds after it is issued, so the middle of the try reads
        early on the card)."""
        torch.cuda.synchronize()
        best = None
        for _ in range(3):
            ev = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter_ns()
            ev.record()
            ev.synchronize()
            h1 = time.perf_counter_ns()
            if best is None or h1 - h0 < best[2]:
                best = (ev, h1, h1 - h0)
        self._anchor = best[:2]

    def _resolve(self, block: bool = True):
        """Device intervals of the pending spans: all of them after a
        synchronize (`block`), else those whose end marker has passed."""
        pend = self._pending
        if not pend:
            return
        if block:
            torch.cuda.synchronize()
        if self._anchor is None:     # reset() while a marked span was open
            self._set_anchor()
        anchor, anchor_ns = self._anchor
        while pend:
            span = pend[0]
            ev0, ev1 = span._marks
            if not block and not ev1.query():
                break
            pend.popleft()
            span.d0 = anchor_ns + round(anchor.elapsed_time(ev0) * 1e6)
            span.d1 = span.d0 + round(ev0.elapsed_time(ev1) * 1e6)
            st = self.stats[span.name]
            st.device = (st.device or 0.0) + (span.d1 - span.d0) / 1e9
            self._pool += (ev0, ev1)
            span._marks = None

    def reset(self):
        """Forget every span and counter; a new anchor and clock pair."""
        if self._pending:
            torch.cuda.synchronize()
            for span in self._pending:
                self._pool += span._marks
                span._marks = None
            self._pending.clear()
        self.stats.clear()
        self.counters.clear()
        self.records.clear()
        self._drain_at = DRAIN
        self._anchor = None
        self._clock = _clock_pair()
        if (self.enabled and torch.cuda.is_available()
                and torch.cuda.is_initialized()):
            self._set_anchor()

    # ---- clocks ----------------------------------------------------------

    def unix_ns(self, perf_ns: int) -> int:
        """A ``perf_counter_ns`` reading on the Unix clock (``time_ns``),
        through the pair read at the last ``reset()``."""
        p, u = self._clock
        return u + perf_ns - p

    def profiler_clock(self, prof) -> Callable[[int], float]:
        """perf_counter_ns -> microseconds on the time base of a finished
        ``torch.profiler.profile``'s events (``time_range``): the Unix
        clock from the trace's start."""
        start = prof.profiler.kineto_results.trace_start_ns()
        return lambda ns: (self.unix_ns(ns) - start) / 1e3

    # ---- reading ---------------------------------------------------------

    def report(self) -> str:
        self._resolve()
        if not self.stats and not self.counters:
            return "(no phases recorded)"
        rows = [("phase", "calls", "first[s]", "warm mean[ms]",
                 "warm last10[ms]", "total[s]", "self[s]", "device[s]")]
        for name in sorted(self.stats, key=lambda n: -self.stats[n].total):
            s = self.stats[name]
            last10 = (sum(s.recent[-10:]) / len(s.recent[-10:]) * 1e3
                      if s.recent else 0.0)
            rows.append((name, str(s.count), f"{s.first:.3f}",
                         f"{s.warm_mean * 1e3:.2f}", f"{last10:.2f}",
                         f"{s.total:.2f}", f"{s.self_total:.2f}",
                         "-" if s.device is None else f"{s.device:.2f}"))
        out = _table(rows) if self.stats else ""
        if self.counters:
            crows = [("counter", "additions", "total", "per addition")]
            for name in sorted(self.counters):
                c = self.counters[name]
                v = c.total()
                crows.append((name, str(c.records), f"{v:g}",
                              f"{v / max(c.records, 1):.4g}"))
            out = (out + "\n\n" if out else "") + _table(crows)
        return out

    def write(self, path: str):
        with open(path, "w") as f:
            f.write(self.report() + "\n")

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{span: count, first_s, warm_mean_ms, total_s, self_s[, device_s]}
        and {counter: count, total}."""
        self._resolve()
        out = {}
        for name, s in self.stats.items():
            out[name] = {"count": s.count, "first_s": s.first,
                         "warm_mean_ms": s.warm_mean * 1e3,
                         "total_s": s.total, "self_s": s.self_total}
            if s.device is not None:
                out[name]["device_s"] = s.device
        for name, c in self.counters.items():
            out[name] = {"count": c.records, "total": c.total()}
        return out

    def write_trace(self, path: str, base_ns: int = 0):
        """The ring's spans, and their device intervals, as Chrome-trace
        events in the process of torch.profiler's host events: ``ts`` in
        microseconds on the Unix clock from `base_ns` (a torch trace's
        ``baseTimeNanoseconds``, ``chrome_base_ns``)."""
        self._resolve()
        pid = os.getpid()

        def us(ns):
            return (self.unix_ns(ns) - base_ns) / 1e3
        events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": label}}
                  for tid, label in ((HOST_TID, "program spans"),
                                     (DEVICE_TID, "program device markers"))]
        for sp in self.records:
            args = {"id": sp.id, "parent": sp.parent, "unit": sp.unit}
            events.append({"ph": "X", "cat": "span", "name": sp.name,
                           "pid": pid, "tid": HOST_TID, "ts": us(sp.t0),
                           "dur": (sp.t1 - sp.t0) / 1e3, "args": args})
            if sp.d0 is not None:
                events.append({"ph": "X", "cat": "device", "name": sp.name,
                               "pid": pid, "tid": DEVICE_TID,
                               "ts": us(sp.d0), "dur": (sp.d1 - sp.d0) / 1e3,
                               "args": args})
        with open(path, "w") as f:
            json.dump({"displayTimeUnit": "ms", "baseTimeNanoseconds":
                       base_ns, "traceEvents": events}, f)


def _table(rows) -> str:
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines = []
    for i, r in enumerate(rows):
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
        if i == 0:
            lines.append("-" * (sum(widths) + 2 * (len(widths) - 1)))
    return "\n".join(lines)


# Process-global tracer of the port; tests and scripts may reset it.
TIMER = PhaseTimer()


def chrome_base_ns(path: str) -> int:
    """The ``baseTimeNanoseconds`` a torch Chrome trace states near its
    head (0 where it states none: its ``ts`` are then Unix
    microseconds)."""
    with open(path, "rb") as f:
        m = re.search(rb'"baseTimeNanoseconds":\s*(\d+)', f.read(1 << 16))
    return int(m.group(1)) if m else 0


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Capture a torch.profiler trace into logdir/trace.json if set, else
    no-op; the TIMER's spans go beside it, into logdir/spans.json."""
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
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    TIMER.write_trace(os.path.join(logdir, "spans.json"),
                      chrome_base_ns(path))


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
