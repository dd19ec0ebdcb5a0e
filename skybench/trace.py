"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a
stretch of the window, read in memory (no Chrome trace is written).

The benchmark opens host spans of its own (``span``: a
``torch.profiler.record_function`` named ``skybench.<call>``) around each
call it makes into the program.  From the profiler's events ``Trace.read``
takes:

- the traced window: the ``skybench.window`` span's start and end;
- device busy time: the union of the intervals of every device event
  (kernels, copies, sets) clipped to the window;
- the device operations that took most time, by name;
- the idle gaps of the device, each charged to the innermost benchmark
  span open at its middle ("(no span)" where none is), summed by span.
"""
from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

__all__ = ["Trace", "TraceReading", "span", "union_gaps"]

WINDOW = "skybench.window"


def span(name: str, on: bool):
    """A host span named ``skybench.<name>`` while tracing, else nothing."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(f"skybench.{name}")


class TraceReading(NamedTuple):
    window_s: float
    busy_s: float
    kernels: int                                  # device events
    device_ops: List[Tuple[str, float]]           # name, seconds
    idle_gaps: List[Tuple[str, float]]            # host span, seconds


def union_gaps(intervals, lo: float, hi: float):
    """(busy length, gaps) of the union of ``intervals`` clipped to
    [lo, hi]; gaps are (start, end) pairs."""
    busy, gaps, cur = 0.0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


class Trace:
    """Profiles from ``start`` to ``stop`` when ``on``; otherwise inert."""

    def __init__(self, on: bool, device: torch.device):
        self.on = on
        self.device = device
        self._prof = None
        self._span = None
        self.reading: Optional[TraceReading] = None
        self.stopped = False

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        """Profile nothing once, so that the profiler's own start-up
        (CUPTI's, seconds on a card) falls before the window."""
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            self._sync()

    def start(self) -> None:
        if not self.on or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._sync()
        self._span = torch.profiler.record_function(WINDOW)
        self._span.__enter__()

    @property
    def started(self) -> bool:
        return self._prof is not None

    @property
    def active(self) -> bool:
        """Between ``start`` and ``stop``."""
        return self._prof is not None and not self.stopped

    def stop(self) -> None:
        if not self.active:
            return
        self._sync()
        self._span.__exit__(None, None, None)
        self._span = None
        self._prof.stop()
        self.stopped = True

    def read(self) -> Optional[TraceReading]:
        """Reduce the profile (once); None when nothing was traced."""
        if self._prof is None:
            return None
        if self.reading is not None:
            return self.reading
        dev_type = torch.autograd.DeviceType.CUDA
        lo = hi = None
        device_ev, spans = [], []
        for ev in self._prof.events():
            tr = ev.time_range
            if ev.name == WINDOW and ev.device_type != dev_type:
                lo, hi = tr.start, tr.end
            elif ev.name.startswith("skybench."):
                if ev.device_type != dev_type:
                    spans.append((tr.start, tr.end, ev.name))
            elif ev.device_type == dev_type:
                device_ev.append((tr.start, tr.end, ev.name))
        self._prof = None            # the events are no longer needed
        if lo is None:
            return None
        busy, gaps = union_gaps([(s, e) for s, e, _ in device_ev], lo, hi)
        by_op: Dict[str, float] = {}
        for s, e, name in device_ev:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                by_op[name[:120]] = by_op.get(name[:120], 0.0) + (e - s)
        spans.sort()
        starts = [s for s, _, _ in spans]
        by_span: Dict[str, float] = {}
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            key = "(no span)"
            # the latest-started span open at ``mid``; the benchmark's
            # spans do not nest deeper than a few, so a short look back
            # finds it
            i = bisect.bisect_right(starts, mid)
            for s, e, name in reversed(spans[max(0, i - 64):i]):
                if e >= mid:
                    key = name
                    break
            by_span[key] = by_span.get(key, 0.0) + (g1 - g0)
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(by_span.items(), key=lambda kv: -kv[1])[:10]
        self.reading = TraceReading(
            window_s=(hi - lo) / 1e6, busy_s=busy / 1e6,
            kernels=sum(1 for s, e, _ in device_ev if s < hi and e > lo),
            device_ops=[(k, v / 1e6) for k, v in top],
            idle_gaps=[(k, v / 1e6) for k, v in idle])
        return self.reading
