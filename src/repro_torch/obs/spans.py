"""Spans of the program's stages, on the profiler's clock.

``span(name)`` is a context manager around one stage of a call
(``Session.infer``'s staging, forward, wait and readback; a train step's
forward, backward and weight gradient; the model's counting work).  It
records only while a ``torch.profiler`` session records, so any profile of
the program shows its stages beside the device ops, and nothing else turns
it on.  Off, a span costs one read of torch's profiler flag (``tracing``)
and hands back a shared null context.

On, a span named ``<name>`` does three things:

- it opens a range ``repro_torch.<name>`` in the same profile as the
  device ops, on its clock (``RANGE``: a host range that the profiler does
  not copy onto the device's timeline, so that the spans add no device
  event to a profile; ``torch.profiler.record_function`` makes a user
  annotation, which the profiler mirrors as a ``gpu_user_annotation``
  device event over the kernels launched inside it);
- it adds a ``span`` event to one process-level ``TraceRecorder`` (the
  engine's ring buffer, ``obs.trace``): the name, start and end from
  ``time.perf_counter_ns``, the parent span, the root call's id and the
  thread;
- given ``device=`` a CUDA tensor or device, it records a pair of timing
  CUDA events on that device's current stream, from a reused pool, read
  as milliseconds only when the spans are read.  Such a time runs from
  the moment the stream reaches the first event to the moment it passes
  the second: where the stream waits for the host's launches inside the
  span, the wait is in it.  Elsewhere the device time is ``None``.

A span's parent is the innermost span open on its thread.  A span opened
on a thread with none open, while a root call (``root=True``:
``Session.infer``, ``Session.train_step``) is open on another, takes the
innermost span open on the root's thread as its parent: the weight
gradient, which autograd runs on a thread of its own on a card, is then a
child of the train step's backward, as it is on the CPU, where autograd
runs on the caller's thread.

Beside the ring, running totals per name (count, host time, self time,
device time) are kept, so that a reading never depends on the ring's
capacity; events the ring evicted are counted.
``read_spans`` is the one reading; ``reset_spans`` starts the totals anew.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

from repro_torch.obs.trace import KIND_SPAN, TraceEvent, TraceRecorder

__all__ = ["PREFIX", "span", "tracing", "read_spans", "reset_spans",
           "SpanReading", "SpanTotal"]

PREFIX = "repro_torch."
RING_CAPACITY = 65536       # span events kept for a timeline
# device-timed spans whose events wait to be read before those the device
# has passed are read at a span's close: enough that a profile of seconds
# reads them only when it is read, not inside the traced stretch
RESOLVE_AFTER = 16384

_NULL = contextlib.nullcontext()
# the range each span opens (see the module's docstring): a host-only
# range, a tenth of ``record_function``'s cost
RANGE = torch._C._profiler._RecordFunctionFast


def tracing() -> bool:
    """Whether a ``torch.profiler`` session is recording: the flag torch
    keeps for cheap checks (the one line a torch upgrade may change)."""
    return _profiler._is_profiler_enabled


class SpanTotal(NamedTuple):
    """One span name's totals over the spans closed since the last
    ``reset_spans``."""

    count: int
    host_ms: float          # wall time between open and close, summed
    self_ms: float          # host_ms less the host time of its children
    device_ms: Optional[float]   # None unless every span was device-timed


class SpanReading(NamedTuple):
    totals: Dict[str, SpanTotal]    # by full name (``repro_torch.<name>``)
    events: List[TraceEvent]        # the ring's ``span`` events, oldest first
    dropped: int                    # events the ring evicted

    def per_call(self, root: str, *names: str,
                 device: bool = False) -> Optional[float]:
        """The host (or ``device``) ms of the spans ``names`` together, per
        span ``root`` closed: None where no ``root`` or none of ``names``
        closed, or where a device time is missing (the CPU)."""
        calls = self.totals.get(root)
        got = [self.totals[n] for n in names if n in self.totals]
        if calls is None or not calls.count or not got:
            return None
        if device:
            if any(t.device_ms is None for t in got):
                return None
            return sum(t.device_ms for t in got) / calls.count
        return sum(t.host_ms for t in got) / calls.count


class _Span:
    """One open span: a context manager of its ``SpanBook``."""

    __slots__ = ("book", "name", "device", "root", "parent", "root_id",
                 "start", "child_ns", "rf", "events")

    def __init__(self, book: "SpanBook", name: str, device, root: bool):
        self.book = book
        self.name = name
        self.device = device
        self.root = root
        self.child_ns = 0
        self.events = None

    def __enter__(self):
        self.book._open(self)
        return self

    def __exit__(self, *exc):
        self.book._close(self)
        return False


class SpanBook:
    """The spans' state: the ring, the totals, the device events waiting
    to be read and the open root call."""

    # lock discipline: spans close on any thread while a reader reads
    _GUARDED_BY = {"_totals": "_lock", "_pending": "_lock", "_pool": "_lock",
                   "_roots": "_lock", "_root_stack": "_lock"}

    def __init__(self, capacity: int = RING_CAPACITY):
        self.recorder = TraceRecorder(capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        # name -> [count, host ns, self ns, device ms, spans not timed]
        self._totals: Dict[str, list] = {}
        self._pending: deque = deque()     # (name, start event, end event)
        self._pool: List = []
        self._roots = 0
        self._root_stack: Optional[list] = None

    def span(self, name: str, *, device=None, root: bool = False) -> _Span:
        """A span named ``name`` (in full) in this book, whether or not
        the profiler records."""
        return _Span(self, name, device, root)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, sp: _Span) -> None:
        stack = self._stack()
        parent = stack[-1] if stack else None
        if parent is None and not sp.root:
            with self._lock:
                other = self._root_stack
                parent = other[-1] if other else None
        if sp.root:
            with self._lock:
                self._roots += 1
                sp.root_id = self._roots
                if self._root_stack is None:
                    self._root_stack = stack
        else:
            sp.root_id = parent.root_id if parent is not None else None
        sp.parent = parent
        if sp.device is not None:
            dev = sp.device.device if isinstance(sp.device, torch.Tensor) \
                else torch.device(sp.device)
            if dev.type == "cuda":
                with self._lock:
                    pool = self._pool
                    pair = [pool.pop() if pool else
                            torch.cuda.Event(enable_timing=True)
                            for _ in range(2)]
                sp.events = (pair[0], pair[1], torch.cuda.current_stream(dev))
        sp.rf = RANGE(sp.name)
        sp.rf.__enter__()
        stack.append(sp)
        if sp.events is not None:
            sp.events[0].record(sp.events[2])
        # spans time the host on the profiler's wall clock, and record only
        # under a profiler, never inside an engine's virtual replay
        sp.start = time.perf_counter_ns()  # lint: allow(clock-discipline)

    def _close(self, sp: _Span) -> None:
        end = time.perf_counter_ns()  # lint: allow(clock-discipline)
        if sp.events is not None:
            sp.events[1].record(sp.events[2])
        stack = self._stack()
        stack.pop()
        sp.rf.__exit__(None, None, None)
        host = end - sp.start
        parent = sp.parent
        with self._lock:
            if self._root_stack is stack and not stack:
                self._root_stack = None
            tot = self._totals.get(sp.name)
            if tot is None:
                tot = self._totals[sp.name] = [0, 0, 0, 0.0, 0]
            tot[0] += 1
            tot[1] += host
            tot[2] += host - sp.child_ns
            if parent is not None:
                parent.child_ns += host
            if sp.events is None:
                tot[4] += 1
            else:
                self._pending.append((sp.name,) + sp.events[:2])
            resolve = len(self._pending) > RESOLVE_AFTER
        if resolve:
            self._resolve(wait=False)
        self.recorder.emit(
            KIND_SPAN, t=sp.start * 1e-9, rid=sp.root_id, name=sp.name,
            start_ns=sp.start, end_ns=end,
            parent=parent.name if parent is not None else None,
            thread=threading.get_ident())

    def _resolve(self, wait: bool) -> None:
        """Add the device times of the waiting pairs to the totals, oldest
        first: all of them (``wait``), or those the device has passed."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                name, start, end = self._pending[0]
                if not wait and not end.query():
                    return
                self._pending.popleft()
            end.synchronize()
            ms = start.elapsed_time(end)
            with self._lock:
                tot = self._totals.get(name)
                if tot is not None:          # else reset in the meantime
                    tot[3] += ms
                self._pool.extend((start, end))

    def read(self) -> SpanReading:
        self._resolve(wait=True)
        with self._lock:
            totals = {
                name: SpanTotal(count=c, host_ms=h * 1e-6, self_ms=s * 1e-6,
                                device_ms=None if untimed else d)
                for name, (c, h, s, d, untimed) in self._totals.items()}
        return SpanReading(totals=totals,
                           events=self.recorder.events(KIND_SPAN),
                           dropped=self.recorder.dropped)

    def reset(self) -> None:
        self._resolve(wait=True)
        with self._lock:
            self._totals.clear()
        self.recorder.clear()


# The profiler is process-wide, and so are the spans it turns on.
_BOOK = SpanBook()


def span(name: str, *, device=None, root: bool = False):
    """A span named ``repro_torch.<name>`` while the profiler records,
    else a shared null context.  ``device``: a tensor or device that the
    span's work runs on; on a CUDA device the span is also timed there.
    ``root``: the span is a call of the program's facade, which the
    spans inside it, and spans opened on other threads meanwhile, count
    as theirs."""
    if not tracing():
        return _NULL
    return _Span(_BOOK, PREFIX + name, device, root)


def read_spans() -> SpanReading:
    """The totals and events of every span closed since the last
    ``reset_spans`` (or since the process started).  Waits for the device
    to pass the device-timed spans' events."""
    return _BOOK.read()


def reset_spans() -> None:
    """Start the totals and the ring anew."""
    _BOOK.reset()
