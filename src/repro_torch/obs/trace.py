"""Typed lifecycle-event tracing for the serving engine.

``TraceRecorder`` is a bounded ring buffer of ``TraceEvent``s behind one
lock.  The engine holds exactly one recorder and calls ``emit`` at every
lifecycle point unconditionally — a disabled recorder (``EngineConfig.trace``
off, the default) returns after a single attribute check, which keeps the
call sites branch-free.  The port holds no gate on the *enabled* overhead:
an enabled recorder takes a lock and appends a tuple per event.

Timestamps come from the engine's ``Clock`` (``bind_clock``): under a
``VirtualClock`` the single-threaded scheduler emits a deterministic
sequence — two replays of the same burst produce byte-identical
``lines()`` — while the threaded engine stamps real wall offsets (its
interleaving is real concurrency and therefore not replay-stable; the
conservation invariant below still holds).

Event taxonomy (``KIND_*`` constants): every submitted request terminates
in *exactly one* event from ``TERMINAL_KINDS`` — ``complete``, ``reject``,
``deadline``, ``cancel`` or ``failed`` — mirroring the engine's
exactly-once future resolution (tests/test_obs.py asserts conservation,
including under sampled FaultPlan chaos).

The ``span`` kind is not the engine's: ``obs.spans`` keeps one
process-level recorder of the program's stage spans (``KIND_SPAN``), each
event stamped at the span's start on ``time.perf_counter``'s clock, with
its root call's id as ``rid``.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["TraceEvent", "TraceRecorder", "TERMINAL_KINDS",
           "KIND_SUBMIT", "KIND_QUEUE_FULL", "KIND_WINDOW", "KIND_ADMIT",
           "KIND_DEGRADE", "KIND_DISPATCH", "KIND_BATCH_DONE", "KIND_RETRY",
           "KIND_COMPLETE", "KIND_REJECT", "KIND_DEADLINE", "KIND_CANCEL",
           "KIND_FAILED", "KIND_SWEEP", "KIND_LANE_DEATH", "KIND_HANG",
           "KIND_LANE_RESTART", "KIND_ROUND", "KIND_DRAIN", "KIND_SHUTDOWN",
           "KIND_CHUNK_START", "KIND_CHUNK_DONE", "KIND_MID_EVICT",
           "KIND_SPAN"]

# -- lifecycle event kinds ---------------------------------------------------
KIND_SUBMIT = "submit"            # request entered the queue
KIND_QUEUE_FULL = "queue_full"    # live submission refused (backpressure)
KIND_WINDOW = "window"            # FIFO window taken from the queue
KIND_ADMIT = "admit"              # window survived SLO filter + was binned
KIND_DEGRADE = "degrade"          # request degraded to fewer timesteps
KIND_DISPATCH = "dispatch"        # micro-batch handed to a lane
KIND_BATCH_DONE = "batch_done"    # lane finished a micro-batch
KIND_RETRY = "retry"              # lane execution attempt failed + retried
KIND_COMPLETE = "complete"        # terminal: request served
KIND_REJECT = "reject"            # terminal: SLO admission drop
KIND_DEADLINE = "deadline"        # terminal: deadline expired / unmeetable
KIND_CANCEL = "cancel"            # terminal: client cancelled
KIND_FAILED = "failed"            # terminal: engine-fatal (all lanes dead)
KIND_SWEEP = "sweep"              # deadline sweep dropped queued requests
KIND_LANE_DEATH = "lane_death"    # lane exhausted retries / crashed
KIND_HANG = "hang"                # busy lane escalated as presumed hung
KIND_LANE_RESTART = "lane_restart"  # supervised lane recovery
KIND_ROUND = "round"              # admission round accounting closed
KIND_DRAIN = "drain"              # scheduler loop drained and exited
KIND_SHUTDOWN = "shutdown"        # shutdown requested (live engine)
# chunked continuous batching (EngineConfig.chunk_timesteps): a request's
# T runs as several chunk dispatches with rescheduling at the boundaries
KIND_CHUNK_START = "chunk_start"  # a request began a timestep chunk
KIND_CHUNK_DONE = "chunk_done"    # a request finished a chunk (t_served)
KIND_MID_EVICT = "mid_evict"      # partially-served request evicted at a
#                                 # chunk boundary (cancel/deadline); the
#                                 # matching TERMINAL event still fires
# the program's stage spans (``obs.spans``), in a recorder of their own
KIND_SPAN = "span"                # a span closed (name, start/end ns,
#                                 # parent, thread; rid = root call id)

#: The kinds that resolve a request; each rid gets exactly one of these.
TERMINAL_KINDS = frozenset(
    {KIND_COMPLETE, KIND_REJECT, KIND_DEADLINE, KIND_CANCEL, KIND_FAILED})


@dataclass(frozen=True)
class TraceEvent:
    """One engine lifecycle event.

    ``data`` is a sorted tuple of (key, value) pairs rather than a dict so
    events are hashable, immutable, and render deterministically."""

    seq: int                          # recorder-assigned monotone sequence
    ts: float                         # engine-clock seconds
    kind: str                         # one of the KIND_* constants
    lane: Optional[int] = None
    rid: Optional[int] = None
    data: Tuple[Tuple[str, Any], ...] = ()

    def get(self, key: str, default: Any = None) -> Any:
        for k, v in self.data:
            if k == key:
                return v
        return default

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"seq": self.seq, "ts": self.ts,
                             "kind": self.kind}
        if self.lane is not None:
            d["lane"] = self.lane
        if self.rid is not None:
            d["rid"] = self.rid
        d.update(dict(self.data))
        return d


def format_event(ev: TraceEvent) -> str:
    """One deterministic text line per event (the byte-identical unit the
    determinism test compares): fixed-precision timestamp, kind, then
    lane/rid/data fields in a stable order."""
    parts = [f"{ev.ts:.9f}", ev.kind]
    if ev.lane is not None:
        parts.append(f"lane={ev.lane}")
    if ev.rid is not None:
        parts.append(f"rid={ev.rid}")
    for k, v in ev.data:
        if isinstance(v, float):
            parts.append(f"{k}={v:.9f}")
        else:
            parts.append(f"{k}={v}")
    return " ".join(parts)


class TraceRecorder:
    """Thread-safe bounded ring buffer of ``TraceEvent``s.

    ``capacity`` bounds memory: once full, the oldest events are evicted
    and counted in ``dropped`` (the conservation tests size the buffer to
    the burst).  ``enabled=False`` turns ``emit`` into a single-attribute
    no-op so an untraced engine pays nothing.
    """

    # lock discipline (checked by repro.analysis rule "lock-discipline"):
    # lanes/clients emit concurrently while readers snapshot the ring
    _GUARDED_BY = {"_buf": "_lock", "_seq": "_lock", "dropped": "_lock"}

    def __init__(self, capacity: int = 65536, *, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._buf: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.dropped = 0
        self._clock = None

    def bind_clock(self, clock) -> None:
        """Attach the engine clock ``emit`` stamps from when no explicit
        ``t`` is passed (the engine binds at loop start, so pre-run events
        carry their request's arrival time instead)."""
        self._clock = clock

    def emit(self, kind: str, *, t: Optional[float] = None,
             lane: Optional[int] = None, rid: Optional[int] = None,
             **data: Any) -> None:
        if not self.enabled:
            return
        if t is None:
            t = self._clock.now() if self._clock is not None else 0.0
        ev_data = tuple(sorted(data.items()))
        with self._lock:
            seq = self._seq
            self._seq += 1
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(TraceEvent(seq=seq, ts=float(t), kind=kind,
                                        lane=lane, rid=rid, data=ev_data))

    # -- reading -------------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def events(self, kind: Optional[str] = None) -> List[TraceEvent]:
        """A stable snapshot of the buffer (oldest first), optionally
        filtered by kind."""
        with self._lock:
            evs = list(self._buf)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        return evs

    def lines(self) -> List[str]:
        """Deterministic one-line-per-event rendering (see
        ``format_event``); under a VirtualClock two replays of the same
        burst produce byte-identical lists."""
        return [format_event(e) for e in self.events()]

    def terminal_rids(self) -> Dict[int, List[str]]:
        """rid -> list of terminal event kinds it received (conservation:
        every submitted rid should map to exactly one)."""
        out: Dict[int, List[str]] = {}
        for e in self.events():
            if e.kind in TERMINAL_KINDS and e.rid is not None:
                out.setdefault(e.rid, []).append(e.kind)
        return out

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0
