"""Multi-replica lane dispatch: execution, straggler detection, failure/retry.

Each serving lane is a replica that executes one micro-batch per admission
round.  The dispatcher

  * times every lane execution and feeds *work-normalized* times (seconds per
    unit of predicted workload) into ``runtime.straggler.StragglerMonitor`` —
    the identical balance math the training fleet uses, reused at request
    granularity;
  * ranks lanes fastest-first from the monitor's EWMAs so the engine can
    re-run CBWS placement over measured per-lane latencies (heaviest
    micro-batch onto the fastest lane);
  * wraps lane execution in ``runtime.fault_tolerance.call_with_retry``; a
    lane that exhausts its retry budget is marked dead (``LaneFailed``) and
    the engine re-queues its micro-batch on the survivors.

Thread-safety: in the threaded engine ``execute`` runs on the lane worker
threads (marking a lane dead races the scheduler reading ``alive()``), so
all lane-state access holds ``_lock``; the straggler monitor carries its own
lock.  The virtual-clock engine is single-threaded and pays only an
uncontended lock.

``fault_hook(lane, attempt)`` is a test/chaos injection point called before
every execution attempt; raising from it simulates a lane failure.  In the
threaded engine it is called *from the worker thread mid-flight* — chaos
hooks that keep state must synchronize.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.runtime.fault_tolerance import RetryPolicy, call_with_retry
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.serving.clock import WallClock

__all__ = ["LaneFailed", "LaneDispatcher"]


class LaneFailed(RuntimeError):
    """A lane exhausted its retry budget; its work must be re-queued."""

    def __init__(self, lane: int, cause: Exception):
        super().__init__(f"lane {lane} failed: {cause!r}")
        self.lane = lane
        self.cause = cause


@dataclass
class _Lane:
    free_at: float = 0.0          # engine time the lane next frees (virtual)
    alive: bool = True
    served: int = 0               # requests completed
    busy_s: float = 0.0           # accumulated measured service time


class LaneDispatcher:
    # lock discipline (checked by repro.analysis rule "lock-discipline"):
    # lane state is mutated by worker threads and read by the scheduler
    _GUARDED_BY = {"lanes": "_lock"}

    def __init__(self, num_lanes: int, *, retry: RetryPolicy = RetryPolicy(),
                 straggler_z: float = 3.0,
                 fault_hook: Optional[Callable[[int, int], None]] = None,
                 sleep_fn: Optional[Callable[[float], None]] = None):
        self.lanes = [_Lane() for _ in range(num_lanes)]
        self.retry = retry
        self.monitor = StragglerMonitor(num_lanes, z_thresh=straggler_z)
        self.fault_hook = fault_hook
        self.sleep_fn = sleep_fn          # retry-backoff sleep (engine clock)
        self.flagged: List[int] = []      # latest straggler verdict
        self._lock = threading.Lock()

    # -- lane state ---------------------------------------------------------
    def alive(self) -> List[int]:
        with self._lock:
            return [i for i, l in enumerate(self.lanes) if l.alive]

    def ready(self, t: float) -> List[int]:
        with self._lock:
            return [i for i, l in enumerate(self.lanes)
                    if l.alive and l.free_at <= t + 1e-12]

    def next_free(self, t: float) -> Optional[float]:
        with self._lock:
            busy = [l.free_at for l in self.lanes if l.alive and l.free_at > t]
        return min(busy) if busy else None

    def mark_dead(self, lane: int) -> None:
        """Take a lane out of service (worker thread crash escalation)."""
        with self._lock:
            self.lanes[lane].alive = False

    def revive(self, lane: int, t: float = 0.0) -> None:
        """Return a supervisor-restarted lane to service.  Served/busy
        counters survive the restart (they describe the lane's lifetime);
        ``free_at`` resets to ``t`` so the virtual-time model doesn't bill
        the new worker for the dead one's phantom backlog."""
        with self._lock:
            l = self.lanes[lane]
            l.alive = True
            l.free_at = float(t)

    def rank(self, lanes: Sequence[int]) -> List[int]:
        """``lanes`` reordered fastest-first by the monitor's measured EWMAs
        — this is where measured per-lane latency re-enters the CBWS
        placement loop."""
        order = {lane: pos for pos, lane in enumerate(self.monitor.speed_rank())}
        return sorted(lanes, key=lambda i: order[i])

    # -- execution ----------------------------------------------------------
    def execute(self, lane: int, fn: Callable[[], object],
                on_retry: Optional[Callable[[int, Exception], None]] = None):
        """Run one micro-batch on ``lane`` with the retry budget.

        Returns (result, measured wall seconds).  Exhausting the budget
        marks the lane dead and raises ``LaneFailed``.  Safe to call from a
        lane worker thread (the threaded engine does).
        """
        def attempt_counter():
            attempt = {"n": 0}

            def run():
                a = attempt["n"]
                attempt["n"] += 1
                if self.fault_hook is not None:
                    self.fault_hook(lane, a)
                return fn()
            return run

        stopwatch = WallClock()           # measured service time is real time
        try:
            out = call_with_retry(attempt_counter(), policy=self.retry,
                                  on_failure=on_retry, sleep_fn=self.sleep_fn)
        except RuntimeError as e:
            with self._lock:
                self.lanes[lane].alive = False
            raise LaneFailed(lane, e) from e
        return out, stopwatch.now()

    def commit(self, lane: int, t: float, service_s: float, served: int,
               ) -> float:
        """Record a completed micro-batch; returns the lane's finish time."""
        with self._lock:
            l = self.lanes[lane]
            l.free_at = max(t, l.free_at) + service_s
            l.served += served
            l.busy_s += service_s
            return l.free_at

    def record_round(self, norm_times: Dict[int, float]) -> List[int]:
        """Feed one round's work-normalized lane times (s per unit predicted
        workload) to the straggler monitor.  Lanes free at different moments,
        so most rounds observe only a subset — ``record_partial`` updates
        exactly the lanes that ran (no fabricated samples for idle lanes,
        which would defeat the monitor's n>=3 real-observation gate)."""
        if norm_times:
            self.flagged = self.monitor.record_partial(norm_times)
        return self.flagged

    def lane_stats(self) -> List[Dict[str, float]]:
        with self._lock:
            return [{"served": l.served, "busy_s": l.busy_s,
                     "alive": float(l.alive)} for l in self.lanes]
