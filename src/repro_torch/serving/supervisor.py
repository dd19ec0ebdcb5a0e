"""Lane supervision: heartbeats, restart budgets, backoff-timed recovery.

``dispatch.LaneDispatcher`` handles *transient* faults (per-execution
retries); this module handles the next escalation level — a lane whose
worker thread died (retry budget exhausted, or the thread itself vanished).
Before this supervisor existed a dead lane stayed dead for the life of the
engine; now the engine's scheduler asks the supervisor what to do:

  * ``on_death(lane, now)`` prices a restart.  While the lane is under its
    ``restart_budget`` the supervisor schedules a restart at
    ``now + policy.backoff_delay(prior_restarts)`` — the same exponential
    capped schedule ``runtime.fault_tolerance`` uses for per-call retries,
    one level up.  Past the budget it returns None and the lane is
    permanently dead (``dispatch.mark_dead`` stands).
  * ``due_restarts(now)`` tells the scheduler which lanes to bring back
    *this* iteration: the engine forks a fresh warmed ``JitCache``, spawns a
    new worker thread, and calls ``on_restarted`` — which returns the
    death-to-recovery time for ``ServingMetrics.record_restart``.
  * ``beat(lane, now)`` / ``stale(now)`` is the liveness channel: workers
    beat at every loop iteration; a lane that is marked busy but has not
    beaten within ``hang_timeout_s`` is presumed hung and reported stale so
    the scheduler can escalate it to a death (the thread itself cannot be
    killed — Python has no thread cancellation — but its lane can be
    re-queued and restarted; the zombie's eventual completion is discarded
    by the engine's stale-generation check).

The supervisor is pure policy + bookkeeping: it never touches threads,
caches, or queues itself, which keeps it trivially unit-testable and the
engine's scheduler the single mutation point.  All state is lock-protected
(deaths are reported from scheduler context but beats land from worker
threads).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.runtime.fault_tolerance import RetryPolicy

__all__ = ["LaneSupervisor"]


@dataclass
class _LaneState:
    restarts: int = 0                 # restarts consumed so far
    dead: bool = False                # currently out of service
    permanent: bool = False           # budget exhausted: never coming back
    died_at: float = 0.0              # when the current death was reported
    restart_at: Optional[float] = None  # scheduled comeback (None: none due)
    last_beat: float = 0.0
    recoveries: List[float] = field(default_factory=list)


class LaneSupervisor:
    """Restart policy for serving lanes (see module docstring)."""

    # lock discipline (checked by repro.analysis rule "lock-discipline"):
    # deaths land from scheduler context, beats from worker threads
    _GUARDED_BY = {"_lanes": "_lock"}

    def __init__(self, num_lanes: int, *,
                 restart_budget: int = 0,
                 policy: Optional[RetryPolicy] = None,
                 hang_timeout_s: Optional[float] = None):
        if num_lanes < 1:
            raise ValueError(f"num_lanes must be >= 1, got {num_lanes}")
        if restart_budget < 0:
            raise ValueError(
                f"restart_budget must be >= 0, got {restart_budget}")
        if hang_timeout_s is not None and hang_timeout_s <= 0:
            raise ValueError(
                f"hang_timeout_s must be positive, got {hang_timeout_s}")
        self.restart_budget = int(restart_budget)
        self.policy = policy if policy is not None else RetryPolicy()
        self.hang_timeout_s = hang_timeout_s
        self._lanes = [_LaneState() for _ in range(num_lanes)]
        self._lock = threading.Lock()

    # -- liveness -----------------------------------------------------------
    def beat(self, lane: int, now: float) -> None:
        """Record a worker heartbeat (called from the worker thread)."""
        with self._lock:
            self._lanes[lane].last_beat = float(now)

    def stale(self, now: float, busy: Optional[List[int]] = None) -> List[int]:
        """Lanes presumed hung: in-service, (optionally) currently busy, and
        silent for longer than ``hang_timeout_s``.  Empty when no timeout is
        configured.  The scheduler escalates these to deaths."""
        if self.hang_timeout_s is None:
            return []
        candidates = set(busy) if busy is not None else None
        out: List[int] = []
        with self._lock:
            for i, l in enumerate(self._lanes):
                if l.dead or (candidates is not None and i not in candidates):
                    continue
                if now - l.last_beat > self.hang_timeout_s:
                    out.append(i)
        return out

    # -- death / restart policy --------------------------------------------
    def on_death(self, lane: int, now: float) -> Optional[float]:
        """A lane died at ``now``.  Returns the engine-clock time its restart
        comes due (exponential capped backoff in the number of restarts this
        lane already consumed), or None when the budget is exhausted and the
        death is permanent.  Idempotent for an already-dead lane (returns
        the standing decision)."""
        with self._lock:
            l = self._lanes[lane]
            if l.dead:
                return l.restart_at
            l.dead = True
            l.died_at = float(now)
            if l.restarts >= self.restart_budget:
                l.permanent = True
                l.restart_at = None
                return None
            l.restart_at = float(now) + self.policy.backoff_delay(l.restarts)
            return l.restart_at

    def due_restarts(self, now: float) -> List[int]:
        """Lanes whose scheduled restart time has arrived."""
        with self._lock:
            return [i for i, l in enumerate(self._lanes)
                    if l.dead and not l.permanent
                    and l.restart_at is not None and l.restart_at <= now]

    def on_restarted(self, lane: int, now: float) -> float:
        """The scheduler brought ``lane`` back at ``now``; consumes one unit
        of budget and returns the death-to-recovery time."""
        with self._lock:
            l = self._lanes[lane]
            recovery = max(0.0, float(now) - l.died_at)
            l.restarts += 1
            l.dead = False
            l.restart_at = None
            l.last_beat = float(now)
            l.recoveries.append(recovery)
            return recovery

    # -- scheduler queries --------------------------------------------------
    def pending_restarts(self) -> List[int]:
        """Lanes dead but scheduled to come back (restart still owed)."""
        with self._lock:
            return [i for i, l in enumerate(self._lanes)
                    if l.dead and not l.permanent]

    def next_restart_at(self) -> Optional[float]:
        """Earliest scheduled restart time (the scheduler's park bound while
        lanes are down), or None when nothing is owed."""
        with self._lock:
            due = [l.restart_at for l in self._lanes
                   if l.dead and not l.permanent and l.restart_at is not None]
        return min(due) if due else None

    def permanently_dead(self) -> List[int]:
        with self._lock:
            return [i for i, l in enumerate(self._lanes) if l.permanent]

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "restarts": sum(l.restarts for l in self._lanes),
                "per_lane_restarts": [l.restarts for l in self._lanes],
                "permanently_dead": [i for i, l in enumerate(self._lanes)
                                     if l.permanent],
                "pending_restarts": [i for i, l in enumerate(self._lanes)
                                     if l.dead and not l.permanent],
                "recoveries_s": [r for l in self._lanes
                                 for r in l.recoveries],
            }
