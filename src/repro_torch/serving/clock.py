"""The serving engine's clock, extracted behind one interface.

The event loop never reads ``time.*`` directly — it asks its ``Clock``:

``VirtualClock``
    Deterministic replay: ``now()`` only moves when the loop calls
    ``advance_to`` (or ``sleep_until``, which is the same thing — virtual
    sleeping is free).  Service times are injected (``service_time_fn``)
    or measured on the wall and mapped onto the virtual axis, so a load
    trace replays bit-identically on a shared CPU.  This is the tier-1
    test clock and the engine's original semantics.

``WallClock``
    Live serving: ``now()`` is monotonic wall seconds since the clock was
    built (the epoch is taken *after* warmup so compile time never
    pollutes latency metrics), and ``sleep_until`` really sleeps — the
    scheduler thread parks between arrival/completion events instead of
    spinning.

Both clocks are monotone non-decreasing; ``VirtualClock.advance_to`` with a
past timestamp is a no-op rather than an error so event loops can pass
``max``-free candidate times.
"""
from __future__ import annotations

import time

__all__ = ["Clock", "VirtualClock", "WallClock"]


class Clock:
    """Interface: seconds since the clock's epoch."""

    #: True when time only moves via advance_to (deterministic replay).
    virtual: bool = False

    def now(self) -> float:
        raise NotImplementedError

    def sleep_until(self, t: float) -> None:
        raise NotImplementedError


class VirtualClock(Clock):
    virtual = True

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance_to(self, t: float) -> None:
        """Move the clock forward (never backward) to ``t``."""
        if t > self._t:
            self._t = float(t)

    def sleep_until(self, t: float) -> None:
        self.advance_to(t)


class WallClock(Clock):
    virtual = False

    def __init__(self):
        self._epoch = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._epoch

    def sleep_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)
