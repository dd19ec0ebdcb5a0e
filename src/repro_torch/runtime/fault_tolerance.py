"""Bounded retry for serving lanes: ``RetryPolicy`` and ``call_with_retry``
(the reference's ``repro.runtime.fault_tolerance``, without the training
loop's ``ResilientLoop`` and its checkpointer, which come with the
checkpoint module)."""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

__all__ = ["RetryPolicy", "call_with_retry"]

log = logging.getLogger("repro_torch.runtime")


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded-retry budget for a single work unit (the serving-lane
    analogue of ResilientLoop's per-step failure budget).

    ``backoff_s`` is the *base* delay between attempts — real concurrent
    lanes retrying against a flapping device want to yield the core to
    their sibling threads rather than hot-loop.  The default 0.0 keeps the
    deterministic virtual-clock engine sleep-free.  Successive attempts
    back off exponentially (``backoff_delay``): attempt ``a`` waits
    ``backoff_s * 2**a`` seconds, capped at ``max_backoff_s`` so an
    exhausted budget never stretches into an unbounded stall.  The same
    schedule prices supervised lane *restarts* (serving.supervisor): the
    k-th restart of a repeatedly-dying lane waits ``backoff_delay(k)``.
    """
    max_retries: int = 2
    backoff_s: float = 0.0
    max_backoff_s: float = 2.0

    def backoff_delay(self, attempt: int) -> float:
        """Delay before re-attempting after failure number ``attempt``
        (0-based).  Deterministic, monotone non-decreasing in ``attempt``,
        capped at ``max_backoff_s`` (property-tested)."""
        if self.backoff_s <= 0.0:
            return 0.0
        return float(min(self.backoff_s * (2.0 ** max(0, int(attempt))),
                         self.max_backoff_s))


def call_with_retry(fn: Callable[..., Any], *args: Any,
                    policy: RetryPolicy = RetryPolicy(),
                    on_failure: Optional[Callable[[int, Exception], None]] = None,
                    sleep_fn: Optional[Callable[[float], None]] = None,
                    ) -> Any:
    """Run ``fn(*args)``, retrying transient failures up to the budget.

    ``on_failure(attempt, exc)`` is the observability hook (serving lanes use
    it to count retries per request).  The final failure propagates so the
    caller can escalate — e.g. mark a serving lane dead and re-queue its
    micro-batch on the survivors.

    ``sleep_fn(seconds)`` is how backoff waits happen.  The serving engine
    injects a sleep routed through its ``Clock`` so virtual-clock fault
    tests advance deterministically instead of wall-sleeping through the
    backoff schedule; the default is a real wall sleep for standalone use
    (this module must not import serving.clock — serving imports us).

    Holds no shared state, so it is safe to call concurrently from many
    lane worker threads (each invocation retries its own work unit; the
    in-flight micro-batch never leaves the calling thread).
    """
    last: Optional[Exception] = None
    for attempt in range(policy.max_retries + 1):
        try:
            return fn(*args)
        except Exception as e:  # noqa: BLE001 — transient device failures
            last = e
            log.warning("attempt %d failed: %r", attempt, e)
            if on_failure is not None:
                on_failure(attempt, e)
            if policy.backoff_s > 0 and attempt < policy.max_retries:
                delay = policy.backoff_delay(attempt)
                if sleep_fn is not None:
                    sleep_fn(delay)
                else:
                    time.sleep(delay)  # lint: allow(clock-discipline) — wall default when no clock is injected
    raise RuntimeError(
        f"retry budget ({policy.max_retries}) exhausted") from last
