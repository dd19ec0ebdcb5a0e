"""Fault tolerance: bounded retry for serving lanes (``RetryPolicy``,
``call_with_retry``) and the training loop's ``ResilientLoop`` (the
reference's ``repro.runtime.fault_tolerance``).

``ResilientLoop`` wraps a step function with:
  * periodic async checkpoints (``checkpoint.Checkpointer``);
  * a resume from the latest checkpoint on (re)start;
  * bounded retry of a step that raises: the state rolls back to the last
    checkpoint (restored into the state's own tensors) and the steps since
    are replayed; with no checkpoint yet the loop goes on with the state
    it has;
  * a failure budget: more than ``max_failures`` within
    ``failure_window`` steps raises, so the job's scheduler can take
    over.

The port's train step writes its state in place, so a step that raises
must do so before its first write (``models.lm.make_train_step``: every
failure point precedes ``adam.update``); the state is then the one the
step was given, as with the reference's functional step.

On a mesh (one process per entry, each running this loop on its shards
with a ``Checkpointer(mesh=...)``) the step's ranks agree before its first
write, so a failure on one rank raises on all of them; each then asks the
checkpointer, whose rank 0 answers for all, for the same latest step, and
all restore it together (rank 0 reads the file and scatters it).  A rank
that fails inside a collective leaves the others waiting there, which
the group's timeout (``dist.spmd``) ends.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, List, Optional, Tuple

__all__ = ["RetryPolicy", "call_with_retry", "LoopConfig", "LoopStats",
           "ResilientLoop"]

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


@dataclass
class LoopConfig:
    checkpoint_every: int = 100
    max_failures: int = 3
    failure_window: int = 1000          # steps
    max_steps: int = 1000


@dataclass
class LoopStats:
    resumed_from: Optional[int] = None
    failures: List[Tuple[int, str]] = field(default_factory=list)
    steps_done: int = 0
    step_times: List[float] = field(default_factory=list)


class ResilientLoop:
    """``step_fn(state, batch) -> (state, metrics)`` run to
    ``cfg.max_steps`` with checkpoints, resume, rollback and a failure
    budget (module doc).  ``ckpt`` is a ``checkpoint.Checkpointer``."""

    def __init__(self, step_fn: Callable[[Any, Any], Tuple[Any, Any]],
                 ckpt, cfg: LoopConfig):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.cfg = cfg
        self.stats = LoopStats()

    def run(self, state: Any, batches: Iterator[Any],
            start_step: int = 0,
            on_metrics: Optional[Callable[[int, Any], None]] = None) -> Any:
        # resume if a newer checkpoint exists
        latest = self.ckpt.latest_step()
        if latest is not None and latest > start_step:
            state = self.ckpt.restore(latest, state)
            start_step = latest
            self.stats.resumed_from = latest
            log.info("resumed from checkpoint step %d", latest)

        step = start_step
        while step < self.cfg.max_steps:
            batch = next(batches)
            # step timing is observability, not schedule input
            t0 = time.perf_counter()  # lint: allow(clock-discipline)
            try:
                state, metrics = self.step_fn(state, batch)
            except Exception as e:  # noqa: BLE001 — transient device failures
                self.stats.failures.append((step, repr(e)))
                recent = [s for s, _ in self.stats.failures
                          if s > step - self.cfg.failure_window]
                if len(recent) > self.cfg.max_failures:
                    raise RuntimeError(
                        f"failure budget exceeded at step {step}") from e
                latest = self.ckpt.latest_step()
                if latest is not None:
                    self.ckpt.wait()
                    state = self.ckpt.restore(latest, state)
                    log.warning("step %d failed (%r); rolled back to %d",
                                step, e, latest)
                    step = latest
                continue
            self.stats.step_times.append(time.perf_counter() - t0)  # lint: allow(clock-discipline)
            step += 1
            self.stats.steps_done += 1
            if on_metrics is not None:
                on_metrics(step, metrics)
            if step % self.cfg.checkpoint_every == 0:
                self.ckpt.save(step, state)
        self.ckpt.save(step, state, blocking=True)
        return state
