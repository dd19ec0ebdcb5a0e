"""Per-request completion handles for live serving (``serve_forever``).

``submit()`` on a live engine returns a ``RequestHandle`` — a minimal
future: ``result(timeout)`` blocks for the request's logits, ``done()``
polls, ``exception()`` surfaces the failure, ``cancel()`` withdraws a
not-yet-dispatched request.  Exactly one of resolve/fail ever fires per
handle (the engine's no-request-lost / no-double-serve conservation
guarantee, chaos-tested): a request whose lane dies mid-flight re-queues
and resolves later on a survivor (or on the supervisor-restarted lane); a
request the SLO admitter drops fails with ``SLORejected``; one whose
deadline passes fails with ``DeadlineExceeded``; a cancelled one fails with
``Cancelled``; an engine-fatal error (all lanes dead past the restart
budget) fails every outstanding handle with the cause, and a shutdown that
cannot drain within its timeout fails them with ``ShutdownTimeout``.
``QueueFull`` is raised *at submit time* (fail-fast backpressure) — no
handle is ever created for a request the bounded queue refused.

``concurrent.futures.Future`` isn't reused because its cancel/running state
machine doesn't match serving semantics (a dispatched micro-batch cannot be
cancelled, only drained), and the whole contract here is four methods.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np

__all__ = ["SLORejected", "DeadlineExceeded", "Cancelled", "QueueFull",
           "ShutdownTimeout", "RequestHandle"]


class SLORejected(RuntimeError):
    """The SLO admitter dropped this request (predicted latency over the
    engine's ``latency_budget_s``).  Carries the request record so clients
    can inspect arrival/workload or resubmit."""

    def __init__(self, request):
        super().__init__(
            f"request {request.rid} rejected at admission: predicted latency "
            f"exceeds the engine's SLO budget")
        self.request = request


class DeadlineExceeded(RuntimeError):
    """The request's own ``deadline_s`` passed (expired in queue) or was
    priced as unmeetable at admission.  Carries the request record."""

    def __init__(self, request):
        super().__init__(
            f"request {request.rid} missed its deadline "
            f"({request.deadline_s}s after arrival)")
        self.request = request


class Cancelled(RuntimeError):
    """The client cancelled this request before it was dispatched."""

    def __init__(self, request):
        super().__init__(f"request {request.rid} cancelled by the client")
        self.request = request


class QueueFull(RuntimeError):
    """Fail-fast backpressure: the bounded queue (``EngineConfig.max_queue``)
    refused the submission.  Raised by ``submit_live`` itself — no handle
    exists, nothing was enqueued; the client should shed or retry later."""

    def __init__(self, depth: int, max_queue: int):
        super().__init__(
            f"serving queue full ({depth} queued >= max_queue={max_queue}); "
            f"submission refused")
        self.depth = depth
        self.max_queue = max_queue


class ShutdownTimeout(RuntimeError):
    """``shutdown(timeout)`` could not drain in time; every outstanding
    handle fails with this instead of hanging its caller forever."""


class RequestHandle:
    """Future-style handle for one live-submitted request."""

    # lock discipline (checked by repro.analysis rule "lock-discipline"):
    # deliberately empty — the handle synchronizes through ``_event``
    # (resolve/fail write-then-set, result() waits-then-reads) and the
    # engine's futures lock serializes who may resolve it; it owns no lock
    _GUARDED_BY: dict = {}

    def __init__(self, request):
        self.request = request
        self._event = threading.Event()
        self._logits: Optional[np.ndarray] = None
        self._exc: Optional[BaseException] = None
        # installed by the engine at registration: attempts the cancel under
        # the engine's futures lock (None on non-live handles)
        self._canceller: Optional[Callable[[], bool]] = None

    # -- engine side (called exactly once) -----------------------------------
    def _resolve(self, logits: np.ndarray) -> None:
        self._logits = logits
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    # -- client side ---------------------------------------------------------
    @property
    def rid(self) -> int:
        return self.request.rid

    def done(self) -> bool:
        """True once the request completed, was rejected, or failed."""
        return self._event.is_set()

    def cancel(self) -> bool:
        """Withdraw the request if it has not been dispatched to a lane.

        Returns True when the cancel took effect — the handle immediately
        fails with ``Cancelled`` and the scheduler drops the queued request
        at its next sweep/admission.  Returns False when it is too late:
        the request is in flight on a lane (a dispatched micro-batch cannot
        be recalled, only drained) or already resolved.  Never blocks."""
        if self._event.is_set() or self._canceller is None:
            return False
        return self._canceller()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block for the request's logits.  Raises ``SLORejected`` if the
        admitter dropped it, ``DeadlineExceeded`` if its deadline passed,
        ``Cancelled`` if the client withdrew it, the engine's failure if
        serving died, or ``TimeoutError`` if ``timeout`` elapses first."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request.rid} not done within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._logits

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        """The failure (``SLORejected`` / ``DeadlineExceeded`` /
        ``Cancelled`` / engine error) or None on success."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request.rid} not done within {timeout}s")
        return self._exc
