"""Tracing and live metrics of the serving engine (the reference's
``repro.obs``, without ``export`` and ``log``, which come later).

``obs.trace``
    A thread-safe, bounded ring-buffer ``TraceRecorder`` of typed request
    lifecycle events, stamped on the engine's ``Clock``: a
    ``VirtualClock`` replay produces identical traces, a ``WallClock`` run
    real timestamps.

``obs.snapshot``
    ``MetricsSnapshot``, the point-in-time view ``ServingEngine.snapshot()``
    returns while the engine runs.
"""
from repro_torch.obs.snapshot import MetricsSnapshot
from repro_torch.obs.trace import TERMINAL_KINDS, TraceEvent, TraceRecorder

__all__ = ["TraceRecorder", "TraceEvent", "TERMINAL_KINDS", "MetricsSnapshot"]
