"""Tracing, live metrics and structured logging of the serving engine (the
reference's ``repro.obs``).

``obs.trace``
    A thread-safe, bounded ring-buffer ``TraceRecorder`` of typed request
    lifecycle events, stamped on the engine's ``Clock``: a
    ``VirtualClock`` replay produces identical traces, a ``WallClock`` run
    real timestamps.

``obs.spans``
    ``span``: the program's stage spans (``Session.infer``'s and
    ``train_step``'s stages, the model's counting work, the weight
    gradient), recorded while a ``torch.profiler`` session records, as
    ``repro_torch.*`` ranges in the profile, events in a process-level
    ``TraceRecorder`` and running totals that ``read_spans`` reads.

``obs.export``
    Chrome trace-event JSON (lanes as tracks, requests as flow events
    linking submit -> dispatch -> complete) loadable in Perfetto /
    chrome://tracing, plus a plain-text timeline renderer.

``obs.snapshot``
    ``MetricsSnapshot``, the point-in-time view ``ServingEngine.snapshot()``
    returns while the engine runs.

``obs.log``
    A stderr logger with per-subsystem levels for the launchers and
    examples (quiet by default, so tests stay silent).
"""
from repro_torch.obs.export import (chrome_trace, render_timeline,
                                    write_chrome_trace)
from repro_torch.obs.log import configure_logging, get_logger
from repro_torch.obs.snapshot import MetricsSnapshot
from repro_torch.obs.spans import (SpanReading, SpanTotal, read_spans,
                                   reset_spans, span, tracing)
from repro_torch.obs.trace import TERMINAL_KINDS, TraceEvent, TraceRecorder

__all__ = [
    "TraceRecorder", "TraceEvent", "TERMINAL_KINDS",
    "chrome_trace", "write_chrome_trace", "render_timeline",
    "MetricsSnapshot",
    "span", "tracing", "read_spans", "reset_spans", "SpanReading",
    "SpanTotal",
    "get_logger", "configure_logging",
]
