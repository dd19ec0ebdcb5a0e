"""Trace exporters: Chrome trace-event JSON (Perfetto) + text timeline (the
reference's ``repro.obs.export``, on the port's ``obs.trace``).

``chrome_trace`` converts a ``TraceRecorder``'s events into the Chrome
trace-event format (the ``{"traceEvents": [...]}`` JSON object array form —
https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU):

  * one named thread (track) per serving lane, plus a ``scheduler`` track
    and a ``requests`` track;
  * every ``dispatch`` .. ``batch_done`` pair on a lane becomes a complete
    ("X") duration event on that lane's track — the lane-occupancy Gantt;
  * every request becomes a flow (``s``/``f``) linking its ``submit``
    instant to its terminal event, so Perfetto draws the submit->serve
    arrows;
  * everything else renders as instant ("i") events on the scheduler track.

Timestamps are engine-clock seconds converted to the format's microseconds.
``render_timeline`` is the dependency-free text fallback for terminals.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.obs.trace import (KIND_BATCH_DONE, KIND_DISPATCH, KIND_SUBMIT,
                                   TERMINAL_KINDS, TraceEvent,
                                   TraceRecorder, format_event)

__all__ = ["chrome_trace", "write_chrome_trace", "render_timeline"]

_PID = 1
_TID_SCHED = 0          # scheduler track
_TID_REQS = 1000        # request flow anchor track
_LANE_TID0 = 1          # lane i -> tid 1 + i


def _events_of(trace) -> List[TraceEvent]:
    if isinstance(trace, TraceRecorder):
        return trace.events()
    return list(trace)


def chrome_trace(trace) -> Dict:
    """Build the Chrome trace-event JSON object for a recorder (or a plain
    event list).  Always valid for Perfetto / chrome://tracing: every event
    carries ph/ts/pid/tid, durations are non-negative, and thread-name
    metadata labels the tracks."""
    events = _events_of(trace)
    lanes = sorted({e.lane for e in events if e.lane is not None})
    out: List[Dict] = []
    for lane in lanes:
        out.append({"ph": "M", "name": "thread_name", "pid": _PID,
                    "tid": _LANE_TID0 + lane,
                    "args": {"name": f"lane {lane}"}})
    out.append({"ph": "M", "name": "thread_name", "pid": _PID,
                "tid": _TID_SCHED, "args": {"name": "scheduler"}})
    out.append({"ph": "M", "name": "thread_name", "pid": _PID,
                "tid": _TID_REQS, "args": {"name": "requests"}})

    open_dispatch: Dict[int, TraceEvent] = {}   # lane -> dispatch event
    for e in events:
        us = e.ts * 1e6
        args = dict(e.data)
        if e.rid is not None:
            args["rid"] = e.rid
        if e.kind == KIND_DISPATCH and e.lane is not None:
            open_dispatch[e.lane] = e
            # flow step: requests in this micro-batch passed through dispatch
            for rid in e.get("rids", ()):
                out.append({"ph": "t", "name": f"req {rid}", "id": int(rid),
                            "cat": "request", "ts": us, "pid": _PID,
                            "tid": _LANE_TID0 + e.lane})
            continue
        if e.kind == KIND_BATCH_DONE and e.lane is not None:
            d = open_dispatch.pop(e.lane, None)
            if d is not None:
                out.append({
                    "ph": "X", "name": f"batch n={d.get('n', '?')}",
                    "cat": "lane", "ts": d.ts * 1e6,
                    "dur": max(0.0, us - d.ts * 1e6),
                    "pid": _PID, "tid": _LANE_TID0 + e.lane,
                    "args": {**dict(d.data), **args}})
            else:
                out.append({"ph": "i", "name": e.kind, "cat": "lane",
                            "ts": us, "s": "t", "pid": _PID,
                            "tid": _LANE_TID0 + e.lane, "args": args})
            continue
        if e.kind == KIND_SUBMIT and e.rid is not None:
            out.append({"ph": "s", "name": f"req {e.rid}", "id": e.rid,
                        "cat": "request", "ts": us, "pid": _PID,
                        "tid": _TID_REQS})
            out.append({"ph": "i", "name": "submit", "cat": "request",
                        "ts": us, "s": "t", "pid": _PID, "tid": _TID_REQS,
                        "args": args})
            continue
        if e.kind in TERMINAL_KINDS and e.rid is not None:
            tid = _LANE_TID0 + e.lane if e.lane is not None else _TID_REQS
            out.append({"ph": "f", "bp": "e", "name": f"req {e.rid}",
                        "id": e.rid, "cat": "request", "ts": us,
                        "pid": _PID, "tid": tid})
            out.append({"ph": "i", "name": e.kind, "cat": "request",
                        "ts": us, "s": "t", "pid": _PID, "tid": tid,
                        "args": args})
            continue
        tid = _LANE_TID0 + e.lane if e.lane is not None else _TID_SCHED
        out.append({"ph": "i", "name": e.kind, "cat": "engine", "ts": us,
                    "s": "t", "pid": _PID, "tid": tid, "args": args})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(trace, path: str) -> int:
    """Serialize ``chrome_trace`` to ``path``; returns the event count."""
    doc = chrome_trace(trace)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])


def render_timeline(trace, *, limit: Optional[int] = None) -> str:
    """Plain-text timeline: one formatted line per event, time-ordered as
    recorded, optionally truncated to the last ``limit`` events."""
    events = _events_of(trace)
    if limit is not None and len(events) > limit:
        head = [f"... ({len(events) - limit} earlier events elided)"]
        events = events[-limit:]
    else:
        head = []
    return "\n".join(head + [format_event(e) for e in events])
