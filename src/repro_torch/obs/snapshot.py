"""``MetricsSnapshot`` — a consistent point-in-time view of a running engine.

``ServingEngine.snapshot()`` (and ``LiveServer.metrics()``) build one of
these *while* ``serve_forever()`` is mid-burst: counters and rolling
percentiles are copied under the metrics lock, queue depth under the
batcher's, lane state under the dispatcher's/supervisor's — each source is
internally consistent, and the cheap reads make the whole snapshot a
near-instant.  Unlike ``summary()`` (terminal, after drain), a snapshot is
valid at any moment of the run.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["MetricsSnapshot"]


@dataclass(frozen=True)
class MetricsSnapshot:
    ts: float                         # engine-clock time of the snapshot
    live: bool                        # serve_forever currently accepting?
    # request accounting (conservation: submitted requests are always in
    # exactly one of queued / in_flight / a terminal count)
    served: int
    queued: int
    in_flight: int
    rejected: int
    degraded: int
    deadline_missed: int
    cancelled: int
    queue_full: int
    rounds: int
    retries: int
    queue_watermark: int
    # rolling latency/throughput over completions so far
    p50_latency_s: float
    p99_latency_s: float
    fps: float
    wall_s: float
    # workload-prediction observability (Skydiver's proportionality claim)
    predicted_balance: float
    measured_balance: float
    workload_residual: float          # mean |predicted - measured| share TV
    residual_rounds: int              # rounds backing the residual
    skip_sparsity: float              # mean fraction of (t,b,row-block)
    #                                 # skip-table cells skipped (hopper)
    skip_batches: int                 # micro-batches backing skip_sparsity
    # lane health
    lanes_alive: int
    lanes_total: int
    lane_seconds_per_work: Tuple[Optional[float], ...]
    lane_served: Tuple[int, ...]
    # restart budget state (serving.supervisor)
    restarts: int
    restart_budget: int
    per_lane_restarts: Tuple[int, ...]
    permanently_dead: Tuple[int, ...]
    pending_restarts: Tuple[int, ...]
    # trace buffer state
    trace_enabled: bool
    trace_events: int
    trace_dropped: int
    # timestep-chunked continuous batching (EngineConfig.chunk_timesteps);
    # defaults keep older snapshot producers constructible
    chunk_timesteps: Optional[int] = None
    chunks_dispatched: int = 0
    mid_evicted: int = 0
    mid_degraded: int = 0
    # multi-device serving (EngineConfig.lane_devices): lane i's pinned
    # device as a
    # string label, () when lanes share the default device.  Joined with
    # lane_seconds_per_work/lane_served this gives per-*device* rates —
    # what the straggler monitor effectively observes under pinning
    lane_devices: Tuple[str, ...] = ()

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, tuple):
                d[k] = list(v)
        return d

    @property
    def outstanding(self) -> int:
        """Requests accepted but not yet resolved (queued + in flight)."""
        return self.queued + self.in_flight

    def device_seconds_per_work(self) -> Dict[str, Optional[float]]:
        """Per-device mean of the lanes' measured seconds-per-work (the
        straggler monitor's EWMAs grouped by ``lane_devices``) — the
        per-device rate view CBWS device placement balances against.
        Empty when lanes are not device-pinned."""
        rates: Dict[str, List[float]] = {}
        for dev, spw in zip(self.lane_devices, self.lane_seconds_per_work):
            rates.setdefault(dev, [])
            if spw is not None:
                rates[dev].append(float(spw))
        return {dev: (sum(v) / len(v) if v else None)
                for dev, v in rates.items()}
