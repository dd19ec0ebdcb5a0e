"""The unit of serving work: one frame inference request.

``workload`` is the APRC-*predicted* relative workload (set at submit time by
``admission.predict_workload``); ``events`` is the *measured* input-event
workload (direct coding: every pixel injects ``intensity`` current each of
the T timesteps, so input synaptic events = T * sum(frame)).  The admission
scheduler bins on the prediction; the balance ratio the engine reports is
measured on ``events`` — the same predicted-vs-actual split the paper uses
for Fig. 7 (partition from predictions, ratio from actual workloads).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = ["Request"]


@dataclass
class Request:
    rid: int
    frame: np.ndarray                 # (H, W, Cin) analog frame in [0, 1]
    arrival: float                    # arrival time on the engine clock, s
    workload: float = 0.0             # APRC-predicted relative workload
    events: float = 0.0               # measured input events (T * frame.sum())

    # client latency contract: seconds after arrival by which the result is
    # useless (None = no deadline).  Expired requests are dropped at queue
    # sweep / admission and their handles fail with DeadlineExceeded.
    deadline_s: Optional[float] = None

    # SLO admission outcome (set by admission.slo_filter)
    timesteps: Optional[int] = None   # degraded T (None -> cfg.timesteps)
    rejected: bool = False            # dropped at admission (over budget)
    deadline_missed: bool = False     # dropped because its deadline was the
                                      # binding constraint (expired in queue
                                      # or priced over it at admission)
    cancelled: bool = False           # client cancelled before dispatch
    in_flight: bool = False           # dispatched to a lane (cancel barrier:
                                      # set under the engine's futures lock,
                                      # after which cancel() refuses)

    # filled in by the engine at dispatch/completion
    start: float = -1.0               # dispatch time on the engine clock
    finish: float = -1.0              # completion time on the engine clock
    lane: int = -1                    # lane that served it
    window: int = -1                  # admission-window index (FIFO order)
    retries: int = 0                  # lane-failure retries
    logits: Optional[np.ndarray] = field(default=None, repr=False)

    # chunked continuous batching (EngineConfig.chunk_timesteps): timesteps
    # served so far and the per-layer membrane/readout state carried between
    # chunks (this request's row of a core.snn_model.ChunkCarry pytree;
    # numpy host arrays).  A chunk boundary is the only place carry/t_served
    # change, so a lane death mid-chunk resumes from the last completed
    # boundary — or from the zero carry when no chunk has finished.
    t_served: int = 0
    carry: Optional[object] = field(default=None, repr=False)

    @property
    def latency(self) -> float:
        return self.finish - self.arrival

    @property
    def done(self) -> bool:
        return self.finish >= 0.0

    @property
    def degraded(self) -> bool:
        return self.timesteps is not None

    @property
    def expires_at(self) -> float:
        """Engine-clock time after which this request is dead (inf = never)."""
        if self.deadline_s is None:
            return float("inf")
        return self.arrival + self.deadline_s

    def expired(self, now: float) -> bool:
        return now > self.expires_at
