"""Serving metrics: latency percentiles, FPS, queue depth, balance, energy.

Latency/FPS are virtual-time quantities (arrival -> completion on the
engine's event clock, service times measured on the wall); the balance
ratios are ``core.balance`` applied at request granularity; energy/image
routes the engine's accumulated spike counts through the Skydiver cycle
model (``perfmodel.skydiver``), the same path Table 1 uses.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.balance import balance_ratio

__all__ = ["ServingMetrics", "percentile", "energy_per_image",
           "workload_residual"]


def workload_residual(predicted: Sequence[float],
                      measured: Sequence[float]) -> Optional[float]:
    """Total-variation distance between the normalized per-group predicted
    workload shares and the measured event shares of one admission round —
    0.0 means APRC's proportionality assumption held exactly, 1.0 means the
    prediction put all mass on the wrong groups.  None when either side has
    no mass or fewer than two groups (a one-group round is vacuous)."""
    if len(predicted) < 2 or len(predicted) != len(measured):
        return None
    p = np.asarray(predicted, dtype=np.float64)
    m = np.asarray(measured, dtype=np.float64)
    if p.sum() <= 0 or m.sum() <= 0:
        return None
    return float(0.5 * np.abs(p / p.sum() - m / m.sum()).sum())


def percentile(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q)) if xs else 0.0


@dataclass
class ServingMetrics:
    """Mutable counters + rolling samples for one engine run.

    Thread-safety: the threaded engine mutates from its scheduler thread
    while ``snapshot()`` reads from any client thread (live introspection),
    so the list-touching mutators and the snapshot hold ``_lock`` (an RLock
    — ``record_round`` calls ``note_depth``).  Plain counter bumps from the
    engine remain bare attribute writes (GIL-atomic enough for monitoring
    reads; the terminal ``summary()`` runs after the scheduler joined)."""

    # lock discipline (checked by repro.analysis rule "lock-discipline"):
    # rolling sample lists grow on the scheduler thread while snapshots read
    # from client threads; scalar counters stay undeclared per the note
    # above.  Not a dataclass field (no annotation), so init is unaffected.
    _GUARDED_BY = {
        "latencies": "_lock",
        "queue_depths": "_lock",
        "predicted_balances": "_lock",
        "measured_balances": "_lock",
        "wall_balances": "_lock",
        "workload_residuals": "_lock",
        "skip_fractions": "_lock",
        "recovery_s": "_lock",
        "restart_times": "_lock",
        "in_flight": "_lock",
        "queue_watermark": "_lock",
    }

    latencies: List[float] = field(default_factory=list)
    queue_depths: List[int] = field(default_factory=list)
    predicted_balances: List[float] = field(default_factory=list)
    measured_balances: List[float] = field(default_factory=list)
    wall_balances: List[float] = field(default_factory=list)
    rounds: int = 0
    served: int = 0
    retries: int = 0
    rejected: int = 0                 # dropped at admission (SLO over budget)
    degraded: int = 0                 # served with reduced timesteps (SLO)
    in_flight: int = 0                # requests dispatched, not yet resolved
    first_arrival: float = float("inf")
    last_finish: float = 0.0
    # workload-prediction observability: per-round APRC predicted-vs-measured
    # share residuals (see workload_residual) and kernel skip-table sparsity
    # (fraction of (t, b, row-block) cells skipped, one sample per batch)
    workload_residuals: List[float] = field(default_factory=list)
    skip_fractions: List[float] = field(default_factory=list)
    # fault tolerance / graceful degradation (serving.supervisor + engine)
    restarts: int = 0                 # supervised lane restarts
    recovery_s: List[float] = field(default_factory=list)
    #                                 # per-restart time-to-recovery (death ->
    #                                 # lane serving again)
    restart_times: List[float] = field(default_factory=list)
    #                                 # engine-clock times lanes came back
    deadline_missed: int = 0          # expired in queue / unmeetable deadline
    cancelled: int = 0                # client-cancelled before dispatch
    queue_full: int = 0               # submissions refused (bounded queue)
    queue_watermark: int = 0          # max queue depth ever observed
    # timestep-chunked continuous batching (EngineConfig.chunk_timesteps)
    chunks_dispatched: int = 0        # request-chunks executed (one request
    #                                 # served in k chunks counts k)
    mid_evicted: int = 0              # partially-served requests evicted at
    #                                 # a chunk boundary (cancel/deadline)
    mid_degraded: int = 0             # in-progress requests whose remaining
    #                                 # chunks were SLO-truncated mid-flight
    _lock: threading.RLock = field(default_factory=threading.RLock,
                                   repr=False, compare=False)

    def record_round(self, *, queue_depth: int,
                     predicted: Optional[float] = None,
                     measured: Optional[float] = None,
                     lane_wall: Sequence[float] = (),
                     group_pred: Sequence[float] = (),
                     group_meas: Sequence[float] = ()) -> None:
        """Balance samples are only meaningful for rounds that actually ran
        >= 2 micro-batches (mean/max of one lane is vacuously 1.0) — callers
        pass None to skip them; queue depth is recorded every round.
        ``group_pred``/``group_meas`` are the round's per-group predicted
        workload and measured event sums; their share mismatch is the APRC
        residual."""
        with self._lock:
            self.rounds += 1
            self.queue_depths.append(int(queue_depth))
            self.note_depth(queue_depth)
            if predicted is not None:
                self.predicted_balances.append(float(predicted))
            if measured is not None:
                self.measured_balances.append(float(measured))
            if len(lane_wall) >= 2:
                self.wall_balances.append(balance_ratio(lane_wall))
            resid = workload_residual(group_pred, group_meas)
            if resid is not None:
                self.workload_residuals.append(resid)

    def note_depth(self, depth: int) -> None:
        """Update the queue high-watermark — sampled at submit time, at
        every scheduler wake, and in the deadline sweep, so depth spikes
        between admission rounds (restart backoff windows, sweep bursts)
        register too.  This is the backpressure signal ``max_queue`` should
        be tuned against."""
        with self._lock:
            if depth > self.queue_watermark:
                self.queue_watermark = int(depth)

    def note_dispatched(self, n: int) -> None:
        """``n`` requests handed to a lane (in-flight until resolved)."""
        with self._lock:
            self.in_flight += int(n)

    def note_resolved(self, n: int) -> None:
        """``n`` previously dispatched requests left the in-flight set
        (completed, failed back to the queue, or abandoned)."""
        with self._lock:
            self.in_flight = max(0, self.in_flight - int(n))

    def note_skip_fraction(self, frac: float) -> None:
        """One micro-batch's kernel skip-table sparsity sample (fraction of
        (t, b, row-block) cells whose receptive rows held zero spikes)."""
        with self._lock:
            self.skip_fractions.append(float(frac))

    def record_restart(self, recovery_s: float, at: float) -> None:
        """One supervised lane restart: ``recovery_s`` is death-to-serving
        time (the backoff delay plus scheduler latency), ``at`` the
        engine-clock instant the lane came back."""
        with self._lock:
            self.restarts += 1
            self.recovery_s.append(float(recovery_s))
            self.restart_times.append(float(at))

    def record_completion(self, arrival: float, finish: float) -> None:
        with self._lock:
            self.served += 1
            self.latencies.append(finish - arrival)
            self.first_arrival = min(self.first_arrival, arrival)
            self.last_finish = max(self.last_finish, finish)

    def fps(self) -> float:
        span = self.last_finish - self.first_arrival
        return self.served / span if span > 0 else 0.0

    def wall_s(self) -> float:
        """Clamped first-arrival -> last-finish span on the engine clock
        (0.0 before any completion) — the wall denominator consumers used
        to recompute from the private first/last fields."""
        span = self.last_finish - self.first_arrival
        return span if span > 0 else 0.0

    def summary(self) -> Dict[str, float]:
        with self._lock:
            return self._summary_locked()

    def _summary_locked(self) -> Dict[str, float]:  # lint: holds(_lock)
        return {
            "served": self.served,
            "rounds": self.rounds,
            "retries": self.retries,
            "rejected": self.rejected,
            "degraded": self.degraded,
            "in_flight": float(self.in_flight),
            "p50_latency_s": percentile(self.latencies, 50),
            "p99_latency_s": percentile(self.latencies, 99),
            "fps": self.fps(),
            "wall_s": self.wall_s(),
            "mean_queue_depth": float(np.mean(self.queue_depths))
            if self.queue_depths else 0.0,
            "max_queue_depth": float(max(self.queue_depths, default=0)),
            # fault tolerance / graceful degradation
            "restarts": float(self.restarts),
            "mean_recovery_s": float(np.mean(self.recovery_s))
            if self.recovery_s else 0.0,
            "max_recovery_s": float(max(self.recovery_s, default=0.0)),
            "deadline_missed": float(self.deadline_missed),
            "cancelled": float(self.cancelled),
            "queue_full": float(self.queue_full),
            "queue_watermark": float(self.queue_watermark),
            # chunked continuous batching
            "chunks_dispatched": float(self.chunks_dispatched),
            "mid_evicted": float(self.mid_evicted),
            "mid_degraded": float(self.mid_degraded),
            # mean over multi-lane rounds only; balance_rounds says how many
            # samples back it (0 -> the 1.0 default is vacuous, not measured)
            "balance_rounds": float(len(self.measured_balances)),
            "request_balance": float(np.mean(self.measured_balances))
            if self.measured_balances else 1.0,
            "predicted_balance": float(np.mean(self.predicted_balances))
            if self.predicted_balances else 1.0,
            "wall_balance": float(np.mean(self.wall_balances))
            if self.wall_balances else 1.0,
            # APRC prediction residual (0 = shares matched exactly) and
            # kernel skip-table sparsity, each with its sample count
            "workload_residual": float(np.mean(self.workload_residuals))
            if self.workload_residuals else 0.0,
            "residual_rounds": float(len(self.workload_residuals)),
            "skip_sparsity": float(np.mean(self.skip_fractions))
            if self.skip_fractions else 0.0,
            "skip_batches": float(len(self.skip_fractions)),
        }

    def snapshot_fields(self) -> Dict[str, float]:
        """A lock-consistent copy of the live-introspection subset (the
        engine folds this into an ``obs.MetricsSnapshot``).  Percentiles
        are computed over a copy taken under the lock, so a mid-burst read
        never races an append."""
        with self._lock:
            lat = list(self.latencies)
            return {
                "served": self.served,
                "in_flight": self.in_flight,
                "rejected": self.rejected,
                "degraded": self.degraded,
                "deadline_missed": self.deadline_missed,
                "cancelled": self.cancelled,
                "queue_full": self.queue_full,
                "rounds": self.rounds,
                "retries": self.retries,
                "queue_watermark": self.queue_watermark,
                "chunks_dispatched": self.chunks_dispatched,
                "mid_evicted": self.mid_evicted,
                "mid_degraded": self.mid_degraded,
                "p50_latency_s": percentile(lat, 50),
                "p99_latency_s": percentile(lat, 99),
                "fps": self.fps(),
                "wall_s": self.wall_s(),
                "predicted_balance": float(np.mean(self.predicted_balances))
                if self.predicted_balances else 1.0,
                "measured_balance": float(np.mean(self.measured_balances))
                if self.measured_balances else 1.0,
                "workload_residual": float(np.mean(self.workload_residuals))
                if self.workload_residuals else 0.0,
                "residual_rounds": len(self.workload_residuals),
                "skip_sparsity": float(np.mean(self.skip_fractions))
                if self.skip_fractions else 0.0,
                "skip_batches": len(self.skip_fractions),
            }


def energy_per_image(cfg, params, timestep_counts: Sequence[np.ndarray],
                     num_images: int, input_hw=None) -> Dict[str, float]:
    """Route accumulated spike workloads through the Skydiver cycle model.

    ``timestep_counts[l]`` is the engine's accumulated (T, Cout) spike count
    of conv layer ``l`` over every served frame (the actual-workload signal);
    layer 0's input is the dense direct-coded frame.  Returns J/image, FPS
    and GSOp/s of the modeled accelerator for the *average* served image.
    """
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.perfmodel import XC7Z045, simulate_network

    h, w = input_hw if input_hw is not None else cfg.input_hw
    cin = cfg.input_channels
    t = cfg.timesteps
    per_layer = [np.full((t, cin), float(num_images * h * w) / cin)]
    for l in range(len(cfg.conv_channels) - 1):
        per_layer.append(np.asarray(timestep_counts[l], dtype=np.float64))
    scheds = build_schedule(params, cfg, "aprc+cbws")
    perf = simulate_network(cfg, per_layer,
                            [s.in_partition for s in scheds],
                            [s.out_partition for s in scheds], XC7Z045)
    n = max(1, int(num_images))
    return {
        "energy_j_per_image": perf.energy_j(XC7Z045) / n,
        "model_fps": perf.fps(XC7Z045) * n,
        "model_gsops": perf.gsops(XC7Z045),
        "model_balance": perf.balance_spartus,
    }
