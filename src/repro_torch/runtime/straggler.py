"""Straggler detection + mitigation hooks.

In synchronous SPMD training the step time is the MAX over hosts — one slow
host drags the fleet, exactly the lane-imbalance problem Skydiver solves at
SPE granularity (the balance-ratio math is identical: fleet efficiency =
mean(host_time)/max(host_time)).

``StragglerMonitor`` keeps an EWMA + variance per host and flags hosts whose
step time departs by ``z_thresh`` sigma.  Mitigations are pluggable; the
built-in one re-runs CBWS over the *measured* per-host work to produce a
rebalanced lane assignment — i.e. the paper's scheduler reused as a
cluster-level straggler mitigation (see tests/test_runtime.py).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.balance import balance_ratio
from repro_torch.core.cbws import cbws_partition


@dataclass
class HostStat:
    ewma: float = 0.0
    var: float = 0.0
    n: int = 0


class StragglerMonitor:
    """EWMA/variance per host with z-score flagging.

    Thread-safe: serving lanes run as worker threads and both record
    (completion path) and read (``speed_rank`` in the scheduler's placement
    loop) concurrently, so every stats access holds ``_lock``.  The lock is
    uncontended in the single-threaded virtual-clock engine.
    """

    # lock discipline (checked by repro.analysis rule "lock-discipline"):
    # completion paths record while the placement loop reads concurrently
    _GUARDED_BY = {"stats": "_lock"}

    def __init__(self, num_hosts: int, alpha: float = 0.1,
                 z_thresh: float = 3.0):
        self.alpha = alpha
        self.z = z_thresh
        self.stats: List[HostStat] = [HostStat() for _ in range(num_hosts)]
        self._lock = threading.Lock()

    def record(self, host_times: Sequence[float]) -> List[int]:
        """Feed one step's per-host times; returns indices flagged slow."""
        return self.record_partial(dict(enumerate(host_times)))

    def record_partial(self, host_times: Dict[int, float]) -> List[int]:
        """Feed times for a subset of hosts (serving lanes free at different
        moments, so most rounds observe only some lanes).  Only observed
        hosts' stats update — no fabricated samples — and fleet mean/std are
        taken over hosts with at least one real observation."""
        with self._lock:
            for i, t in host_times.items():
                s = self.stats[i]
                if s.n == 0:
                    s.ewma, s.var = t, 0.0
                else:
                    d = t - s.ewma
                    s.ewma += self.alpha * d
                    s.var = (1 - self.alpha) * (s.var + self.alpha * d * d)
                s.n += 1
            observed = [s.ewma for s in self.stats if s.n > 0]
            if not observed:
                return []
            fleet_mean = float(np.mean(observed))
            fleet_std = float(np.std(observed)) + 1e-9
            flagged = []
            for i, s in enumerate(self.stats):
                if s.n >= 3 and (s.ewma - fleet_mean) / fleet_std > self.z:
                    flagged.append(i)
            return flagged

    def seconds_per_work(self) -> Optional[float]:
        """Fleet-mean work-normalized service time (s per unit predicted
        workload), or None before any real observation.  The serving
        admitter prices queue delay with this."""
        with self._lock:
            obs = [s.ewma for s in self.stats if s.n > 0]
        return float(np.mean(obs)) if obs else None

    def per_host_seconds_per_work(self) -> List[Optional[float]]:
        """Each host's EWMA work-normalized service time (s per unit
        predicted workload), None for hosts with no observation yet — the
        per-lane view live snapshots expose (``seconds_per_work`` is the
        fleet mean of these)."""
        with self._lock:
            return [s.ewma if s.n > 0 else None for s in self.stats]

    def fleet_balance(self) -> float:
        with self._lock:
            return balance_ratio([s.ewma for s in self.stats])

    def speed_rank(self) -> List[int]:
        """Host indices fastest-first (EWMA ascending; unobserved hosts rank
        at the fleet mean).  Consumers place the heaviest CBWS group on the
        fastest lane — measured-latency-driven schedule placement."""
        with self._lock:
            obs = [s.ewma for s in self.stats if s.n > 0]
            mean = float(np.mean(obs)) if obs else 0.0
            keyed = [(s.ewma if s.n > 0 else mean, i)
                     for i, s in enumerate(self.stats)]
        return [i for _, i in sorted(keyed)]


def rebalance_lanes(measured_work: Sequence[float], num_lanes: int):
    """CBWS over measured work — the paper's Algorithm 1 reused to re-pack
    work units (channels, experts, shards) away from slow lanes."""
    return cbws_partition(measured_work, num_lanes)
