"""Workload-balance metrics (Spartus [15] balance ratio).

For N parallel lanes with actual workloads ``w_1..w_N`` (e.g. spike-event
counts processed by each lane), the array finishes at ``max_n w_n`` while the
ideal balanced machine finishes at ``mean_n w_n``:

    balance_ratio = (sum w / N) / max_n w_n  =  mean / max   in (0, 1].

The paper evaluates this per layer with the partition computed from
*predicted* workloads (APRC filter magnitudes) but the ratio measured on
*actual* spike workloads — exactly what ``measure_balance`` does.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.cbws import Partition

__all__ = ["balance_ratio", "measure_balance", "throughput_gain"]


def balance_ratio(lane_workloads: Sequence[float]) -> float:
    w = np.asarray(lane_workloads, dtype=np.float64)
    mx = w.max(initial=0.0)
    if mx <= 0.0:
        return 1.0
    return float(w.mean() / mx)


def measure_balance(partition: Partition, actual_workloads: Sequence[float]) -> float:
    """Balance ratio when ``partition`` (built from predictions) runs lanes
    whose true per-channel work is ``actual_workloads``."""
    w = np.asarray(actual_workloads, dtype=np.float64)
    lane = [w[list(g)].sum() if g else 0.0 for g in partition.groups]
    return balance_ratio(lane)


def throughput_gain(ratio_after: float, ratio_before: float) -> float:
    """Relative actual-throughput gain implied by balance-ratio improvement.

    Lane-parallel completion time scales as max-lane work = total/(N*ratio),
    so throughput ∝ ratio and the gain is the plain ratio of ratios.
    """
    return ratio_after / ratio_before
