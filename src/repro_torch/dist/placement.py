"""CBWS device placement: the paper's SPE assignment lifted to mesh
devices (the reference's ``repro.dist.placement``, numpy on the port's
``core.cbws``).

Skydiver's CBWS (Algorithm 1) bins predicted per-channel workload onto SPEs
so that no engine stalls; ``serving.admission`` reuses it to bin requests
into balanced micro-batch groups.  This module applies the same scheduler
one level up: heavy micro-batch *groups* (or requests, or lanes) go to mesh
*devices* so that every device retires comparable work.

  * offline: ``device_placement`` (CBWS) against ``fifo_placement``
    (striped) and ``assignment_balance``;
  * online: ``assign_groups_to_devices``, the greedy deal the serving
    engine runs each dispatch round when lanes are pinned to devices
    (``EngineConfig.lane_devices``): heaviest group first, onto an idle
    lane whose device carries the least in-flight work, ties broken by the
    dispatcher's fastest-first lane ranking.  Devices are keyed by the
    mesh entries the caller passes (``lane_devices``), never by a tensor's
    device: on the CPU every host entry's tensors report ``cpu``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.balance import balance_ratio
from repro_torch.core.cbws import cbws_partition, naive_partition

__all__ = ["device_placement", "fifo_placement", "assignment_balance",
           "assign_groups_to_devices"]


def device_placement(loads: Sequence[float], num_devices: int) -> np.ndarray:
    """CBWS assignment of items (micro-batch groups) to devices: returns an
    int array ``assign`` with ``assign[i]`` = device of item i."""
    loads = np.asarray(loads, dtype=np.float64)
    part = cbws_partition(loads, num_devices)
    assign = np.empty(len(loads), dtype=np.int64)
    for dev, grp in enumerate(part.groups):
        assign[list(grp)] = dev
    return assign


def fifo_placement(num_items: int, num_devices: int) -> np.ndarray:
    """Workload-blind striped assignment (the FIFO baseline of the paper's
    Figure 7): item i -> the naive contiguous partition."""
    part = naive_partition(num_items, num_devices)
    assign = np.empty(num_items, dtype=np.int64)
    for dev, grp in enumerate(part.groups):
        assign[list(grp)] = dev
    return assign


def assignment_balance(loads: Sequence[float], assign: Sequence[int],
                       num_devices: int) -> float:
    """Balance ratio (mean/max of per-device load sums, 1.0 = perfect) of an
    assignment; devices left empty count as zero load."""
    loads = np.asarray(loads, dtype=np.float64)
    assign = np.asarray(assign, dtype=np.int64)
    sums = [float(loads[assign == d].sum()) for d in range(num_devices)]
    return balance_ratio(sums)


def assign_groups_to_devices(group_works: Sequence[float],
                             lane_order: Sequence[int],
                             lane_devices: Sequence,
                             device_load: Dict) -> List[int]:
    """One dispatch round of online CBWS device placement.

    ``group_works`` must already be sorted heaviest-first (the admission
    window emits groups that way); ``lane_order`` is the idle lanes ranked
    fastest-first by the dispatcher; ``device_load`` maps a mesh entry to
    its in-flight predicted work (updated in place, so the caller's view
    stays current).  Returns the lane chosen for each group, at most
    ``len(lane_order)`` of them.
    """
    chosen: List[int] = []
    avail = list(lane_order)
    for work in group_works:
        if not avail:
            break
        # min() scans `avail` in order, so ties on device load fall back to
        # the dispatcher's fastest-first ranking
        lane = min(avail, key=lambda l: float(device_load.get(
            lane_devices[l], 0.0)))
        avail.remove(lane)
        dev = lane_devices[lane]
        device_load[dev] = float(device_load.get(dev, 0.0)) + float(work)
        chosen.append(lane)
    return chosen
