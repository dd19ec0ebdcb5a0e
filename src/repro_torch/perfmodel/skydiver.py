"""Cycle-level performance model of the Skydiver accelerator (paper §III-A).

The FPGA cannot be synthesized here; this model reproduces the paper's
throughput/energy *methodology* so Table I rows can be derived from measured
spike workloads:

  * M filter-based SPE clusters (output-channel parallel)
  * N channel-based SPEs per cluster (input-channel parallel)
  * 4 row-streams per SPE (row-parallel within a channel)
  * event-driven: one synaptic-update op per (input spike x filter tap x
    output channel); zero spikes are skipped by the spike scheduler.

Per layer, lane ``(m, n)`` performs
    ops(m, n) = R^2 * |out_channels(m)| * spikes(in_channels(n))
and the layer finishes when the slowest lane finishes (the balance-ratio
mechanism).  Timesteps are serialized (spatio-*temporal* workload: the
per-timestep imbalance is what CBWS absorbs, Fig. 2).

Calibration: 200 MHz clock, 0.96 W on-chip power (paper Table I).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from repro_torch.config import SNNConfig
from repro_torch.core.cbws import Partition

__all__ = ["HardwareConfig", "LayerPerf", "NetPerf", "XC7Z045",
           "simulate_network"]


@dataclass(frozen=True)
class HardwareConfig:
    clock_hz: float = 200e6
    power_w: float = 0.96
    num_clusters: int = 8        # M
    num_spes: int = 4            # N
    streams_per_spe: int = 4
    # fixed per-layer overhead (pipeline fill, weight-bank switch), cycles
    layer_overhead_cycles: int = 64


XC7Z045 = HardwareConfig()


@dataclass(frozen=True)
class LayerPerf:
    cycles: int
    ideal_cycles: int
    total_sops: float            # synaptic operations (the paper's GSOp unit)
    balance: float               # ideal/actual (per-timestep barriers)
    balance_spartus: float       # Spartus [15]: mean/max of TOTAL lane busy


@dataclass(frozen=True)
class NetPerf:
    layers: List[LayerPerf]

    @property
    def total_cycles(self) -> int:
        return sum(l.cycles for l in self.layers)

    @property
    def total_sops(self) -> float:
        return sum(l.total_sops for l in self.layers)

    def fps(self, hw: HardwareConfig) -> float:
        return hw.clock_hz / max(1, self.total_cycles)

    def energy_j(self, hw: HardwareConfig) -> float:
        return hw.power_w / self.fps(hw)

    def gsops(self, hw: HardwareConfig) -> float:
        """Effective synaptic-op throughput (paper's GSOp/s)."""
        return self.total_sops * self.fps(hw) / 1e9

    @property
    def balance(self) -> float:
        ideal = sum(l.ideal_cycles for l in self.layers)
        return ideal / max(1, self.total_cycles)

    @property
    def balance_spartus(self) -> float:
        """The paper's metric (Spartus [15]): per-lane busy cycles summed
        over the whole inference, balance = mean/max — work-weighted across
        layers."""
        num = sum(l.total_sops for l in self.layers)
        den = sum(l.total_sops / max(l.balance_spartus, 1e-9)
                  for l in self.layers)
        return num / max(den, 1e-9)


def _lane_cycles(per_in_channel_spikes: np.ndarray,
                 in_partition: Partition,
                 out_partition: Partition,
                 r: int, streams: int, hw: HardwareConfig):
    """max/ideal lane cycles for one timestep of one layer.

    When a layer has fewer output channels than clusters (e.g. the seg net's
    final 1C3), the controller splits output *rows* across the otherwise-idle
    clusters (the 4-stream row split generalized), so per-cluster output work
    is the uniform fraction cout/M."""
    s = np.asarray(per_in_channel_spikes, dtype=np.float64)
    total_channels = sum(len(g) for g in out_partition.groups)
    M = out_partition.num_groups
    N = in_partition.num_groups
    row_split = total_channels < M
    # likewise, a layer with fewer INPUT channels than SPEs (seg net layer 0:
    # 3 RGB channels on 4 SPEs) splits each channel's spatial events across
    # the SPEs instead of idling one — per-SPE share becomes uniform.
    cin_total = sum(len(g) for g in in_partition.groups)
    col_split = cin_total < N
    total_ops = 0.0
    worst = 0.0
    lane_ops = np.zeros((M, N))
    for mi, m_group in enumerate(out_partition.groups):
        cout_m = total_channels / M if row_split else len(m_group)
        for ni, n_group in enumerate(in_partition.groups):
            if col_split:
                ops = r * r * cout_m * s.sum() / N
            else:
                ops = r * r * cout_m * s[list(n_group)].sum() if n_group else 0.0
            total_ops += ops
            lane_ops[mi, ni] = ops
            worst = max(worst, np.ceil(ops / streams))
    lanes = max(1, M * in_partition.num_groups)
    ideal = np.ceil(total_ops / (lanes * streams))
    return int(worst), int(ideal), float(total_ops), lane_ops


def simulate_network(
    cfg: SNNConfig,
    per_layer_timestep_channel_spikes: Sequence[np.ndarray],  # layer -> (T, Cin)
    in_partitions: Sequence[Partition],
    out_partitions: Sequence[Partition],
    hw: HardwareConfig = XC7Z045,
) -> NetPerf:
    """Simulate one frame.  ``per_layer_timestep_channel_spikes[l][t, c]`` is
    the measured spike count entering layer ``l`` from input channel ``c`` at
    timestep ``t`` (layer 0 sees the encoded input)."""
    layers: List[LayerPerf] = []
    for l, spikes_tc in enumerate(per_layer_timestep_channel_spikes):
        spikes_tc = np.asarray(spikes_tc, dtype=np.float64)
        cycles = hw.layer_overhead_cycles
        ideal = hw.layer_overhead_cycles
        ops_total = 0.0
        lane_busy = None
        for t in range(spikes_tc.shape[0]):
            c, i, o, lane = _lane_cycles(spikes_tc[t], in_partitions[l],
                                         out_partitions[l], cfg.kernel_size,
                                         hw.streams_per_spe, hw)
            cycles += c
            ideal += i
            ops_total += o
            lane_busy = lane if lane_busy is None else lane_busy + lane
        mx = lane_busy.max() if lane_busy is not None else 0.0
        spartus = float(lane_busy.mean() / mx) if mx > 0 else 1.0
        layers.append(LayerPerf(cycles=cycles, ideal_cycles=ideal,
                                total_sops=ops_total,
                                balance=ideal / max(1, cycles),
                                balance_spartus=spartus))
    return NetPerf(layers=layers)
