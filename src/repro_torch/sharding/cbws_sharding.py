"""CBWS-driven placement for the distributed layer (the reference's
``repro.sharding.cbws_sharding``).

Two applications of the paper's scheduler at mesh granularity:

1. ``snn_channel_permutation``: permute SNN conv output channels so each
   `model`-axis shard owns a contiguous, workload-balanced channel group
   (the chip-level version of the SPE-cluster assignment).  Sharding needs
   equal group sizes, so the equal-size CBWS variant is used.

2. ``expert_placement``: permute the MoE expert axis so each
   expert-parallel shard owns a load-balanced expert *group*.  Expert load
   plays the role of channel spike rate and is predicted offline, like
   APRC.

Both produce plain permutations applied to the weights once at load time
(no runtime cost, the paper's key property); ``apply_expert_permutation``
applies one to numpy arrays or torch tensors.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.core.cbws import cbws_partition_equal

__all__ = ["expert_placement", "snn_channel_permutation", "placement_balance",
           "apply_expert_permutation"]


def expert_placement(expert_loads: Sequence[float], num_shards: int
                     ) -> np.ndarray:
    """Permutation of the expert axis: experts of shard j occupy the
    contiguous block [j*E/N, (j+1)*E/N) after permutation."""
    p = cbws_partition_equal(np.asarray(expert_loads, dtype=np.float64),
                             num_shards)
    return p.permutation()


def snn_channel_permutation(filter_magnitudes: Sequence[float],
                            num_shards: int) -> np.ndarray:
    w = np.maximum(np.asarray(filter_magnitudes, dtype=np.float64), 0.0)
    return cbws_partition_equal(w, num_shards).permutation()


def placement_balance(loads: Sequence[float], perm: np.ndarray,
                      num_shards: int) -> float:
    """Balance ratio achieved by a contiguous-block placement under
    ``perm``."""
    loads = np.asarray(loads, dtype=np.float64)[perm]
    groups = np.array_split(np.arange(len(loads)), num_shards)
    lane = [loads[g].sum() for g in groups]
    mx = max(lane)
    return float(np.mean(lane) / mx) if mx > 0 else 1.0


def apply_expert_permutation(moe_params: Dict, perm: np.ndarray) -> Dict:
    """Permute the expert axis of one MoE layer's params and its router
    columns, preserving the network function exactly.  Leaves may be
    numpy arrays or torch tensors."""
    perm = np.asarray(perm, dtype=np.int64)

    def take(a, axis):
        if isinstance(a, torch.Tensor):
            return a.index_select(axis, torch.as_tensor(perm,
                                                        device=a.device))
        return np.take(a, perm, axis=axis)

    out = dict(moe_params)
    out["router"] = take(moe_params["router"], 1)
    for k in ("w_gate", "w_up", "w_down"):
        out[k] = take(moe_params[k], 0)
    return out
