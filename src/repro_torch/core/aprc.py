"""APRC — Approximate Proportional Relation Construction (paper §III-B).

The *structural* half of APRC lives in ``snn_layers.conv2d`` (full padding,
stride 1).  This module holds the *prediction* half: filter magnitudes as the
offline per-output-channel workload proxy, plus the measurement used for the
Fig. 6 reproduction (spike-count vs magnitude relation with/without APRC).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "filter_magnitudes", "layer_magnitudes", "predicted_input_workloads",
    "proportionality",
]


def filter_magnitudes(w, mode: str = "sum") -> np.ndarray:
    """Magnitude of each filter = Σ of its elements (paper's definition).

    ``w``: (R, R, Cin, Cout) -> (Cout,), a tensor on any device or an
    array.  ``mode='abs'`` is a robustness variant (Σ|w|); the paper uses
    the raw sum, which is what Eq. (5) factors.  Summed in float64 on the
    host, as the reference does, so both packages find the same partitions.
    """
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w = np.asarray(w, dtype=np.float64)
    if mode == "abs":
        w = np.abs(w)
    elif mode != "sum":  # pragma: no cover
        raise ValueError(mode)
    return w.sum(axis=tuple(range(w.ndim - 1)))


def layer_magnitudes(params: Dict, mode: str = "sum") -> List[np.ndarray]:
    """Per-conv-layer output-channel magnitudes for a whole SNN."""
    return [filter_magnitudes(p["w"], mode) for p in params["conv"]]


def predicted_input_workloads(params: Dict, layer: int,
                              mode: str = "sum") -> np.ndarray:
    """Predicted workload of layer ``layer``'s *input* channels.

    The input channels of conv layer l are the output channels of layer l-1,
    whose spike counts APRC predicts via layer l-1's filter magnitudes.  For
    the first layer, input intensity is data- not weight-determined, so the
    proxy is uniform.
    """
    if layer == 0:
        cin = params["conv"][0]["w"].shape[2]
        return np.ones((cin,), dtype=np.float64)
    mags = filter_magnitudes(params["conv"][layer - 1]["w"], mode)
    # spike *counts* cannot be negative: clamp the proxy at 0 (a channel whose
    # net drive is negative virtually never fires under reset-by-subtraction)
    return np.maximum(mags, 0.0)


def proportionality(magnitudes: Sequence[float],
                    spike_counts: Sequence[float]) -> Dict[str, float]:
    """Quantify the Fig. 6 relation: Pearson r and Spearman rho between the
    predicted proxy and the measured spike counts."""
    m = np.asarray(magnitudes, dtype=np.float64)
    s = np.asarray(spike_counts, dtype=np.float64)
    if m.std() == 0 or s.std() == 0:
        return {"pearson": 0.0, "spearman": 0.0}
    pearson = float(np.corrcoef(m, s)[0, 1])

    def rankdata(x):
        order = np.argsort(x, kind="stable")
        ranks = np.empty_like(order, dtype=np.float64)
        ranks[order] = np.arange(len(x))
        return ranks

    rm, rs = rankdata(m), rankdata(s)
    spearman = float(np.corrcoef(rm, rs)[0, 1])
    return {"pearson": pearson, "spearman": spearman}
