"""Channel→lane scheduling: glue between APRC prediction and CBWS
partitioning.

``build_schedule`` produces, per conv layer:
  * the *output-channel* partition across M SPE clusters (filter-parallel),
  * the *input-channel* partition across N SPEs within a cluster
    (channel-parallel — the paper's Algorithm 1 use case),
  * channel permutations that realize each partition as a contiguous
    re-layout.

On the card the lanes are only a permutation of channels, which the kernels
tile as they choose: ``lay_out`` gives the weights the ``hopper`` backend
runs on and the order that returns its per-channel counts to canonical
order, derived once per params version by the serving cache; the identity,
as ``build_schedule`` gives it (its output partition is always contiguous
striping), derives to nothing.

Modes map to the paper's Fig. 7 ablation:
  'none'       naive contiguous striping                     (neither)
  'cbws'       CBWS on magnitudes of the *unmodified* net    (CBWS alone)
  'aprc+cbws'  CBWS on magnitudes of the APRC-modified net   (both)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import SNNConfig
from repro_torch.core import aprc
from repro_torch.core.cbws import Partition, cbws_partition, naive_partition

__all__ = ["LayerSchedule", "build_schedule", "permute_conv_params",
           "ChannelLayout", "lay_out"]


@dataclass(frozen=True)
class LayerSchedule:
    out_partition: Partition       # output channels → M clusters
    in_partition: Partition        # input channels → N SPEs
    out_perm: np.ndarray           # contiguous re-layout permutations
    in_perm: np.ndarray


def build_schedule(params: Dict, cfg: SNNConfig, mode: str = "aprc+cbws",
                   ) -> List[LayerSchedule]:
    scheds: List[LayerSchedule] = []
    M, N = cfg.num_spe_clusters, cfg.num_spes_per_cluster
    for l, p in enumerate(params["conv"]):
        cin, cout = p["w"].shape[2], p["w"].shape[3]
        # Within a layer every output channel applies to ALL input spikes, so
        # cluster work is uniform per channel -> equal-size split is optimal.
        # The spike-count imbalance lives on the INPUT channels (= previous
        # layer's outputs, whose rates APRC predicts): CBWS partitions those
        # across the N channel-SPEs (Algorithm 1's use case).
        outp = naive_partition(cout, M)
        if mode == "none":
            inp = naive_partition(cin, N)
        elif mode in ("cbws", "aprc+cbws"):
            in_w = aprc.predicted_input_workloads(params, l)
            inp = cbws_partition(in_w, N)
        else:
            raise ValueError(
                f"unknown schedule mode {mode!r}; expected 'none', 'cbws' "
                f"or 'aprc+cbws'")
        scheds.append(LayerSchedule(
            out_partition=outp, in_partition=inp,
            out_perm=outp.permutation(), in_perm=inp.permutation()))
    return scheds


def permute_conv_params(params: Dict, scheds: List[LayerSchedule]) -> Dict:
    """Physically re-layout conv weights so each lane's channels are
    contiguous.  The inverse permutation is applied to the next layer's
    input axis, so the network function is unchanged (verified by tests)."""
    new_conv = []
    prev_out_perm = None
    for l, p in enumerate(params["conv"]):
        w, b = p["w"], p["b"]
        perm = torch.as_tensor(scheds[l].out_perm, device=w.device)
        if prev_out_perm is not None:
            w = w[:, :, prev_out_perm, :]
        w = w[:, :, :, perm]
        b = b[perm]
        new_conv.append({"w": w, "b": b})
        prev_out_perm = perm
    new_params = dict(params)
    new_params["conv"] = new_conv
    if params.get("dense") and prev_out_perm is not None:
        # un-permute at the flatten boundary: dense weights are indexed by
        # (h*w*c) with c fastest in NHWC flatten → permute the c sub-axis.
        d0 = params["dense"][0]
        din = d0["w"].shape[0]
        c = len(prev_out_perm)
        hw = din // c
        d0p = {k: (t.reshape(hw, c, -1)[:, prev_out_perm, :].reshape(din, -1)
                   if k != "b" else t) for k, t in d0.items()}
        new_params["dense"] = [d0p] + params["dense"][1:]
    return new_params


@dataclass(frozen=True, eq=False)
class ChannelLayout:
    """What a ``hopper`` forward runs on: ``source``'s weights laid out
    under a schedule (``params``) and, per conv layer, the device index
    order that returns its (t, Cout) counts to canonical channel order
    (None: ``params`` is ``source``)."""
    source: Dict
    params: Dict
    count_order: Optional[Tuple[torch.Tensor, ...]] = None


def lay_out(params: Dict, schedule: Optional[Sequence[LayerSchedule]],
            ) -> ChannelLayout:
    """``params`` laid out under ``schedule`` (a ``build_schedule``
    result, or None).  Where every ``out_perm`` is the identity nothing is
    copied and no count is gathered."""
    perms = [s.out_perm for s in schedule or ()]
    if all(np.array_equal(p, np.arange(len(p))) for p in perms):
        return ChannelLayout(params, params)
    dev = params["conv"][0]["w"].device
    return ChannelLayout(params, permute_conv_params(params, schedule), tuple(
        torch.as_tensor(np.argsort(p), device=dev) for p in perms))
