"""Leaky/Integrate-and-Fire dynamics — paper Eq. (1)-(3).

    V_i^l(t)     = V_i^l(t-1) + z_i^l(t) - V_th * Theta_i^l(t)        (1)
    z_i^l(t)     = sum_j W_ij^l Theta_j^{l-1}(t) + b_i^l              (2)
    Theta_i^l(t) = U(V_i^l(t^-) - V_th)                               (3)

i.e. integrate the synaptic current, fire when the membrane potential crosses
``V_th`` and reset by subtraction.  The paper's neuron is a non-leaky IF cell
(no decay term in Eq. 1); a leak factor is exposed for generality and defaults
to 1.0 (= the paper's model).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.surrogate import spike_fn

__all__ = ["LIFState", "lif_init", "lif_step", "lif_over_time"]


class LIFState(NamedTuple):
    v: torch.Tensor  # membrane potential, same shape as the layer activation


def lif_init(shape, dtype=torch.float32, device=None) -> LIFState:
    return LIFState(v=torch.zeros(shape, dtype=dtype, device=device))


def lif_step(
    state: LIFState,
    z: torch.Tensor,
    *,
    v_th: float = 1.0,
    leak: float = 1.0,
    surrogate_alpha: float = 10.0,
    surrogate_kind: str = "fast_sigmoid",
) -> Tuple[LIFState, torch.Tensor]:
    """One timestep of Eq. (1)+(3). Returns (new_state, spikes)."""
    v = state.v * leak + z
    spikes = spike_fn(v - v_th, surrogate_alpha, surrogate_kind)
    v = v - v_th * spikes  # reset by subtraction (Eq. 1 third term)
    return LIFState(v=v), spikes


def lif_over_time(
    z_seq: torch.Tensor,  # (T, ...) input currents per timestep
    *,
    v_th: float = 1.0,
    leak: float = 1.0,
    surrogate_alpha: float = 10.0,
    surrogate_kind: str = "fast_sigmoid",
) -> Tuple[torch.Tensor, LIFState]:
    """Run Eq. (1)-(3) over the leading time axis.

    Returns (spike trains (T, ...), final state).
    """
    state = lif_init(z_seq.shape[1:], z_seq.dtype, z_seq.device)
    spikes = []
    for z in z_seq:
        state, s = lif_step(state, z, v_th=v_th, leak=leak,
                            surrogate_alpha=surrogate_alpha,
                            surrogate_kind=surrogate_kind)
        spikes.append(s)
    return torch.stack(spikes), state
