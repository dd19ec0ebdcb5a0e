"""Plain-PyTorch oracles for every kernel (the allclose targets).

These are also the kernels' plain versions: a wrapper given CPU tensors
computes through them, and ``chip_smoke.py`` holds each kernel against
them on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.snn_layers import conv2d

__all__ = ["spiking_conv_ref", "lif_fused_ref", "spiking_conv_lif_ref"]


def spiking_conv_ref(spikes: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     *, aprc: bool = True) -> torch.Tensor:
    """Reference for the spike-driven conv: plain conv (full or same pad).

    spikes: (B, H, W, Cin);  w: (R, R, Cin, Cout);  b: (Cout,)
    returns dV: (B, E, E', Cout) with E = H+R-1 in APRC mode.
    """
    out = conv2d(spikes.float(), w.float(), aprc=aprc)
    return (out + b.float()).to(spikes.dtype)


def lif_fused_ref(v: torch.Tensor, z: torch.Tensor, v_th: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference fused LIF step: integrate, fire, reset-by-subtraction."""
    vf = v.float() + z.float()
    s = (vf >= v_th).to(v.dtype)
    v_new = (vf - v_th * s.float()).to(v.dtype)
    return v_new, s


def spiking_conv_lif_ref(spikes: torch.Tensor, v0: torch.Tensor,
                         w: torch.Tensor, b: torch.Tensor, *,
                         v_th: float = 1.0, aprc: bool = True,
                         save_u: bool = False) -> Tuple[torch.Tensor, ...]:
    """Oracle for the fused conv+LIF kernel: the explicit composition of
    ``spiking_conv_ref`` and ``lif_fused_ref``, a Python loop over T.

    spikes: (T, B, H, W, Cin);  v0: (B, E, E', Cout).
    Returns (spike train (T, B, E, E', Cout), final membrane), and with
    ``save_u`` also the pre-reset membrane train ``u_t = v_{t-1} + dV_t``
    (the training residual; at a threshold flip it says how close to
    ``v_th`` the membrane was).
    """
    v, s_seq, u_seq = v0, [], []
    for s_t in spikes:
        z = spiking_conv_ref(s_t, w, b, aprc=aprc).float()
        if save_u:
            u_seq.append(v.float() + z)
        v, s = lif_fused_ref(v, z, v_th)
        s_seq.append(s)
    if save_u:
        return torch.stack(s_seq), v, torch.stack(u_seq)
    return torch.stack(s_seq), v
