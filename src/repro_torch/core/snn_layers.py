"""Spiking layers (conv / dense) with the APRC structural option.

APRC (paper §III-B): pad ``R-1`` zeros on every side of every channel and use
stride 1 ("full" convolution).  Then Eq. (5) holds exactly:

    sum_xy dV_n[t] = (sum w_n) * (sum_in in[t])

so per-output-channel workload is proportional to the filter magnitude.
Without APRC we use SAME padding (the conventional structure).

Layouts are the reference's: NHWC activations, RRIO ``(R, R, Cin, Cout)``
conv weights, ``(din, dout)`` dense weights.  ``conv2d`` is the one place
that converts to PyTorch's NCHW/OIHW, as views.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.neuron import LIFState, lif_step
from repro_torch.device import full_fp32

__all__ = ["conv2d", "dense", "init_conv", "init_dense", "spiking_conv_step",
           "spiking_dense_step", "conv_out_hw"]


def conv2d(x: torch.Tensor, w: torch.Tensor, *, aprc: bool) -> torch.Tensor:
    """NHWC x RRIO convolution; APRC = full padding + stride 1.  Returns
    NHWC (a view of PyTorch's channels-last output)."""
    r = w.shape[0]
    lo, hi = (r - 1, r - 1) if aprc else ((r - 1) // 2, r - 1 - (r - 1) // 2)
    xn = x.permute(0, 3, 1, 2)
    if lo != hi:
        xn, pad = F.pad(xn, (lo, hi, lo, hi)), 0
    else:
        pad = lo
    with full_fp32():
        out = F.conv2d(xn, w.permute(3, 2, 0, 1), padding=pad)
    return out.permute(0, 2, 3, 1)


def dense(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """``x @ w + b`` in full float32."""
    with full_fp32():
        return x @ p["w"] + p["b"]


def conv_out_hw(h: int, w: int, r: int, aprc: bool) -> Tuple[int, int]:
    return (h + r - 1, w + r - 1) if aprc else (h, w)


def init_conv(r: int, cin: int, cout: int, *, generator: torch.Generator,
              device: Optional[torch.device] = None,
              dtype=torch.float32) -> Dict:
    """He-normal RRIO filters, zero bias (the reference's init law; the
    bits differ from ``jax.random``'s — load JAX weights with
    ``repro_torch.interop.from_jax_params`` to compare like with like)."""
    fan_in = r * r * cin
    w = torch.randn((r, r, cin, cout), generator=generator, dtype=dtype)
    w = w * math.sqrt(2.0 / fan_in)
    return {"w": w.to(device), "b": torch.zeros((cout,), dtype=dtype,
                                                device=device)}


def init_dense(din: int, dout: int, *, generator: torch.Generator,
               device: Optional[torch.device] = None,
               dtype=torch.float32) -> Dict:
    w = torch.randn((din, dout), generator=generator, dtype=dtype)
    w = w * math.sqrt(2.0 / din)
    return {"w": w.to(device), "b": torch.zeros((dout,), dtype=dtype,
                                                device=device)}


def spiking_conv_step(
    params: Dict, state: LIFState, spikes_in: torch.Tensor,
    *, aprc: bool, v_th: float, surrogate_alpha: float = 10.0,
    surrogate_kind: str = "fast_sigmoid", backend: str = "ref",
) -> Tuple[LIFState, torch.Tensor]:
    """One timestep: synaptic current (Eq. 2) then LIF update (Eq. 1+3).

    ``backend="ref"``/``"batched"`` is the differentiable plain path;
    ``backend="hopper"`` runs the fused conv+LIF kernel
    (``kernels.spiking_conv_lif``) with T=1.
    """
    if backend == "hopper":
        from repro_torch.kernels.spiking_conv_lif import spiking_conv_lif
        s, v = spiking_conv_lif(spikes_in[None], state.v, params["w"],
                                params["b"], v_th=float(v_th), aprc=aprc,
                                surrogate_alpha=surrogate_alpha,
                                surrogate_kind=surrogate_kind)
        return LIFState(v=v), s[0]
    if backend not in ("ref", "batched"):
        from repro_torch.core.snn_model import SNN_BACKENDS
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {SNN_BACKENDS} "
            "(the model-level switch lives in core.snn_model.snn_apply)")
    z = conv2d(spikes_in, params["w"], aprc=aprc) + params["b"]
    return lif_step(state, z, v_th=v_th, surrogate_alpha=surrogate_alpha,
                    surrogate_kind=surrogate_kind)


def spiking_dense_step(
    params: Dict, state: LIFState, spikes_in: torch.Tensor,
    *, v_th: float, surrogate_alpha: float = 10.0,
    surrogate_kind: str = "fast_sigmoid",
) -> Tuple[LIFState, torch.Tensor]:
    z = dense(spikes_in, params)
    return lif_step(state, z, v_th=v_th, surrogate_alpha=surrogate_alpha,
                    surrogate_kind=surrogate_kind)
