"""Fused spiking-conv + LIF over all T timesteps: the wrapper of kernel
``csrc/spiking_conv_lif.cu`` and its plain version.

For each t: dV_t = conv(spikes[t], w) + bias (bias only where the
block's receptive inputs hold no spike), then ``v += dV_t; s = v >= v_th;
v -= v_th * s``.  The kernel keeps the membrane in registers from ``v0``
to ``v_final`` (the reference's
``repro.kernels.spiking_conv_lif.spiking_conv_lif_pallas``).  It takes
``v0`` and returns ``v_final``, so a caller can run T in chunks and thread
the membrane between them.

Given CPU tensors the wrapper computes through the plain version, a Python
loop over T of conv plus LIF; given CUDA tensors it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import spiking_conv_lif_ref
from repro_torch.kernels.spiking_conv import _conv_dims, plan_tiles

__all__ = ["spiking_conv_lif", "spiking_conv_lif_plain"]

# spiking_conv_lif_launch(x, v0, w, b, s, v, T, N, H, W, Cin, Cout, R, pad_lo,
#                         E_h, E_w, block_rows, cout_tile, v_th, stream)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 \
    + [ctypes.c_float, ctypes.c_void_p]

# The plain version is the oracle itself (per-t conv plus LIF).
spiking_conv_lif_plain = spiking_conv_lif_ref


def spiking_conv_lif(spikes: torch.Tensor, v0: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor, *, v_th: float = 1.0,
                     aprc: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """spikes: (T, B, H, W, Cin);  v0: (B, E_h, E_w, Cout).  Returns the
    output spike train (T, B, E_h, E_w, Cout) and the final membrane."""
    if spikes.device.type == "cpu":
        return spiking_conv_lif_plain(spikes, v0, w, bias, v_th=v_th,
                                      aprc=aprc)
    fn = "spiking_conv_lif"
    dev = _build.check_cuda_args(fn, spikes=spikes, v0=v0, w=w, bias=bias)
    if spikes.dim() != 5:
        raise ValueError(f"{fn}: spikes must be (T, B, H, W, Cin), got "
                         f"{tuple(spikes.shape)}")
    h, wd, cin, cout, r, pad_lo, e_h, e_w = _conv_dims(spikes, w, bias,
                                                      aprc, fn)
    t, n = spikes.shape[:2]
    if tuple(v0.shape) != (n, e_h, e_w, cout):
        raise ValueError(f"{fn}: v0 must be {(n, e_h, e_w, cout)}, got "
                         f"{tuple(v0.shape)}")
    block_rows, cout_tile = plan_tiles(e_w, r, cin, cout)
    s = torch.empty((t, n, e_h, e_w, cout), dtype=torch.float32, device=dev)
    v = torch.empty_like(v0)
    if t == 0:
        return s, v.copy_(v0)
    if v.numel() == 0:
        return s, v
    lib = _build.load("spiking_conv_lif", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.spiking_conv_lif_launch(
            spikes.data_ptr(), v0.data_ptr(), w.data_ptr(), bias.data_ptr(),
            s.data_ptr(), v.data_ptr(), t, n, h, wd, cin, cout, r, pad_lo,
            e_h, e_w, block_rows, cout_tile, float(v_th), stream)
    _build.check_launch(lib, fn, rc)
    spiking_conv_lif.launches += 1
    return s, v


spiking_conv_lif.launches = 0
