"""Fused LIF step: the wrapper of kernel ``csrc/lif_fused.cu`` and its plain
version (the reference's ``repro.kernels.lif.lif_fused_pallas``).

Per element, in float32: ``vf = v + z; s = vf >= v_th; v' = vf - v_th * s``;
both outputs are stored in ``v``'s type (float32 or bfloat16).  ``z`` is a
materialized synaptic current; the layer-level fusion that never writes it
to memory is ``kernels.spiking_conv_lif``.  This is the building block for
callers that stream one timestep at a time (``kernels.ops.lif_fused``, and
the T=1 two-kernel path: ``spiking_conv`` then ``lif_fused`` equals the
fused ``spiking_conv_lif`` with T=1).

Given CPU tensors the wrapper computes through its plain version; given
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import lif_fused_ref

__all__ = ["lif_fused", "lif_fused_plain", "DTYPES"]

# storage types the kernel takes, in the order of its dtype argument
DTYPES = (torch.float32, torch.bfloat16)

lif_fused_plain = lif_fused_ref


def lif_fused(v: torch.Tensor, z: torch.Tensor, v_th: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """v, z: tensors of one shape and type (float32 or bfloat16).  Returns
    (v_new, spikes), both in v's type."""
    if v.device.type == "cpu":
        return lif_fused_plain(v, z, v_th)
    fn = "lif_fused"
    dev = _build.check_cuda_args(fn, DTYPES, v=v, z=z)
    if v.shape != z.shape or v.dtype != z.dtype:
        raise ValueError(f"{fn}: v {tuple(v.shape)} {v.dtype} and z "
                         f"{tuple(z.shape)} {z.dtype} must have one shape "
                         f"and type")
    v_new, s = torch.empty_like(v), torch.empty_like(v)
    if v.numel() == 0:
        return v_new, s
    _build.launch(dev, fn, _build.entry("lif_fused"), v.data_ptr(),
                  z.data_ptr(), v_new.data_ptr(), s.data_ptr(), v.numel(),
                  DTYPES.index(v.dtype), float(v_th))
    lif_fused.launches += 1
    return v_new, s


lif_fused.launches = 0
