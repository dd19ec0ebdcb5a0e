"""Skydiver on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its layout
and names (``config``, ``configs``, ``core``, ``kernels``, ``launch``) and
never imports it or JAX.  Every Pallas kernel on a ported path has a
hand-written CUDA counterpart under ``kernels/csrc``.  Entry points put
their tensors on the card unless the caller asks for the CPU.
"""
from repro_torch.config import (ArchConfig, SNNConfig, get_arch, get_snn,
                                list_archs, list_snns, register,
                                register_snn)

__all__ = ["ArchConfig", "SNNConfig", "get_arch", "get_snn", "list_archs",
           "list_snns", "register", "register_snn"]
