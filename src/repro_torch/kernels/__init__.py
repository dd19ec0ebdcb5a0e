"""Hand-written Hopper kernels, their wrappers and plain versions.

  spiking_conv      spike-driven conv (csrc/spiking_conv.cu)
  spiking_conv_lif  fused conv + LIF over all T (csrc/spiking_conv_lif.cu)
  ref               the plain-PyTorch oracles
  _build            nvcc build at first use and the ctypes binding

Importing this package compiles and loads nothing.
"""
