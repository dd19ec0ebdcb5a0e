"""Hand-written Hopper kernels, their wrappers and plain versions.

  spiking_conv      spike-driven conv (csrc/spiking_conv.cu) in its dV
                    mode and its hoisted mode (the first layer's conv and
                    T LIF steps), its input gradient
                    (csrc/conv_grad_input.cu), its weight gradient
                    (csrc/conv_grad_weights.cu) and SpikingConvFn
  spiking_conv_lif  fused conv + LIF over all T, with and without the saved
                    pre-reset membrane (csrc/spiking_conv_lif.cu), the
                    surrogate backward (csrc/lif_bwd.cu), SpikingConvLIFFn
                    and HoistedConvLIFFn
  lif               the elementwise LIF step (csrc/lif_fused.cu)
  ops               the public op layer over all of them (the reference's
                    kernels.ops), with the chunked fused layer
  ref               the plain-PyTorch oracles
  _build            nvcc build at first use and the ctypes binding

Importing this package compiles and loads nothing.
"""
