"""Skydiver core in PyTorch: the counterpart of ``repro.core``.

  neuron      LIF dynamics (Eq. 1-3)
  surrogate   surrogate-gradient spike function
  encoding    spike encoders
  snn_layers  spiking conv/dense with the APRC structural option
  snn_model   the paper's classification & segmentation networks
  snn_train   backend-selectable surrogate-gradient training step
  aprc        filter-magnitude workload prediction
  cbws        Algorithm 1 balanced partitioner
  balance     Spartus balance-ratio metric (Fig. 7)
  scheduler   channel→lane assignment
"""
from repro_torch.core.aprc import filter_magnitudes, layer_magnitudes, proportionality
from repro_torch.core.balance import balance_ratio, measure_balance, throughput_gain
from repro_torch.core.cbws import (Partition, cbws_partition,
                                   greedy_lpt_partition, naive_partition,
                                   partition_sums)
from repro_torch.core.encoding import direct_encode, poisson_encode
from repro_torch.core.neuron import LIFState, lif_init, lif_over_time, lif_step
from repro_torch.core.scheduler import (LayerSchedule, build_schedule,
                                        permute_conv_params)
from repro_torch.core.snn_model import (SNN, SNN_BACKENDS, ChunkCarry,
                                        SNNOutputs, finalize_logits,
                                        init_chunk_carry, init_snn,
                                        layer_shapes, snn_apply)
from repro_torch.core.snn_train import (accuracy, make_loss_fn,
                                        make_train_step)
from repro_torch.core.surrogate import SURROGATE_KINDS, heaviside, spike_fn

__all__ = [
    "filter_magnitudes", "layer_magnitudes", "proportionality",
    "balance_ratio", "measure_balance", "throughput_gain",
    "Partition", "cbws_partition", "greedy_lpt_partition", "naive_partition",
    "partition_sums", "direct_encode", "poisson_encode",
    "LIFState", "lif_init", "lif_over_time", "lif_step",
    "LayerSchedule", "build_schedule", "permute_conv_params",
    "SNN", "SNN_BACKENDS", "SNNOutputs", "init_snn", "layer_shapes",
    "snn_apply", "ChunkCarry", "finalize_logits", "init_chunk_carry",
    "accuracy", "make_loss_fn", "make_train_step",
    "SURROGATE_KINDS", "heaviside", "spike_fn",
]
