"""The public kernel ops (the reference's ``repro.kernels.ops``).

Each op delegates to its kernel's wrapper, which launches the hand-written
kernel on CUDA tensors and computes through its plain version on CPU
tensors.  ``spiking_conv`` and ``spiking_conv_lif`` are differentiable
(their wrappers go through ``SpikingConvFn`` / ``SpikingConvLIFFn`` when a
gradient is needed), and so is ``spiking_conv_lif_chunked``, which chains
the fused op over segments of T.

The reference's TPU knobs (``block_rows`` and ``num_groups`` of the conv
grid, ``lif_fused``'s block shape, ``interpret``, the choice of backward)
have no counterpart: the conv kernels plan their own tiles, and the LIF
kernel is a grid-stride loop over any element count, so nothing is padded.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import lif as _lif
from repro_torch.kernels import spiking_conv as _sc
from repro_torch.kernels import spiking_conv_lif as _scl
from repro_torch.kernels.spiking_conv import skip_table_fraction

__all__ = ["spiking_conv", "lif_fused", "spiking_conv_lif",
           "spiking_conv_lif_chunked", "skip_table_fraction"]


def spiking_conv(spikes: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 *, aprc: bool = True) -> torch.Tensor:
    """Spike-driven conv (kernel A, ``kernels.spiking_conv``): dV =
    conv(spikes, w) + bias, (B, H, W, Cin) -> (B, E_h, E_w, Cout).
    Differentiable (transposed-tap backward)."""
    return _sc.spiking_conv(spikes, w, bias, aprc=aprc)


def lif_fused(v: torch.Tensor, z: torch.Tensor, v_th: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused membrane update + fire + reset over (N, C) tensors (kernel F,
    ``kernels.lif``).  Returns (v_new, spikes) in v's type."""
    return _lif.lif_fused(v.contiguous(), z.contiguous(), v_th)


def spiking_conv_lif(
    spikes: torch.Tensor, v0: torch.Tensor, w: torch.Tensor,
    bias: torch.Tensor, *, v_th: float = 1.0, aprc: bool = True,
    surrogate_alpha: float = 10.0, surrogate_kind: str = "fast_sigmoid",
    spec: Optional[object] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused conv+LIF over a whole spike train (kernel B; under autograd C,
    with the backward D and E): spikes (T, B, H, W, Cin), v0 (B, E_h, E_w,
    Cout).  Returns the output spike train and the final membrane.

    ``spec`` (an execution spec, duck-typed) overrides the surrogate
    kwargs.  Spec fields this op cannot apply are loud errors, never
    silent drops: it IS the kernel backend (``spec.backend`` must be
    "hopper"), T comes from the spike train's leading axis, a schedule is
    applied by permuting the weights upstream, and chunking is
    ``spiking_conv_lif_chunked``'s."""
    if spec is not None:
        spec_backend = getattr(spec, "backend", None)
        if spec_backend is not None and spec_backend != "hopper":
            raise ValueError(
                f"spec.backend={spec_backend!r} cannot be applied by "
                f"ops.spiking_conv_lif — this op IS the hopper kernel; "
                f"route backend selection through snn_apply")
        t_spec = getattr(spec, "timesteps", None)
        if t_spec is not None and t_spec != spikes.shape[0]:
            raise ValueError(
                f"spec.timesteps={t_spec} conflicts with the spike train's "
                f"T={spikes.shape[0]} — the kernel runs the train it is "
                f"given; resolve T upstream")
        if getattr(spec, "resolved_schedule", lambda: None)() is not None:
            raise ValueError(
                "spec.schedule_mode cannot be applied by ops.spiking_conv_lif"
                " — the CBWS schedule permutes weights upstream "
                "(core.scheduler.permute_conv_params); pass pre-permuted "
                "weights or go through snn_apply with schedule=")
        chunk_t = getattr(spec, "chunk_timesteps", None)
        if chunk_t is not None:
            raise ValueError(
                f"spec.chunk_timesteps={chunk_t} cannot be applied by "
                f"ops.spiking_conv_lif — this op runs the whole train it is "
                f"given; chunk upstream via ops.spiking_conv_lif_chunked or "
                f"core.snn_apply_chunked (the serving engine does this)")
        surrogate_alpha = getattr(spec, "surrogate_alpha", surrogate_alpha)
        surrogate_kind = getattr(spec, "surrogate_kind", surrogate_kind)
    return _scl.spiking_conv_lif(spikes, v0, w, bias, v_th=v_th, aprc=aprc,
                                 surrogate_alpha=surrogate_alpha,
                                 surrogate_kind=surrogate_kind)


def spiking_conv_lif_chunked(
    spikes: torch.Tensor, v0: torch.Tensor, w: torch.Tensor,
    bias: torch.Tensor, *, chunk_timesteps: int, v_th: float = 1.0,
    aprc: bool = True, surrogate_alpha: float = 10.0,
    surrogate_kind: str = "fast_sigmoid",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused conv+LIF in segments of ``chunk_timesteps``, threading the
    membrane between segments (``v_final`` of one call is ``v0`` of the
    next).

    Bit-identical to the single whole-T ``spiking_conv_lif`` call for every
    partition of T: the kernel's T loop is sequential per element, so a
    chunk boundary only writes out the membrane it would have kept in
    registers.  Differentiable: each segment goes through the fused op's
    autograd Function and BPTT chains across segments through the carried
    membrane."""
    from repro_torch.core.snn_model import chunk_lengths
    s_parts = []
    v, t0 = v0, 0
    for c in chunk_lengths(spikes.shape[0], chunk_timesteps):
        s, v = spiking_conv_lif(spikes[t0:t0 + c].contiguous(),
                                v.contiguous(), w, bias, v_th=v_th,
                                aprc=aprc, surrogate_alpha=surrogate_alpha,
                                surrogate_kind=surrogate_kind)
        s_parts.append(s)
        t0 += c
    return torch.cat(s_parts, dim=0), v


# the oracles, for tests
spiking_conv_ref = ref.spiking_conv_ref
lif_fused_ref = ref.lif_fused_ref
spiking_conv_lif_ref = ref.spiking_conv_lif_ref
