"""Spike encoders: images -> spike trains over T timesteps.

``poisson``  — rate coding: spike[t] ~ Bernoulli(pixel)   (classic SNN input)
``direct``   — the analog frame is injected as constant input current each
               timestep (first spiking layer does the conversion).

``poisson_encode`` draws from an explicit ``torch.Generator``: it gives other
bits than ``jax.random`` from the same seed, so cross-package tests feed
both sides one numpy-made train instead.
"""
from __future__ import annotations

import torch

__all__ = ["poisson_encode", "direct_encode"]


def poisson_encode(generator: torch.Generator, x: torch.Tensor,
                   timesteps: int) -> torch.Tensor:
    """x in [0,1], shape (...,) -> spikes (T, ...) in {0,1}."""
    u = torch.rand((timesteps,) + tuple(x.shape), generator=generator,
                   dtype=x.dtype, device=x.device)
    return (u < x).to(x.dtype)


def direct_encode(x: torch.Tensor, timesteps: int) -> torch.Tensor:
    """Repeat the frame as input current at every timestep: (T, ...)."""
    return x.unsqueeze(0).expand((timesteps,) + tuple(x.shape))
