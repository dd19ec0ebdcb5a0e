"""Weight interchange with the JAX reference package.

The reference's ``init_snn`` returns ``{"conv": [{"w", "b"}], "dense":
[{"w", "b"}]}`` with RRIO conv weights and (din, dout) dense weights — the
layout the port keeps at its public functions.  These two functions move
such a dict, as numpy arrays, into torch tensors and back, bit for bit, so
both packages compute with identical weights.  Neither imports JAX: the
caller hands over numpy arrays (``np.asarray`` of each JAX leaf).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["from_jax_params", "to_numpy_params"]


def _map(params: Dict, fn) -> Dict:
    return {k: [{n: fn(a) for n, a in layer.items()} for layer in params[k]]
            for k in ("conv", "dense")}


def from_jax_params(np_params: Dict, device=None) -> Dict:
    """numpy (or array-like) parameter dict -> float32 torch tensors on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    return _map(np_params, lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(dev))


def to_numpy_params(params: Dict) -> Dict:
    """torch parameter dict (any device) -> float32 numpy arrays."""
    return _map(params, lambda t: t.detach().cpu().numpy())
