"""``Leaves``: an ``nn.Module`` whose parameters read by leaf name.

The layer functions take their parameters as a mapping of the reference's
leaf names (``params["wq"]``, ``"bq" in params``), so they work on a plain
dict of tensors and on the layer modules alike; a module's own
``forward`` calls the same function on itself.  A nested leaf group of the
reference (MoE's ``shared``, MLA's ``q_norm``) is a submodule, read by its
name the same way.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

__all__ = ["Leaves", "normal"]


class Leaves(nn.Module):
    """A module whose direct parameters and submodules are also its
    items."""

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        return self._modules[name]

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def normal(shape: Sequence[int], scale: float,
           generator: Optional[torch.Generator], dtype, device
           ) -> nn.Parameter:
    """A parameter of ``shape`` drawn N(0, 1) x ``scale`` from
    ``generator``, made where the generator lives (``device``); with no
    generator it is left uninitialised, for weights loaded after it (the
    ``meta`` device makes no storage at all)."""
    if generator is None:
        t = torch.empty(tuple(shape), dtype=dtype, device=device)
    else:
        t = torch.randn(tuple(shape), generator=generator, dtype=dtype,
                        device=device).mul_(scale)
    return nn.Parameter(t)
