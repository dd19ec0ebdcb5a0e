"""RMSNorm (the norm every LM arch here uses) and LayerNorm, with their
statistics in float32 whatever the activations' dtype."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers.leaves import Leaves
from repro_torch.sharding.context import local_body

__all__ = ["RMSNorm", "rms_apply", "ln_apply", "rms_specs", "ln_specs"]


def rms_specs():
    return {"scale": (None,)}


def ln_specs():
    return {"scale": (None,), "bias": (None,)}


def rms_apply(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def ln_apply(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)
            + params["bias"].to(torch.float32)).to(x.dtype)


class RMSNorm(Leaves):
    """``rms_apply`` over one parameter, ``scale`` (ones at init)."""

    def __init__(self, d: int, eps: float = 1e-6, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones((d,), dtype=dtype,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Under a mesh, on x's local shards (``local_body``).  x enters
        the norm through one view on a single device, as ``to_local``
        hands it to the body on a mesh: the gradients of the norm's three
        uses of x are summed before the residual's joins them on both, so
        a group of one keeps the single device's bits."""
        with local_body(self, x, split_model=False, keep_tokens=True) as b:
            xl = x.view_as(x) if b.ctx is None else b.x
            return b.out(rms_apply(b.params, xl, self.eps), None)
