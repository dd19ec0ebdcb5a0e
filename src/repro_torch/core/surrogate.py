"""Surrogate gradients for the non-differentiable spike function.

Forward: Heaviside step  U(v - v_th)  (paper Eq. 3).
Backward: fast-sigmoid (SuperSpike), triangle or arctan surrogate, selectable.

``heaviside`` is the *inference-only* step: differentiating through it is
a silent-zero-gradient bug (the derivative is 0 a.e.), so its backward
raises instead of returning zeros — training code must go through
``spike_fn``.
"""
from __future__ import annotations

import torch

__all__ = ["spike_fn", "heaviside", "surrogate_grad", "SURROGATE_KINDS",
           "NonDifferentiableSpikeError"]

SURROGATE_KINDS = ("fast_sigmoid", "triangle", "arctan")


class NonDifferentiableSpikeError(TypeError):
    """Raised when ``heaviside`` is differentiated (gradient is 0 a.e.)."""


def surrogate_grad(v: torch.Tensor, alpha: float, kind: str) -> torch.Tensor:
    """d(spike)/dv of the chosen surrogate, evaluated at ``v = V - V_th``."""
    if kind == "fast_sigmoid":
        # SuperSpike: 1 / (1 + alpha*|v|)^2
        return 1.0 / (1.0 + alpha * v.abs()) ** 2
    if kind == "triangle":
        return torch.clamp(1.0 - alpha * v.abs(), min=0.0)
    if kind == "arctan":
        return 1.0 / (1.0 + (alpha * v) ** 2)
    raise ValueError(f"unknown surrogate {kind!r}; expected one of "
                     f"{SURROGATE_KINDS}")


class _Heaviside(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v):
        return (v >= 0.0).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        raise NonDifferentiableSpikeError(
            "heaviside() has zero gradient almost everywhere; differentiating "
            "through it silently kills training. Use spike_fn() (surrogate "
            "gradient) or one of the differentiable snn_apply backends "
            "('ref', 'batched').")


def heaviside(v: torch.Tensor) -> torch.Tensor:
    """Straight Heaviside — used at pure-inference time.  Its backward
    raises (see module doc) rather than producing zero gradients."""
    return _Heaviside.apply(v)


class _SpikeFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, alpha, kind):
        ctx.save_for_backward(v)
        ctx.alpha, ctx.kind = alpha, kind
        return (v >= 0.0).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        return g * surrogate_grad(v, ctx.alpha, ctx.kind).to(g.dtype), None, None


def spike_fn(v: torch.Tensor, alpha: float = 10.0,
             kind: str = "fast_sigmoid") -> torch.Tensor:
    """Spike = U(v);  d(spike)/dv given by the chosen surrogate."""
    return _SpikeFn.apply(v, alpha, kind)
