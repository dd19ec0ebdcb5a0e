"""Surrogate-gradient training of the paper's SNNs: the counterpart of
``repro.core.snn_train``.

One loss and one step for every backend (``core.snn_model.SNN_BACKENDS``):
``"ref"`` trains through the timestep-outer scan, ``"batched"`` through the
time-batched plain ops, and ``"hopper"`` through the hand-written kernels,
whose autograd Functions run the surrogate BPTT on the backward kernels.
So the dataflow that is trained is the one that is served.

Parameters are the ``init_snn`` dict (``{"conv": [{"w", "b"}], "dense":
[...]}``), and the step is a plain function on it, like the reference's
(no ``torch.optim``).  Configuration comes as loose keyword arguments.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.config import SNNConfig
from repro_torch.core.snn_model import snn_apply

__all__ = ["make_loss_fn", "make_grad_rows_fn", "make_train_step",
           "accuracy"]


def make_loss_fn(cfg: SNNConfig, *, backend: str = "ref",
                 surrogate_alpha: float = 10.0,
                 surrogate_kind: str = "fast_sigmoid") -> Callable:
    """``(params, x, y) -> loss``: cross-entropy on the readout logits of
    the selected backend.  ``x`` is (B, H, W, Cin) frames or a (T, B, ...)
    spike train; ``y`` (B,) integer labels."""
    def loss_fn(params: Dict, x: torch.Tensor, y: torch.Tensor
                ) -> torch.Tensor:
        out = snn_apply(params, x, cfg, backend=backend,
                        surrogate_alpha=surrogate_alpha,
                        surrogate_kind=surrogate_kind)
        logp = torch.log_softmax(out.logits.float(), dim=-1)
        # the logits' batch size, not x.shape[0]: x may be a spike train
        return -logp[torch.arange(logp.shape[0], device=logp.device),
                     y.long()].mean()

    return loss_fn


def _value_and_grad(loss_fn: Callable, params: Dict, *args
                    ) -> Tuple[torch.Tensor, Dict]:
    """The loss and its gradient with respect to every leaf of ``params``.
    A leaf the loss does not reach raises, rather than reading as zero."""
    leaves, spec = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(leaves, spec), *args)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(list(grads), spec)


def make_grad_rows_fn(cfg: SNNConfig, *, backend: str = "ref",
                      surrogate_alpha: float = 10.0,
                      surrogate_kind: str = "fast_sigmoid",
                      sequential: bool = False) -> Callable:
    """Per-example loss and gradient rows: ``(params, x, y) -> (loss_rows,
    grad_rows)``, each leaf with a leading batch axis.  Row i is the loss
    and gradient of example i alone (batch 1), so rows are independent of
    one another and of the batch they came in.

    Rows are computed by a loop over batch-1 calls, the reference's
    ``sequential=True`` semantics, whichever ``sequential`` is given: the
    reference's vmap has no counterpart that passes through the kernels.
    The argument stays for the reference's signature."""
    del sequential
    loss_fn = make_loss_fn(cfg, backend=backend,
                           surrogate_alpha=surrogate_alpha,
                           surrogate_kind=surrogate_kind)

    def rows_fn(params: Dict, x: torch.Tensor, y: torch.Tensor):
        rows = [_value_and_grad(loss_fn, params, x[i:i + 1], y[i:i + 1])
                for i in range(x.shape[0])]
        losses = torch.stack([loss for loss, _ in rows])
        grads = tree_map(lambda *g: torch.stack(g), *[g for _, g in rows])
        return losses, grads

    return rows_fn


def make_train_step(cfg: SNNConfig, *, backend: str = "ref",
                    lr: float = 1e-3, momentum: float = 0.9,
                    surrogate_alpha: float = 10.0,
                    surrogate_kind: str = "fast_sigmoid") -> Callable:
    """SGD with momentum: ``(params, mom, x, y) -> (params, mom, loss)``
    with ``mom = momentum * mom + g`` and ``p = p - lr * mom``.  Returns
    new dicts and leaves the given ones as they are."""
    loss_fn = make_loss_fn(cfg, backend=backend,
                           surrogate_alpha=surrogate_alpha,
                           surrogate_kind=surrogate_kind)

    def step(params: Dict, mom: Dict, x: torch.Tensor, y: torch.Tensor
             ) -> Tuple[Dict, Dict, torch.Tensor]:
        loss, g = _value_and_grad(loss_fn, params, x, y)
        with torch.no_grad():
            mom = tree_map(lambda m, gg: momentum * m + gg, mom, g)
            params = tree_map(lambda w, m: w - lr * m, params, mom)
        return params, mom, loss

    return step


def accuracy(params: Dict, cfg: SNNConfig, x: torch.Tensor, y: torch.Tensor,
             *, backend: str = "ref") -> float:
    """Fraction of ``x`` whose argmax logit is its label ``y``."""
    with torch.no_grad():
        out = snn_apply(params, x, cfg, backend=backend)
        return float((out.logits.argmax(dim=-1) == y.long()).float().mean())
