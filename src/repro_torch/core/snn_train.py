"""Surrogate-gradient training of the paper's SNNs: the counterpart of
``repro.core.snn_train``.

One loss and one step for every backend (``core.snn_model.SNN_BACKENDS``):
``"ref"`` trains through the timestep-outer scan, ``"batched"`` through the
time-batched plain ops, and ``"hopper"`` through the hand-written kernels,
whose autograd Functions run the surrogate BPTT on the backward kernels.
So the dataflow that is trained is the one that is served.

Parameters are the ``init_snn`` dict (``{"conv": [{"w", "b"}], "dense":
[...]}``), and the step is a plain function on it, like the reference's
(no ``torch.optim``).  Configuration arrives as a
``repro_torch.api.TrainSpec`` (``spec=``, duck-typed so core never imports
the facade).  The legacy loose kwargs (``backend=``/``surrogate_*``/
``lr=``) still work but are deprecation shims: the first explicit use
warns once per process.  Every forward here asks ``snn_apply`` for the
logits alone (``logits_only``): the loss never reads the counts.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch import obs
from repro_torch.config import SNNConfig
from repro_torch.core.snn_model import snn_apply

__all__ = ["make_loss_fn", "make_grad_rows_fn", "make_train_step",
           "accuracy"]

_UNSET = object()                     # legacy-kwarg sentinel (shim detection)
_LOSS_DEFAULTS = dict(backend="ref", surrogate_alpha=10.0,
                      surrogate_kind="fast_sigmoid")


def _resolve(spec, legacy: Dict, defaults: Dict, what: str,
             cfg: SNNConfig) -> Dict:
    """Merge a TrainSpec-like ``spec`` with explicitly passed legacy kwargs.

    The spec wins field by field; an explicit legacy kwarg without a spec
    is the old signature and warns once (the facade's deprecation shim).
    Spec fields this layer cannot apply are loud errors, not silent drops:
    ``spec.timesteps`` must already be resolved into ``cfg`` (``Session``
    does this) and a kernel schedule has no training semantics."""
    explicit = {k: v for k, v in legacy.items() if v is not _UNSET}
    if spec is not None:
        clash = sorted(set(explicit) & set(defaults))
        if clash:
            raise ValueError(
                f"{what}: pass configuration through spec= OR the legacy "
                f"kwargs, not both (got spec and {clash})")
        t_spec = getattr(spec, "timesteps", None)
        if t_spec is not None and t_spec != cfg.timesteps:
            raise ValueError(
                f"{what}: spec.timesteps={t_spec} conflicts with "
                f"cfg.timesteps={cfg.timesteps}; resolve the spec's T into "
                f"the config first (repro_torch.api.Session does this)")
        if getattr(spec, "resolved_schedule", lambda: None)() is not None:
            raise ValueError(
                f"{what}: spec carries a kernel schedule_mode, which has "
                f"no training semantics (TrainSpec rejects it; pass an "
                f"ExecutionSpec without one)")
        out = dict(defaults)
        for k in defaults:
            if hasattr(spec, k):
                out[k] = getattr(spec, k)
        return out
    if explicit:
        from repro_torch.api._compat import warn_deprecated_once
        warn_deprecated_once(
            what,
            f"{what}(..., {', '.join(sorted(explicit))}=...) is deprecated; "
            f"pass a repro_torch.api.TrainSpec via spec= (or use "
            f"repro_torch.api.Session.train_step)")
    out = dict(defaults)
    out.update(explicit)
    return out


def _build_loss_fn(cfg: SNNConfig, backend: str, surrogate_alpha: float,
                   surrogate_kind: str) -> Callable:
    def loss_fn(params: Dict, x: torch.Tensor, y: torch.Tensor
                ) -> torch.Tensor:
        out = snn_apply(params, x, cfg, backend=backend,
                        surrogate_alpha=surrogate_alpha,
                        surrogate_kind=surrogate_kind, logits_only=True)
        logp = torch.log_softmax(out.logits.float(), dim=-1)
        # the logits' batch size, not x.shape[0]: x may be a spike train
        return -logp[torch.arange(logp.shape[0], device=logp.device),
                     y.long()].mean()

    return loss_fn


def make_loss_fn(cfg: SNNConfig, *, backend=_UNSET, surrogate_alpha=_UNSET,
                 surrogate_kind=_UNSET, spec: Optional[object] = None,
                 ) -> Callable:
    """``(params, x, y) -> loss``: cross-entropy on the readout logits of
    the selected backend.  ``x`` is (B, H, W, Cin) frames or a (T, B, ...)
    spike train; ``y`` (B,) integer labels."""
    r = _resolve(spec, dict(backend=backend, surrogate_alpha=surrogate_alpha,
                            surrogate_kind=surrogate_kind),
                 _LOSS_DEFAULTS, "core.snn_train.make_loss_fn", cfg)
    return _build_loss_fn(cfg, r["backend"], r["surrogate_alpha"],
                          r["surrogate_kind"])


def _value_and_grad(loss_fn: Callable, params: Dict, *args
                    ) -> Tuple[torch.Tensor, Dict]:
    """The loss and its gradient with respect to every leaf of ``params``.
    A leaf the loss does not reach raises, rather than reading as zero.
    The two halves are the spans ``train.forward`` and ``train.backward``
    (``obs.spans``)."""
    leaves, spec = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        with obs.span("train.forward"):
            loss = loss_fn(tree_unflatten(leaves, spec), *args)
        with obs.span("train.backward"):
            grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(list(grads), spec)


def make_grad_rows_fn(cfg: SNNConfig, *, backend=_UNSET,
                      surrogate_alpha=_UNSET, surrogate_kind=_UNSET,
                      spec: Optional[object] = None,
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
    r = _resolve(spec, dict(backend=backend, surrogate_alpha=surrogate_alpha,
                            surrogate_kind=surrogate_kind),
                 _LOSS_DEFAULTS, "core.snn_train.make_grad_rows_fn", cfg)
    loss_fn = _build_loss_fn(cfg, r["backend"], r["surrogate_alpha"],
                             r["surrogate_kind"])

    def rows_fn(params: Dict, x: torch.Tensor, y: torch.Tensor):
        rows = [_value_and_grad(loss_fn, params, x[i:i + 1], y[i:i + 1])
                for i in range(x.shape[0])]
        losses = torch.stack([loss for loss, _ in rows])
        grads = tree_map(lambda *g: torch.stack(g), *[g for _, g in rows])
        return losses, grads

    return rows_fn


def make_train_step(cfg: SNNConfig, *, backend=_UNSET, lr=_UNSET,
                    momentum=_UNSET, surrogate_alpha=_UNSET,
                    surrogate_kind=_UNSET, spec: Optional[object] = None,
                    ) -> Callable:
    """SGD with momentum: ``(params, mom, x, y) -> (params, mom, loss)``
    with ``mom = momentum * mom + g`` and ``p = p - lr * mom``.  Returns
    new dicts and leaves the given ones as they are."""
    r = _resolve(spec, dict(backend=backend, lr=lr, momentum=momentum,
                            surrogate_alpha=surrogate_alpha,
                            surrogate_kind=surrogate_kind),
                 dict(_LOSS_DEFAULTS, lr=1e-3, momentum=0.9),
                 "core.snn_train.make_train_step", cfg)
    loss_fn = _build_loss_fn(cfg, r["backend"], r["surrogate_alpha"],
                             r["surrogate_kind"])
    lr_v, mom_v = r["lr"], r["momentum"]

    def step(params: Dict, mom: Dict, x: torch.Tensor, y: torch.Tensor
             ) -> Tuple[Dict, Dict, torch.Tensor]:
        loss, g = _value_and_grad(loss_fn, params, x, y)
        with torch.no_grad(), obs.span("train.update"):
            mom = tree_map(lambda m, gg: mom_v * m + gg, mom, g)
            params = tree_map(lambda w, m: w - lr_v * m, params, mom)
        return params, mom, loss

    return step


def accuracy(params: Dict, cfg: SNNConfig, x: torch.Tensor, y: torch.Tensor,
             *, backend: str = "ref") -> float:
    """Fraction of ``x`` whose argmax logit is its label ``y``."""
    with torch.no_grad():
        out = snn_apply(params, x, cfg, backend=backend, logits_only=True)
        return float((out.logits.argmax(dim=-1) == y.long()).float().mean())
