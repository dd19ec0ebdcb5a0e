"""Step functions: train, prefill, encode and decode, and the loss, shared
by the launchers, the examples and the tests.

``make_*_step`` return functions of (state, batch), (params, batch) or
(params, caches, token, pos), as the reference's do.  The train step
writes its ``TrainState`` in place (``optim.adam``: a functional update
of a full-width model would not fit on the card beside its grads) and
returns it with its metrics, 0-d tensors on the device; it makes no host
sync.  Every point where it can raise (the forward, the backward, the
clip) comes before its first write, so a step that raises leaves the
state as it was, as the reference's functional step does
(``runtime.fault_tolerance.ResilientLoop`` relies on that).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.config import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.optim import adam, schedules

__all__ = ["TrainState", "cross_entropy", "loss_fn", "make_train_step",
           "make_prefill_step", "make_encode_step", "make_decode_step",
           "init_train_state"]


class TrainState(NamedTuple):
    params: Any                 # a ``transformer.Transformer``
    opt: adam.AdamState


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """logits (B, S, V) any dtype; labels (B, S) integer, -1 = masked.
    Mean over the unmasked positions, in float32."""
    mask = labels >= 0
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    is_gold = vocab == torch.where(mask, labels, -1)[..., None]
    mx = torch.amax(logits, dim=-1)
    exp = torch.exp(logits.to(torch.float32)
                    - mx.to(torch.float32)[..., None])
    logz = torch.log(torch.sum(exp, dim=-1)) + mx.to(torch.float32)
    gold = torch.sum(torch.where(is_gold, logits, 0).to(torch.float32),
                     dim=-1)
    ce = (logz - gold) * mask.to(torch.float32)
    return ce.sum() / torch.clamp(mask.sum().to(torch.float32), min=1.0)


def loss_fn(params, cfg: ArchConfig, batch: Dict, *, remat: bool = True):
    """(loss, {"ce", "aux"}) of a forward over ``batch`` ("tokens",
    "frames" or "patches", and "labels")."""
    logits, aux = transformer.forward(
        params, cfg, tokens=batch.get("tokens"), frames=batch.get("frames"),
        patches=batch.get("patches"), remat=remat)
    ce = cross_entropy(logits, batch["labels"])
    moe_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
    return ce + moe_w * aux, {"ce": ce, "aux": aux}


def make_train_step(cfg: ArchConfig, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    clip_norm: float = 1.0, remat: bool = True):
    """The reference's step: loss and grads of ``loss_fn``, the grads
    clipped to ``clip_norm``, ``lr = linear_warmup_cosine(step + 1)``, then
    the AdamW update, which writes the state in place.  Returns
    ``(state, metrics)``: ``ce``, ``aux``, ``loss``, ``grad_norm`` and
    ``lr``, detached 0-d tensors."""
    def train_step(state: TrainState, batch: Dict):
        model = state.params
        names, leaves = zip(*model.named_parameters())
        loss, metrics = loss_fn(model, cfg, batch, remat=remat)
        # a leaf the loss does not reach gets a zero grad, as under jax.grad
        grads = {n: torch.zeros_like(p) if g is None else g
                 for n, p, g in zip(names, leaves, torch.autograd.grad(
                     loss, leaves, allow_unused=True))}
        grads, gnorm = adam.clip_by_global_norm(grads, clip_norm)
        lr = schedules.linear_warmup_cosine(
            state.opt.step + 1, peak_lr=peak_lr, warmup=warmup,
            total=total_steps)
        # the first write to the state
        adam.update(grads, state.opt, model, lr=lr)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss.detach(), grad_norm=gnorm, lr=lr)
        return state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch: Dict):
        return transformer.prefill(
            params, cfg, tokens=batch.get("tokens"),
            frames=batch.get("frames"), patches=batch.get("patches"))

    return prefill_step


def make_encode_step(cfg: ArchConfig):
    """Encoder-only archs (hubert): full forward, no cache, no labels."""
    def encode_step(params, batch: Dict):
        logits, _ = transformer.forward(
            params, cfg, tokens=batch.get("tokens"),
            frames=batch.get("frames"), patches=batch.get("patches"))
        return logits

    return encode_step


def make_decode_step(cfg: ArchConfig):
    def decode_step(params, caches, token, pos):
        return transformer.decode_step(params, caches, cfg, token=token,
                                       pos=pos)

    return decode_step


def init_train_state(generator: torch.Generator, cfg: ArchConfig,
                     dtype=torch.float32, opt_dtype=torch.float32,
                     device=None) -> TrainState:
    """A ``Transformer`` of ``cfg`` drawn from ``generator`` (which lives on
    ``device``, the card by default) and its zero AdamW state."""
    params = transformer.init_params(generator, cfg, dtype,
                                     device=resolve_device(device))
    return TrainState(params=params, opt=adam.init(params, opt_dtype))
