"""Step functions: prefill, encode and decode, and the loss, shared by the
serve launcher, the examples and the tests.

``make_*_step`` return functions of (params, batch) or (params, caches,
token, pos), as the reference's do.  The training state and step
(``TrainState``, ``make_train_step``, ``init_train_state``) come with the
port of ``optim`` (ROADMAP queue 1, item 14e).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import ArchConfig
from repro_torch.models import transformer

__all__ = ["cross_entropy", "loss_fn", "make_prefill_step",
           "make_encode_step", "make_decode_step"]


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
