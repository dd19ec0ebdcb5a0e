"""Token embedding and logits head, with the stub modality frontends.

Frontends (the modality encoders are stubs):
  frames          hubert: precomputed conv-stem frame features (B, S, F),
                  projected by ``front_proj``
  patches+tokens  pixtral: precomputed ViT patch embeddings (B, P, F),
                  projected by ``front_proj`` and put before the text
                  token embeddings
Every ``family == "dense"`` config with tied embeddings scales the token
embeddings by sqrt(d_model), as the reference does: gemma's scaling,
which qwen2.5-3b and command-r-35b also get.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ArchConfig
from repro_torch.models.layers.leaves import Leaves, normal
from repro_torch.sharding.context import shard_logical

__all__ = ["Embedding", "embed", "logits"]


class Embedding(Leaves):
    """``tok`` (vocab, d) for token frontends, ``front_proj`` (F, d) for
    frame and patch frontends, ``head`` (d, vocab) unless tied."""

    def __init__(self, cfg: ArchConfig, *,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        scale = cfg.d_model ** -0.5
        if cfg.frontend in ("tokens", "patches+tokens"):
            self.tok = normal((cfg.vocab_size, cfg.d_model), scale,
                              generator, dtype, device)
        if cfg.frontend in ("frames", "patches+tokens"):
            self.front_proj = normal((cfg.frontend_dim, cfg.d_model),
                                     cfg.frontend_dim ** -0.5, generator,
                                     dtype, device)
        if not cfg.tie_embeddings:
            self.head = normal((cfg.d_model, cfg.vocab_size), scale,
                               generator, dtype, device)

    def forward(self, tokens=None, frames=None, patches=None):
        return embed(self, self.cfg, tokens=tokens, frames=frames,
                     patches=patches)


def embed(params, cfg: ArchConfig, tokens=None, frames=None, patches=None
          ) -> torch.Tensor:
    """Returns (B, S_total, d_model) input activations; ``tokens`` are
    int32 ids, as in the reference."""
    parts = []
    if cfg.frontend == "frames":
        proj = params["front_proj"]
        parts.append(frames.to(proj.dtype) @ proj)
    else:
        if cfg.frontend == "patches+tokens" and patches is not None:
            proj = params["front_proj"]
            parts.append(patches.to(proj.dtype) @ proj)
        # torch indexes with int64: the ids are widened, not changed
        emb = params["tok"][tokens.long()]
        if cfg.family == "dense" and cfg.tie_embeddings:
            emb = emb * _scalar(cfg.d_model ** 0.5, emb.dtype)
        parts.append(emb)
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return shard_logical(x, ("batch", "act_seq", None))


def logits(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    w = params["tok"].T if cfg.tie_embeddings else params["head"]
    out = x @ w.to(x.dtype)
    return shard_logical(out, ("batch", None, "vocab"))


def _scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as ``jnp.asarray(value, dtype)``
    gives it."""
    return float(torch.tensor(value, dtype=dtype))
