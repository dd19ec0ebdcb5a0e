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
from repro_torch.sharding.context import lay_out, local_body, shard_logical

__all__ = ["Embedding", "embed", "logits", "specs"]


def specs(cfg: ArchConfig):
    s = {}
    if cfg.frontend in ("tokens", "patches+tokens"):
        s["tok"] = ("vocab", "fsdp")
    if cfg.frontend in ("frames", "patches+tokens"):
        s["front_proj"] = (None, "fsdp")
    if not cfg.tie_embeddings:
        s["head"] = ("fsdp", "vocab")
    return s


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
    int32 ids, as in the reference.  Under a mesh, inputs every rank
    holds whole are laid out over the batch axes first, and a table split
    over ``model`` (the vocab) is looked up where it lives: each rank
    gathers its own rows, zeros for ids it does not hold, and the
    all-reduce over ``model`` sums the one row of each id with zeros."""
    parts = []
    if cfg.frontend == "frames":
        parts.append(_project(params, lay_out(frames, ("batch", None, None))))
    else:
        if cfg.frontend == "patches+tokens" and patches is not None:
            parts.append(_project(params,
                                  lay_out(patches, ("batch", None, None))))
        with local_body({"tok": params["tok"]},
                        lay_out(tokens, ("batch", None))) as b:
            tok, ids = b.params["tok"], b.x.long()
            # torch indexes with int64: the ids are widened, not changed
            if b.model_parallel:
                lo = b.mesh.get_local_rank("model") * tok.shape[0]
                ids = ids - lo
                held = (ids >= 0) & (ids < tok.shape[0])
                emb = tok[torch.where(held, ids, 0)] * held[..., None]
            else:
                emb = tok[ids]
            if cfg.family == "dense" and cfg.tie_embeddings:
                emb = emb * _scalar(cfg.d_model ** 0.5, emb.dtype)
            parts.append(b.out(emb, ("batch", None, None)))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return shard_logical(x, ("batch", "act_seq", None))


def _project(params, feats):
    with local_body({"front_proj": params["front_proj"]}, feats) as b:
        proj = b.params["front_proj"]
        return b.out(b.x.to(proj.dtype) @ proj, ("batch", None, None))


def logits(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Under a mesh, a vocab split over ``model`` stays split: each rank's
    logits are its columns of the vocab."""
    name = "tok" if cfg.tie_embeddings else "head"
    with local_body({name: params[name]}, x) as b:
        w = b.params[name].T if cfg.tie_embeddings else b.params[name]
        return b.out(b.x @ w.to(b.x.dtype), ("batch", None, "vocab"),
                     split_dim=2)


def _scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as ``jnp.asarray(value, dtype)``
    gives it."""
    return float(torch.tensor(value, dtype=dtype))
