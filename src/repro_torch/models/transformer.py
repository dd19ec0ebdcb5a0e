"""The model: the config's (mixer, ffn) pattern as a list of sublayers.

Each config stage ``(repeats, sub_pattern)`` becomes ``repeats`` copies of
its sublayers, in order, run by a Python loop (the reference's
``lax.scan`` over stacked repeats; ``interop`` converts between the two
layouts).  Three execution modes share the same parameters:
  forward      train / encoder forward (no caches)
  prefill      forward, returning the last token's logits and the
               per-layer decode caches
  decode       one-token step against the caches

This slice ports the dense family's kinds: ``ATTN_FULL``, ``ATTN_SLIDING``
and ``FFN_DENSE`` (SwiGLU, or the RWKV channel-mix when the config carries
``rwkv``).  Building a model with any other kind raises
``NotImplementedError`` naming its ROADMAP item; nothing stands in for it.

Parameters are float32 by default, made where ``generator`` lives (the
card by default: ``device=None`` means ``"cuda"``).  Caches are bfloat16
by default; decode casts them to the activations' dtype.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import (ATTN_FULL, ATTN_MLA, ATTN_SLIDING,
                                FFN_DENSE, FFN_MOE, MAMBA, RWKV6,
                                ArchConfig)
from repro_torch.device import resolve_device
from repro_torch.models.layers import attention, embedding, ffn, norms
from repro_torch.sharding.context import shard_logical

__all__ = ["NOT_PORTED", "Sublayer", "Transformer", "init_params",
           "forward", "init_caches", "prefill", "decode_step"]

# the kinds still to port, each with its ROADMAP item
NOT_PORTED = {
    FFN_MOE: "ROADMAP queue 1, item 14a (MoE)",
    ATTN_MLA: "ROADMAP queue 1, item 14b (MLA)",
    MAMBA: "ROADMAP queue 1, item 14c (Mamba, jamba)",
    RWKV6: "ROADMAP queue 1, item 14d (RWKV6)",
}
_MIXERS = (ATTN_FULL, ATTN_SLIDING)
_FFNS = (FFN_DENSE,)


def _check_kinds(cfg: ArchConfig, mixer_kind: str, ffn_kind: str) -> None:
    for kind, ported in ((mixer_kind, _MIXERS), (ffn_kind, _FFNS)):
        if kind in ported:
            continue
        if kind in NOT_PORTED:
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind!r} is not ported yet "
                f"({NOT_PORTED[kind]})")
        raise ValueError(f"{cfg.name}: unknown layer kind {kind!r}")


class Sublayer(nn.Module):
    """norm1, mixer, norm2, ffn: one (mixer, ffn) entry of the pattern."""

    def __init__(self, cfg: ArchConfig, mixer_kind: str, ffn_kind: str, *,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        _check_kinds(cfg, mixer_kind, ffn_kind)
        self.cfg = cfg
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.norm1 = norms.RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype,
                                   device=device)
        self.mixer = attention.Attention(
            cfg, sliding=mixer_kind == ATTN_SLIDING, **kw)
        self.norm2 = norms.RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype,
                                   device=device)
        self.ffn = (ffn.RWKVChannelMix if cfg.rwkv is not None
                    else ffn.SwiGLU)(cfg.d_model, cfg.d_ff, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.mixer(self.norm1(x))
        x = x + self.ffn(self.norm2(x))
        return shard_logical(x, ("batch", "act_seq", None))

    def prefill(self, x: torch.Tensor, cache_len: int, cache_dtype
                ) -> Tuple[torch.Tensor, Dict]:
        h, mixer_cache = self.mixer.prefill(self.norm1(x),
                                            cache_len=cache_len,
                                            cache_dtype=cache_dtype)
        x = x + h
        h = self.norm2(x)
        ffn_cache = {}
        if self.cfg.rwkv is not None:
            ffn_cache = {"shift": h[:, -1:].to(cache_dtype)}
        x = x + self.ffn(h)
        x = shard_logical(x, ("batch", None, None))
        return x, {"mixer": mixer_cache, "ffn": ffn_cache}

    def decode(self, x: torch.Tensor, cache: Dict, pos
               ) -> Tuple[torch.Tensor, Dict]:
        h, mixer_cache = self.mixer.decode(self.norm1(x), cache["mixer"],
                                           pos)
        x = x + h
        h = self.norm2(x)
        ffn_cache = cache["ffn"]
        if self.cfg.rwkv is not None:
            shift = ffn_cache["shift"]
            ffn_cache = {"shift": h.to(shift.dtype)}
            h = self.ffn(h, shift.to(h.dtype))
        else:
            h = self.ffn(h)
        return x + h, {"mixer": mixer_cache, "ffn": ffn_cache}


class Transformer(nn.Module):
    """``embed``, ``layers`` (one ``Sublayer`` per entry of
    ``cfg.pattern()``) and ``final_norm``.  ``groups`` holds each repeat's
    range of layers: the unit the reference's scan runs and ``remat``
    recomputes."""

    def __init__(self, cfg: ArchConfig, *,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.embed = embedding.Embedding(cfg, **kw)
        self.layers = nn.ModuleList(Sublayer(cfg, m, f, **kw)
                                    for m, f in cfg.pattern())
        self.final_norm = norms.RMSNorm(cfg.d_model, cfg.norm_eps,
                                        dtype=dtype, device=device)
        self.groups: List[range] = []
        start = 0
        for repeats, sub in cfg.stage_list():
            for _ in range(repeats):
                self.groups.append(range(start, start + len(sub)))
                start += len(sub)

    def forward(self, *, tokens=None, frames=None, patches=None,
                remat: bool = True):
        return forward(self, self.cfg, tokens=tokens, frames=frames,
                       patches=patches, remat=remat)


def init_params(generator: torch.Generator, cfg: ArchConfig,
                dtype=torch.float32, device=None) -> Transformer:
    """A ``Transformer`` of ``cfg`` with weights drawn from ``generator``,
    which must live on ``device`` (default: the card), so the weights are
    made there."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"init_params: the generator lives on "
                         f"{generator.device}, the weights go to {dev}; "
                         f"pass a generator on {dev.type}")
    return Transformer(cfg, generator=generator, dtype=dtype, device=dev)


def _run_group(model: Transformer, group: range, x: torch.Tensor):
    for i in group:
        x = model.layers[i](x)
    return x


def forward(params: Transformer, cfg: ArchConfig, *, tokens=None,
            frames=None, patches=None, remat: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V), aux_loss).  With ``remat`` and autograd
    recording, each repeat's activations are recomputed in the backward
    (``torch.utils.checkpoint``); under ``torch.inference_mode`` it has no
    effect."""
    x = embedding.embed(params.embed, cfg, tokens=tokens, frames=frames,
                        patches=patches)
    remat = remat and torch.is_grad_enabled()
    for group in params.groups:
        if remat:
            x = checkpoint(_run_group, params, group, x, use_reentrant=False)
        else:
            x = _run_group(params, group, x)
    x = params.final_norm(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return embedding.logits(params.embed, cfg, x), aux


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None) -> List[Dict]:
    """Per-layer caches, in pattern order: {"mixer": {"k", "v"}, "ffn": {}
    or {"shift"}}."""
    dev = resolve_device(device)
    caches = []
    for m, f in cfg.pattern():
        _check_kinds(cfg, m, f)
        c = {"mixer": attention.init_cache(
            cfg, batch, max_len, sliding=m == ATTN_SLIDING, dtype=dtype,
            device=dev), "ffn": {}}
        if cfg.rwkv is not None:
            c["ffn"] = {"shift": torch.zeros((batch, 1, cfg.d_model),
                                             dtype=dtype, device=dev)}
        caches.append(c)
    return caches


def decode_step(params: Transformer, caches: List[Dict], cfg: ArchConfig, *,
                token: torch.Tensor, pos: Union[int, torch.Tensor]
                ) -> Tuple[torch.Tensor, List[Dict]]:
    """token: (B, 1) int32; pos: an int or a 0-d integer tensor.  Writes
    the caches in place; returns (logits (B, 1, V), caches)."""
    x = embedding.embed(params.embed, cfg, tokens=token)
    if isinstance(pos, int):
        for (m, _), c in zip(cfg.pattern(), caches):
            if m == ATTN_FULL:
                attention.check_position(pos, c["mixer"]["k"].shape[1])
    # one position tensor for every layer
    pos = torch.as_tensor(pos, device=x.device)
    new = []
    for layer, cache in zip(params.layers, caches):
        x, c = layer.decode(x, cache, pos)
        new.append(c)
    x = params.final_norm(x)
    return embedding.logits(params.embed, cfg, x), new


def prefill(params: Transformer, cfg: ArchConfig, *, tokens=None,
            frames=None, patches=None, remat: bool = True, max_len: int = 0,
            cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, List[Dict]]:
    """Full-sequence forward returning (last-token logits (B, 1, V), decode
    caches).  ``max_len``: cache capacity (>= prompt length + planned
    decode steps).  ``remat`` is taken for the reference's signature and
    has no effect: a prefill serves, under ``torch.inference_mode``."""
    del remat
    x = embedding.embed(params.embed, cfg, tokens=tokens, frames=frames,
                        patches=patches)
    cache_len = max(max_len, x.shape[1])
    caches = []
    for layer in params.layers:
        x, c = layer.prefill(x, cache_len, cache_dtype)
        caches.append(c)
    x = params.final_norm(x[:, -1:])
    return embedding.logits(params.embed, cfg, x), caches
