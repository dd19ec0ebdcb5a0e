"""The model: the config's (mixer, ffn) pattern as a list of sublayers.

Each config stage ``(repeats, sub_pattern)`` becomes ``repeats`` copies of
its sublayers, in order, run by a Python loop (the reference's
``lax.scan`` over stacked repeats; ``interop`` converts between the two
layouts).  Three execution modes share the same parameters:
  forward      train / encoder forward (no caches)
  prefill      forward, returning the last token's logits and the
               per-layer decode caches
  decode       one-token step against the caches

Every kind of the reference: the mixers ``ATTN_FULL``, ``ATTN_SLIDING``,
``ATTN_MLA`` (DeepSeek's latent attention, its decode absorbed), ``MAMBA``
(Jamba's selective SSM) and ``RWKV6`` (the RWKV-6 time-mix), each a module
with ``forward``, ``prefill`` and ``decode``; the FFNs ``FFN_DENSE``
(SwiGLU, or the RWKV channel-mix when the config carries ``rwkv``) and
``FFN_MOE`` (routed experts with shared ones).  Any other kind raises
``ValueError``.

``forward`` returns the sum of the MoE layers' router aux losses, in layer
order; ``prefill`` and ``decode_step`` drop it, as the reference's do.
The ``cfg`` handed to these functions reaches the MoE layers, whose
routing reads its capacity factor; the other layers read the config they
were built with.

Parameters are float32 by default, made where ``generator`` lives (the
card by default: ``device=None`` means ``"cuda"``).  Caches are bfloat16
by default; decode casts them to the activations' dtype.

Under a ``ShardingCtx`` on a torch mesh the parameters and caches are
DTensors laid out by ``param_specs`` and ``cache_specs``
(``sharding.partitioning``), and the three modes run each layer's body on
its shards (``sharding.context``); inputs that every rank holds whole are
laid out over the batch axes, and the logits come out split over the
vocab where the vocab is split over ``model``.
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
from repro_torch.models.layers import attention, embedding, ffn, mamba, \
    mla, moe, norms, rwkv
from repro_torch.sharding.context import current_ctx, mesh_ops, \
    shard_logical, use_sharding

__all__ = ["Sublayer", "Transformer", "init_params", "forward",
           "init_caches", "prefill", "decode_step", "param_specs",
           "cache_specs"]

# each mixer kind's module, whose ``init_cache`` makes its decode cache
_MIXERS = {ATTN_FULL: attention, ATTN_SLIDING: attention, ATTN_MLA: mla,
           MAMBA: mamba, RWKV6: rwkv}
_FFNS = (FFN_DENSE, FFN_MOE)


def _ffn_specs(cfg: ArchConfig, kind: str) -> Dict:
    if kind == FFN_MOE:
        return moe.specs(cfg)
    return ffn.rwkv_cmix_specs() if cfg.rwkv is not None \
        else ffn.swiglu_specs()


def _flat(tree: Dict, prefix: str, out: Dict) -> Dict:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}{k}.", out)
        else:
            out[prefix + k] = tuple(v)
    return out


def param_specs(cfg: ArchConfig) -> Dict[str, tuple]:
    """Each parameter's logical spec, keyed by its ``named_parameters``
    name (the reference's tree, one entry per layer: the stacked layer
    axis, unsharded there, has no counterpart)."""
    tree = {"embed": embedding.specs(cfg),
            "final_norm": norms.rms_specs()}
    for i, (m, f) in enumerate(cfg.pattern()):
        _check_kinds(cfg, m, f)
        tree[f"layers.{i}"] = {"norm1": norms.rms_specs(),
                               "mixer": _MIXERS[m].specs(cfg),
                               "norm2": norms.rms_specs(),
                               "ffn": _ffn_specs(cfg, f)}
    return _flat(tree, "", {})


def cache_specs(cfg: ArchConfig, *, long_context: bool = False
                ) -> List[Dict]:
    """The logical specs of ``init_caches``' tree, layer by layer."""
    out = []
    for m, f in cfg.pattern():
        _check_kinds(cfg, m, f)
        c = {"mixer": _MIXERS[m].cache_specs(
            cfg, sliding=m == ATTN_SLIDING, long_context=long_context),
            "ffn": {}}
        if cfg.rwkv is not None and f == FFN_DENSE:
            c["ffn"] = {"shift": ("batch", None, None)}
        out.append(c)
    return out


def _check_kinds(cfg: ArchConfig, mixer_kind: str, ffn_kind: str) -> None:
    for kind, known in ((mixer_kind, _MIXERS), (ffn_kind, _FFNS)):
        if kind not in known:
            raise ValueError(f"{cfg.name}: unknown layer kind {kind!r}")


def _mixer(cfg: ArchConfig, kind: str, **kw) -> nn.Module:
    if kind == ATTN_MLA:
        return mla.MLA(cfg, **kw)
    if kind == MAMBA:
        return mamba.Mamba(cfg, **kw)
    if kind == RWKV6:
        return rwkv.RWKV6(cfg, **kw)
    return attention.Attention(cfg, sliding=kind == ATTN_SLIDING, **kw)


class Sublayer(nn.Module):
    """norm1, mixer, norm2, ffn: one (mixer, ffn) entry of the pattern.
    Its steps take the model's ``cfg`` for the MoE's routing and return
    the MoE's aux loss where ``forward`` needs it (None for other FFNs)."""

    def __init__(self, cfg: ArchConfig, mixer_kind: str, ffn_kind: str, *,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        _check_kinds(cfg, mixer_kind, ffn_kind)
        self.is_moe = ffn_kind == FFN_MOE
        # the channel-mix's token shift is the FFN's cache (dense FFNs only)
        self.has_shift = cfg.rwkv is not None and not self.is_moe
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.norm1 = norms.RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype,
                                   device=device)
        self.mixer = _mixer(cfg, mixer_kind, **kw)
        self.norm2 = norms.RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype,
                                   device=device)
        if self.is_moe:
            self.ffn = moe.MoE(cfg, **kw)
        else:
            self.ffn = (ffn.RWKVChannelMix if self.has_shift
                        else ffn.SwiGLU)(cfg.d_model, cfg.d_ff, **kw)

    def _ffn(self, h: torch.Tensor, cfg: ArchConfig):
        """(out, aux): the MoE's aux, None for a dense FFN."""
        if self.is_moe:
            return self.ffn(h, cfg)
        return self.ffn(h), None

    def forward(self, x: torch.Tensor, cfg: ArchConfig):
        x = x + self.mixer(self.norm1(x))
        h, aux = self._ffn(self.norm2(x), cfg)
        x = x + h
        return shard_logical(x, ("batch", "act_seq", None)), aux

    def prefill(self, x: torch.Tensor, cfg: ArchConfig, cache_len: int,
                cache_dtype) -> Tuple[torch.Tensor, Dict]:
        h, mixer_cache = self.mixer.prefill(self.norm1(x),
                                            cache_len=cache_len,
                                            cache_dtype=cache_dtype)
        x = x + h
        h = self.norm2(x)
        ffn_cache = {}
        if self.has_shift:
            ffn_cache = {"shift": h[:, -1:].to(cache_dtype)}
        x = x + self._ffn(h, cfg)[0]
        x = shard_logical(x, ("batch", None, None))
        return x, {"mixer": mixer_cache, "ffn": ffn_cache}

    def decode(self, x: torch.Tensor, cfg: ArchConfig, cache: Dict, pos
               ) -> Tuple[torch.Tensor, Dict]:
        h, mixer_cache = self.mixer.decode(self.norm1(x), cache["mixer"],
                                           pos)
        x = x + h
        h = self.norm2(x)
        ffn_cache = cache["ffn"]
        if self.has_shift:
            shift = ffn_cache["shift"]
            ffn_cache = {"shift": h.to(shift.dtype)}
            h = self.ffn(h, shift.to(h.dtype))
        else:
            h = self._ffn(h, cfg)[0]
        return x + h, {"mixer": mixer_cache, "ffn": ffn_cache}


class Transformer(nn.Module):
    """``embed``, ``layers`` (one ``Sublayer`` per entry of
    ``cfg.pattern()``) and ``final_norm``.  ``groups`` holds each repeat's
    range of layers: the unit the reference's scan runs and ``remat``
    recomputes."""

    def __init__(self, cfg: ArchConfig, *,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None, place=None):
        """``place(prefix, module)``, when given, takes each submodule as
        soon as it is drawn (``embed``, each layer, ``final_norm``) and
        returns what the model keeps of it (``sharding.partitioning``
        lays it out on a mesh)."""
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, dtype=dtype, device=device)
        put = place or (lambda prefix, module: module)
        self.embed = put("embed.", embedding.Embedding(cfg, **kw))
        self.layers = nn.ModuleList(
            put(f"layers.{i}.", Sublayer(cfg, m, f, **kw))
            for i, (m, f) in enumerate(cfg.pattern()))
        self.final_norm = put("final_norm.", norms.RMSNorm(
            cfg.d_model, cfg.norm_eps, dtype=dtype, device=device))
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


def _run_group(model: Transformer, group: range, x: torch.Tensor,
               aux: torch.Tensor, cfg: ArchConfig, ctx=None):
    """Runs under ``ctx`` (a ``ShardingCtx``, or None): the backward
    recomputes a checkpointed group in autograd's own thread, which does
    not see the caller's thread-local context."""
    if ctx is not None:
        with use_sharding(ctx), mesh_ops():
            return _run_group(model, group, x, aux, cfg)
    for i in group:
        x, a = model.layers[i](x, cfg)
        if a is not None:
            aux = aux + a
    return x, aux


def forward(params: Transformer, cfg: ArchConfig, *, tokens=None,
            frames=None, patches=None, remat: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V), aux_loss): the MoE layers' aux losses
    summed in layer order (0 without MoE).  With ``remat`` and autograd
    recording, each repeat's activations are recomputed in the backward
    (``torch.utils.checkpoint``); under ``torch.inference_mode`` it has no
    effect."""
    with mesh_ops():
        return _forward(params, cfg, tokens, frames, patches, remat)


def _forward(params, cfg, tokens, frames, patches, remat):
    x = embedding.embed(params.embed, cfg, tokens=tokens, frames=frames,
                        patches=patches)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat and torch.is_grad_enabled()
    for group in params.groups:
        if remat:
            x, aux = checkpoint(_run_group, params, group, x, aux, cfg,
                                current_ctx(), use_reentrant=False)
        else:
            x, aux = _run_group(params, group, x, aux, cfg)
    x = params.final_norm(x)
    return embedding.logits(params.embed, cfg, x), aux


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None) -> List[Dict]:
    """Per-layer caches, in pattern order: {"mixer": {"k", "v"} (MLA:
    {"ckv", "k_rope"}; Mamba: {"conv", "ssm"}; RWKV6: {"state",
    "shift"}), "ffn": {} or {"shift"}}.  The Mamba and RWKV6 states are
    float32 whatever ``dtype``."""
    dev = resolve_device(device)
    caches = []
    for m, f in cfg.pattern():
        _check_kinds(cfg, m, f)
        if m in (ATTN_FULL, ATTN_SLIDING):
            mixer = attention.init_cache(cfg, batch, max_len,
                                         sliding=m == ATTN_SLIDING,
                                         dtype=dtype, device=dev)
        else:
            mixer = _MIXERS[m].init_cache(cfg, batch, max_len, dtype=dtype,
                                          device=dev)
        c = {"mixer": mixer, "ffn": {}}
        if cfg.rwkv is not None and f == FFN_DENSE:
            c["ffn"] = {"shift": torch.zeros((batch, 1, cfg.d_model),
                                             dtype=dtype, device=dev)}
        caches.append(c)
    return caches


def decode_step(params: Transformer, caches: List[Dict], cfg: ArchConfig, *,
                token: torch.Tensor, pos: Union[int, torch.Tensor]
                ) -> Tuple[torch.Tensor, List[Dict]]:
    """token: (B, 1) int32; pos: an int or a 0-d integer tensor.  Writes
    the caches in place; returns (logits (B, 1, V), caches)."""
    with mesh_ops():
        return _decode_step(params, caches, cfg, token, pos)


def _decode_step(params, caches, cfg, token, pos):
    x = embedding.embed(params.embed, cfg, tokens=token)
    if isinstance(pos, int):
        for (m, _), c in zip(cfg.pattern(), caches):
            if m in (ATTN_FULL, ATTN_MLA):
                size = c["mixer"]["ckv" if m == ATTN_MLA else "k"].shape[1]
                attention.check_position(pos, size)
    # one position tensor for every layer
    pos = torch.as_tensor(pos, device=x.device)
    new = []
    for layer, cache in zip(params.layers, caches):
        x, c = layer.decode(x, cfg, cache, pos)
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
    with mesh_ops():
        return _prefill(params, cfg, tokens, frames, patches, max_len,
                        cache_dtype)


def _prefill(params, cfg, tokens, frames, patches, max_len, cache_dtype):
    x = embedding.embed(params.embed, cfg, tokens=tokens, frames=frames,
                        patches=patches)
    cache_len = max(max_len, x.shape[1])
    caches = []
    for layer in params.layers:
        x, c = layer.prefill(x, cfg, cache_len, cache_dtype)
        caches.append(c)
    x = params.final_norm(x[:, -1:])
    return embedding.logits(params.embed, cfg, x), caches
