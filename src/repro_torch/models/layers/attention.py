"""GQA attention: full and sliding-window, full-sequence (chunked over
queries) and single-token decode against a KV cache.

The reference's formula, written out: scores by ``einsum``, cast to
float32 and scaled, masked with ``NEG_INF``, softmax in float32, cast back
to q's dtype, then the value ``einsum``.  Not ``F.scaled_dot_product_attention``,
whose masking and reduction order differ.  Queries go in chunks of
``Q_CHUNK`` (a sequence longer than one chunk must be a whole number of
them), so the scores are never (S x S) at once, and a sliding layer slices
K/V to a band of ``Q_CHUNK + window`` keys a chunk where ``window +
Q_CHUNK <= S``, so its work is O(S * window).

Decode caches:
  full layers     (B, S_max, n_kv, hd) k/v, written at ``pos``
  sliding layers  ring buffer (B, window, n_kv, hd), slot = pos % window,
                  when the prompt held at least ``window`` tokens; a
                  shorter prompt leaves a (B, max(max_len, S), ...) buffer,
                  as the reference's ``apply_prefill`` does, and decode
                  then attends to every earlier position (the reference's
                  behaviour, kept: ROADMAP queue 3)
Decode writes the new k/v into the cache in place (``index_copy_``) and
returns the same dict.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.config import ArchConfig, AttnConfig
from repro_torch.models.layers.leaves import Leaves, normal
from repro_torch.models.layers.rope import apply_rope
from repro_torch.sharding.context import local_body, shard_logical

__all__ = ["Q_CHUNK", "NEG_INF", "Attention", "attend", "specs", "cache_specs",
           "apply_train", "init_cache", "apply_prefill", "apply_decode",
           "check_position"]


def specs(cfg: ArchConfig) -> Dict:
    s = {"wq": ("fsdp", "heads", None), "wk": ("fsdp", "kv_heads", None),
         "wv": ("fsdp", "kv_heads", None), "wo": ("heads", None, "fsdp")}
    if cfg.attn.qkv_bias:
        s.update(bq=("heads", None), bk=("kv_heads", None),
                 bv=("kv_heads", None))
    return s


def cache_specs(cfg: ArchConfig, *, sliding: bool, long_context: bool
                ) -> Dict:
    """The seq dim carries ``cache_seq`` (empty by default); sliding ring
    buffers stay small: only batch and kv heads are sharded."""
    del long_context
    spec = ("batch", None if sliding else "cache_seq", "kv_heads", None)
    return {"k": spec, "v": spec}

Q_CHUNK = 1024
NEG_INF = -1e30


class Attention(Leaves):
    """``wq`` (d, nq, hd), ``wk``, ``wv`` (d, nkv, hd), ``wo`` (nq, hd, d),
    and with ``qkv_bias`` ``bq`` (nq, hd), ``bk``, ``bv`` (nkv, hd) at 0."""

    def __init__(self, cfg: ArchConfig, *, sliding: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg, self.sliding = cfg, sliding
        a = cfg.attn
        d, nq, nkv, hd = cfg.d_model, a.num_q_heads, a.num_kv_heads, \
            a.head_dim
        s = d ** -0.5
        self.wq = normal((d, nq, hd), s, generator, dtype, device)
        self.wk = normal((d, nkv, hd), s, generator, dtype, device)
        self.wv = normal((d, nkv, hd), s, generator, dtype, device)
        self.wo = normal((nq, hd, d), (nq * hd) ** -0.5, generator, dtype,
                         device)
        if a.qkv_bias:
            for name, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
                setattr(self, name, torch.nn.Parameter(
                    torch.zeros((n, hd), dtype=dtype, device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_train(self, x, self.cfg, sliding=self.sliding)

    def prefill(self, x: torch.Tensor, *, cache_len: int,
                cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict]:
        return apply_prefill(self, x, self.cfg, sliding=self.sliding,
                             cache_len=cache_len, cache_dtype=cache_dtype)

    def decode(self, x: torch.Tensor, cache: Dict, pos
               ) -> Tuple[torch.Tensor, Dict]:
        return apply_decode(self, x, cache, pos, self.cfg,
                            sliding=self.sliding)


def _project_qkv(params, x: torch.Tensor, a: AttnConfig,
                 positions: torch.Tensor):
    dt = x.dtype
    q = torch.einsum("bsd,dnh->bsnh", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dnh->bsnh", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dnh->bsnh", x, params["wv"].to(dt))
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = apply_rope(q, positions, a.rope_theta)
    k = apply_rope(k, positions, a.rope_theta)
    q = shard_logical(q, ("batch", None, "heads", None))
    k = shard_logical(k, ("batch", None, "kv_heads", None))
    v = shard_logical(v, ("batch", None, "kv_heads", None))
    return q, k, v


def _softmax_attend(scores: torch.Tensor, mask: torch.Tensor,
                    v: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Masked float32 softmax of ``scores`` (b, n, g, q, k), cast to
    ``dt``, against ``v`` (b, k, n, h): (b, q, n, g, h)."""
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dt)
    return torch.einsum("bngqk,bknh->bqngh", probs, v)


def _sdpa(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
          scale: float) -> torch.Tensor:
    """q: (B, Lq, nkv, g, hd); k/v: (B, Lk, nkv, hd).  Softmax in f32."""
    scores = torch.einsum("bqngh,bknh->bngqk", q, k).to(torch.float32) \
        * scale
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return _softmax_attend(scores, mask, v, q.dtype)


def attend(q, k, v, a: AttnConfig, *, causal: bool) -> torch.Tensor:
    """Chunked attention.  q/k/v: (B, S, n, hd) after rope.  Returns
    (B, S, nq, hd)."""
    B, S, nq, hd = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    scale = hd ** -0.5
    qg = q.reshape(B, S, nkv, g, hd)
    window = a.window
    dev = q.device

    if S <= Q_CHUNK:
        pos = torch.arange(S, device=dev)
        out = _sdpa(qg, k, v, pos, pos, causal=causal, window=window,
                    scale=scale)
        return out.reshape(B, S, nq, hd)

    if S % Q_CHUNK:
        raise ValueError(f"attend: a sequence longer than Q_CHUNK="
                         f"{Q_CHUNK} must be a multiple of it, got S={S}")
    band = Q_CHUNK + window if window and window + Q_CHUNK <= S else S
    outs = []
    for start_q in range(0, S, Q_CHUNK):
        # sliding: only a band of K/V is needed per chunk
        start = min(max(start_q - window, 0), S - band) if band < S else 0
        q_pos = start_q + torch.arange(Q_CHUNK, device=dev)
        k_pos = start + torch.arange(band, device=dev)
        outs.append(_sdpa(qg[:, start_q:start_q + Q_CHUNK],
                          k[:, start:start + band], v[:, start:start + band],
                          q_pos, k_pos, causal=causal, window=window,
                          scale=scale))
    return torch.cat(outs, dim=1).reshape(B, S, nq, hd)


def apply_train(params, x: torch.Tensor, cfg: ArchConfig, *,
                sliding: bool) -> torch.Tensor:
    """Full-sequence forward (training, encoding, the prefill trunk)."""
    with local_body(params, x) as b:
        out, _, _ = _full_sequence(b.params, b.x, cfg, sliding)
        return b.out(out, ("batch", None, None))


def _full_sequence(params, x, cfg: ArchConfig, sliding: bool):
    a = cfg.attn
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, a, positions)
    a_local = dataclasses.replace(a, window=a.window if sliding else 0)
    out = attend(q, k, v, a_local, causal=not cfg.is_encoder_only)
    out = torch.einsum("bsnh,nhd->bsd", out, params["wo"].to(x.dtype))
    return shard_logical(out, ("batch", None, None)), k, v


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, sliding: bool,
               dtype=torch.bfloat16, device=None) -> Dict:
    a = cfg.attn
    size = min(a.window, max_len) if sliding else max_len
    shape = (batch, size, a.num_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def apply_decode(params, x: torch.Tensor, cache: Dict,
                 pos: Union[int, torch.Tensor], cfg: ArchConfig, *,
                 sliding: bool) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d); pos: the position of this token (an int, or a 0-d
    integer tensor on x's device).  Writes the token's k/v into ``cache``
    and returns (out (B, 1, d), cache).  An int position past a full
    cache raises; a tensor one is clamped to its last slot, as the
    reference's ``dynamic_update_slice`` does.  Under a mesh the body
    runs on its shards of the heads and the caches (module doc of
    ``sharding.context``)."""
    if isinstance(pos, int) and not sliding:
        check_position(pos, cache["k"].shape[1])
    with local_body(params, x) as b:
        local = {n: b.cache_in(cache[n], model_dim=2) for n in ("k", "v")}
        out = _decode(b.params, b.x, local, pos, cfg, sliding)
        for n in ("k", "v"):
            b.cache_out(cache[n], local[n], model_dim=2)
        return b.out(out, ("batch", None, None)), cache


def _decode(params, x: torch.Tensor, cache: Dict, pos, cfg: ArchConfig,
            sliding: bool) -> torch.Tensor:
    a = cfg.attn
    B = x.shape[0]
    dt = x.dtype
    size = cache["k"].shape[1]
    pos_t = torch.as_tensor(pos, device=x.device).reshape(())
    positions = pos_t.to(torch.int32).expand(B, 1)
    q, k_new, v_new = _project_qkv(params, x, a, positions)

    slot = (pos_t % size if sliding else pos_t.clamp(max=size - 1)) \
        .reshape(1).long()
    k = cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
    v = cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))

    # this body's heads (all of them off a mesh)
    nkv, hd, nq = k.shape[2], k.shape[3], q.shape[2]
    qg = q.reshape(B, 1, nkv, nq // nkv, hd)
    # ring slots written so far all lie within the window by construction;
    # for full caches this is plain causal validity
    valid = torch.arange(size, device=x.device) <= pos_t
    scores = torch.einsum("bqngh,bknh->bngqk", qg, k.to(dt)) \
        .to(torch.float32) * hd ** -0.5
    out = _softmax_attend(scores, valid, v.to(dt), dt).reshape(B, 1, nq, hd)
    out = torch.einsum("bsnh,nhd->bsd", out, params["wo"].to(dt))
    return shard_logical(out, ("batch", None, None))


def check_position(pos: int, size: int) -> None:
    """Raise unless decode position ``pos`` fits a full cache of ``size``."""
    if not 0 <= pos < size:
        raise ValueError(f"decode position {pos} lies outside the cache of "
                         f"{size} positions")


def apply_prefill(params, x: torch.Tensor, cfg: ArchConfig, *,
                  sliding: bool, cache_len: int,
                  cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict]:
    """Forward plus the decode cache: full k/v, or for sliding layers the
    ring of the last ``window`` tokens (when the prompt holds that many)."""
    a = cfg.attn
    with local_body(params, x) as b:
        x = b.x
        B, S, _ = x.shape
        out, k, v = _full_sequence(b.params, x, cfg, sliding)
        cdt = cache_dtype
        if sliding and a.window and S >= a.window:
            w = a.window
            cache = {"k": torch.roll(k[:, S - w:], S % w, dims=1).to(cdt),
                     "v": torch.roll(v[:, S - w:], S % w, dims=1).to(cdt)}
        else:
            size = max(cache_len, S)
            cache = {}
            for name, t in (("k", k), ("v", v)):
                c = torch.zeros((B, size) + tuple(t.shape[2:]), dtype=cdt,
                                device=x.device)
                c[:, :S] = t
                cache[name] = c
        spec = cache_specs(cfg, sliding=sliding, long_context=False)
        cache = {n: b.cache_new(c, spec[n], model_dim=2)
                 for n, c in cache.items()}
        return b.out(out, ("batch", None, None)), cache
