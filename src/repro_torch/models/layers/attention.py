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

Under a mesh (``sharding.context``) the body splits over ``model`` as
the reference's specs do: the q heads (``wq``, ``bq``, and ``wo`` by
rows), and K/V with them where the KV heads divide ``model``; where they
do not, ``wk``, ``wv``, ``bk`` and ``bv`` are whole on every card, which
projects every KV head and attends with those its own q heads read (q
head h reads KV head h // (nq / nkv)).  Where the q heads do not divide
``model`` either, no weight is split and the body runs whole on every
card, as the reference's ``pspec`` leaves it (gemma3-4b: 8 q heads on a
``model`` of 16).  A full layer's cache whose sequence is split
(``cache_seq``, set per cell by ``launch.cells.tune_cache_rules``) is
attended where it lives: each card scores its positions, the softmax's
max and sum are all-reduced over the splitting mesh dims in float32, and
so are the weighted values; a split over ``model`` gathers the token's q
heads first, so every card scores every head, and keeps its own heads'
output for ``wo``.  Only the card whose shard holds the
position writes the token's k/v; a prefill writes each card's shard.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
from torch.distributed.tensor import Shard

from repro_torch.config import ArchConfig, AttnConfig
from repro_torch.models.layers.leaves import Leaves, normal
from repro_torch.models.layers.rope import apply_rope
from repro_torch.sharding.collectives import all_max, all_reduce
from repro_torch.sharding.context import local_body, shard_logical

__all__ = ["Q_CHUNK", "NEG_INF", "Attention", "attend", "specs", "cache_specs",
           "apply_train", "init_cache", "apply_prefill", "apply_decode",
           "check_position", "split_softmax", "reduce_over", "write_token"]


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


def _body(params, x, cfg: ArchConfig):
    a = cfg.attn
    return local_body(params, x, axes={"heads": a.num_q_heads,
                                       "kv_heads": a.num_kv_heads})


def _first_head(b, params) -> int:
    """The first q head this body holds (0 where it holds them all)."""
    return b.model_rank * params["wq"].shape[1] if b.model_parallel else 0


def _read_kv(t: torch.Tensor, q0: int, nq: int, a: AttnConfig):
    """The KV heads of ``t`` (B, S, heads, hd) that q heads q0 .. q0 + nq
    - 1 read, so that the j-th of them reads the (j // g)-th for one g:
    ``t`` itself where it holds only those heads already."""
    g = a.num_q_heads // a.num_kv_heads
    if t.shape[2] != a.num_kv_heads or nq == a.num_q_heads:
        return t
    if nq % g and g % nq:
        raise ValueError(f"attention: {nq} q heads a card and groups of "
                         f"{g} split the KV heads unevenly")
    return t.narrow(2, q0 // g, max(1, nq // g))


def reduce_over(t: torch.Tensor, groups) -> torch.Tensor:
    """``t`` summed over each of ``groups`` in turn."""
    for g in groups:
        t = all_reduce(t, g)
    return t


def split_softmax(scores: torch.Tensor, groups) -> torch.Tensor:
    """The float32 softmax along the last dim of masked ``scores`` whose
    keys are split over ``groups``: the max and the sum all-reduced."""
    mx = scores.amax(dim=-1, keepdim=True)
    for g in groups:
        mx = all_max(mx, g)
    e = torch.exp(scores - mx)
    return e / reduce_over(e.sum(dim=-1, keepdim=True), groups)


def apply_train(params, x: torch.Tensor, cfg: ArchConfig, *,
                sliding: bool) -> torch.Tensor:
    """Full-sequence forward (training, encoding, the prefill trunk)."""
    with _body(params, x, cfg) as b:
        out, _, _ = _full_sequence(b.params, b.x, cfg, sliding,
                                   _first_head(b, b.params))
        return b.out(out, ("batch", None, None))


def _full_sequence(params, x, cfg: ArchConfig, sliding: bool, q0: int = 0):
    """(out, k, v): k and v with every head this body projects (those
    the cache keeps); the q heads from ``q0`` read theirs."""
    a = cfg.attn
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, a, positions)
    a_local = dataclasses.replace(a, window=a.window if sliding else 0)
    nq = q.shape[2]
    out = attend(q, _read_kv(k, q0, nq, a), _read_kv(v, q0, nq, a),
                 a_local, causal=not cfg.is_encoder_only)
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
    runs on its shards of the heads and of the cache (module doc)."""
    size = cache["k"].shape[1]
    if isinstance(pos, int) and not sliding:
        check_position(pos, size)
    with _body(params, x, cfg) as b:
        pl = getattr(cache["k"], "placements", None)
        offset, _, groups = b.chunk(pl, 1, size)
        gather = b.model_parallel and pl[b.mdim] == Shard(1)
        local = {n: b.cache_in(cache[n]) for n in ("k", "v")}
        out = _decode(b.params, b.x, local, pos, cfg, sliding, size=size,
                      offset=offset, groups=groups,
                      q0=_first_head(b, b.params),
                      gather=b.gather_model if gather else None)
        return b.out(out, ("batch", None, None)), cache


def write_token(c: torch.Tensor, new: torch.Tensor, slot: torch.Tensor,
           offset: int, split: bool) -> torch.Tensor:
    """``new`` (B, 1, ...) written at global position ``slot`` of ``c``,
    this rank's positions offset .. offset + len - 1 of a cache (where the
    sequence is ``split``, a rank holding another position writes back
    what it holds)."""
    new = new.to(c.dtype)
    if not split:
        return c.index_copy_(1, slot.reshape(1).long(), new)
    n = c.shape[1]
    at = slot - offset
    idx = at.clamp(0, n - 1).reshape(1).long()
    held = (at >= 0) & (at < n)
    return c.index_copy_(1, idx, torch.where(held, new,
                                             c.index_select(1, idx)))


def _decode(params, x: torch.Tensor, cache: Dict, pos, cfg: ArchConfig,
            sliding: bool, *, size: int, offset: int = 0, groups=(),
            q0: int = 0, gather=None) -> torch.Tensor:
    """One token against ``cache``, this rank's positions offset ..
    offset + len - 1 of ``size`` (``groups``: the process groups that
    split them; none: the whole cache).  ``gather``: joins q's heads
    over ``model``, where the cache's sequence takes that axis (its K/V
    heads are then whole: they do not divide ``model``)."""
    a = cfg.attn
    B = x.shape[0]
    dt = x.dtype
    pos_t = torch.as_tensor(pos, device=x.device).reshape(())
    positions = pos_t.to(torch.int32).expand(B, 1)
    q, k_new, v_new = _project_qkv(params, x, a, positions)
    nq_own = q.shape[2]
    if gather is not None:
        q = gather(q, 2)

    slot = pos_t % size if sliding else pos_t.clamp(max=size - 1)
    k = write_token(cache["k"], k_new, slot, offset, bool(groups))
    v = write_token(cache["v"], v_new, slot, offset, bool(groups))

    # the heads this body attends with (all of them off a mesh)
    nq, hd = q.shape[2], k.shape[3]
    qh0 = 0 if gather is not None else q0
    k, v = _read_kv(k, qh0, nq, a), _read_kv(v, qh0, nq, a)
    nkv = k.shape[2]
    qg = q.reshape(B, 1, nkv, nq // nkv, hd)
    # ring slots written so far all lie within the window by construction;
    # for full caches this is plain causal validity
    valid = offset + torch.arange(k.shape[1], device=x.device) <= pos_t
    scores = torch.einsum("bqngh,bknh->bngqk", qg, k.to(dt)) \
        .to(torch.float32) * hd ** -0.5
    if groups:
        probs = split_softmax(torch.where(valid, scores, NEG_INF), groups)
        out = reduce_over(torch.einsum("bngqk,bknh->bqngh", probs,
                                       v.to(torch.float32)), groups).to(dt)
    else:
        out = _softmax_attend(scores, valid, v.to(dt), dt)
    out = out.reshape(B, 1, nq, hd)
    if gather is not None:
        out = out.narrow(2, q0, nq_own)
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
    ring of the last ``window`` tokens (when the prompt holds that many).
    Under a mesh each card builds its own shard of the cache."""
    a = cfg.attn
    with _body(params, x, cfg) as b:
        xl = b.x
        Bl, S, _ = xl.shape
        out, k, v = _full_sequence(b.params, xl, cfg, sliding,
                                   _first_head(b, b.params))
        cdt = cache_dtype
        spec = cache_specs(cfg, sliding=sliding, long_context=False)
        ring = sliding and a.window and S >= a.window
        size = a.window if ring else max(cache_len, S)
        shape = (x.shape[0], size, a.num_kv_heads, a.head_dim)
        offset, n, _ = b.chunk(b.cache_placements(spec["k"], shape), 1,
                               size)
        cache = {}
        for name, t in (("k", k), ("v", v)):
            if ring:
                c = torch.roll(t[:, S - size:], S % size, dims=1).to(cdt)
            else:
                c = torch.zeros((Bl, n) + tuple(t.shape[2:]), dtype=cdt,
                                device=xl.device)
                held = max(0, min(S, offset + n) - offset)
                c[:, :held] = t[:, offset:offset + held]
            cache[name] = b.cache_new(c, spec[name], shape)
        return b.out(out, ("batch", None, None)), cache
