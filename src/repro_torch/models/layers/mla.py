"""Multi-head Latent Attention (DeepSeek-V2/V3).

Train and prefill materialise per-head ``k_nope`` and ``v`` from the
compressed latent.  Decode takes the *absorbed* form: the cache holds only
``ckv`` (B, L, kv_lora_rank) and ``k_rope`` (B, L, qk_rope_dim), one
shared RoPE head; ``w_uk`` is folded into the query and ``w_uv`` into the
output, so attention runs in the latent.  The two forms are equal in exact
arithmetic only.

The reference's formula, written out: scores by ``einsum``, cast to
float32 and scaled by (qk_nope_dim + qk_rope_dim)^-0.5, masked with
``NEG_INF``, softmax in float32, cast back.  The full-sequence pass splits
the queries into ``max(1, S // Q_CHUNK)`` equal chunks, so S must be a
multiple of that count (the reference's reshape fails otherwise; here it
raises).  The latent norms use ``rms_apply``'s default eps (1e-6), as the
reference's do, not ``cfg.norm_eps``.  Decode writes the new latent into
the cache in place (``index_copy_``) and returns the same dict.

Under a mesh the body splits by heads as the reference's specs do:
``w_uq``, ``w_uk``, ``w_uv`` and ``wo`` (by rows, its partial sum
completed by the body's all-reduce) over ``model``, while ``w_dq``,
``w_dkv`` and the two norms are whole on every card (the latent is the
same on every card, and so is the cache, which has no heads).  The
absorbed decode's ``q_lat`` and value absorption run on the card's
heads; a cache whose sequence is split (``cache_seq``) is attended as
``attention``'s is (its module doc).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.config import ArchConfig, AttnConfig
from repro_torch.models.layers import norms
from torch.distributed.tensor import Shard

from repro_torch.models.layers.attention import NEG_INF, Q_CHUNK, \
    check_position, reduce_over, split_softmax, write_token
from repro_torch.models.layers.leaves import Leaves, normal
from repro_torch.models.layers.rope import apply_rope
from repro_torch.sharding.context import local_body, shard_logical

__all__ = ["MLA", "apply_train", "init_cache", "specs", "cache_specs",
           "apply_prefill", "apply_decode"]


def specs(cfg: ArchConfig) -> Dict:
    return {"w_dq": ("fsdp", None), "q_norm": {"scale": (None,)},
            "w_uq": ("fsdp", "heads", None), "w_dkv": ("fsdp", None),
            "kv_norm": {"scale": (None,)}, "w_uk": ("fsdp", "heads", None),
            "w_uv": ("fsdp", "heads", None), "wo": ("heads", None, "fsdp")}


def cache_specs(cfg: ArchConfig, *, long_context: bool, **_) -> Dict:
    return {"ckv": ("batch", "cache_seq", None),
            "k_rope": ("batch", "cache_seq", None)}


class MLA(Leaves):
    """``w_dq`` (d, q_rank), ``q_norm``, ``w_uq`` (q_rank, nq, dn + dr),
    ``w_dkv`` (d, kv_rank + dr), ``kv_norm``, ``w_uk`` (kv_rank, nq, dn),
    ``w_uv`` (kv_rank, nq, dv), ``wo`` (nq, dv, d)."""

    def __init__(self, cfg: ArchConfig, *,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        a = cfg.attn
        d, nq = cfg.d_model, a.num_q_heads
        qr, kvr = a.q_lora_rank, a.kv_lora_rank
        dn, dr, dv = a.qk_nope_dim, a.qk_rope_dim, a.v_head_dim
        s = d ** -0.5
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.w_dq = normal((d, qr), s, **kw)
        self.q_norm = norms.RMSNorm(qr, dtype=dtype, device=device)
        self.w_uq = normal((qr, nq, dn + dr), qr ** -0.5, **kw)
        self.w_dkv = normal((d, kvr + dr), s, **kw)
        self.kv_norm = norms.RMSNorm(kvr, dtype=dtype, device=device)
        self.w_uk = normal((kvr, nq, dn), kvr ** -0.5, **kw)
        self.w_uv = normal((kvr, nq, dv), kvr ** -0.5, **kw)
        self.wo = normal((nq, dv, d), (nq * dv) ** -0.5, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_train(self, x, self.cfg)

    def prefill(self, x: torch.Tensor, *, cache_len: int,
                cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict]:
        return apply_prefill(self, x, self.cfg, cache_len=cache_len,
                             cache_dtype=cache_dtype)

    def decode(self, x: torch.Tensor, cache: Dict, pos
               ) -> Tuple[torch.Tensor, Dict]:
        return apply_decode(self, x, cache, pos, self.cfg)


def _body(params, x, cfg: ArchConfig):
    return local_body(params, x, axes={"heads": cfg.attn.num_q_heads})


def _project_q(params, x: torch.Tensor, a: AttnConfig,
               positions: torch.Tensor):
    dt = x.dtype
    cq = norms.rms_apply(params["q_norm"], x @ params["w_dq"].to(dt))
    q = torch.einsum("bsr,rnh->bsnh", cq, params["w_uq"].to(dt))
    q_nope, q_rope = q[..., :a.qk_nope_dim], q[..., a.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, a.rope_theta)


def _project_kv_latent(params, x: torch.Tensor, a: AttnConfig,
                       positions: torch.Tensor):
    """(ckv (B, S, kv_rank), k_rope (B, S, dr)): the normed latent and the
    shared RoPE head."""
    dt = x.dtype
    dkv = x @ params["w_dkv"].to(dt)
    ckv = norms.rms_apply(params["kv_norm"], dkv[..., :a.kv_lora_rank])
    k_rope = apply_rope(dkv[..., None, a.kv_lora_rank:], positions,
                        a.rope_theta)
    return ckv, k_rope[..., 0, :]


def _full_sequence(params, x: torch.Tensor, cfg: ArchConfig):
    """(out (B, S, d), ckv, k_rope) of a causal pass over x (B, S, d)."""
    a = cfg.attn
    B, S, _ = x.shape
    dt = x.dtype
    dev = x.device
    positions = torch.arange(S, device=dev)[None, :]
    q_nope, q_rope = _project_q(params, x, a, positions)
    ckv, k_rope = _project_kv_latent(params, x, a, positions)
    k_nope = torch.einsum("bsr,rnh->bsnh", ckv, params["w_uk"].to(dt))
    v = torch.einsum("bsr,rnh->bsnh", ckv, params["w_uv"].to(dt))
    q_nope = shard_logical(q_nope, ("batch", None, "heads", None))
    k_nope = shard_logical(k_nope, ("batch", None, "heads", None))

    scale = (a.qk_nope_dim + a.qk_rope_dim) ** -0.5
    n_chunks = max(1, S // Q_CHUNK)
    if S % n_chunks:
        raise ValueError(f"mla: a sequence of S={S} does not split into "
                         f"{n_chunks} equal query chunks (max(1, S // "
                         f"{Q_CHUNK}))")
    lq = S // n_chunks
    k_pos = torch.arange(S, device=dev)
    outs = []
    for start in range(0, S, lq):
        qn, qr = q_nope[:, start:start + lq], q_rope[:, start:start + lq]
        scores = (torch.einsum("bqnh,bknh->bnqk", qn, k_nope)
                  + torch.einsum("bqnh,bkh->bnqk", qr, k_rope)
                  ).to(torch.float32) * scale
        q_pos = start + torch.arange(lq, device=dev)
        mask = k_pos[None, :] <= q_pos[:, None]
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(dt)
        outs.append(torch.einsum("bnqk,bknh->bqnh", probs, v))
    out = torch.einsum("bsnh,nhd->bsd", torch.cat(outs, dim=1),
                       params["wo"].to(dt))
    return shard_logical(out, ("batch", None, None)), ckv, k_rope


def apply_train(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence forward (training, the prefill trunk)."""
    with _body(params, x, cfg) as b:
        return b.out(_full_sequence(b.params, b.x, cfg)[0],
                     ("batch", None, None))


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device=None) -> Dict:
    a = cfg.attn
    return {"ckv": torch.zeros((batch, max_len, a.kv_lora_rank),
                               dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, a.qk_rope_dim),
                                  dtype=dtype, device=device)}


def apply_decode(params, x: torch.Tensor, cache: Dict,
                 pos: Union[int, torch.Tensor], cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, Dict]:
    """Absorbed single-token decode.  x: (B, 1, d); pos: an int or a 0-d
    integer tensor on x's device.  An int position past the cache raises;
    a tensor one is clamped to its last slot, as the reference's
    ``dynamic_update_slice`` does."""
    size = cache["ckv"].shape[1]
    if isinstance(pos, int):
        check_position(pos, size)
    with _body(params, x, cfg) as b:
        pl = getattr(cache["ckv"], "placements", None)
        offset, _, groups = b.chunk(pl, 1, size)
        gather = b.model_parallel and pl[b.mdim] == Shard(1)
        local = {n: b.cache_in(cache[n]) for n in ("ckv", "k_rope")}
        out = _decode(b.params, b.x, local, pos, cfg, size=size,
                      offset=offset, groups=groups,
                      gather=b.gather_model if gather else None,
                      q0=b.model_rank * b.params["w_uk"].shape[1])
        return b.out(out, ("batch", None, None)), cache


def _decode(params, x: torch.Tensor, cache: Dict, pos, cfg: ArchConfig, *,
            size: int, offset: int = 0, groups=(), gather=None, q0: int = 0
            ) -> torch.Tensor:
    """The absorbed decode on this rank's heads and cache positions
    offset .. offset + len - 1 of ``size`` (``attention._decode``)."""
    a = cfg.attn
    B = x.shape[0]
    dt = x.dtype
    pos_t = torch.as_tensor(pos, device=x.device).reshape(())
    positions = pos_t.to(torch.int32).expand(B, 1)
    q_nope, q_rope = _project_q(params, x, a, positions)     # (B, 1, n, .)
    ckv_new, k_rope_new = _project_kv_latent(params, x, a, positions)

    slot = pos_t.clamp(max=size - 1)
    ckv = write_token(cache["ckv"], ckv_new, slot, offset, bool(groups))
    k_rope = write_token(cache["k_rope"], k_rope_new, slot, offset,
                         bool(groups))

    # w_uk folded into the query: q_lat (B, 1, n, kv_rank)
    q_lat = torch.einsum("bqnh,rnh->bqnr", q_nope, params["w_uk"].to(dt))
    n_own = q_lat.shape[2]
    if gather is not None:
        q_lat, q_rope = gather(q_lat, 2), gather(q_rope, 2)
    scale = (a.qk_nope_dim + a.qk_rope_dim) ** -0.5
    ckv_d = ckv.to(dt)
    scores = (torch.einsum("bqnr,bkr->bnqk", q_lat, ckv_d)
              + torch.einsum("bqnh,bkh->bnqk", q_rope, k_rope.to(dt))
              ).to(torch.float32) * scale
    valid = offset + torch.arange(ckv.shape[1], device=x.device) <= pos_t
    scores = torch.where(valid, scores, NEG_INF)
    if groups:
        o_lat = reduce_over(torch.einsum(
            "bnqk,bkr->bqnr", split_softmax(scores, groups),
            ckv.to(torch.float32)), groups).to(dt)
    else:
        probs = torch.softmax(scores, dim=-1).to(dt)
        o_lat = torch.einsum("bnqk,bkr->bqnr", probs, ckv_d)
    if gather is not None:
        o_lat = o_lat.narrow(2, q0, n_own)
    out = torch.einsum("bqnr,rnh->bqnh", o_lat, params["w_uv"].to(dt))
    out = torch.einsum("bsnh,nhd->bsd", out, params["wo"].to(dt))
    return shard_logical(out, ("batch", None, None))


def apply_prefill(params, x: torch.Tensor, cfg: ArchConfig, *,
                  cache_len: int, cache_dtype=torch.bfloat16
                  ) -> Tuple[torch.Tensor, Dict]:
    """Forward plus the latent cache of max(cache_len, S) positions (under
    a mesh, each card's shard of it)."""
    with _body(params, x, cfg) as b:
        xl = b.x
        Bl, S, _ = xl.shape
        out, ckv, k_rope = _full_sequence(b.params, xl, cfg)
        size = max(cache_len, S)
        spec = cache_specs(cfg, long_context=False)
        cache = {}
        for name, t in (("ckv", ckv), ("k_rope", k_rope)):
            shape = (x.shape[0], size, t.shape[-1])
            offset, n, _ = b.chunk(b.cache_placements(spec[name], shape), 1,
                                   size)
            c = torch.zeros((Bl, n, t.shape[-1]), dtype=cache_dtype,
                            device=xl.device)
            held = max(0, min(S, offset + n) - offset)
            c[:, :held] = t[:, offset:offset + held]
            cache[name] = b.cache_new(c, spec[name], shape)
        return b.out(out, ("batch", None, None)), cache
