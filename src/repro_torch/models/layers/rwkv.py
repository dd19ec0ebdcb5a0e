"""RWKV-6 ("Finch") time-mix: linear attention with a data-dependent
per-channel decay, as chunked products.

State per head: S (hd, hd); per token t, head-local:
    y_t = r_t (S_{t-1} + (u * k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with w_t = exp(-exp(w0 + lora(x_t))) in (0, 1).

The reference's chunking (length L), in the log domain: ``lw`` is the
inclusive cumulative sum of log w within the chunk, ``elw`` the exclusive
one.  The inter-chunk term is (r exp(elw)) @ S0; the intra-chunk pairs use
D[t, s] = exp(clip(elw_t - lw_s, -60, 0)) for s < t, so no 1/decay factor
ever appears; the bonus diagonal is (r u) . k; the state update is
exp(lw_L) S0 + sum_s (k_s exp(lw_L - lw_s)) v_s^T.  The token shift is the
reference's static lerp.  A sequence must be shorter than ``chunk`` or a
multiple of it (``mamba.chunk_length``; the reference asserts so).

``w0``, ``u`` and the state are float32 whatever the model's dtype
(float64 in a float64 model).  ``out_norm`` is ``rms_apply`` at its
default eps (1e-6), as in the reference, not ``cfg.norm_eps``.  Decode
writes the new state and shift token into the cache in place and returns
the same dict; ``pos`` and ``cache_len`` are unused.

Under a mesh the body splits by heads over ``model``, as the reference's
specs do: ``wr``, ``wk``, ``wv``, ``u`` and the ``state`` cache hold the
card's heads, ``wg`` its columns (the same channels), and ``wo`` splits
by rows, its partial sum completed by the body's output.  ``mix``,
``w0``, the decay LoRA and ``out_norm`` are whole on every card: the
decay is computed for every channel and sliced to the card's, and
``out_norm``, an RMS over the whole ``d``, all-reduces its local sum of
squares over ``model`` before the scale.  The ``shift`` cache is whole
on every card.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ArchConfig
from repro_torch.models.layers import norms
from repro_torch.models.layers.leaves import Leaves, normal
from repro_torch.models.layers.mamba import chunk_length
from repro_torch.sharding.context import local_body, shard_logical

__all__ = ["RWKV6", "LORA_RANK", "apply_train", "init_cache", "specs",
           "cache_specs", "apply_prefill", "apply_decode"]


def specs(cfg: ArchConfig) -> Dict:
    return {"mix": (None, None), "w0": (None,),
            "w_lora_a": ("fsdp", None), "w_lora_b": (None, "fsdp"),
            "wr": ("fsdp", "heads", None), "wk": ("fsdp", "heads", None),
            "wv": ("fsdp", "heads", None), "wg": ("fsdp", "ffn"),
            "u": ("heads", None), "out_norm": {"scale": (None,)},
            "wo": ("heads", None, "fsdp")}


def cache_specs(cfg: ArchConfig, **_) -> Dict:
    return {"state": ("batch", "heads", None, None),
            "shift": ("batch", None, None)}

LORA_RANK = 64


class RWKV6(Leaves):
    """``mix`` (5, d), ``w0`` (d,) float32, ``w_lora_a`` (d, 64),
    ``w_lora_b`` (64, d), ``wr``, ``wk``, ``wv`` (d, H, hd), ``wg`` (d, d),
    ``u`` (H, hd) float32, ``out_norm``, ``wo`` (H, hd, d)."""

    def __init__(self, cfg: ArchConfig, *,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.rwkv.head_dim
        H = d // hd
        s = d ** -0.5
        kw = dict(generator=generator, dtype=dtype, device=device)
        # the r, k, v, w, g token-shift mixes
        self.mix = nn.Parameter(torch.full((5, d), 0.5, dtype=dtype,
                                           device=device))
        # the decay bias: w ~ exp(-exp(w0))
        self.w0 = nn.Parameter(torch.full((d,), -0.6931, dtype=torch.float32,
                                          device=device))
        self.w_lora_a = normal((d, LORA_RANK), s, **kw)
        self.w_lora_b = normal((LORA_RANK, d), LORA_RANK ** -0.5 * 0.1, **kw)
        self.wr = normal((d, H, hd), s, **kw)
        self.wk = normal((d, H, hd), s, **kw)
        self.wv = normal((d, H, hd), s, **kw)
        self.wg = normal((d, d), s, **kw)
        self.u = normal((H, hd), 0.1, generator, torch.float32, device)
        self.out_norm = norms.RMSNorm(d, dtype=dtype, device=device)
        self.wo = normal((H, hd, d), s, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_train(self, x, self.cfg)

    def prefill(self, x: torch.Tensor, *, cache_len: int = 0,
                cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict]:
        return apply_prefill(self, x, self.cfg, cache_dtype=cache_dtype)

    def decode(self, x: torch.Tensor, cache: Dict, pos=None
               ) -> Tuple[torch.Tensor, Dict]:
        return apply_decode(self, x, cache, pos, self.cfg)


def _body(params, x, cfg: ArchConfig):
    d = cfg.d_model
    return local_body(params, x, axes={"heads": d // cfg.rwkv.head_dim,
                                       "ffn": d})


def _channels(b, params):
    """(first, count) of the channels of d this body's heads hold."""
    n = params["wg"].shape[1]
    return (b.model_rank * n if b.model_parallel else 0), n


def _out_norm(b, params, y: torch.Tensor, c0: int) -> torch.Tensor:
    """``rms_apply(out_norm, y)`` over the whole d, y holding channels c0
    .. of it: the sum of squares all-reduced over ``model``."""
    if not b.model_parallel:
        return norms.rms_apply(params["out_norm"], y)
    yf = y.to(torch.float32)
    d = b.model_size * y.shape[-1]
    var = b.all_reduce(torch.sum(yf * yf, dim=-1, keepdim=True)) / d
    scale = params["out_norm"]["scale"].narrow(0, c0, y.shape[-1])
    return (yf * torch.rsqrt(var + 1e-6)
            * scale.to(torch.float32)).to(y.dtype)


def _mix_projections(params, x: torch.Tensor, x_prev: torch.Tensor,
                     cfg: ArchConfig, c0: int = 0):
    """The token-shift lerp and the projections, x (B, S, d), x_prev (B, 1,
    d): r, k, v (B, S, H, hd), g (B, S, d) and log w (B, S, H, hd) in the
    state's dtype; under a split body, the heads and channels from
    channel ``c0`` (``wr``'s local heads)."""
    hd = cfg.rwkv.head_dim
    dt = x.dtype
    shifted = torch.cat([x_prev, x[:, :-1]], dim=1)
    mix = params["mix"].to(dt)[:, None, None]               # (5, 1, 1, d)
    xr, xk, xv, xw, xg = x[None] * mix + shifted[None] * (1 - mix)
    r = torch.einsum("bsd,dnh->bsnh", xr, params["wr"].to(dt))
    k = torch.einsum("bsd,dnh->bsnh", xk, params["wk"].to(dt))
    v = torch.einsum("bsd,dnh->bsnh", xv, params["wv"].to(dt))
    g = F.silu(xg @ params["wg"].to(dt))
    f = torch.promote_types(dt, torch.float32)
    w_raw = params["w0"] + (torch.tanh(xw @ params["w_lora_a"].to(dt))
                            @ params["w_lora_b"].to(dt)).to(f)
    log_w = -torch.exp(w_raw.narrow(-1, c0, g.shape[-1]))
    return r, k, v, g, log_w.reshape(*log_w.shape[:-1], r.shape[2], hd)


def _chunk_wkv(r, k, v, log_w, u, S0):
    """One chunk, batched over (B, H): r, k, v (B, L, H, hd), log_w (B, L,
    H, hd) and S0 (B, H, hd, hd) in the state's dtype, u (H, hd).  Returns
    y (B, L, H, hd) in r's dtype and S1."""
    L = r.shape[1]
    f = log_w.dtype
    rf, kf, vf = r.to(f), k.to(f), v.to(f)
    lw = torch.cumsum(log_w, dim=1)                         # inclusive
    elw = lw - log_w                                        # exclusive
    y_inter = torch.einsum("blnh,bnhe->blne", rf * torch.exp(elw), S0)
    D = torch.exp(torch.clamp(elw[:, :, None] - lw[:, None], -60.0, 0.0))
    scores = torch.einsum("blnh,bsnh,blsnh->blsn", rf, kf, D)
    ar = torch.arange(L, device=r.device)
    scores = scores * (ar[:, None] > ar[None, :])[None, :, :, None]
    bonus = torch.einsum("blnh,blnh->bln", rf * u.to(f), kf)
    y_intra = torch.einsum("blsn,bsnh->blnh", scores, vf) \
        + bonus[..., None] * vf
    k_s = kf * torch.exp(lw[:, -1:] - lw)                   # <= 1
    S1 = torch.exp(lw[:, -1])[..., None] * S0 \
        + torch.einsum("blnh,blne->bnhe", k_s, vf)
    return (y_inter + y_intra).to(r.dtype), S1


def _mix(params, x: torch.Tensor, cfg: ArchConfig, b):
    """(out (B, S, d), the last state) of the time-mix from a zero
    previous token and a zero state, on ``b``'s heads."""
    B, S, _ = x.shape
    hd = cfg.rwkv.head_dim
    c0, dl = _channels(b, params)
    H = dl // hd
    L = chunk_length(cfg.rwkv.chunk, S, "rwkv6")
    r, k, v, g, log_w = _mix_projections(
        params, x, torch.zeros_like(x[:, :1]), cfg, c0)
    r = shard_logical(r, ("batch", None, "heads", None))
    state = torch.zeros((B, H, hd, hd), dtype=log_w.dtype, device=x.device)
    ys = []
    for s0 in range(0, S, L):
        c = slice(s0, s0 + L)
        y, state = _chunk_wkv(r[:, c], k[:, c], v[:, c], log_w[:, c],
                              params["u"], state)
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(B, S, dl)
    y = _out_norm(b, params, y, c0) * g
    out = torch.einsum("bsnh,nhd->bsd", y.reshape(B, S, H, hd),
                       params["wo"].to(x.dtype))
    return shard_logical(out, ("batch", None, None)), state


def apply_train(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence forward, x (B, S, d)."""
    with _body(params, x, cfg) as b:
        return b.out(_mix(b.params, b.x, cfg, b)[0], ("batch", None, None))


def init_cache(cfg: ArchConfig, batch: int, max_len: int = 0, *,
               dtype=torch.bfloat16, device=None) -> Dict:
    """``state`` (B, H, hd, hd) float32, ``shift`` (B, 1, d) in
    ``dtype``."""
    d, hd = cfg.d_model, cfg.rwkv.head_dim
    return {"state": torch.zeros((batch, d // hd, hd, hd),
                                 dtype=torch.float32, device=device),
            "shift": torch.zeros((batch, 1, d), dtype=dtype, device=device)}


def apply_decode(params, x: torch.Tensor, cache: Dict, pos,
                 cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """One token, x (B, 1, d): y = r (S0 + u k v^T), S1 = w S0 + k v^T;
    the new shift is x."""
    del pos
    with _body(params, x, cfg) as b:
        p, x = b.params, b.x
        state, shift = b.cache_in(cache["state"]), b.cache_in(cache["shift"])
        B = x.shape[0]
        hd = cfg.rwkv.head_dim
        c0, dl = _channels(b, p)
        dt = x.dtype
        r, k, v, g, log_w = _mix_projections(p, x, shift.to(dt), cfg, c0)
        f = log_w.dtype
        rf, kf, vf = (t[:, 0].to(f) for t in (r, k, v))    # (B, H, hd)
        kv = kf[..., :, None] * vf[..., None, :]            # (B, H, hd, hd)
        y = torch.einsum("bnh,bnhe->bne", rf,
                         state + p["u"].to(f)[None, :, :, None] * kv)
        S1 = torch.exp(log_w[:, 0])[..., None] * state + kv
        y = _out_norm(b, p, y.reshape(B, 1, dl).to(dt), c0) * g
        out = torch.einsum("bsnh,nhd->bsd", y.reshape(B, 1, dl // hd, hd),
                           p["wo"].to(dt))
        state.copy_(S1)
        shift.copy_(x)
        return b.out(out, ("batch", None, None)), cache


def apply_prefill(params, x: torch.Tensor, cfg: ArchConfig, *,
                  cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict]:
    """Forward plus the decode cache: the last state and the last input
    token."""
    d, hd = cfg.d_model, cfg.rwkv.head_dim
    with _body(params, x, cfg) as b:
        out, state = _mix(b.params, b.x, cfg, b)
        B = x.shape[0]
        spec = cache_specs(cfg)
        cache = {"state": b.cache_new(state, spec["state"],
                                      (B, d // hd, hd, hd)),
                 "shift": b.cache_new(b.x[:, -1:].to(cache_dtype),
                                      spec["shift"], (B, 1, d))}
        return b.out(out, ("batch", None, None)), cache
