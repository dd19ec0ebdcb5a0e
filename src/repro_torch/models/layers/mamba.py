"""Mamba-1 selective SSM block (Jamba's sequence mixer).

The reference's chunked scan: chunks of ``chunk`` tokens carry the state;
inside a chunk, the inclusive prefix of h_t = a_t h_{t-1} + b_t is
ceil(log2 L) shifted-combine steps of the associative scan's own combine,
(a1 a2, a2 b1 + b2): no loop over tokens and no division by a decay
prefix.  The decay ``a`` and input ``b`` (B, L, di, n) are made one chunk
at a time from the whole sequence's ``delta``, ``B`` and ``C`` (elementwise,
so the reference's values), which bounds the working set to one chunk.

A sequence must be shorter than ``chunk`` or a multiple of it (the
reference asserts so in its forward, and its prefill's reshape fails
otherwise), and a prefill at least ``d_conv - 1`` tokens long (a shorter
one would leave a conv cache too short for the next decode, where the
reference fails); both raise ``ValueError``.

``A_log``, ``D`` and the SSM state are float32 whatever the model's dtype
(float64 in a float64 model).  Decode writes the new conv window and state
into the cache in place and returns the same dict; ``pos`` and
``cache_len`` are taken for the mixers' common signature and unused.

Under a mesh the body splits by ``d_inner`` channels over ``model``, as
the reference's specs do: ``conv_w``, ``conv_b``, ``dt_proj`` (by
columns), ``dt_bias``, ``A_log``, ``D`` and the caches hold the card's
channels, the scan runs on them, ``x_proj`` and ``out_proj`` split by
rows: ``x_proj``'s (B, L, dt_rank + 2n) partial sums are all-reduced
inside the body, ``out_proj``'s by the body's output.  ``in_proj`` keeps
its layout (the reference's checkpoints and ``interop`` share it): its
(d, 2 di) columns split contiguously, so a card's block holds u-channels
or z-channels of other cards (with m cards, block j holds the u or z of
cards 2j mod m and 2j + 1 mod m), not its own.  Each card multiplies by
its block and one all-to-all over ``model`` (``_split_uz``) sends every
half-block to the card whose u or z it is: 2 B L di / m elements a card
each way, where gathering ``in_proj`` instead would move (m - 1) / m of
its d x 2 di weights to every card on every call, decode steps included.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ArchConfig
from repro_torch.models.layers.leaves import Leaves, normal
from repro_torch.sharding.collectives import exchange
from repro_torch.sharding.context import local_body, shard_logical

__all__ = ["Mamba", "dt_rank", "chunk_length", "apply_train", "init_cache",
           "specs", "cache_specs", "apply_prefill", "apply_decode"]


def specs(cfg: ArchConfig) -> Dict:
    return {"in_proj": ("fsdp", "ffn"), "conv_w": (None, "ffn"),
            "conv_b": ("ffn",), "x_proj": ("ffn", None),
            "dt_proj": (None, "ffn"), "dt_bias": ("ffn",),
            "A_log": ("ffn", None), "D": ("ffn",),
            "out_proj": ("ffn", "fsdp")}


def cache_specs(cfg: ArchConfig, **_) -> Dict:
    return {"conv": ("batch", None, "ffn"), "ssm": ("batch", "ffn", None)}


def dt_rank(cfg: ArchConfig) -> int:
    return math.ceil(cfg.d_model / 16)


def chunk_length(chunk: int, seq: int, layer: str) -> int:
    """min(chunk, seq), which must divide ``seq``: the chunked scans'
    length rule."""
    n = min(chunk, seq)
    if seq % n:
        raise ValueError(f"{layer}: a sequence of {seq} tokens is neither "
                         f"shorter than the chunk ({chunk}) nor a multiple "
                         f"of it")
    return n


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The state's dtype: float32, or the model's if wider."""
    return torch.promote_types(dtype, torch.float32)


class Mamba(Leaves):
    """``in_proj`` (d, 2 di), ``conv_w`` (d_conv, di), ``conv_b``,
    ``x_proj`` (di, dt_rank + 2n), ``dt_proj`` (dt_rank, di), ``dt_bias``,
    ``A_log`` (di, n) and ``D`` (di,) float32, ``out_proj`` (di, d)."""

    def __init__(self, cfg: ArchConfig, *,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        m = cfg.mamba
        d = cfg.d_model
        di, n, dc, dtr = m.expand * d, m.d_state, m.d_conv, dt_rank(cfg)
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.in_proj = normal((d, 2 * di), d ** -0.5, **kw)
        self.conv_w = normal((dc, di), dc ** -0.5, **kw)
        self.conv_b = nn.Parameter(torch.zeros((di,), dtype=dtype,
                                               device=device))
        self.x_proj = normal((di, dtr + 2 * n), di ** -0.5, **kw)
        self.dt_proj = normal((dtr, di), dtr ** -0.5, **kw)
        # dt log-uniform in [1e-3, 0.1], through softplus's inverse
        if generator is None:
            dt_bias = torch.empty((di,), dtype=dtype, device=device)
        else:
            lo, hi = math.log(1e-3), math.log(0.1)
            dt = torch.exp(torch.rand((di,), generator=generator,
                                      dtype=torch.float32, device=device)
                           * (hi - lo) + lo)
            dt_bias = torch.log(torch.expm1(dt)).to(dtype)
        self.dt_bias = nn.Parameter(dt_bias)
        # S4D-real: A = -(1, ..., n) in every channel
        self.A_log = nn.Parameter(torch.log(torch.arange(
            1, n + 1, dtype=torch.float32, device=device)).repeat(di, 1))
        self.D = nn.Parameter(torch.ones((di,), dtype=torch.float32,
                                         device=device))
        self.out_proj = normal((di, d), di ** -0.5, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_train(self, x, self.cfg)

    def prefill(self, x: torch.Tensor, *, cache_len: int = 0,
                cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict]:
        return apply_prefill(self, x, self.cfg, cache_dtype=cache_dtype)

    def decode(self, x: torch.Tensor, cache: Dict, pos=None
               ) -> Tuple[torch.Tensor, Dict]:
        return apply_decode(self, x, cache, pos, self.cfg)


def _body(params, x, cfg: ArchConfig):
    return local_body(params, x,
                      axes={"ffn": cfg.mamba.expand * cfg.d_model})


def _ssm_inputs(params, u: torch.Tensor, cfg: ArchConfig, b=None):
    """u (B, L, di) post-conv -> (delta (B, L, di), B (B, L, n), C (B, L,
    n)), in the state's dtype; ``b``: the body that completes x_proj's
    partial sums."""
    n, dtr = cfg.mamba.d_state, dt_rank(cfg)
    dt, f = u.dtype, _wide(u.dtype)
    xdb = u @ params["x_proj"].to(dt)
    if b is not None:
        xdb = b.all_reduce(xdb)
    delta = F.softplus((xdb[..., :dtr] @ params["dt_proj"].to(dt)).to(f)
                       + params["dt_bias"])
    return delta, xdb[..., dtr:dtr + n].to(f), xdb[..., dtr + n:].to(f)


def _decay_input(params, delta: torch.Tensor, u: torch.Tensor,
                 bc: torch.Tensor):
    """a = exp(delta A) and b = delta u B, each (B, L, di, n)."""
    A = -torch.exp(params["A_log"].to(delta.dtype))
    a = torch.exp(delta[..., None] * A)
    b = (delta * u.to(delta.dtype))[..., None] * bc[..., None, :]
    return a, b


def _ssm_coeffs(params, u: torch.Tensor, cfg: ArchConfig, body=None):
    """The reference's ``_ssm_coeffs``: a, b (B, L, di, n) and C (B, L,
    n)."""
    delta, bc, cc = _ssm_inputs(params, u, cfg, body)
    return (*_decay_input(params, delta, u, bc), cc)


def _chunk_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t h_{t-1} + b_t within a chunk, a, b (B, L, di, n), from h0
    (B, di, n): (h_all (B, L, di, n), h_last).  The prefix pairs come from
    shifted combines at distances 1, 2, 4, ... (Hillis-Steele)."""
    step = a.shape[1]
    shift = 1
    while shift < step:
        a_hi = a[:, shift:]
        b = torch.cat([b[:, :shift], a_hi * b[:, :-shift] + b[:, shift:]],
                      dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a_hi], dim=1)
        shift *= 2
    h_all = a * h0[:, None] + b
    return h_all, h_all[:, -1]


def _split_uz(uz: torch.Tensor, b):
    """(u, z) of this card's channels from ``uz``, x times its block of
    in_proj's columns (module doc): block j's halves are the u- or
    z-channels of cards 2j mod m and 2j + 1 mod m, exchanged over
    ``model``."""
    m, r = b.model_size, b.model_rank
    n = uz.shape[-1] // 2
    if m == 1:
        return uz[..., :n], uz[..., n:]
    to = [(2 * r + p) % m for p in (0, 1)]
    halves = [uz[..., :n], uz[..., n:]]
    if to[1] < to[0]:
        halves.reverse()
    send, recv = [0] * m, [0] * m
    for k in to:
        send[k] += 1
    recv[r // 2] += 1           # u of channel block r: half r of all 2m
    recv[(m + r) // 2] += 1     # z: half m + r
    got = exchange(torch.stack(halves), b.mesh.get_group(b.mdim), send,
                   recv)
    return got[0], got[1]


def _in_proj(params, x: torch.Tensor, cfg: ArchConfig, b=None):
    uz = x @ params["in_proj"].to(x.dtype)
    if b is not None and b.model_parallel:
        return _split_uz(uz, b)
    di = cfg.mamba.expand * cfg.d_model
    return uz[..., :di], uz[..., di:]


def _mix(params, x: torch.Tensor, cfg: ArchConfig, b=None):
    """(out (B, S, d), u_raw (B, S, di) before the conv, last state); ``b``:
    the body whose shards these are (None: whole)."""
    m = cfg.mamba
    B, S, _ = x.shape
    dt = x.dtype
    L = chunk_length(m.chunk, S, "mamba")
    u_raw, z = _in_proj(params, x, cfg, b)
    u_raw = shard_logical(u_raw, ("batch", None, "ffn"))
    # causal depthwise conv along S, in the reference's order of terms
    u_pad = F.pad(u_raw, (0, 0, m.d_conv - 1, 0))
    conv = sum(u_pad[:, i:i + S] * params["conv_w"][i].to(dt)
               for i in range(m.d_conv))
    u = F.silu(conv + params["conv_b"].to(dt))
    delta, bc, cc = _ssm_inputs(params, u, cfg, b)
    h = torch.zeros((B, u.shape[-1], m.d_state), dtype=delta.dtype,
                    device=x.device)
    ys = []
    for s0 in range(0, S, L):
        c = slice(s0, s0 + L)
        a, b = _decay_input(params, delta[:, c], u[:, c], bc[:, c])
        h_all, h = _chunk_scan(a, b, h)
        ys.append(torch.einsum("blin,bln->bli", h_all, cc[:, c]))
    y = torch.cat(ys, dim=1)
    y = (y + params["D"] * u.to(y.dtype)).to(dt)
    out = (y * F.silu(z)) @ params["out_proj"].to(dt)
    return shard_logical(out, ("batch", None, None)), u_raw, h


def apply_train(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence forward, x (B, S, d)."""
    with _body(params, x, cfg) as b:
        return b.out(_mix(b.params, b.x, cfg, b)[0], ("batch", None, None))


def init_cache(cfg: ArchConfig, batch: int, max_len: int = 0, *,
               dtype=torch.bfloat16, device=None) -> Dict:
    """``conv`` (B, d_conv - 1, di) in ``dtype``, ``ssm`` (B, di, n)
    float32."""
    m = cfg.mamba
    di = m.expand * cfg.d_model
    return {"conv": torch.zeros((batch, m.d_conv - 1, di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, di, m.d_state), dtype=torch.float32,
                               device=device)}


def apply_decode(params, x: torch.Tensor, cache: Dict, pos,
                 cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """One token, x (B, 1, d): the conv window is the cache plus the new
    ``u``, then one step of the recurrence."""
    del pos
    with _body(params, x, cfg) as b:
        p, x = b.params, b.x
        conv_c, ssm_c = b.cache_in(cache["conv"]), b.cache_in(cache["ssm"])
        dt = x.dtype
        u, z = _in_proj(p, x[:, 0], cfg, b)                    # (B, di)
        conv_in = torch.cat([conv_c.to(dt), u[:, None]], dim=1)
        conv = torch.einsum("bci,ci->bi", conv_in, p["conv_w"].to(dt))
        # contiguous: ``u @ x_proj`` then folds into one mm whether or not
        # x_proj requires grad (a transposed u would go through bmm where
        # it does not: other bits for a mesh's local weights)
        u = F.silu(conv + p["conv_b"].to(dt)).contiguous()
        a, bb, cc = _ssm_coeffs(p, u[:, None], cfg, b)         # L = 1
        h = a[:, 0] * ssm_c + bb[:, 0]
        y = torch.einsum("bin,bn->bi", h, cc[:, 0])
        y = (y + p["D"] * u.to(y.dtype)).to(dt)
        out = (y * F.silu(z)) @ p["out_proj"].to(dt)
        conv_c.copy_(conv_in[:, 1:])
        ssm_c.copy_(h)
        return b.out(out[:, None], ("batch", None, None)), cache


def apply_prefill(params, x: torch.Tensor, cfg: ArchConfig, *,
                  cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict]:
    """Forward plus the decode cache: the last ``d_conv - 1`` rows of the
    pre-conv ``u`` and the last chunk's state."""
    m = cfg.mamba
    keep = m.d_conv - 1
    if x.shape[1] < keep:
        raise ValueError(f"mamba: a prompt of {x.shape[1]} tokens is "
                         f"shorter than the conv cache's {keep} rows")
    with _body(params, x, cfg) as b:
        out, u_raw, h = _mix(b.params, b.x, cfg, b)
        B, di = x.shape[0], m.expand * cfg.d_model
        spec = cache_specs(cfg)
        cache = {"conv": b.cache_new(
                     u_raw[:, x.shape[1] - keep:].to(cache_dtype),
                     spec["conv"], (B, keep, di)),
                 "ssm": b.cache_new(h, spec["ssm"], (B, di, m.d_state))}
        return b.out(out, ("batch", None, None)), cache
