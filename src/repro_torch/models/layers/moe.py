"""Routed Mixture-of-Experts with shared experts (DeepSeek-style): the
reference's local path (``repro.models.layers.moe.apply_local``).

  router -> top-k -> position in expert (stable argsort rank) -> scatter
  tokens into (E, C + 1, d) -> batched expert SwiGLU -> gather + combine

The router's product and softmax are float32.  A (token, choice) ranked at
or past the capacity C (``capacity_for``) is dropped: it is written to the
pad slot C, which is sliced off before the experts run, and its weight in
the combine is 0.  Only the pad slot takes more than one write, so the
scatter needs no deterministic ``index_put_``.

The dispatch is dense in experts, as the reference's is: every expert runs
its C capacity slots on every call, so a decode step reads every expert's
weights, routed or not.

The sharded paths (the reference's ``_apply_sharded`` and ``_apply_ep2d``:
experts over the mesh) are ROADMAP queue 1, item 14f; ``apply`` raises
under an active ``ShardingCtx``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ArchConfig, MoEConfig
from repro_torch.models.layers.ffn import SwiGLU, swiglu_apply
from repro_torch.models.layers.leaves import Leaves, normal
from repro_torch.sharding.context import current_ctx

__all__ = ["MoE", "route", "capacity_for", "apply_local", "apply",
           "recorded_routes"]


class MoE(Leaves):
    """``router`` (d, E) float32, ``w_gate``, ``w_up`` (E, d, d_e) and
    ``w_down`` (E, d_e, d); with ``num_shared``, ``shared``: a SwiGLU of
    width d_e x num_shared."""

    def __init__(self, cfg: ArchConfig, *,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        m = cfg.moe
        d, de, E = cfg.d_model, m.d_expert, m.num_experts
        s, se = d ** -0.5, de ** -0.5
        self.router = normal((d, E), s, generator, torch.float32, device)
        self.w_gate = normal((E, d, de), s, generator, dtype, device)
        self.w_up = normal((E, d, de), s, generator, dtype, device)
        self.w_down = normal((E, de, d), se, generator, dtype, device)
        if m.num_shared:
            self.shared = SwiGLU(d, de * m.num_shared, generator=generator,
                                 dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, cfg: Optional[ArchConfig] = None):
        """(out, aux); ``cfg`` (default: the one built with) sets the
        routing's capacity factor."""
        return apply(self, x, self.cfg if cfg is None else cfg)


def _route(router_w, x2d: torch.Tensor, m: MoEConfig):
    """(top_vals (T, k) float32 renormalised, top_idx (T, k), aux): the
    Switch load-balancing loss E x sum(mean(gates) x mean(one_hot(top1)))."""
    logits = x2d.to(torch.float32) @ router_w.to(torch.float32)
    gates = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(gates, m.top_k, dim=-1)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True),
                                      min=1e-9)
    E = gates.shape[-1]
    me = gates.mean(dim=0)
    ce = F.one_hot(top_idx[:, 0], E).to(torch.float32).mean(dim=0)
    aux = E * torch.sum(me * ce)
    return top_vals, top_idx, aux


def _positions_in_expert(top_idx: torch.Tensor) -> torch.Tensor:
    """Rank of each (token, choice) within its expert, in token order: a
    stable argsort's rank, no (T, k, E) one-hot.  Each expert's segment of
    the sorted choices starts where ``searchsorted`` finds its first entry
    (the reference's ``cumsum`` of a ``bincount``: the same integers;
    ``torch.bincount`` would read its input's maximum back to the host on
    the card)."""
    flat = top_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    seg_start = torch.searchsorted(sorted_e, sorted_e)
    rank_sorted = torch.arange(flat.shape[0], device=flat.device) - seg_start
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    return rank.reshape(top_idx.shape)


def route(params, x2d: torch.Tensor, m: MoEConfig, capacity: int):
    """The routing of tokens ``x2d`` (T, d): (top_vals, top_idx, pos, keep,
    aux), ``keep`` false where a choice is dropped (pos >= capacity)."""
    top_vals, top_idx, aux = _route(params["router"], x2d, m)
    pos = _positions_in_expert(top_idx)
    return top_vals, top_idx, pos, pos < capacity, aux


def _expert_ffn(w_gate, w_up, w_down, xe: torch.Tensor) -> torch.Tensor:
    """xe: (E, C, d) -> (E, C, d); the SwiGLU of each expert, batched."""
    dt = xe.dtype
    h = F.silu(torch.bmm(xe, w_gate.to(dt))) * torch.bmm(xe, w_up.to(dt))
    return torch.bmm(h, w_down.to(dt))


def _dispatch_compute_combine(params, x2d: torch.Tensor, m: MoEConfig,
                              capacity: int):
    """The routed experts over tokens ``x2d`` (T, d): (out (T, d), aux)."""
    T, d = x2d.shape
    E, k = m.num_experts, m.top_k
    top_vals, top_idx, pos, keep, aux = route(params, x2d, m, capacity)
    e = top_idx.reshape(-1)
    slot = torch.where(keep, pos, capacity).reshape(-1)   # dropped -> pad
    xe = x2d.new_zeros((E, capacity + 1, d))
    tok = torch.arange(T, device=x2d.device)[:, None].expand(T, k) \
        .reshape(-1)
    xe[e, slot] = x2d[tok]
    ye = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"],
                     xe[:, :capacity])
    ye_pad = torch.cat([ye, ye.new_zeros((E, 1, d))], dim=1)
    picked = ye_pad[e, slot].reshape(T, k, d)
    w = (top_vals * keep.to(torch.float32)).to(x2d.dtype)
    return torch.einsum("tkd,tk->td", picked, w), aux


def capacity_for(m: MoEConfig, tokens_per_shard: int) -> int:
    """Slots per expert: T x k / E x capacity_factor, rounded up to a
    multiple of 8, at least 8 (the reference's rounding, which decides
    which tokens drop)."""
    c = int(tokens_per_shard * m.top_k / m.num_experts * m.capacity_factor)
    return max(8, -(-c // 8) * 8)


def apply_local(params, x: torch.Tensor, cfg: ArchConfig):
    """x: (B, S, d) -> (out (B, S, d), aux)."""
    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    cap = capacity_for(cfg.moe, x2d.shape[0])
    out, aux = _dispatch_compute_combine(params, x2d, cfg.moe, cap)
    out = out.reshape(B, S, d)
    if cfg.moe.num_shared:
        out = out + swiglu_apply(params["shared"], x)
    return out, aux


def apply(params, x: torch.Tensor, cfg: ArchConfig):
    """The local path; under an active ``ShardingCtx`` it raises (the
    sharded paths are not ported)."""
    ctx = current_ctx()
    if ctx is not None:
        raise NotImplementedError(
            f"moe.apply under an active ShardingCtx over {ctx.axis_sizes}: "
            f"the sharded MoE (experts over the mesh) is ROADMAP queue 1, "
            f"item 14f, not ported; run it with no sharding context")
    return apply_local(params, x, cfg)


@contextlib.contextmanager
def recorded_routes(model: nn.Module) -> Iterator[List[Dict]]:
    """Within the block, each call of a ``MoE`` layer of ``model`` appends
    the routing it used to the yielded list: ``layer`` (its name),
    ``top_idx``, ``pos``, ``keep``, ``capacity`` and ``margin``, the
    smallest gap between any token's k-th and (k+1)-th gate, where a near
    tie would flip a choice.  Recording repeats the router's work, so it
    stays off timed runs."""
    records: List[Dict] = []

    def hook(name):
        def pre(module, args):
            x = args[0]
            m = (args[1] if len(args) > 1 else module.cfg).moe
            x2d = x.reshape(-1, x.shape[-1])
            cap = capacity_for(m, x2d.shape[0])
            with torch.no_grad():
                _, top_idx, pos, keep, _ = route(module, x2d, m, cap)
                gates = torch.softmax(x2d.to(torch.float32)
                                      @ module.router.to(torch.float32), -1)
                top = torch.topk(gates, min(m.top_k + 1, m.num_experts),
                                 dim=-1).values
            margin = (float((top[:, m.top_k - 1] - top[:, m.top_k]).min())
                      if m.top_k < m.num_experts else float("inf"))
            records.append({"layer": name, "top_idx": top_idx, "pos": pos,
                            "keep": keep, "capacity": cap,
                            "margin": margin})
        return pre

    handles = [mod.register_forward_pre_hook(hook(name))
               for name, mod in model.named_modules()
               if isinstance(mod, MoE)]
    try:
        yield records
    finally:
        for h in handles:
            h.remove()
