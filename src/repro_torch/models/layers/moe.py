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

Under an active ``ShardingCtx`` on a torch mesh ``apply`` dispatches as
the reference does, and both routes write their collectives out, as the
reference's ``shard_map`` bodies do, on local shards with
``torch.distributed`` on the mesh's groups:
  * ``_apply_sharded``  tokens stay on their data shard, experts split over
                        ``model``; capacity counts one shard's tokens, so
                        drops differ from ``apply_local``'s; one
                        all-reduce over ``model`` combines the experts;
  * ``_apply_ep2d``     experts split over ``model`` x ``data``; each card
                        routes its slice of the tokens, one all-to-all
                        over the whole grid sends them to their experts'
                        owners and one brings the outputs back, in
                        float8 (e4m3, sent as its bytes) when the payload
                        is large; the outputs combine on their owner,
                        and where each card of a model row routed a
                        slice of the row's tokens, one all-gather over
                        ``model`` joins the slices, as the reference's
                        ``out_specs`` do.
The aux loss is averaged over ``model`` and the data axes.  Gradients
flow through both: each collective (``sharding.collectives``, the
all-to-all here) has its transpose as its backward.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.config import ArchConfig, MoEConfig
from repro_torch.models.layers.ffn import SwiGLU, swiglu_apply
from repro_torch.models.layers.leaves import Leaves, normal
from repro_torch.sharding.collectives import all_gather, all_reduce, \
    scale_grad
from repro_torch.sharding.context import current_ctx, local_body, local_view

__all__ = ["MoE", "route", "capacity_for", "apply_local", "apply",
           "recorded_routes", "specs", "to_e4m3"]

# the ep2d dispatch goes in float8 from this many tokens a card
F8_TOKENS = 1024


def specs(cfg: ArchConfig) -> Dict:
    s = {"router": (None, None), "w_gate": ("experts", "fsdp", None),
         "w_up": ("experts", "fsdp", None),
         "w_down": ("experts", None, "fsdp")}
    if cfg.moe.num_shared:
        s["shared"] = {"w_gate": ("fsdp", "ffn"), "w_up": ("fsdp", "ffn"),
                       "w_down": ("ffn", "fsdp")}
    return s


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
    """(top_vals (T, k) float32 renormalised, top_idx (T, k), aux, gates):
    aux is the Switch load-balancing loss E x sum(mean(gates) x
    mean(one_hot(top1)))."""
    logits = x2d.to(torch.float32) @ router_w.to(torch.float32)
    gates = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(gates, m.top_k, dim=-1)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True),
                                      min=1e-9)
    E = gates.shape[-1]
    me = gates.mean(dim=0)
    ce = F.one_hot(top_idx[:, 0], E).to(torch.float32).mean(dim=0)
    aux = E * torch.sum(me * ce)
    return top_vals, top_idx, aux, gates


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
    top_vals, top_idx, aux, gates = _route(params["router"], x2d, m)
    pos = _positions_in_expert(top_idx)
    _record(top_idx, pos, pos < capacity, capacity, gates, m)
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
    """``apply_local`` with no context; under one, ``_apply_ep2d`` when the
    experts take both ``data`` and ``model`` and the counts divide, else
    ``_apply_sharded`` (a mesh without ``model`` runs ``apply_local`` on
    the whole batch, as GSPMD runs the reference's)."""
    ctx = current_ctx()
    if ctx is None:
        return apply_local(params, x, cfg)
    sizes = ctx.axis_sizes
    if not isinstance(x, DTensor):
        raise TypeError(f"moe.apply got a plain {type(x).__name__} under a "
                        f"ShardingCtx over {sizes}: under a mesh the "
                        f"activations are DTensors")
    if "model" not in sizes:
        with local_body(params, x, keep_batch=False,
                        split_model=False) as b:
            out, aux = apply_local(b.params, b.x, cfg)
            return b.out(out, ("batch", None, None)), aux
    exp_axes = ctx.axes_for("experts")
    n_batch = sizes.get("pod", 1) * sizes.get("data", 1)
    if ("data" in exp_axes and "model" in exp_axes
            and cfg.moe.num_experts % (sizes["model"] * sizes["data"]) == 0
            and x.shape[0] % n_batch == 0):
        return _apply_ep2d(params, x, cfg, ctx)
    return _apply_sharded(params, x, cfg, ctx)


def _local(t: DTensor, keep: Dict[str, object], varies) -> torch.Tensor:
    """``t``'s local tensor laid out per mesh axis by ``keep`` (default
    Replicate), its cotangent summed over the axes in ``varies``."""
    names = t.device_mesh.mesh_dim_names
    return local_view(t, [keep.get(n, Replicate()) for n in names],
                      [n in varies for n in names])


def _combine(out_l, aux_l, x: DTensor, x_keep, reduce_axes, aux_axes):
    """The local output (a partial sum over ``reduce_axes``) and aux
    loss as DTensors: out summed, aux averaged over ``aux_axes``."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    n = 1
    for a in reduce_axes:
        out_l = all_reduce(out_l, mesh.get_group(a))
    for a in aux_axes:
        aux_l = all_reduce(aux_l, mesh.get_group(a))
        n *= mesh.size(names.index(a))
    out = DTensor.from_local(out_l, mesh, [x_keep.get(a, Replicate())
                                           for a in names], run_check=False)
    aux = DTensor.from_local(aux_l, mesh, [Replicate()] * len(names),
                             run_check=False)
    return out, aux / n


def _experts_local(params, keep, varies):
    return {k: _local(params[k], keep, varies)
            for k in ("w_gate", "w_up", "w_down")}


def _apply_sharded(params, x: DTensor, cfg: ArchConfig, ctx):
    """Tokens stay on their data shard (replicated when the batch does not
    divide the data axes), experts split over ``model``; capacity from
    one shard's tokens; one all-reduce over ``model`` (module doc)."""
    m = cfg.moe
    mesh = x.device_mesh
    sizes = ctx.axis_sizes
    n_model = sizes["model"]
    if m.num_experts % n_model:
        raise ValueError(f"moe: {m.num_experts} experts do not divide the "
                         f"model axis of {n_model}")
    B, S, d = x.shape
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    n_data = 1
    for a in data_axes:
        n_data *= sizes[a]
    if B % n_data:
        data_axes, n_data = (), 1
    cap = capacity_for(m, (B * S) // n_data)
    varies = data_axes + ("model",)
    x_keep = {a: Shard(0) for a in data_axes}
    x_l = _local(x, x_keep, varies)
    router = _local(params["router"], {}, varies)
    w = _experts_local(params, {"model": Shard(0)}, varies)
    E_local = m.num_experts // n_model
    lo = mesh.get_local_rank("model") * E_local

    x2d = x_l.reshape(-1, d)
    top_vals, top_idx, aux, gates = _route(router, x2d, m)
    pos = _positions_in_expert(top_idx)
    _record(top_idx, pos, pos < cap, cap, gates, m)
    keep = (pos < cap) & (top_idx >= lo) & (top_idx < lo + E_local)
    e = torch.clamp(top_idx - lo, 0, E_local - 1).reshape(-1)
    slot = torch.where(keep, pos, cap).reshape(-1)
    T, k = top_idx.shape
    xe = x2d.new_zeros((E_local, cap + 1, d))
    tok = torch.arange(T, device=x2d.device)[:, None].expand(T, k) \
        .reshape(-1)
    xe = xe.index_put((e, slot), x2d[tok])
    ye = _expert_ffn(w["w_gate"], w["w_up"], w["w_down"], xe[:, :cap])
    ye_pad = torch.cat([ye, ye.new_zeros((E_local, 1, d))], dim=1)
    picked = ye_pad[e, slot].reshape(T, k, d)
    wts = (top_vals * keep.to(torch.float32)).to(x2d.dtype)
    out_l = torch.einsum("tkd,tk->td", picked, wts).reshape(x_l.shape)
    out, aux = _combine(out_l, aux, x, x_keep, ("model",),
                        ("model",) + data_axes)
    if m.num_shared:
        out = out + swiglu_apply(params["shared"], x)
    return out, aux


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float8 e4m3fn as ``ml_dtypes`` (and so the reference)
    rounds it: to nearest even, and NaN (its sign kept) for what
    overflows, for infinities and for NaN, where torch's own cast
    saturates."""
    y = x.to(torch.float8_e4m3fn).view(torch.uint8)
    nan = torch.where(torch.signbit(x), 0xFF, 0x7F).to(torch.uint8)
    return torch.where(x.abs() <= 464, y, nan).view(torch.float8_e4m3fn)


def _exchange(t: torch.Tensor, group, f8: bool) -> torch.Tensor:
    """One all-to-all of ``t`` (its dim 0 indexed by the group's ranks)
    over ``group``, in float8 when ``f8`` (sent as its bytes: not every
    backend carries float8); back in ``t``'s dtype."""
    send = (to_e4m3(t).view(torch.uint8) if f8 else t).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if f8:
        recv = recv.view(torch.float8_e4m3fn)
    return recv.to(t.dtype)


class _AllToAll(torch.autograd.Function):
    """``_exchange`` with its transpose as the backward (the cotangent
    goes back the same way, in the same dtype), as JAX transposes the
    reference's ``all_to_all``."""

    @staticmethod
    def forward(ctx, t, group, f8):
        ctx.group, ctx.f8 = group, f8
        return _exchange(t, group, f8)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.f8), None, None


def _apply_ep2d(params, x: DTensor, cfg: ArchConfig, ctx):
    """Experts split over ``model`` x ``data`` (module doc).  Card (data
    d, model j) owns the experts of flat index d x Nm + j, DTensor's
    order on the mesh: the reference's model-major order moves experts
    between cards but no result."""
    m = cfg.moe
    mesh = x.device_mesh
    sizes = ctx.axis_sizes
    Nm, Nd = sizes["model"], sizes["data"]
    E, k = m.num_experts, m.top_k
    eb = E // (Nm * Nd)
    B, S, d = x.shape
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    n_data = 1
    for a in data_axes:
        n_data *= sizes[a]
    batch_model = ("model" in ctx.axes_for("batch")
                   and B % (n_data * Nm) == 0)
    T_l = (B // n_data) * S
    sp_mode = (not batch_model and ctx.axes_for("act_seq") == ("model",)
               and S % Nm == 0)
    seq_split = (not sp_mode and not batch_model and T_l % Nm == 0
                 and (T_l // Nm) * k >= Nm * Nd)
    T_sp = T_l // Nm if (seq_split or sp_mode or batch_model) else T_l
    cap = capacity_for(m, T_sp)
    f8 = T_sp >= F8_TOKENS

    if batch_model:
        x_keep = {a: Shard(0) for a in data_axes + ("model",)}
    else:
        x_keep = {a: Shard(0) for a in data_axes}
        if sp_mode:
            x_keep["model"] = Shard(1)
    # the tokens a card routes differ along every axis but pod-free
    # replicas: the data axes, and model (each card its slice)
    varies = data_axes + ("model",)
    x_l = _local(x, x_keep, varies)
    router = _local(params["router"], {}, varies)
    w = _experts_local(params, {"data": Shard(0), "model": Shard(0)},
                       varies)

    Bl, Sl, _ = x_l.shape
    x2d = x_l.reshape(-1, d)
    mj = mesh.get_local_rank("model")
    x_my = x2d[mj * T_sp:(mj + 1) * T_sp] if seq_split else x2d
    T = x_my.shape[0]
    top_vals, top_idx, aux, gates = _route(router, x_my, m)
    pos = _positions_in_expert(top_idx)
    keep = pos < cap
    _record(top_idx, pos, keep, cap, gates, m)
    owner = (top_idx // eb).reshape(-1)
    sub = (top_idx % eb).reshape(-1)
    slot = torch.where(keep, pos, cap).reshape(-1)
    tok = torch.arange(T, device=x2d.device)[:, None].expand(T, k) \
        .reshape(-1)
    send = x2d.new_zeros((Nm * Nd, eb, cap + 1, d))
    send = send.index_put((owner, sub, slot), x_my[tok])[:, :, :cap]
    group = _grid_group(mesh)
    recv = _AllToAll.apply(send, group, f8)
    xe = recv.transpose(0, 1).reshape(eb, Nm * Nd * cap, d)
    ye = _expert_ffn(w["w_gate"], w["w_up"], w["w_down"], xe)
    back = ye.reshape(eb, Nm * Nd, cap, d).transpose(0, 1)
    ret = _AllToAll.apply(back, group, f8)
    ret_pad = torch.cat([ret, ret.new_zeros((Nm * Nd, eb, 1, d))], dim=2)
    picked = ret_pad[owner, sub, slot].reshape(T, k, d)
    wts = (top_vals * keep.to(torch.float32)).to(x2d.dtype)
    out_my = torch.einsum("tkd,tk->td", picked, wts)
    if seq_split:
        # each card routed its slice of the model row's tokens: join them
        out_l = all_gather(out_my, mesh.get_group("model"), 0, False)
    elif batch_model or sp_mode:
        out_l = out_my                      # each card its own tokens
    else:
        # every model row routed the same tokens: the outputs agree, and
        # each row's cotangent carries 1/Nm of the tokens' gradient
        out_l = scale_grad(out_my, 1.0 / Nm)
    out, aux = _combine(out_l.reshape(Bl, Sl, d), aux, x, x_keep, (),
                        ("model",) + data_axes)
    if m.num_shared:
        out = out + swiglu_apply(params["shared"], x)
    return out, aux


def _grid_group(mesh):
    """The process group over the (data, model) grid of this card's pod,
    its ranks in DTensor's order of the grid."""
    names = mesh.mesh_dim_names
    if "pod" not in names:
        return mesh._flatten().get_group() if mesh.ndim > 1 \
            else mesh.get_group()
    return mesh[("data", "model")]._flatten().get_group()


_recording = threading.local()


def _record(top_idx, pos, keep, capacity: int, gates, m: MoEConfig):
    """Note a routing in the active ``recorded_routes`` block, if any."""
    records = getattr(_recording, "records", None)
    if records is None:
        return
    with torch.no_grad():
        if m.top_k < m.num_experts:
            top = torch.topk(gates, m.top_k + 1, dim=-1).values
            margin = float((top[:, m.top_k - 1] - top[:, m.top_k]).min())
        else:
            margin = float("inf")
    records.append({"layer": getattr(_recording, "layer", None),
                    "top_idx": top_idx.detach(),
                    "pos": pos.detach(), "keep": keep.detach(),
                    "capacity": capacity, "margin": margin})


@contextlib.contextmanager
def recorded_routes(model: nn.Module) -> Iterator[List[Dict]]:
    """Within the block, each routing a ``MoE`` layer of ``model`` makes
    is appended to the yielded list: ``layer`` (its name), ``top_idx``,
    ``pos``, ``keep``, ``capacity`` and ``margin``, the smallest gap
    between any token's k-th and (k+1)-th gate, where a near tie would
    flip a choice.  Under a mesh each rank records the routing of the
    tokens it routes (its shard), with that route's capacity.  A forward
    recomputed in a backward records again.  Recording reads the margin
    back to the host, so it stays off timed runs."""
    records: List[Dict] = []

    def hook(name):
        def pre(module, args):
            _recording.layer = name
        return pre

    handles = [mod.register_forward_pre_hook(hook(name))
               for name, mod in model.named_modules()
               if isinstance(mod, MoE)]
    prev = getattr(_recording, "records", None)
    _recording.records = records
    try:
        yield records
    finally:
        _recording.records = prev
        for h in handles:
            h.remove()
