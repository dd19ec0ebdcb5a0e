"""Collectives on local shards, each with its transpose as its backward:
what GSPMD inserts (and transposes) around the reference's sharded
layers, written out for the layers' bodies (``context.local_view``,
``Body.out``) and the sharded MoE.  Each is a ``torch.autograd.Function``
over one ``torch.distributed`` process group (a mesh axis's group),
hands the collective contiguous tensors (NCCL refuses others; gloo takes
them) and returns its input itself on a group of one.

  * ``all_gather(t, group, dim, partial_grad)``: the group's shards of
    ``t`` joined along ``dim`` in group-rank order; backward a
    reduce-scatter when each rank's cotangent is a partial sum
    (``partial_grad``: the computation differs along the group), else
    this rank's own slice of it;
  * ``all_reduce(t, group)``: the sum over the group; backward the
    identity (the cotangent of a replicated sum is whole on every rank);
  * ``all_max(t, group)``: the elementwise maximum over the group, no
    gradient (a softmax's shift);
  * ``exchange(t, group, send, recv)``: an all-to-all along dim 0,
    ``send[k]`` rows to group rank k and ``recv[k]`` rows from it, in
    group-rank order; backward the same exchange the other way;
  * ``reduce_grad(t, group)``: the identity; backward the sum over the
    group (Megatron's f: a replicated input of a computation that differs
    along the group);
  * ``scale_grad(t, s)``: the identity; backward times ``s``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather", "all_reduce", "all_max", "exchange",
           "reduce_grad", "scale_grad"]

# torch 2.13 renames both; the arguments are the same
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


def _gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + src.shape[1:])
    _all_gather(out, src, group=group)
    return out.movedim(0, dim) if dim else out


def _scatter(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = g.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
    _reduce_scatter(out, src, group=group)
    return out.movedim(0, dim) if dim else out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim, partial_grad):
        ctx.group, ctx.dim, ctx.partial = group, dim, partial_grad
        ctx.size = t.shape[dim]
        return _gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return _scatter(g, ctx.group, ctx.dim), None, None, None
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.size, ctx.size), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _exchange(t: torch.Tensor, group, send, recv) -> torch.Tensor:
    out = t.new_empty((sum(recv),) + t.shape[1:])
    dist.all_to_all_single(out, t.contiguous(), list(recv), list(send),
                           group=group)
    return out


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, send, recv):
        ctx.group, ctx.send, ctx.recv = group, send, recv
        return _exchange(t, group, send, recv)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.recv, ctx.send), None, None, None


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, s):
        ctx.s = s
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _single(group) -> bool:
    return dist.get_world_size(group) == 1


def all_gather(t: torch.Tensor, group, dim: int,
               partial_grad: bool) -> torch.Tensor:
    return t if _single(group) else _AllGather.apply(t, group, dim,
                                                     partial_grad)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    return t if _single(group) else _AllReduce.apply(t, group)


def all_max(t: torch.Tensor, group) -> torch.Tensor:
    if _single(group):
        return t
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def exchange(t: torch.Tensor, group, send, recv) -> torch.Tensor:
    return t if _single(group) else _Exchange.apply(t, group, tuple(send),
                                                    tuple(recv))


def reduce_grad(t: torch.Tensor, group) -> torch.Tensor:
    return t if _single(group) else _ReduceGrad.apply(t, group)


def scale_grad(t: torch.Tensor, s: float) -> torch.Tensor:
    return t if s == 1 else _ScaleGrad.apply(t, s)
