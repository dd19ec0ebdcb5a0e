"""Placements of the LM's parameters, optimizer state, batches and caches
on a torch mesh (the reference's ``repro.sharding.partitioning``), and
the counterpart of its ``jax.device_put``: laying a tree out as DTensors.

The logical specs live beside each layer (``models/layers/*``,
``transformer.param_specs`` and ``cache_specs``); this module resolves
them against a ``ShardingCtx`` and the shapes (``ShardingCtx.placements``,
divisibility-aware), returning DTensor placements where the reference
returns ``NamedSharding``s.  Shapes come from a model built on the
``meta`` device: nothing is materialised.

  * ``shard_model``, ``shard_train_state``, ``shard_caches``,
    ``shard_batch``  lay out tensors that every rank holds whole, each rank
                     keeping its own shard (no communication), or, with
                     ``src_rank``, tensors that one rank holds, scattered
                     from it;
  * ``init_params``  builds a model too large for one card: each submodule
                     of ``transformer.Transformer`` is drawn on the source
                     rank from the generator, in ``init_params``' order,
                     its leaves scattered one by one and freed before the
                     next submodule is drawn, so the result equals
                     ``transformer.init_params`` from the same generator
                     and device, bit for bit, and no card ever holds more
                     than one submodule whole.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro_torch.config import ArchConfig
from repro_torch.models import lm, transformer
from repro_torch.optim import adam
from repro_torch.sharding.context import ShardingCtx

__all__ = ["BATCH_SPEC", "sharding_tree", "param_shapes", "param_shardings",
           "train_state_shardings", "batch_shardings",
           "cache_shardings", "replicated", "shard_tensor", "shard_model",
           "shard_train_state", "shard_caches", "shard_batch",
           "init_params", "init_train_state"]

BATCH_SPEC = ("batch", None)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def sharding_tree(ctx: ShardingCtx, spec_tree: Any, shape_tree: Any):
    """A tree of logical specs x a tree of shapes (or tensors) -> the same
    tree of placements."""
    if _is_spec(spec_tree):
        return ctx.placements(spec_tree, tuple(shape_tree))
    if isinstance(spec_tree, dict):
        return {k: sharding_tree(ctx, v, shape_tree[k])
                for k, v in spec_tree.items()}
    return [sharding_tree(ctx, s, t) for s, t in zip(spec_tree, shape_tree)]


def param_shapes(cfg: ArchConfig, dtype=torch.float32) -> Dict[str, tuple]:
    """{parameter name: shape} of ``cfg``'s model, built on ``meta``."""
    model = transformer.Transformer(cfg, dtype=dtype, device="meta")
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def param_shardings(ctx: ShardingCtx, cfg: ArchConfig,
                    dtype=torch.float32) -> Dict[str, tuple]:
    return sharding_tree(ctx, transformer.param_specs(cfg),
                         param_shapes(cfg, dtype))


def _opt_specs(ctx: ShardingCtx, pspecs: Dict[str, tuple],
              pshapes: Dict[str, tuple]) -> Dict[str, tuple]:
    """The moments share the parameters' specs, except under a profile
    with an ``opt`` rule (ZeRO-1): a moment then has its first dim that
    is not sharded and divides by the ``opt`` axes sharded over them."""
    opt_axes = tuple(a for a in ctx.rules.get("opt", ())
                     if a in ctx.axis_sizes)
    if not opt_axes:
        return dict(pspecs)
    n_opt = ctx.axes_size(opt_axes)

    def one(spec, shape):
        resolved = ctx.pspec(spec, shape)
        entries = list(resolved) + [None] * (len(shape) - len(resolved))
        for i, dim in enumerate(shape):
            if entries[i] is None and dim % n_opt == 0:
                new = list(spec)
                new[i] = "opt"
                return tuple(new)
        return tuple(spec)

    return {n: one(s, pshapes[n]) for n, s in pspecs.items()}


def train_state_shardings(ctx: ShardingCtx, cfg: ArchConfig,
                          dtype=torch.float32) -> lm.TrainState:
    """A ``TrainState`` of placements: the params', and AdamW's step
    (replicated), m and v (``_opt_specs``)."""
    pspecs = transformer.param_specs(cfg)
    pshapes = param_shapes(cfg, dtype)
    ospecs = _opt_specs(ctx, pspecs, pshapes)
    m = sharding_tree(ctx, ospecs, pshapes)
    return lm.TrainState(
        params=sharding_tree(ctx, pspecs, pshapes),
        opt=adam.AdamState(step=replicated(ctx), m=m, v=dict(m)))


def batch_shardings(ctx: ShardingCtx, batch_shapes: Dict[str, Any]
                    ) -> Dict[str, tuple]:
    return {k: ctx.placements(("batch",) + (None,) * (len(v) - 1),
                              tuple(v))
            for k, v in batch_shapes.items()}


def cache_shardings(ctx: ShardingCtx, cfg: ArchConfig, cache_shapes,
                    *, long_context: bool = False):
    return sharding_tree(ctx, transformer.cache_specs(
        cfg, long_context=long_context), cache_shapes)


def replicated(ctx: ShardingCtx) -> tuple:
    return (Replicate(),) * len(ctx.axis_sizes)


def shard_tensor(ctx: ShardingCtx, t: torch.Tensor, placements,
                 src_rank: Optional[int] = None) -> DTensor:
    """``t`` laid out by ``placements``: each rank keeps its shard of its
    own whole ``t`` (``src_rank`` None), or the shards are scattered from
    ``src_rank`` (the other ranks' ``t`` gives only shape and dtype)."""
    return distribute_tensor(t.detach(), ctx.torch_mesh, list(placements),
                             src_data_rank=src_rank)


def _swap_params(module: torch.nn.Module, values: Dict[str, DTensor]):
    for name, value in values.items():
        *path, leaf = name.split(".")
        owner = module.get_submodule(".".join(path)) if path else module
        owner._parameters[leaf] = torch.nn.Parameter(
            value, requires_grad=owner._parameters[leaf].requires_grad)


def shard_model(ctx: ShardingCtx, model: transformer.Transformer,
                src_rank: Optional[int] = None
                ) -> transformer.Transformer:
    """Lays out ``model``'s parameters by ``param_specs``, in place, leaf
    by leaf (each whole leaf is freed as its shard replaces it)."""
    specs = transformer.param_specs(model.cfg)
    for name, p in list(model.named_parameters()):
        pl = ctx.placements(specs[name], p.shape)
        _swap_params(model, {name: shard_tensor(ctx, p, pl, src_rank)})
    return model


def shard_train_state(ctx: ShardingCtx, state: lm.TrainState,
                      src_rank: Optional[int] = None) -> lm.TrainState:
    """A ``TrainState`` laid out by ``train_state_shardings``: the model in
    place, new m and v."""
    model = shard_model(ctx, state.params, src_rank)
    cfg = model.cfg
    pspecs = transformer.param_specs(cfg)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    ospecs = _opt_specs(ctx, pspecs, shapes)

    def lay(tree):
        return {n: shard_tensor(ctx, t, ctx.placements(ospecs[n], t.shape),
                                src_rank) for n, t in tree.items()}

    opt = state.opt
    return lm.TrainState(model, adam.AdamState(
        step=opt.step, m=lay(opt.m), v=lay(opt.v)))


def shard_caches(ctx: ShardingCtx, cfg: ArchConfig, caches: List[Dict],
                 *, long_context: bool = False,
                 src_rank: Optional[int] = None) -> List[Dict]:
    specs = transformer.cache_specs(cfg, long_context=long_context)
    return [{part: {n: shard_tensor(ctx, t, ctx.placements(
        spec[part][n], t.shape), src_rank) for n, t in leaves.items()}
        for part, leaves in c.items()} for c, spec in zip(caches, specs)]


def shard_batch(ctx: ShardingCtx, batch: Dict[str, torch.Tensor],
                src_rank: Optional[int] = None) -> Dict[str, DTensor]:
    pl = batch_shardings(ctx, {k: v.shape for k, v in batch.items()})
    return {k: shard_tensor(ctx, v, pl[k], src_rank)
            for k, v in batch.items()}


def init_params(ctx: ShardingCtx, generator: Optional[torch.Generator],
                cfg: ArchConfig, dtype=torch.float32, *, device,
                src_rank: int = 0) -> transformer.Transformer:
    """``transformer.init_params(generator, cfg, dtype, device)`` laid out
    on the mesh without any rank holding it whole (module doc).
    ``generator`` is used on ``src_rank`` only (None elsewhere)."""
    rank = ctx.torch_mesh.get_rank()
    is_src = rank == src_rank
    if is_src and generator is None:
        raise ValueError("partitioning.init_params: the source rank needs "
                         "the generator")
    specs = transformer.param_specs(cfg)
    kw = dict(dtype=dtype)

    def place(prefix: str, module: torch.nn.Module) -> torch.nn.Module:
        if not is_src:
            module = module.to_empty(device=device)
        for name, p in list(module.named_parameters()):
            pl = ctx.placements(specs[prefix + name], p.shape)
            _swap_params(module, {name: shard_tensor(ctx, p, pl,
                                                     src_rank)})
        return module

    return transformer.Transformer(
        cfg, generator=generator if is_src else None,
        device=device if is_src else "meta", place=place, **kw)


def init_train_state(ctx: ShardingCtx, generator, cfg: ArchConfig,
                     dtype=torch.float32, opt_dtype=torch.float32, *,
                     device, src_rank: int = 0) -> lm.TrainState:
    """``init_params`` and its zero AdamW state laid out by
    ``_opt_specs``."""
    model = init_params(ctx, generator, cfg, dtype, device=device,
                        src_rank=src_rank)
    pspecs = transformer.param_specs(cfg)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    ospecs = _opt_specs(ctx, pspecs, shapes)

    def zeros_on(device):
        return {n: DTensor.from_local(
            torch.zeros(_local_shape(ctx, shapes[n], ospecs[n]),
                        dtype=opt_dtype, device=device),
            ctx.torch_mesh, list(ctx.placements(ospecs[n], shapes[n])),
            run_check=False) for n in shapes}

    step = torch.zeros((), dtype=torch.int32, device=device)
    return lm.TrainState(model, adam.AdamState(
        step=step, m=zeros_on(device), v=zeros_on(device)))


def _local_shape(ctx: ShardingCtx, shape, spec) -> tuple:
    """The shape of one rank's shard of a tensor of ``shape`` laid out by
    ``spec`` (every split divides: ``pspec`` keeps only those)."""
    out = list(shape)
    for i, entry in enumerate(ctx.pspec(spec, shape)):
        if entry is not None:
            out[i] //= ctx.axes_size((entry,) if isinstance(entry, str)
                                     else entry)
    return tuple(out)
