"""Sharding context: logical-axis rules resolved against a mesh (the
reference's ``repro.sharding.context``, without JAX).

Rules map logical axis names (``batch``, ``heads``, ...) onto mesh axes,
with divisibility checks, so one set of annotations serves every mesh.
``ShardingCtx`` reads the axis sizes from a torch
``torch.distributed.device_mesh.DeviceMesh`` (one process per entry, its
``mesh_dim_names``), from a ``dist.DeviceMesh`` or from a mesh
description (a tuple of ``(name, size)`` pairs, or any form
``dist.normalize_mesh`` takes); ``pspec`` returns the per-dimension
entries the reference's ``PartitionSpec`` holds, as a plain tuple, and on
a torch mesh ``placements`` turns them into DTensor placements (the
counterpart of the reference's ``NamedSharding``).  A dimension split
over several mesh axes is split in the mesh's order (DTensor's
convention): the reference's ``("model", "data")`` entry of the
``ep2d`` experts is model-major there and data-major here, which moves
experts between cards but changes no result.  ``use_sharding`` and
``current_ctx`` thread a context to code below without plumbing it
through every signature (thread-local, as in the reference).

``shard_logical`` is what the LM layers call on their activations.  With
no active context it returns its input.  Under one, a DTensor is
redistributed to the resolved placements (what ``with_sharding_constraint``
does in the reference), and a plain tensor raises, naming the call site:
there it would be an activation that silently skips the sharding.

The layers' bodies run on local shards (``local_body``): the activation
keeps its batch shards, and a weight keeps its split over ``model``
where its placement has one; every other split (FSDP's, over ``data``)
is gathered (an all-gather whose backward is a reduce-scatter).  A body
with at least one weight split over ``model`` is split there: Megatron's
column/row split, its output a partial sum that one all-reduce over
``model`` completes (after ``wo``, ``w_down``, ``out_proj`` and the
vocab-parallel head).  Its other weights, those the reference's specs
leave whole over ``model`` (K/V whose heads do not divide it, MLA's
down-projections and norms, RWKV's mixes and decay LoRA), are whole on
every card, their gradients summed over ``model``.  A partial sum needed
inside the body (Mamba's ``x_proj`` output, RWKV's sum of squares in
``out_norm``) goes through ``Body.all_reduce``.  These collectives are
written out on the mesh axes' process groups (``local_view``,
``sharding.collectives``), each with its transpose as its backward;
DTensor stays at the body's edges (``to_local`` in, ``from_local`` out,
neither of which communicates), so the activations between layers, the
parameters and the optimizer's state are DTensors.  ``mesh_ops`` lets
DTensors and plain tensors (positions, masks, constants) meet in one op
outside the bodies (the residual adds, the loss), the plain ones read as
replicated.

Inside a body ``shard_logical`` checks the reference's constraint
instead of applying it: the body declares the global sizes of the
logical axes it carries (``axes``), and a local tensor must be split
over ``model`` on exactly the dims ``pspec(logical, global dims)``
splits there, or it raises, naming the call site.  A body that runs
whole where the reference splits cannot pass.

A decode cache is used where it lives (``Body.cache_in``): its batch
shards are the activation's, its heads or channels the body's, and a
sequence split (``cache_seq``) is attended shard by shard with a
softmax whose statistics are all-reduced (``models/layers/attention``,
``mla``).
"""
from __future__ import annotations

import contextlib
import sys
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh as TorchMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.dist.mesh import DeviceMesh, normalize_mesh
from repro_torch.sharding.collectives import all_gather, all_reduce, \
    reduce_grad

__all__ = ["DEFAULT_RULES", "RULE_PROFILES", "make_rules", "ShardingCtx",
           "current_ctx", "use_sharding", "shard_logical", "lay_out",
           "mesh_ops", "local_body", "Body",
           "redistribute", "local_view"]

_state = threading.local()

Entry = Union[None, str, Tuple[str, ...]]

# logical axis -> tuple of mesh axes (in sharding priority order)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "experts": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "vocab": ("model",),
    "fsdp": ("data",),          # FSDP / ZeRO-3 dimension for big-model training
    "seq_data": ("data",),      # sequence sharding (long-context decode cache)
    "seq_model": ("model",),    # sequence parallelism variant
    "cache_seq": (),            # decode-cache seq axis, set per cell
    "act_seq": (),              # layer-boundary activation seq sharding (SP)
}

# Named parallelism profiles: each is a rules override; re-mapping the
# logical axes re-plans the whole collective schedule.
RULE_PROFILES: Dict[str, Dict[str, Tuple[str, ...]]] = {
    # Megatron-style TP(model) x DP(data) + FSDP over data: the baseline.
    "tp_fsdp": dict(DEFAULT_RULES),
    # pure data parallelism over every mesh axis, replicated weights,
    # ZeRO-1 sharded optimizer states
    "dp_zero1": {
        "batch": ("pod", "data", "model"),
        "experts": (), "heads": (), "kv_heads": (), "ffn": (), "vocab": (),
        "fsdp": (),
        "opt": ("data", "model"),        # optimizer-state-only sharding
        "seq_data": ("data",), "seq_model": ("model",),
    },
    # 2D expert parallelism: experts sharded over (model x data)
    "ep2d": {
        "batch": ("pod", "data"),
        "experts": ("model", "data"),
        "heads": ("model",), "kv_heads": ("model",), "ffn": ("model",),
        "vocab": ("model",),
        "fsdp": (),
        "opt": ("data",),
        "seq_data": ("data",), "seq_model": ("model",),
    },
    # EP + ZeRO-DP, no tensor parallelism: batch over every mesh axis,
    # dense weights ZeRO-3 sharded over (data x model)
    "ep2d_zero": {
        "batch": ("pod", "data", "model"),
        "experts": ("model", "data"),
        "heads": (), "kv_heads": (), "ffn": (),
        "vocab": (),
        "fsdp": ("data", "model"),
        "opt": ("pod",),
        "seq_data": ("data",), "seq_model": ("model",),
    },
    # sequence parallelism + 2D EP + ZeRO-3
    "sp_ep2d": {
        "batch": ("pod", "data"),
        "experts": ("model", "data"),
        "heads": (), "kv_heads": (), "ffn": (),
        "vocab": ("model",),
        "fsdp": ("data", "model"),
        "opt": ("data",),
        "act_seq": ("model",),
        "seq_data": ("data",), "seq_model": ("model",),
    },
    # serving: weights model-sharded and replicated across data
    "serve": {
        "batch": ("pod", "data"),
        "experts": ("model",),
        "heads": ("model",), "kv_heads": ("model",), "ffn": ("model",),
        "vocab": ("model",),
        "fsdp": (),
        "seq_data": ("data",), "seq_model": ("model",),
    },
    # serving with 2D-EP MoE
    "serve_ep2d": {
        "batch": ("pod", "data"),
        "experts": ("model", "data"),
        "heads": ("model",), "kv_heads": ("model",), "ffn": ("model",),
        "vocab": ("model",),
        "fsdp": (),
        "seq_data": ("data",), "seq_model": ("model",),
    },
}


def make_rules(profile: str) -> Dict[str, Tuple[str, ...]]:
    return dict(RULE_PROFILES[profile])


class ShardingCtx:
    """Logical rules over one mesh's axis sizes."""

    def __init__(self, mesh, rules: Optional[Dict[str, Tuple[str, ...]]]
                 = None):
        self.mesh = mesh
        if isinstance(mesh, TorchMesh):
            axes = tuple(zip(mesh.mesh_dim_names, mesh.shape))
        elif isinstance(mesh, DeviceMesh):
            axes = mesh.axes
        else:
            axes = normalize_mesh(mesh)
        if axes is None:
            raise ValueError("ShardingCtx needs a mesh, got None")
        self.axis_sizes: Dict[str, int] = dict(axes)
        self.rules = dict(DEFAULT_RULES if rules is None else rules)

    def axes_for(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        axes = self.rules.get(logical, ())
        return tuple(a for a in axes if a in self.axis_sizes)

    def axes_size(self, axes: Sequence[str]) -> int:
        """The product of the sizes of mesh ``axes`` (1 for none)."""
        n = 1
        for a in axes:
            n *= self.axis_sizes[a]
        return n

    def pspec(self, logical: Sequence[Optional[str]],
              dims: Optional[Sequence[int]] = None) -> Tuple[Entry, ...]:
        """Resolve logical names to per-dimension entries (a mesh axis name,
        a tuple of them, or None), dropping axes whose product does not
        divide the corresponding dim.  A mesh axis may be claimed by at most
        one dim (left-to-right priority): later dims lose contested axes.
        Trailing Nones are dropped, as ``PartitionSpec`` does."""
        entries = []
        used: set = set()
        for i, name in enumerate(logical):
            axes = tuple(a for a in self.axes_for(name) if a not in used)
            if not axes:
                entries.append(None)
                continue
            if dims is not None:
                while axes and dims[i] % self.axes_size(axes) != 0:
                    axes = axes[:-1]
                if not axes:
                    entries.append(None)
                    continue
            used.update(axes)
            entries.append(axes[0] if len(axes) == 1 else tuple(axes))
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    @property
    def torch_mesh(self) -> TorchMesh:
        if not isinstance(self.mesh, TorchMesh):
            raise TypeError(f"this ShardingCtx holds a {type(self.mesh)}, "
                            f"not a torch DeviceMesh: it has no placements")
        return self.mesh

    def placements(self, logical: Sequence[Optional[str]],
                   dims: Optional[Sequence[int]] = None) -> tuple:
        """The DTensor placements of ``pspec(logical, dims)``, one per
        mesh axis (the counterpart of the reference's ``sharding``)."""
        names = list(self.axis_sizes)
        out = [Replicate()] * len(names)
        for i, entry in enumerate(self.pspec(logical, dims)):
            for a in (entry,) if isinstance(entry, str) else entry or ():
                out[names.index(a)] = Shard(i)
        return tuple(out)


def current_ctx() -> Optional[ShardingCtx]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_sharding(ctx: Optional[ShardingCtx]):
    prev = getattr(_state, "ctx", None)
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


def _call_site() -> str:
    """file:line of the first caller outside this module and contextlib."""
    f = sys._getframe(1)
    while f.f_back is not None and f.f_code.co_filename in (
            __file__, contextlib.__file__):
        f = f.f_back
    return f"{f.f_code.co_filename}:{f.f_lineno}"


def redistribute(t: DTensor, placements) -> DTensor:
    """``t`` laid out by ``placements``: ``t`` itself when it already is.
    Under ``torch.inference_mode`` the redistribution runs outside it,
    without autograd (torch 2.11's ``redistribute`` fails inside it, on
    ``aten.detach_``)."""
    if tuple(t.placements) == tuple(placements):
        return t
    if torch.is_inference_mode_enabled():
        with torch.inference_mode(False), torch.no_grad():
            return t.redistribute(t.device_mesh, tuple(placements))
    return t.redistribute(t.device_mesh, tuple(placements))


def local_view(t: DTensor, keep: Sequence, varies: Sequence[bool]):
    """``t``'s local tensor laid out by ``keep`` (one placement a mesh
    dim: ``t``'s own, or ``Replicate`` where ``t`` is split: gathered),
    differentiable: its cotangent comes back in ``t``'s layout, summed
    over the mesh dims along which the computation ``varies``.  The
    collectives are ``sharding.collectives``' on the mesh dims' groups,
    innermost dim first (a tensor dim split over several mesh dims is
    split in the mesh's order); a move they do not cover (a split kept
    inside one that is gathered, a partial or a new split) goes through
    DTensor's ``redistribute``."""
    mesh, src = t.device_mesh, tuple(t.placements)
    moves = []
    for i, (p, k) in enumerate(zip(src, keep)):
        if p == k:
            continue
        if not (isinstance(p, Shard) and isinstance(k, Replicate)) or any(
                keep[j] == p for j in range(i + 1, mesh.ndim)):
            grad = [k if isinstance(k, Shard) else Partial() if v
                    else Replicate() for k, v in zip(keep, varies)]
            return redistribute(t, keep).to_local(grad_placements=grad)
        moves.append(i)
    x = t.to_local()
    for i in reversed(range(mesh.ndim)):
        if i in moves:
            x = all_gather(x, mesh.get_group(i), src[i].dim, varies[i])
        elif varies[i] and isinstance(src[i], Replicate):
            x = reduce_grad(x, mesh.get_group(i))
    return x


def shard_logical(x, logical: Sequence[Optional[str]]):
    """``x`` itself with no active context; under one, a DTensor
    redistributed to ``placements(logical, x.shape)``; inside a
    ``local_body``, a plain tensor checked against the reference's split
    (``Body.check``) and returned as it is; any other plain tensor raises
    ``TypeError`` naming the call site."""
    ctx = current_ctx()
    if ctx is None:
        return x
    if isinstance(x, DTensor):
        return redistribute(x, ctx.placements(logical, x.shape))
    stack = getattr(_state, "bodies", None)
    if stack:
        if stack[-1].ctx is not None:
            stack[-1].check(x, logical)
        return x
    raise TypeError(
        f"shard_logical{tuple(logical)} at {_call_site()}: a plain "
        f"{type(x).__name__} under a ShardingCtx over {ctx.axis_sizes}; "
        f"under a mesh the activations are DTensors (lay the inputs out "
        f"with sharding.partitioning)")


def lay_out(x: torch.Tensor, logical: Sequence[Optional[str]]):
    """A plain tensor that every rank holds whole, as a DTensor laid out
    by ``logical`` under the active context (each rank keeps its own
    shard: no communication); a DTensor, or no context, passes through."""
    ctx = current_ctx()
    if ctx is None or isinstance(x, DTensor):
        return x
    return distribute_tensor(x, ctx.torch_mesh,
                             ctx.placements(logical, x.shape),
                             src_data_rank=None)


_mesh_ops_lock = threading.Lock()
_mesh_ops_open = []     # the outermost entered implicit_replication


@contextlib.contextmanager
def mesh_ops():
    """A context in which ops may mix DTensors with plain tensors (read as
    replicated) under an active torch mesh; nothing otherwise.  DTensor's
    flag for it is process-wide (the backward's recomputed forwards run
    in autograd's own threads), so the contexts nest across threads and
    only the outermost one clears it."""
    ctx = current_ctx()
    if ctx is None or not isinstance(ctx.mesh, TorchMesh):
        yield
        return
    with _mesh_ops_lock:
        if not _mesh_ops_open:
            cm = implicit_replication()
            cm.__enter__()
            _mesh_ops_open.append(cm)
        _mesh_ops_open.append(None)
    try:
        yield
    finally:
        with _mesh_ops_lock:
            _mesh_ops_open.pop()
            if len(_mesh_ops_open) == 1:
                _mesh_ops_open.pop().__exit__(None, None, None)


def _tree(params, fn):
    """``fn`` over the leaves of a layer's parameters (a ``Leaves``
    module, or a dict of tensors and nested groups): a nested dict."""
    if isinstance(params, nn.Module):
        items = list(params._parameters.items()) \
            + list(params._modules.items())
    else:
        items = list(params.items())
    return {k: _tree(v, fn) if isinstance(v, (nn.Module, Mapping))
            else fn(v) for k, v in items if v is not None}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _entry_axes(entry: Entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


class Body:
    """A layer body's local view: ``params`` (a nested dict of local
    tensors) and ``x``, the activation's local shard.  With no context
    both are what was given and ``out`` returns its argument.  ``axes``:
    the global sizes of the logical axes the body's tensors carry
    (``heads``, ``ffn``, ...), for ``check``."""

    def __init__(self, params, x, ctx: Optional[ShardingCtx] = None, *,
                 split_model: bool = True, keep_batch: bool = True,
                 keep_tokens: bool = False,
                 axes: Optional[Mapping[str, int]] = None):
        self.ctx, self.axes = ctx, dict(axes or {})
        self.mdim, self.model_size, self.model_rank = None, 1, 0
        if ctx is None:
            self.params, self.x, self.model_parallel = params, x, False
            return
        if not isinstance(x, DTensor):
            raise TypeError(
                f"a layer body at {_call_site()} got a plain "
                f"{type(x).__name__} under a ShardingCtx over "
                f"{ctx.axis_sizes}: under a mesh the activations are "
                f"DTensors")
        mesh = self.mesh = x.device_mesh
        names = mesh.mesh_dim_names
        self.mdim = names.index("model") if "model" in names else None
        # the activation keeps its batch shards (with ``keep_tokens``,
        # every shard but the features'); all else is gathered
        last = x.ndim - 1 if keep_tokens else 1
        self.layout = tuple(
            p if keep_batch and isinstance(p, Shard) and p.dim < last
            else Replicate() for p in x.placements)
        params = _tree(params, lambda t: t)
        md = self.mdim
        # split over ``model`` where a weight is: the others are whole
        self.model_parallel = bool(
            split_model and md is not None
            and not isinstance(self.layout[md], Shard)
            and any(isinstance(t, DTensor)
                    and isinstance(t.placements[md], Shard)
                    for t in _leaves(params)))
        if self.model_parallel:
            self.model_size = mesh.size(md)
            self.model_rank = mesh.get_local_rank(md)
        self.params = _tree(params, self._weight)
        self.x = self.local(x)

    def _varies(self, i: int) -> bool:
        """Whether the body computes different things along mesh dim i."""
        return isinstance(self.layout[i], Shard) or (
            self.model_parallel and i == self.mdim)

    def _weight(self, w):
        if not isinstance(w, DTensor):
            return w
        md = self.mdim
        keep = [w.placements[i] if self.model_parallel and i == md
                else Replicate() for i in range(self.mesh.ndim)]
        return local_view(w, keep, [self._varies(i)
                                    for i in range(self.mesh.ndim)])

    def local(self, t):
        """Another activation of x's layout (an RWKV shift), local."""
        if self.ctx is None:
            return t
        return local_view(t, self.layout, [
            self.model_parallel and i == self.mdim
            for i in range(self.mesh.ndim)])

    def _model_group(self):
        return self.mesh.get_group(self.mdim)

    def all_reduce(self, t):
        """A partial sum over ``model`` inside the body, whole on every
        card: the sum, whose cotangent (a partial sum too) is summed in
        the backward.  ``t`` itself where the body is not split."""
        if not self.model_parallel:
            return t
        g = self._model_group()
        return reduce_grad(all_reduce(t, g), g)

    def gather_model(self, t, dim: int):
        """The card's split of ``t`` along ``dim`` joined over ``model``
        (inference only: no cotangent flows back)."""
        if not self.model_parallel:
            return t
        return all_gather(t, self._model_group(), dim, False)

    def _model_layout(self, dim: Optional[int]):
        """x's layout, with the model dim split at ``dim`` (None: not
        split)."""
        pl = list(self.layout)
        if self.model_parallel and dim is not None:
            pl[self.mdim] = Shard(dim)
        return pl

    def out(self, y, logical: Optional[Sequence[Optional[str]]], *,
            split_dim: Optional[int] = None):
        """The body's local output ``y`` as a DTensor, redistributed to
        ``logical`` (None: left in x's layout).  ``split_dim``: the dim a
        model-parallel body splits (a column-parallel output); without it
        a model-parallel output is a partial sum over ``model``
        (row-parallel), completed here."""
        if self.ctx is None:
            return y
        if self.model_parallel and split_dim is None:
            y = all_reduce(y, self._model_group())
        t = DTensor.from_local(y, self.mesh, self._model_layout(split_dim),
                               run_check=False)
        return t if logical is None else shard_logical(t, logical)

    def check(self, t: torch.Tensor, logical: Sequence[Optional[str]]
              ) -> None:
        """Raise unless the local ``t`` is split over ``model`` on exactly
        the dims ``ctx.pspec(logical, global dims)`` splits there (the
        reference's ``with_sharding_constraint`` at that site).  A dim of
        a declared axis is whole at its global size and split at 1/m of
        it; the batch dim is split as x's layout splits it."""
        md = self.mdim
        if md is None or self.mesh.size(md) == 1:
            return
        m = self.mesh.size(md)
        dims, split = [], []
        for i, name in enumerate(logical):
            n = t.shape[i]
            if name is None:
                dims.append(n)
                split.append(False)
            elif name == "batch" and i == 0:
                k = 1
                for j, p in enumerate(self.layout):
                    if p == Shard(0):
                        k *= self.mesh.size(j)
                dims.append(n * k)
                split.append(self.layout[md] == Shard(0))
            elif name in self.axes:
                size = self.axes[name]
                if n != size and n * m != size:
                    raise ValueError(
                        f"shard_logical{tuple(logical)} at {_call_site()}"
                        f": dim {i} ({name}) holds {n} of {size}, neither "
                        f"whole nor split {m} ways over model")
                dims.append(size)
                split.append(n != size)
            else:
                raise TypeError(
                    f"shard_logical{tuple(logical)} at {_call_site()}: "
                    f"the body declares no global size for {name!r}")
        spec = self.ctx.pspec(logical, dims)
        want = [i < len(spec) and "model" in _entry_axes(spec[i])
                for i in range(len(dims))]
        if want != split:
            where = lambda f: [logical[i] for i, s in enumerate(f) if s]
            raise ValueError(
                f"shard_logical{tuple(logical)} at {_call_site()}: a local "
                f"{tuple(t.shape)} split over model on {where(split)}, "
                f"where the reference's {spec} splits {where(want)}")

    # ------------------------------------------------------------ caches
    def cache_in(self, c):
        """A cache DTensor's local shard, used where it lives (its own
        storage: writes land in place).  Its batch must be split as x's
        is; its other splits are the layer's to read (``chunk``)."""
        if self.ctx is None:
            return c
        for i, (p, q) in enumerate(zip(c.placements, self.layout)):
            if (p == Shard(0)) != (q == Shard(0)):
                raise ValueError(
                    f"a cache laid out {tuple(c.placements)} in a body "
                    f"at {_call_site()} whose activation is laid out "
                    f"{self.layout}: mesh dim {i} splits one batch only")
        return c.to_local()

    def chunk(self, placements, dim: int, size: int):
        """(offset, length, groups) of this rank's part of dim ``dim`` (of
        global ``size``) of a tensor laid out by ``placements``: the
        process groups of the mesh dims that split it, in mesh order
        (none: the whole dim, offset 0)."""
        if self.ctx is None:
            return 0, size, []
        idx, parts, groups = 0, 1, []
        for j, p in enumerate(placements):
            if p == Shard(dim):
                n = self.mesh.size(j)
                idx = idx * n + self.mesh.get_local_rank(j)
                parts *= n
                groups.append(self.mesh.get_group(j))
        length = size // parts
        return idx * length, length, groups

    def cache_placements(self, logical: Sequence[Optional[str]],
                         shape: Sequence[int]):
        """The placements of a cache of global ``shape`` laid out by
        ``logical`` (None with no context)."""
        return None if self.ctx is None else self.ctx.placements(
            logical, tuple(shape))

    def cache_new(self, local, logical: Sequence[Optional[str]],
                  shape: Sequence[int]):
        """A new cache of global ``shape`` from this rank's shard of it,
        laid out by ``logical``; raises if ``local`` is not that shard's
        size (a body split otherwise than the cache)."""
        if self.ctx is None:
            return local
        pl = self.ctx.placements(logical, tuple(shape))
        want = list(shape)
        for j, p in enumerate(pl):
            if isinstance(p, Shard):
                want[p.dim] //= self.mesh.size(j)
        if list(local.shape) != want:
            raise ValueError(
                f"a cache shard of {tuple(local.shape)} at {_call_site()}"
                f" where {tuple(logical)} lays {tuple(shape)} out as "
                f"{tuple(want)} a rank")
        return DTensor.from_local(local.contiguous(), self.mesh, pl,
                                  run_check=False)


@contextlib.contextmanager
def local_body(params, x, *, split_model: bool = True,
               keep_batch: bool = True, keep_tokens: bool = False,
               axes: Optional[Mapping[str, int]] = None):
    """The ``Body`` of a layer's ``params`` on activation ``x`` under the
    active context (module doc).  The body splits over ``model`` when a
    weight is split there, and keeps the others whole;
    ``split_model=False`` gathers every weight (the body is replicated
    over ``model``), ``keep_batch=False`` also gathers the batch and
    ``keep_tokens`` keeps every split but the last dim's (a per-token
    body: a norm).  ``axes``: the global sizes of the logical axes that
    ``shard_logical`` names inside (``Body.check``).  Inside another body
    a plain ``x`` is already local: the body is its own (no context)."""
    ctx = current_ctx()
    stack = getattr(_state, "bodies", None)
    if stack is None:
        stack = _state.bodies = []
    if stack and not isinstance(x, DTensor):
        ctx = None
    body = Body(params, x, ctx, split_model=split_model,
                keep_batch=keep_batch, keep_tokens=keep_tokens, axes=axes)
    stack.append(body)
    try:
        yield body
    finally:
        stack.pop()
