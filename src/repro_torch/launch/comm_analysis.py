"""What one traced call of a step did, per rank: its collectives (the
roofline's third term), its FLOPs and its live storage.  The counterpart
of the reference's ``launch/hlo_analysis.py``, which parses compiled HLO
text: the port has no HLO, so ``Recorder`` watches the call itself.

``Recorder`` is a ``TorchDispatchMode``.  It sees every op of the call on
this rank's local tensors, forward and backward (remat's recomputation
included): an op on DTensors is handed back to DTensor, whose local ops
and collectives then come through the mode.

  * collectives: the ``c10d`` ops of ``torch.distributed`` (the bodies'
    gathers, reduce-scatters and all-reduces, ``sharding/collectives.py``;
    the train step's agreement flag, ``lm._agreed``) and the
    ``_c10d_functional``/``_dtensor`` ops DTensor issues at the bodies'
    edges.  Each one adds an event (kind, payload bytes, group size,
    whether the group lies within one node of ``NODE_SIZE`` consecutive
    ranks) to ``events``, in order, and to ``CollectiveStats`` with the
    reference's payload conventions: the all-gather operand is the local
    shard, the reduce-scatter operand the full tensor.  Every count is
    exact: the port runs every layer, so there is no trip-count
    inference.  On a mesh built for ``cpu``, DTensor lowers a
    Shard->Shard redistribute to all-gathers (gloo has no all-to-all);
    the recorder counts it as the one all-to-all a ``cuda`` mesh issues,
    so the record does not depend on the mesh's device type;
  * FLOPs: ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
    registry) over the local ops, so a DTensor op counts its shard's
    FLOPs, not the global op's;
  * memory: every storage on ``device`` that an op creates is live from
    its creation until its release (a weakref finalizer); ``peak_bytes``
    is the most live at once, the storages registered with ``hold`` (the
    arguments) included.

DTensor's sharding propagation runs each new op once on fake global
tensors to learn its output's shape; the recorder ignores those ops, so
the record does not depend on DTensor's caches.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["COLLECTIVE_KINDS", "NODE_SIZE", "CollectiveStats",
           "CollectiveEvent", "collective_kind", "Recorder", "tensor_bytes",
           "tensors_of"]

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# per-device wire bytes on a ring algorithm, as factors of the payload
_WIRE_FACTOR = {
    "all-reduce": lambda n: 2.0 * (n - 1) / n,
    "all-gather": lambda n: float(n - 1),
    "reduce-scatter": lambda n: (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}

# ranks a node holds: a DGX H100 joins 8 cards by NVLink
NODE_SIZE = 8


@dataclass
class CollectiveStats:
    payload_bytes: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    wire_bytes: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    count: Dict[str, float] = field(default_factory=lambda: defaultdict(float))

    def add(self, kind: str, payload: float, n: int, mult: float = 1.0):
        self.payload_bytes[kind] += mult * payload
        self.wire_bytes[kind] += mult * payload * _WIRE_FACTOR[kind](max(2, n))
        self.count[kind] += mult

    def merge_scaled(self, other: "CollectiveStats", mult: float):
        for k, v in other.payload_bytes.items():
            self.payload_bytes[k] += mult * v
        for k, v in other.wire_bytes.items():
            self.wire_bytes[k] += mult * v
        for k, v in other.count.items():
            self.count[k] += mult * v

    def total_payload(self) -> float:
        return sum(self.payload_bytes.values())

    def total_wire(self) -> float:
        return sum(self.wire_bytes.values())


class CollectiveEvent(NamedTuple):
    kind: str               # one of COLLECTIVE_KINDS
    payload_bytes: int
    group_size: int
    intra_node: bool        # the group's ranks lie in one node

    @property
    def wire_bytes(self) -> float:
        return self.payload_bytes * _WIRE_FACTOR[self.kind](
            max(2, self.group_size))


# op name (without namespace and overload) -> (kind, operand argument):
# the operand whose bytes are the payload.  The c10d ops are what
# ``torch.distributed``'s calls dispatch (``all_gather_into_tensor`` and
# its 2.13 name ``all_gather_single`` both reach ``_allgather_base_``);
# the others are DTensor's
_OPS = {
    "allreduce_": ("all-reduce", "tensors"),
    "_allgather_base_": ("all-gather", "input_tensor"),
    "_reduce_scatter_base_": ("reduce-scatter", "input_tensor"),
    "alltoall_base_": ("all-to-all", "input"),
    "all_reduce": ("all-reduce", "input"),
    "all_gather_into_tensor": ("all-gather", "input"),
    "reduce_scatter_tensor": ("reduce-scatter", "input"),
    "all_to_all_single": ("all-to-all", "input"),
    "shard_dim_alltoall": ("all-to-all", "input"),
}
_NAMESPACES = ("c10d", "_c10d_functional", "_dtensor")
# ops of those namespaces that move no data between ranks
_QUIET = {"wait_tensor", "_wrap_tensor_autograd"}


def collective_kind(func) -> Optional[str]:
    """The ``COLLECTIVE_KINDS`` entry of a dispatcher op, None for an op
    that is no collective; raises for a collective with no wire model
    (a broadcast, a barrier, a send)."""
    if func.namespace not in _NAMESPACES:
        return None
    name = func._schema.name.split("::")[-1]
    if name in _QUIET:
        return None
    if name not in _OPS:
        raise NotImplementedError(
            f"comm_analysis: no wire model for the collective {func}")
    return _OPS[name][0]


def tensor_bytes(t) -> int:
    """A tensor's bytes, or the local shard's for a DTensor."""
    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.numel() * t.element_size()


def tensors_of(tree):
    """The tensors of a tree whose leaves may be modules (a model: its
    parameters)."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.nn.Module):
            yield from leaf.parameters()
        elif isinstance(leaf, torch.Tensor):
            yield leaf


def _group(func, args, kwargs):
    """The process group an op runs on."""
    names = [a.name for a in func._schema.arguments]
    vals = dict(zip(names, args), **kwargs)
    if "process_group" in vals:
        return dist.ProcessGroup.unbox(vals["process_group"])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(vals["group_name"])


def _in_one_node(ranks) -> bool:
    return len({r // NODE_SIZE for r in ranks}) == 1


def _operand_bytes(func, args, kwargs) -> int:
    name = func._schema.name.split("::")[-1]
    names = [a.name for a in func._schema.arguments]
    operand = dict(zip(names, args), **kwargs)[_OPS[name][1]]
    return sum(tensor_bytes(t) for t in tree_leaves(operand)
               if isinstance(t, torch.Tensor))


_ACTIVE: List["Recorder"] = []


class Recorder(TorchDispatchMode):
    """Records one rank's collectives, FLOPs and live storage on
    ``device`` while entered (module doc).  Enter it with ``with``;
    ``hold`` registers tensors that are live before the call (the
    arguments)."""

    def __init__(self, device="meta"):
        super().__init__()
        self.device = torch.device(device)
        self.events: List[CollectiveEvent] = []
        self.stats = CollectiveStats()
        self.flops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._quiet = 0
        self._depth = 0

    # ---------------------------------------------------------- storage
    def hold(self, tree) -> None:
        for t in tensors_of(tree):
            self._track(t)

    def _track(self, t) -> None:
        if isinstance(t, DTensor):
            t = t._local_tensor
        if t.device != self.device or (
                type(t) is not torch.Tensor
                and not isinstance(t, torch.nn.Parameter)):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key)

    def _release(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # ------------------------------------------------------ collectives
    def add_event(self, kind: str, payload: int, group) -> None:
        n = group.size()
        ranks = dist.get_process_group_ranks(group)
        self.events.append(CollectiveEvent(kind, payload, n,
                                           _in_one_node(ranks)))
        self.stats.add(kind, payload, n)

    def link_wire_bytes(self) -> Dict[str, float]:
        """Wire bytes of the groups within one node (``nvlink``) and of
        those across nodes (``network``)."""
        out = {"nvlink": 0.0, "network": 0.0}
        for e in self.events:
            out["nvlink" if e.intra_node else "network"] += e.wire_bytes
        return out

    @contextlib.contextmanager
    def quiet(self):
        """Nothing inside is recorded."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    # --------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # DTensor's own dispatch runs the local ops, which come back
            # through this mode
            return NotImplemented
        if self._quiet:
            return func(*args, **kwargs)
        kind = collective_kind(func)
        count = flop_registry.get(func._overloadpacket)
        if kind is None and count is None:
            # a composite op (matmul, linear, einsum reach the mode whole
            # where autograd is off) runs as its parts, which are counted
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        if kind is not None:
            self.add_event(kind, _operand_bytes(func, args, kwargs),
                           _group(func, args, kwargs))
        out = func(*args, **kwargs)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    def __enter__(self):
        if not self._depth:
            _ACTIVE.append(self)
            self._patches = _patch()
            self._patches.__enter__()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if not self._depth:
                self._patches.__exit__(None, None, None)
                _ACTIVE.remove(self)


def _current() -> Optional[Recorder]:
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def _patch():
    """DTensor's sharding propagation runs quiet, and its all-to-all
    fallback on a ``cpu`` mesh counts as the all-to-all (module doc)."""
    from torch.distributed.tensor import _collective_utils, placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    saved = []

    def swap(owner, name, new):
        saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, new)

    for name in ("_propagate_tensor_meta_non_cached",
                 "_propagate_tensor_meta"):
        if name in ShardingPropagator.__dict__:
            swap(ShardingPropagator, name, _quiet_call(
                ShardingPropagator.__dict__[name]))
            break
    alltoall = _collective_utils.shard_dim_alltoall

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        rec = _current()
        if rec is None or mesh.device_type != "cpu":
            return alltoall(input, gather_dim, shard_dim, mesh, mesh_dim)
        rec.add_event("all-to-all", tensor_bytes(input),
                      mesh.get_group(mesh_dim))
        with rec.quiet():
            out = alltoall(input, gather_dim, shard_dim, mesh, mesh_dim)
            if out.untyped_storage().nbytes() > tensor_bytes(out):
                out = out.clone()    # the all-to-all's own buffer
        rec._track(out)
        return out

    for owner in (_collective_utils, placement_types):
        if "shard_dim_alltoall" in owner.__dict__:
            swap(owner, "shard_dim_alltoall", shard_dim_alltoall)
    try:
        yield
    finally:
        for owner, name, old in reversed(saved):
            setattr(owner, name, old)


def _quiet_call(fn):
    def call(*args, **kwargs):
        rec = _current()
        if rec is None:
            return fn(*args, **kwargs)
        with rec.quiet():
            return fn(*args, **kwargs)
    return call
