"""Sharding context: logical-axis rules resolved against a mesh (the
reference's ``repro.sharding.context``, without JAX).

Rules map logical axis names (``batch``, ``heads``, ...) onto mesh axes,
with divisibility checks, so one set of annotations serves every mesh.
``ShardingCtx`` reads the axis sizes from a ``dist.DeviceMesh`` or from a
mesh description (a tuple of ``(name, size)`` pairs, or any form
``dist.normalize_mesh`` takes); ``pspec`` returns the per-dimension
entries the reference's ``PartitionSpec`` holds, as a plain tuple.  The
live consumer is ``dist.MeshRunner``, which shards the batch axis over
what ``axes_for("batch")`` resolves to.  ``use_sharding`` and
``current_ctx`` thread a context to code below without plumbing it
through every signature (thread-local, as in the reference).

``shard_logical`` is what the LM layers call on their activations.  With
no active context it returns its input, as the reference does.  Under an
active context the reference applies a GSPMD constraint; torch has none to
apply, and ignoring the context would hide that the model is not sharded,
so it raises until the LM half of ROADMAP item 11 (``partitioning``,
``shard_logical`` on a mesh) is ported.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.dist.mesh import DeviceMesh, normalize_mesh

__all__ = ["DEFAULT_RULES", "RULE_PROFILES", "make_rules", "ShardingCtx",
           "current_ctx", "use_sharding", "shard_logical"]

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
        axes = mesh.axes if isinstance(mesh, DeviceMesh) \
            else normalize_mesh(mesh)
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


def shard_logical(x, logical: Sequence[Optional[str]]):
    """``x`` itself when no sharding context is active; under one, raises
    ``NotImplementedError`` (the LM layers' sharding is not ported)."""
    ctx = current_ctx()
    if ctx is None:
        return x
    raise NotImplementedError(
        f"shard_logical{tuple(logical)} under an active ShardingCtx over "
        f"{ctx.axis_sizes}: the LM half of ROADMAP item 11 (partitioning, "
        f"shard_logical on a mesh) is not ported; run the LM layers with no "
        f"sharding context")
