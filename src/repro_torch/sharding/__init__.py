"""Logical-axis sharding rules, the LM's placements on a torch mesh and
CBWS placement (the reference's ``repro.sharding``).

``context`` maps logical axis names (``batch``, ``heads``, ...) onto mesh
axes, turns them into DTensor placements and runs the LM layers' bodies on
local shards (``shard_logical``, ``local_body``); ``partitioning`` lays
the LM's parameters, optimizer state, caches and batches out on a mesh;
``cbws_sharding`` carries the CBWS load-balanced placement helpers.
``dist.MeshRunner`` drives the ``batch`` -> ``data`` rule for the SNN.
``partitioning`` and ``cbws_sharding`` load lazily (PEP 562), as in the
reference.
"""
from __future__ import annotations

import importlib

from repro_torch.sharding.context import (DEFAULT_RULES, RULE_PROFILES,
                                          ShardingCtx, current_ctx,
                                          make_rules, shard_logical,
                                          use_sharding)

__all__ = [
    "DEFAULT_RULES",
    "RULE_PROFILES",
    "ShardingCtx",
    "apply_expert_permutation",
    "current_ctx",
    "expert_placement",
    "make_rules",
    "partitioning",
    "placement_balance",
    "shard_logical",
    "snn_channel_permutation",
    "use_sharding",
]

_LAZY = {
    "partitioning": "repro_torch.sharding.partitioning",
    "apply_expert_permutation": "repro_torch.sharding.cbws_sharding",
    "expert_placement": "repro_torch.sharding.cbws_sharding",
    "placement_balance": "repro_torch.sharding.cbws_sharding",
    "snn_channel_permutation": "repro_torch.sharding.cbws_sharding",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'repro_torch.sharding' has no attribute {name!r}")
    if mod.endswith("." + name):
        return importlib.import_module(mod)
    return getattr(importlib.import_module(mod), name)
