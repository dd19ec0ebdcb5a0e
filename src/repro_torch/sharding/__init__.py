"""Logical-axis sharding rules and CBWS placement (the SNN half of the
reference's ``repro.sharding``).

``context`` maps logical axis names (``batch``, ``channels``, ...) onto
mesh axes; ``cbws_sharding`` carries the CBWS load-balanced placement
helpers.  The live consumer is ``repro_torch.dist.MeshRunner``, which
drives the ``batch`` -> ``data`` rule for sharded inference and training.
``shard_logical`` (called only by LM layers) returns its input when no
context is active and raises under one; the reference's ``partitioning``
(param, optimizer and batch shardings of the LM) and ``shard_logical`` on
a mesh are the LM half of ROADMAP item 11.  ``cbws_sharding`` loads lazily
(PEP 562), as in the reference.
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
    "placement_balance",
    "shard_logical",
    "snn_channel_permutation",
    "use_sharding",
]

_LAZY = {
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
    return getattr(importlib.import_module(mod), name)
