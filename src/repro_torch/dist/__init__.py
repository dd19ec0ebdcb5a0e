"""``repro_torch.dist``: multi-device execution beneath the
``repro_torch.api`` facade (the reference's ``repro.dist``).

The layer that turns ``ExecutionSpec.mesh`` (a validated axis description,
e.g. ``{"data": 4}``) into execution on several devices:

  * ``mesh``: spec parsing and validation (pure) and ``DeviceMesh``
    (resolves the cards ``cuda:0..N-1``, or N host entries on the CPU,
    and hands out lane -> device pinnings);
  * ``runner``: ``MeshRunner``, batch-sharded ``Session.infer`` and
    ``train_step`` with a bit-parity contract across device counts;
  * ``placement``: CBWS device placement (Skydiver's SPE assignment at
    mesh-device granularity) for the serving engine's pinned lanes;
  * ``spmd``: one process per mesh entry for the sharded LM (``run``),
    and ``mesh.make_test_mesh``, the torch ``DeviceMesh`` of its group;
  * ``mesh.make_production_mesh``: the reference's 256- and 512-rank
    meshes over the default group (``launch.dryrun`` traces them on
    ``meta`` tensors under a fake group of that size).

``MeshRunner``, the placement helpers and ``spmd`` load lazily (PEP 562),
so spec validation (``normalize_mesh``) stays importable without the
model code.  The reference's ``host_device_env`` and ``HOST_DEVICE_FLAG``
have no counterpart (torch needs no flag for host entries).
"""
from __future__ import annotations

import importlib

from repro_torch.dist.mesh import (DeviceMesh, MeshAxes,
                                   make_production_mesh, make_test_mesh,
                                   mesh_str, normalize_mesh, parse_mesh)

__all__ = [
    "DeviceMesh",
    "MeshAxes",
    "MeshRunner",
    "assign_groups_to_devices",
    "assignment_balance",
    "device_placement",
    "fifo_placement",
    "make_production_mesh",
    "make_test_mesh",
    "mesh_str",
    "normalize_mesh",
    "parse_mesh",
    "spmd",
]

_LAZY = {
    "MeshRunner": "repro_torch.dist.runner",
    "assign_groups_to_devices": "repro_torch.dist.placement",
    "assignment_balance": "repro_torch.dist.placement",
    "device_placement": "repro_torch.dist.placement",
    "fifo_placement": "repro_torch.dist.placement",
    "spmd": "repro_torch.dist.spmd",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'repro_torch.dist' has no attribute {name!r}")
    if mod.endswith("." + name):
        return importlib.import_module(mod)
    return getattr(importlib.import_module(mod), name)
