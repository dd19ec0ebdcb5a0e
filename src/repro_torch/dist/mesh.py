"""Device meshes: the reference's ``repro.dist.mesh`` on torch devices.

The facade's ``ExecutionSpec.mesh`` is a validated *description* of a mesh
(axis names and sizes, canonically a tuple of ``(name, size)`` pairs, so
the frozen spec stays hashable and round-trips through JSON).
``parse_mesh``, ``normalize_mesh`` and ``mesh_str`` parse and check it
without touching a device, so a spec can be built and serialized on a
machine that will never run it.  ``DeviceMesh`` resolves a description
against the cards of this host (``cuda:0..N-1``), or, when asked for the
CPU, against N host entries ``cpu:0..cpu:N-1``: distinct mesh entries that
all compute on the CPU (the counterpart of the reference's
``--xla_force_host_platform_device_count`` host devices, which torch needs
no flag for).  It never repeats a card and never falls back to the CPU.

Skydiver places hot channels on SPEs; this layer places the batch axis
(and the serving engine's lanes) on mesh devices: the same balance story
one level up the hardware.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Tuple

import torch

__all__ = ["MeshAxes", "parse_mesh", "normalize_mesh", "mesh_str",
           "DeviceMesh", "make_production_mesh", "make_test_mesh"]

MeshAxes = Tuple[Tuple[str, int], ...]


def parse_mesh(text: str) -> MeshAxes:
    """Parse a CLI mesh spec like ``"data=4"`` or ``"data=2,model=2"`` into
    the canonical ``ExecutionSpec.mesh`` tuple.  A bare integer is sugar
    for the data axis: ``"4"`` == ``"data=4"``."""
    text = text.strip()
    if not text:
        raise ValueError("empty mesh spec (expected e.g. 'data=4')")
    if text.isdigit():
        return (("data", int(text)),)
    axes = []
    for part in text.split(","):
        name, eq, size = part.partition("=")
        if not eq:
            raise ValueError(
                f"bad mesh axis {part!r} in {text!r}: expected name=size "
                f"(e.g. 'data=4' or 'data=2,model=2')")
        try:
            axes.append((name.strip(), int(size)))
        except ValueError:
            raise ValueError(
                f"bad mesh axis size {size!r} in {text!r}: expected an "
                f"integer (e.g. 'data=4')") from None
    return normalize_mesh(axes)


def normalize_mesh(mesh) -> Optional[MeshAxes]:
    """Canonicalize any accepted mesh form — ``None``, a ``{name: size}``
    mapping, or a sequence of ``(name, size)`` pairs (lists after a JSON
    round trip) — into a validated tuple of ``(name, size)``.

    Validation is pure (no device access): axis names must be unique
    non-empty strings, sizes integers >= 1.  Axis order is meaningful (the
    device grid's order) and preserved; dict forms keep insertion order."""
    if mesh is None:
        return None
    items = list(mesh.items()) if isinstance(mesh, Mapping) else list(mesh)
    axes = []
    for pair in items:
        try:
            name, size = pair
        except (TypeError, ValueError):
            raise ValueError(
                f"bad mesh entry {pair!r}: expected a (name, size) pair "
                f"(mesh forms: dict {{'data': 4}} or tuple of pairs)"
            ) from None
        if not isinstance(name, str) or not name:
            raise ValueError(
                f"mesh axis name must be a non-empty string, got {name!r}")
        if isinstance(size, bool) or not isinstance(size, int):
            raise ValueError(
                f"mesh axis {name!r} size must be an integer, got {size!r}")
        if size < 1:
            raise ValueError(
                f"mesh axis {name!r} size must be >= 1, got {size}")
        axes.append((name, int(size)))
    names = [n for n, _ in axes]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate mesh axis names in {names}")
    if not axes:
        raise ValueError(
            "empty mesh (use None for the single-device default)")
    return tuple(axes)


def mesh_str(axes: MeshAxes) -> str:
    """Inverse of ``parse_mesh``: ``(("data", 4),)`` -> ``"data=4"``."""
    return ",".join(f"{n}={s}" for n, s in axes)


class DeviceMesh:
    """A validated mesh description resolved against this host's devices.

    ``axes`` takes ``normalize_mesh``'s forms or one ``(name, size)`` pair
    (``DeviceMesh(("data", 2))``).  ``devices`` lists the entries explicitly (the first N are taken; none
    may repeat).  Without it, ``device`` picks their kind: the cards
    ``cuda:0..N-1`` (the default), raising ``ValueError`` when fewer than N
    are visible, or ``"cpu"`` for the host entries ``cpu:0..cpu:N-1``.
    Entries are ``torch.device`` objects in row-major order of the axes.

    Immutable after construction, so the serving engine's lane threads
    read it without a lock.

        dm = DeviceMesh((("data", 4),))
        dm.data_size        # 4
        dm.lane_devices(6)  # round-robin lane -> device pinning
    """

    def __init__(self, axes, devices: Optional[Sequence] = None, *,
                 device=None):
        if isinstance(axes, tuple) and len(axes) == 2 \
                and isinstance(axes[0], str):
            axes = (axes,)
        self.axes: MeshAxes = normalize_mesh(axes)
        if self.axes is None:
            raise ValueError("DeviceMesh needs a mesh spec, got None")
        n = 1
        for _, size in self.axes:
            n *= size
        if devices is None:
            kind = torch.device("cuda" if device is None else device).type
            if kind == "cuda":
                count = (torch.cuda.device_count()
                         if torch.cuda.is_available() else 0)
                if count < n:
                    raise ValueError(
                        f"mesh {mesh_str(self.axes)} needs {n} devices but "
                        f"only {count} CUDA devices are visible; pass "
                        f"devices= to name the entries, or device='cpu' for "
                        f"{n} host entries cpu:0..cpu:{n - 1}")
            elif kind != "cpu":
                raise ValueError(
                    f"DeviceMesh device kind must be 'cuda' or 'cpu', got "
                    f"{kind!r}")
            devs = [torch.device(kind, i) for i in range(n)]
        else:
            devs = [torch.device(d) for d in devices]
            if len(devs) < n:
                raise ValueError(
                    f"mesh {mesh_str(self.axes)} needs {n} devices but "
                    f"devices= names only {len(devs)}")
            devs = devs[:n]
            if len(set(devs)) < n:
                raise ValueError(
                    f"mesh {mesh_str(self.axes)}: devices= repeats an entry "
                    f"({[str(d) for d in devs]})")
        self.devices: Tuple[torch.device, ...] = tuple(devs)

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.axes)

    def axis_size(self, name: str) -> int:
        for n, s in self.axes:
            if n == name:
                return s
        raise KeyError(f"mesh has no axis {name!r} (axes: {self.axis_names})")

    @property
    def data_size(self) -> int:
        """Size of the ``data`` axis: the batch axis's shard count (1 when
        the mesh has no data axis)."""
        return self.axis_size("data") if "data" in self.axis_names else 1

    def lane_devices(self, num_lanes: int) -> Tuple[torch.device, ...]:
        """Round-robin lane -> device pinning for the serving engine: lane
        i executes on entry ``i % num_devices``.  With more lanes than
        entries, entries are shared evenly, and the engine's CBWS device
        placement balances work, not just lane count, across them."""
        if num_lanes < 1:
            raise ValueError(f"num_lanes must be >= 1, got {num_lanes}")
        return tuple(self.devices[i % self.num_devices]
                     for i in range(num_lanes))

    def __repr__(self) -> str:
        return f"DeviceMesh({mesh_str(self.axes)}, devices={self.num_devices})"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The torch ``DeviceMesh`` of the current default group at the
    reference's production size: single pod (data=16, model=16), 256
    ranks; multi-pod (pod=2, data=16, model=16), 512 ranks, ``pod`` the
    data-parallel axis across pods.  A group of another size raises,
    naming the size it needs; no smaller mesh is built.  ``device_type``:
    the mesh's (default as ``make_test_mesh``: ``cuda`` under ``nccl``,
    else ``cpu``); a ``fake`` group of that size (``launch.dryrun``)
    serves for tracing on ``meta`` tensors."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != need:
        raise ValueError(
            f"make_production_mesh(multi_pod={multi_pod}) needs a default "
            f"process group of {need} ranks, "
            + ("none is initialised" if have is None else f"this one has "
               f"{have}"))
    kind = device_type or ("cuda" if dist.get_backend() == "nccl"
                           else "cpu")
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def make_test_mesh(shape: Sequence[int] = (2, 2),
                   axes: Sequence[str] = ("data", "model")):
    """The torch ``DeviceMesh`` of the current process group (one process
    per entry, ``dist.spmd``), its axes named as the reference's: on the
    cards under ``nccl``, on the host under ``gloo``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axes))
