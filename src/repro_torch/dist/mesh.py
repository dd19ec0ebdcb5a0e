"""Device-mesh descriptions: the pure half of the reference's
``repro.dist.mesh``.

The facade's ``ExecutionSpec.mesh`` is a validated *description* of a mesh
(axis names and sizes, canonically a tuple of ``(name, size)`` pairs, so
the frozen spec stays hashable and round-trips through JSON).  These
functions parse and check it without touching a device, so a spec can be
built and serialized on a machine that will never run it.  Resolving a
description against real devices waits for the port of the mesh runtime
(ROADMAP queue 1, item 11).
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

__all__ = ["MeshAxes", "parse_mesh", "normalize_mesh", "mesh_str"]

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
