"""Naming the leaves of a tree of tensors: one walk, shared by the
optimizer (``.``-joined parameter names), the checkpointer (the
reference's ``/``-joined paths) and ``interop``.

A tree is nested dicts (keys in sorted order, as JAX flattens them),
lists, tuples and NamedTuples, and ``nn.Module``s, which flatten through
their named parameters; anything else is a leaf.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

from torch import nn

__all__ = ["flatten_with_paths"]


def _children(node, sep: str) -> Optional[Iterator[Tuple[str, Any]]]:
    """(path entry, child) of a tree node; None for a leaf."""
    if isinstance(node, nn.Module):
        return ((n.replace(".", sep), p) for n, p in node.named_parameters())
    if isinstance(node, dict):
        return ((str(k), node[k]) for k in sorted(node))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return ((f".{f}", getattr(node, f)) for f in node._fields)
    if isinstance(node, (list, tuple)):
        return ((str(i), c) for i, c in enumerate(node))
    return None


def flatten_with_paths(tree, sep: str = "/",
                       prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} of ``tree``, its entries joined by ``sep``, in JAX's
    order of leaves.  With ``sep="."`` a module's paths are the names of
    ``named_parameters``; with ``"/"`` they are the reference
    checkpointer's keys (a NamedTuple's field as ``.name``)."""
    kids = _children(tree, sep)
    if kids is None:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, child in kids:
        out.update(flatten_with_paths(
            child, sep, f"{prefix}{sep}{key}" if prefix else key))
    return out
