"""The weight law of the benchmark's language models, drawn on the device.

The model is cut into blocks, drawn one at a time: ``"embed"``, each layer
``0 .. L - 1`` and ``"head"``.  A block's matrices are one normal draw in
the served dtype from a ``torch.Generator`` on the device seeded from the
run's seed and the block (``block_seed``), split in a fixed order and each
scaled as its leaf says (``fan_in ** -0.5``); leaves of another dtype (a
MoE router's float32) are a second draw.  Norm scales are ones.  So the
program's weights are written one block at a time, and the reference draws
any block again, alone, and gets the same bits on the same device.

Leaves are named as the port's modules name their parameters: the
embedding ``embed.tok`` (V, d), scale d^-1/2; a layer's ``norm1.scale``
and ``norm2.scale`` (d,), then its mixer's leaves under ``mixer.`` and its
FFN's under ``ffn.``, as the layer kind's module gives them
(``reference/kinds/<kind>.py``: ``leaves``); the head ``final_norm.scale``
(d,) and ``embed.head`` (d, V), scale d^-1/2.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple, Union

import torch

from skybench import harness
from skybench.inputs import sub_seed

__all__ = ["DTYPES", "layer_kinds", "block_shapes", "block_seed",
           "block_weights", "blocks"]

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}

Block = Union[str, int]
# name -> (shape, scale; None: ones, dtype: None for the served one)
Shapes = Dict[str, Tuple[Tuple[int, ...], object, object]]


def layer_kinds(model: Dict) -> List[Tuple[str, str]]:
    """(mixer, ffn) of every layer, from the ``layers`` stages of a
    configuration's ``model`` block: ``[[repeats, [[mixer, ffn], ...]]]``."""
    out: List[Tuple[str, str]] = []
    for repeats, sub in model["layers"]:
        out.extend([tuple(k) for k in sub] * int(repeats))
    if len(out) != model["num_hidden_layers"]:
        raise ValueError(f"layers give {len(out)} layers, "
                         f"num_hidden_layers is {model['num_hidden_layers']}")
    return out


def blocks(model: Dict) -> List[Block]:
    return ["embed", *range(model["num_hidden_layers"]), "head"]


def block_shapes(model: Dict, block: Block) -> Shapes:
    d, V = model["hidden_size"], model["vocab_size"]
    if block == "embed":
        return {"embed.tok": ((V, d), d ** -0.5, None)}
    if block == "head":
        return {"final_norm.scale": ((d,), None, None),
                "embed.head": ((d, V), d ** -0.5, None)}
    mixer, ffn = layer_kinds(model)[block]
    out: Shapes = {"norm1.scale": ((d,), None, None),
                   "norm2.scale": ((d,), None, None)}
    for part, name in (("mixer", mixer), ("ffn", ffn)):
        leaves = harness.load_kind(name).leaves(model)
        out.update({f"{part}.{k}": v for k, v in leaves.items()})
    return out


def block_seed(seed: int, model: Dict, block: Block) -> int:
    return sub_seed(seed, 1000 + blocks(model).index(block))


def block_weights(model: Dict, block: Block, seed: int, dtype: torch.dtype,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """The leaves of ``block``, drawn from ``seed`` on ``device``: every
    matrix of the served ``dtype`` in one call, a router in another."""
    shapes = block_shapes(model, block)
    gen = torch.Generator(device=device).manual_seed(
        block_seed(seed, model, block))
    groups: Dict[object, list] = {}        # None (served dtype) first
    for k, (s, sc, dt) in shapes.items():
        if sc is not None:
            groups.setdefault(dt, []).append((k, s, sc))
    out: Dict[str, torch.Tensor] = {}
    for dt, drawn in groups.items():
        sizes = [math.prod(s) for _, s, _ in drawn]
        z = torch.randn(sum(sizes), generator=gen, dtype=dt or dtype,
                        device=device)
        for (k, s, sc), part in zip(drawn, torch.split(z, sizes)):
            out[k] = part.view(s).mul_(sc)
    for k, (s, sc, _) in shapes.items():
        if sc is None:
            out[k] = torch.ones(s, dtype=dtype, device=device)
    return {k: out[k] for k in shapes}
