"""The operations and bytes that a language model's decode steps need,
whatever computes them, counted from the network and from the routing of
the plain reference (``reference/lm.py``), never from the program's plan.

Each layer's mixer and FFN count their own work
(``reference/kinds/<kind>.py``: ``decode_work``), summed by part over the
layers; the head adds 2 operations per weight per token, its weights read
once a step, the embedding rows looked up and the logits written.  Bytes
are in the served dtype.  A routed layer reads only the experts that some
token of the step chose (``occupied``, the mean over the reference's
layers and steps), so a dispatch that reads only those can reach this
bound; the port's dense one reads all of them (``roofline.decode``).
Least time comes from ``work.least_seconds``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from skybench import harness
from skybench.data.lm_weights import layer_kinds
from skybench.work import LayerWork

__all__ = ["decode_work", "occupied_experts"]


def occupied_experts(routes: Sequence[torch.Tensor], first: int,
                     steps: int) -> float:
    """Mean distinct experts a step's tokens choose, over the routed
    layers and the positions ``first`` .. ``first + steps - 1`` of the
    reference's routing (each (B, S, k))."""
    counts = [len(torch.unique(r[:, first + s])) for r in routes
              for s in range(steps)]
    return sum(counts) / len(counts) if counts else 0.0


def decode_work(model: Dict, positions: Sequence[int], batch: int,
                occupied: float, wbytes: float = 2.0) -> List[LayerWork]:
    """Work of one decode step at each of ``positions`` over ``batch``
    sequences."""
    steps = len(positions)
    cached = sum(p + 1 for p in positions)
    parts: Dict[str, LayerWork] = {}
    for layer in layer_kinds(model):
        for name in layer:
            for lw in harness.load_kind(name).decode_work(
                    model, cached, steps, batch, occupied, wbytes):
                have = parts.get(lw.name, LayerWork(lw.name, 0.0, 0.0))
                parts[lw.name] = LayerWork(lw.name, have.flops + lw.flops,
                                           have.bytes + lw.bytes)
    d, V = model["hidden_size"], model["vocab_size"]
    tokens = batch * steps
    head = LayerWork("head", 2.0 * d * V * tokens,
                     wbytes * (d * V * steps + d * tokens + V * tokens))
    return [*parts.values(), head]
