"""The weight law of the benchmark's networks, drawn on the device.

Filters are He-normal (``N(0, 2 / fan_in)``, RRIO conv weights and
``(din, dout)`` dense weights, zero biases), as the port's
``core/snn_layers.py:init_conv`` draws them.  Each conv layer's output
channels are then scaled by ``lognormal(0, sigma)`` factors, as
``core/snn_model.py:skew_channels`` does: a trained net's channels fire
unevenly (Skydiver Fig. 2b), and that unevenness is what APRC and CBWS act
on.  The draws come from one ``torch.Generator`` on ``device`` seeded with
the run's seed, in two calls (every normal at once, every factor at once),
so the same seed gives the same weights on the same device.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

__all__ = ["layer_shapes", "make_weights"]


def layer_shapes(model: Dict) -> Tuple[List[Tuple[int, int, int, int]],
                                       List[Tuple[int, int]]]:
    """The conv weights' (R, R, Cin, Cout) and the dense weights' (din,
    dout) of the ``model`` block of a configuration file."""
    r, aprc = model["kernel_size"], model["aprc"]
    h, w = model["input_hw"]
    cin = model["input_channels"]
    conv = []
    for cout in model["conv_channels"]:
        conv.append((r, r, cin, cout))
        if aprc:
            h, w = h + r - 1, w + r - 1
        cin = cout
    dense = []
    din = h * w * cin
    for dout in model["dense_units"]:
        dense.append((din, dout))
        din = dout
    return conv, dense


def make_weights(model: Dict, sigma: float, seed: int,
                 device: torch.device) -> Dict:
    """``{"conv": [{"w", "b"}], "dense": [{"w", "b"}]}`` in float32 on
    ``device``, from ``seed``."""
    conv, dense = layer_shapes(model)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(s) for s in conv + dense]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    couts = [s[-1] for s in conv]
    skew = torch.empty(sum(couts), device=device).log_normal_(
        0.0, sigma, generator=gen)
    parts = list(torch.split(normal, sizes))
    factors = list(torch.split(skew, couts))
    params: Dict = {"conv": [], "dense": []}
    for shape, z, f in zip(conv, parts, factors):
        fan_in = shape[0] * shape[1] * shape[2]
        w = z.view(shape) * math.sqrt(2.0 / fan_in) * f
        params["conv"].append({"w": w.contiguous(),
                               "b": torch.zeros(shape[-1], device=device)})
    for shape, z in zip(dense, parts[len(conv):]):
        w = z.view(shape) * math.sqrt(2.0 / shape[0])
        params["dense"].append({"w": w.contiguous(),
                                "b": torch.zeros(shape[-1], device=device)})
    return params
