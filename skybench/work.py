"""The operations and bytes that the benchmark's inputs need, whatever
computes them, and the card's peaks that turn them into least times.

Counts follow the network and the spikes that the reference's own trains
hold (``reference.snn.RefOutputs.taps`` and ``counts``), never a kernel's
plan, so a change of implementation changes neither:

- a conv layer: 2 operations per (nonzero input element, filter tap) pair
  that lands in the output, per output channel; the first layer's analog
  conv once per frame (its input does not change over T);
- a spiking layer's neurons: 4 operations per membrane update (add the
  current, compare, reset), a non-firing readout's 1;
- a dense readout: its dense product at every step;
- training adds, per conv layer after the first, the dense input gradient
  (2 per input element, tap and output channel, at every step), the weight
  gradient (as many operations as the layer's forward conv: only nonzero
  inputs contribute), 8 per neuron and step for the surrogate LIF backward,
  the dense readout's two gradient products, and 4 per parameter for SGD
  with momentum;
- bytes: each input read once and each output written once, spikes at one
  bit, currents, membranes, gradients and weights in float32.  A train
  that one layer writes and the next reads counts twice.

Least time = max(operations / 989 TFLOP/s, bytes / 3.35 TB/s): the H100
SXM's highest dense rate (bf16 on the tensor cores, so no float32-exact
implementation can beat it) and its HBM rate, at the full 700 W.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

__all__ = ["PEAK_FLOPS", "PEAK_BYTES", "LayerWork", "infer_work",
           "train_work", "least_seconds", "total"]

PEAK_FLOPS = 989e12     # H100 SXM, dense bf16 on the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM, HBM3


class LayerWork(NamedTuple):
    name: str
    flops: float
    bytes: float


def _shapes(model: Dict):
    """(H_in, W_in, Cin, E_h, E_w, Cout) of every conv layer."""
    r, aprc = model["kernel_size"], model["aprc"]
    h, w = model["input_hw"]
    cin, out = model["input_channels"], []
    for cout in model["conv_channels"]:
        e_h, e_w = (h + r - 1, w + r - 1) if aprc else (h, w)
        out.append((h, w, cin, e_h, e_w, cout))
        h, w, cin = e_h, e_w, cout
    return out


def _dense(model: Dict):
    h, w, _, e_h, e_w, cout = _shapes(model)[-1]
    din, out = e_h * e_w * cout, []
    for dout in model["dense_units"]:
        out.append((din, dout))
        din = dout
    return out


def infer_work(model: Dict, taps: Sequence[float], frames: float,
               calls: float) -> List[LayerWork]:
    """Work of ``frames`` frames served in ``calls`` batches; ``taps`` is
    per conv layer the nonzero-input taps of one frame (summed over T)."""
    t_steps, r = model["timesteps"], model["kernel_size"]
    seg = not model["dense_units"]
    shapes = _shapes(model)
    out = []
    for i, ((h, w, cin, e_h, e_w, cout), tp) in enumerate(zip(shapes, taps)):
        readout = seg and i == len(shapes) - 1
        neurons = t_steps * e_h * e_w * cout
        flops = 2.0 * tp * cout + (1 if readout else 4) * neurons
        n_in = h * w * cin
        read = 4.0 * n_in if i == 0 else t_steps * n_in / 8.0
        if readout:
            write = 4.0 * model["input_hw"][0] * model["input_hw"][1] * cout
        else:
            write = neurons / 8.0
        wbytes = 4.0 * (r * r * cin * cout + cout)
        out.append(LayerWork(f"conv{i}", frames * flops,
                             frames * (read + write) + calls * wbytes))
    for j, (din, dout) in enumerate(_dense(model)):
        flops = 2.0 * t_steps * din * dout
        nbytes = t_steps * din / 8.0 + 4.0 * dout
        out.append(LayerWork(f"dense{j}", frames * flops,
                             frames * nbytes + calls * 4.0 * (din + 1) * dout))
    # the per-layer spike counts the infer verbs return: (T, Cout) each
    counts = 4.0 * t_steps * sum(c for *_, c in shapes)
    out.append(LayerWork("counts", 0.0, calls * counts))
    return out


def train_work(model: Dict, taps: Sequence[float], frames: float,
               steps: float) -> List[LayerWork]:
    """Work of ``steps`` training steps over ``frames`` frames in all: the
    forward of ``infer_work`` plus the backward and the update."""
    t_steps, r = model["timesteps"], model["kernel_size"]
    fwd = infer_work(model, taps, frames, steps)[:-1]
    out = []
    shapes = _shapes(model)
    for i, ((h, w, cin, e_h, e_w, cout), tp, lw) in enumerate(
            zip(shapes, taps, fwd)):
        neurons = t_steps * e_h * e_w * cout
        n_in = t_steps * h * w * cin
        flops = 2.0 * tp * cout + 8.0 * neurons       # dW, LIF backward
        nbytes = 4.0 * neurons + (n_in / 8.0 if i else 4.0 * h * w * cin)
        if i:                                         # the input gradient
            flops += 2.0 * n_in * r * r * cout
            nbytes += 4.0 * n_in
        wbytes = 4.0 * (r * r * cin * cout + cout)
        out.append(LayerWork(lw.name, lw.flops + frames * flops,
                             lw.bytes + frames * nbytes + steps * wbytes))
    n_params = sum(r * r * cin * cout + cout
                   for _, _, cin, _, _, cout in shapes)
    for j, ((din, dout), lw) in enumerate(zip(_dense(model),
                                              fwd[len(shapes):])):
        flops = 4.0 * t_steps * din * dout
        nbytes = 4.0 * t_steps * din + t_steps * din / 8.0 + 4.0 * dout
        out.append(LayerWork(lw.name, lw.flops + frames * flops,
                             lw.bytes + frames * nbytes
                             + steps * 4.0 * (din + 1) * dout))
        n_params += (din + 1) * dout
    out.append(LayerWork("sgd", steps * 4.0 * n_params,
                         steps * 20.0 * n_params))
    return out


def least_seconds(work: Sequence[LayerWork]) -> float:
    """Sum over the layers of each one's least time on the card."""
    return sum(max(lw.flops / PEAK_FLOPS, lw.bytes / PEAK_BYTES)
               for lw in work)


def total(work: Sequence[LayerWork]) -> LayerWork:
    return LayerWork("total", sum(lw.flops for lw in work),
                     sum(lw.bytes for lw in work))
