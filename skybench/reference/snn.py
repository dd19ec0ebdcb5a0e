"""The plain reference of the paper's two spiking networks (Skydiver §IV).

Plain PyTorch in float32, with TF32 off for cuBLAS and cuDNN
(``exact_float32``).  It reads the widths from the ``model`` block of a
configuration file and knows nothing of the program:

- conv: ``F.conv2d`` on NHWC activations and RRIO filters, APRC full pads
  (``R - 1`` zeros on every side) or SAME pads;
- neurons: integrate-and-fire with reset by subtraction (Eq. 1-3),
  ``v += z; s = U(v - v_th); v -= v_th * s``, the first layer's current
  constant over T (direct coding);
- readout: the classifier's dense layer summed over T, or the segmentation
  net's last conv as a non-firing membrane, cropped to the input size; both
  divided by T;
- training: cross-entropy of the logits, the fast-sigmoid surrogate
  ``1 / (1 + alpha |v - v_th|)^2``, SGD with momentum
  (``m = mu m + g; p = p - lr m``).

``control=True`` computes every product from operands rounded to TF32 (ten
mantissa bits, round to nearest even), which is what TF32 tensor cores do:
the lower precision that the benchmark's control runs in.

The forward also counts, per conv layer, the spikes by step and channel
and ``taps``: the (nonzero input element, filter tap) pairs that land in
the output, which ``skybench/work.py`` turns into operations.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["exact_float32", "round_tf32", "RefOutputs", "forward",
           "loss_fn", "train_steps"]


def exact_float32() -> None:
    """Float32 products without TF32, and cuDNN's deterministic algorithms
    (the same bits on every run)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's ten mantissa bits, to nearest
    even; the gradient passes straight through."""
    xd = x.detach().contiguous()
    bits = xd.view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(bits, 13), 1)
    bits = torch.bitwise_and(bits + 0x0FFF + lsb, ~0x1FFF)
    return x + (bits.view(torch.float32) - xd)


class RefOutputs(NamedTuple):
    logits: torch.Tensor               # (B, classes) or (B, H, W, 1)
    counts: List[torch.Tensor]         # per conv layer: (T, Cout) spikes
    taps: List[float]                  # per conv layer: nonzero-input taps


class _Spike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, alpha):
        ctx.save_for_backward(v)
        ctx.alpha = alpha
        return (v >= 0.0).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        return g / (1.0 + ctx.alpha * v.abs()) ** 2, None


def _pads(r: int, aprc: bool):
    return (r - 1, r - 1) if aprc else ((r - 1) // 2, r - 1 - (r - 1) // 2)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, aprc: bool,
          control: bool) -> torch.Tensor:
    """NHWC ``x`` (N, H, W, Cin) by RRIO ``w``: (N, E_h, E_w, Cout)."""
    lo, hi = _pads(w.shape[0], aprc)
    xi = F.pad(x.permute(0, 3, 1, 2), (lo, hi, lo, hi))
    wt = w.permute(3, 2, 0, 1)
    if control:
        xi, wt = round_tf32(xi), round_tf32(wt)
    return F.conv2d(xi, wt).permute(0, 2, 3, 1) + b


def _taps(x: torch.Tensor, r: int, aprc: bool) -> float:
    """Pairs of a nonzero element of ``x`` (N, H, W, C) and a filter tap
    that lands inside the output."""
    lo, hi = _pads(r, aprc)
    nz = (x.detach() != 0).sum(dim=-1, dtype=torch.float32)[:, None]
    ones = torch.ones((1, 1, r, r), dtype=nz.dtype, device=nz.device)
    hits = F.conv2d(F.pad(nz, (lo, hi, lo, hi)), ones)
    return float(hits.double().sum())


def forward(model: Dict, params: Dict, frames: torch.Tensor, *,
            alpha: float = 10.0, control: bool = False) -> RefOutputs:
    """The network on analog frames (B, H, W, Cin), in one block."""
    t_steps, v_th = model["timesteps"], float(model["v_threshold"])
    aprc, r = model["aprc"], model["kernel_size"]
    convs = params["conv"]
    seg = not model["dense_units"]
    b = frames.shape[0]
    counts, taps = [], []

    def lif(zs):
        v, out = torch.zeros_like(zs[0]), []
        for z in zs:
            v = v + z
            s = _Spike.apply(v - v_th, alpha)
            v = v - v_th * s
            out.append(s)
        return torch.stack(out)

    # first layer: the frame's current is the same at every step
    z0 = _conv(frames, convs[0]["w"], convs[0]["b"], aprc, control)
    taps.append(_taps(frames, r, aprc))
    x = lif([z0] * t_steps)
    counts.append(x.detach().sum(dim=(1, 2, 3)))
    for i in range(1, len(convs)):
        folded = x.reshape((t_steps * b,) + x.shape[2:])
        taps.append(_taps(folded, r, aprc))
        z = _conv(folded, convs[i]["w"], convs[i]["b"], aprc, control)
        z = z.reshape((t_steps, b) + z.shape[1:])
        if seg and i == len(convs) - 1:
            v, cnt = torch.zeros_like(z[0]), []
            for z_t in z:
                v = v + z_t
                cnt.append((v.detach() >= v_th).sum(dim=(0, 1, 2)))
            counts.append(torch.stack(cnt).to(z.dtype))
            h0, w0 = model["input_hw"]
            dh, dw = (v.shape[1] - h0) // 2, (v.shape[2] - w0) // 2
            return RefOutputs(v[:, dh:dh + h0, dw:dw + w0] / t_steps,
                              counts, taps)
        x = lif(z)
        counts.append(x.detach().sum(dim=(1, 2, 3)))
    x = x.reshape(t_steps, b, -1)
    for j, dp in enumerate(params["dense"]):
        w = round_tf32(dp["w"]) if control else dp["w"]
        if j < len(params["dense"]) - 1:
            x = lif([x_t @ w + dp["b"] for x_t in x])
            continue
        acc = torch.zeros((b, w.shape[1]), dtype=x.dtype, device=x.device)
        for x_t in x:
            acc = acc + (x_t @ w + dp["b"])
        return RefOutputs(acc / t_steps, counts, taps)
    raise ValueError("a network ends in a dense layer or a readout conv")


def forward_blocks(model: Dict, params: Dict, frames: torch.Tensor,
                   block: int, **kw) -> RefOutputs:
    """``forward`` over blocks of ``block`` frames, without autograd:
    logits concatenated, counts and taps summed."""
    outs = []
    with torch.no_grad():
        for i in range(0, frames.shape[0], block):
            outs.append(forward(model, params, frames[i:i + block], **kw))
    return RefOutputs(
        torch.cat([o.logits for o in outs]),
        [sum(o.counts[k] for o in outs) for k in range(len(outs[0].counts))],
        [sum(o.taps[k] for o in outs) for k in range(len(outs[0].taps))])


def loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the classifier's logits."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp[torch.arange(logp.shape[0], device=logp.device),
                 labels.long()].mean()


def _leaves(params: Dict) -> List[torch.Tensor]:
    return [p[k] for group in ("conv", "dense") for p in params[group]
            for k in ("w", "b")]


def _tree(leaves: Sequence[torch.Tensor], like: Dict) -> Dict:
    it = iter(leaves)
    return {group: [{k: next(it) for k in ("w", "b")} for _ in like[group]]
            for group in ("conv", "dense")}


class TrainRecord(NamedTuple):
    losses: List[float]
    first_grad: Dict                   # the first step's gradient
    params: Dict                       # the parameters after the last step
    outputs: Optional[RefOutputs]      # the first step's forward (counts)


def train_steps(model: Dict, params: Dict, batches, *, lr: float,
                momentum: float, alpha: float = 10.0,
                control: bool = False) -> TrainRecord:
    """SGD with momentum from ``params`` over ``batches`` of (frames,
    labels) tensors; ``params`` is left as it was."""
    leaves = [p.detach().clone() for p in _leaves(params)]
    mom = [torch.zeros_like(p) for p in leaves]
    losses, first_grad, first_out = [], None, None
    for x, y in batches:
        live = [p.requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            out = forward(model, _tree(live, params), x, alpha=alpha,
                          control=control)
            loss = loss_fn(out.logits, y)
            grads = torch.autograd.grad(loss, live)
        losses.append(loss.item())
        if first_grad is None:
            first_grad = _tree([g.detach().clone() for g in grads], params)
            first_out = RefOutputs(out.logits.detach(), out.counts, out.taps)
        with torch.no_grad():
            mom = [momentum * m + g for m, g in zip(mom, grads)]
            leaves = [p.detach() - lr * m for p, m in zip(live, mom)]
    return TrainRecord(losses, first_grad, _tree(leaves, params), first_out)
