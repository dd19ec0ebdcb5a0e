"""Spiking layers (conv / dense) with the APRC structural option.

APRC (paper §III-B): pad ``R-1`` zeros on every side of every channel and use
stride 1 ("full" convolution).  Then Eq. (5) holds exactly:

    sum_xy dV_n[t] = (sum w_n) * (sum_in in[t])

so per-output-channel workload is proportional to the filter magnitude.
Without APRC we use SAME padding (the conventional structure).

Layouts are the reference's: NHWC activations, RRIO ``(R, R, Cin, Cout)``
conv weights, ``(din, dout)`` dense weights.

A row's result never depends on the batch it is computed in (the serving
engine regroups a request's timestep chunks into whatever micro-batch is
running, and the chunk-parity contract needs the same bits in every one).
A library GEMM or convolution picks its algorithm, and so its summation
order, by the row count, so ``conv2d`` and ``dense`` avoid that:

- a spike input (every value 0 or 1: every dense input, and every conv
  input after the first layer) is multiplied in float64 against the
  weights rounded onto a power-of-two grid fine enough that every partial
  sum is exact (``exact_grid``): exact sums are the same in any order, so
  the library's choice of algorithm cannot change a bit.  The rounding
  moves each weight by less than 2**-50 of the layer's largest column
  sum; the result is rounded to float32 once, like a float32 product.  A
  conv takes one GEMM per tap (R*R of them, accumulated in float64: each
  partial sum is exact, so the bits are those of a single GEMM over the
  im2col patches, which is never built), and its backward keeps only the
  input (``_SpikeConv``);
- any other conv input (the direct-coded frame of a first layer, analog
  values, for which the float64 products would not be exact) is convolved
  by elementwise multiply-adds in a fixed tap and channel order.

``conv2d`` tells the two apart by looking at the values, which costs one
pass over the input and, on the card, a host sync, unless the caller says
which it is (``binary=``): a layer fed by a spiking layer knows.  These are
the plain paths, not the kernels.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.core.neuron import LIFState, lif_step

__all__ = ["conv2d", "dense", "exact_grid", "with_exact_grid", "init_conv",
           "init_dense", "spiking_conv_step", "spiking_dense_step",
           "conv_out_hw"]


def exact_grid(w: torch.Tensor, dim: int) -> torch.Tensor:
    """``w`` in float64, rounded onto the grid 2**(E-52), where 2**(E-2)
    bounds the largest sum of |w| along ``dim`` (one bit of margin against
    the rounding of log2).  Any partial sum of 0/1-weighted grid values is
    then a multiple of the grid below 2**E in magnitude, which float64
    holds exactly.  The gradient passes straight through the rounding.
    Computed on the device, without a host sync."""
    wd = w.double()
    bound = wd.detach().abs().sum(dim=dim).amax().clamp_min(2.0 ** -900)
    grid = torch.exp2(torch.ceil(torch.log2(bound)) + 2 - 52)
    q = torch.round(wd.detach() / grid) * grid
    return wd + (q - wd.detach())


def with_exact_grid(p: Dict) -> Dict:
    """A dense layer's parameters holding also ``"wq"``, its weights on the
    exact grid (``exact_grid(p["w"], 0)``), unless they hold it already:
    the model adds it once per chunk, the serving cache once per
    parameter version (``snn_model.freeze_params``)."""
    return p if "wq" in p else {**p, "wq": exact_grid(p["w"], dim=0)}


def _pads(r: int, aprc: bool) -> Tuple[int, int]:
    return (r - 1, r - 1) if aprc else ((r - 1) // 2, r - 1 - (r - 1) // 2)


def _taps(xp: torch.Tensor, r: int, e_h: int, e_w: int):
    """The R*R shifted windows of the padded input, (dy, dx) row-major."""
    for k in range(r * r):
        dy, dx = divmod(k, r)
        yield k, xp[:, dy:dy + e_h, dx:dx + e_w, :]


def _flat_rows(x: torch.Tensor, lo: int, hi: int):
    """``x`` padded (one more row at the bottom) and flattened to rows of
    its channels: (N * L, C), L = (H_pad + 1) * W_pad.  Output pixel (y, x)
    of an image is row y * W_pad + x of its L, and tap (dy, dx) reads input
    row y * W_pad + x + dy * W_pad + dx: each tap's operand is one
    contiguous slice of the rows, shifted by that offset, for the whole
    batch at once.  The rows of columns x >= E_w, and those that run into
    the next image, compute values that are never read; the extra row
    keeps the last image's slices inside the tensor.  Returns (rows, H_pad
    + 1, W_pad)."""
    xp = F.pad(x, (0, 0, lo, hi, lo, hi + 1))
    n, hp, wp, c = xp.shape
    return xp.reshape(n * hp * wp, c), hp, wp


def _tap_offsets(r: int, wp: int):
    """(k, row offset) of the R*R taps in ``_flat_rows``' layout."""
    return [(k, (k // r) * wp + k % r) for k in range(r * r)]


class _SpikeConv(torch.autograd.Function):
    """The conv of a 0/1 input on the exact-grid weights: float64, one GEMM
    per tap on a shifted view of the input's rows (``_flat_rows``: no copy
    of the taps), accumulated in place over the taps (module doc), rounded
    to the input's type once.  The backward keeps only the input and the
    weights: dx adds each tap's transposed product into the padded input's
    rows at the tap's offset, dw is one product per tap, both in float64
    and rounded once."""

    @staticmethod
    def forward(ctx, x, w, lo, hi):
        r, _, cin, cout = w.shape
        n = x.shape[0]
        e_h = x.shape[1] + lo + hi - r + 1
        e_w = x.shape[2] + lo + hi - r + 1
        wq = exact_grid(w.detach().reshape(r * r * cin, cout), dim=0)
        xr, hp, wp = _flat_rows(x.detach().double(), lo, hi)
        rows = xr.shape[0] - (r - 1) * (wp + 1)
        z = xr.new_empty((xr.shape[0], cout))
        for k, off in _tap_offsets(r, wp):
            wk = wq[k * cin:(k + 1) * cin]
            if k == 0:
                torch.mm(xr[off:off + rows], wk, out=z[:rows])
            else:
                z[:rows].addmm_(xr[off:off + rows], wk)
        ctx.save_for_backward(x, wq)
        ctx.geom = (r, lo, hi, e_h, e_w, w.dtype)
        z = z.reshape(n, hp, wp, cout)[:, :e_h, :e_w]
        return z.to(x.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, wq = ctx.saved_tensors
        r, lo, hi, e_h, e_w, w_dtype = ctx.geom
        n, h, wd, cin = x.shape
        cout = wq.shape[-1]
        hp, wp = h + lo + hi + 1, wd + lo + hi
        rows = n * hp * wp - (r - 1) * (wp + 1)
        # the cotangent in the forward's row layout, zero at the rows that
        # are no output
        gr = g.new_zeros((n, hp, wp, cout), dtype=torch.float64)
        gr[:, :e_h, :e_w] = g
        gr = gr.reshape(-1, cout)[:rows]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dxr = gr.new_zeros((n * hp * wp, cin))
            for k, off in _tap_offsets(r, wp):
                dxr[off:off + rows].addmm_(gr, wq[k * cin:(k + 1) * cin].T)
            dx = dxr.reshape(n, hp, wp, cin)[:, lo:lo + h, lo:lo + wd]
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            xr, _, _ = _flat_rows(x.double(), lo, hi)
            dw = torch.stack([xr[off:off + rows].T @ gr
                              for _, off in _tap_offsets(r, wp)])
            dw = dw.reshape(r, r, cin, cout).to(w_dtype)
        return dx, dw, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, *, aprc: bool,
           binary: Optional[bool] = None) -> torch.Tensor:
    """NHWC x RRIO convolution; APRC = full padding + stride 1.  Rows are
    independent of the batch (module doc).  ``binary`` says whether every
    value of ``x`` is 0 or 1; ``None`` looks at the values (a host sync on
    the card)."""
    r, _, cin, _ = w.shape
    lo, hi = _pads(r, aprc)
    if binary is None:
        xd = x.detach()
        binary = bool(((xd == 0) | (xd == 1)).all())
    if binary:
        return _SpikeConv.apply(x, w, lo, hi)
    e_h, e_w = x.shape[1] + lo + hi - r + 1, x.shape[2] + lo + hi - r + 1
    z = None
    for k, tap in _taps(F.pad(x, (0, 0, lo, hi, lo, hi)), r, e_h, e_w):
        for ci in range(cin):
            term = tap[..., ci:ci + 1] * w[k // r, k % r, ci]
            z = term if z is None else z + term
    return z


def dense(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """``x @ w + b`` for a spike input ``x``; rows are independent of the
    batch (module doc).  Uses ``p["wq"]`` where ``with_exact_grid`` put
    it."""
    wq = p["wq"] if "wq" in p else exact_grid(p["w"], dim=0)
    return (x.double() @ wq).to(p["b"].dtype) + p["b"]


def conv_out_hw(h: int, w: int, r: int, aprc: bool) -> Tuple[int, int]:
    return (h + r - 1, w + r - 1) if aprc else (h, w)


def init_conv(r: int, cin: int, cout: int, *, generator: torch.Generator,
              device: Optional[torch.device] = None,
              dtype=torch.float32) -> Dict:
    """He-normal RRIO filters, zero bias (the reference's init law; the
    bits differ from ``jax.random``'s — load JAX weights with
    ``repro_torch.interop.from_jax_params`` to compare like with like)."""
    fan_in = r * r * cin
    w = torch.randn((r, r, cin, cout), generator=generator, dtype=dtype)
    w = w * math.sqrt(2.0 / fan_in)
    return {"w": w.to(device), "b": torch.zeros((cout,), dtype=dtype,
                                                device=device)}


def init_dense(din: int, dout: int, *, generator: torch.Generator,
               device: Optional[torch.device] = None,
               dtype=torch.float32) -> Dict:
    w = torch.randn((din, dout), generator=generator, dtype=dtype)
    w = w * math.sqrt(2.0 / din)
    return {"w": w.to(device), "b": torch.zeros((dout,), dtype=dtype,
                                                device=device)}


def spiking_conv_step(
    params: Dict, state: LIFState, spikes_in: torch.Tensor,
    *, aprc: bool, v_th: float, surrogate_alpha: float = 10.0,
    surrogate_kind: str = "fast_sigmoid", backend: str = "ref",
    binary: Optional[bool] = None,
) -> Tuple[LIFState, torch.Tensor]:
    """One timestep: synaptic current (Eq. 2) then LIF update (Eq. 1+3).

    ``backend="ref"``/``"batched"`` is the differentiable plain path
    (``binary`` as for ``conv2d``); ``backend="hopper"`` runs the fused
    conv+LIF kernel (``kernels.spiking_conv_lif``) with T=1.
    """
    if backend == "hopper":
        from repro_torch.kernels.spiking_conv_lif import spiking_conv_lif
        s, v = spiking_conv_lif(spikes_in[None], state.v, params["w"],
                                params["b"], v_th=float(v_th), aprc=aprc,
                                surrogate_alpha=surrogate_alpha,
                                surrogate_kind=surrogate_kind)
        return LIFState(v=v), s[0]
    if backend not in ("ref", "batched"):
        from repro_torch.core.snn_model import SNN_BACKENDS
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {SNN_BACKENDS} "
            "(the model-level switch lives in core.snn_model.snn_apply)")
    z = conv2d(spikes_in, params["w"], aprc=aprc, binary=binary) \
        + params["b"]
    return lif_step(state, z, v_th=v_th, surrogate_alpha=surrogate_alpha,
                    surrogate_kind=surrogate_kind)


def spiking_dense_step(
    params: Dict, state: LIFState, spikes_in: torch.Tensor,
    *, v_th: float, surrogate_alpha: float = 10.0,
    surrogate_kind: str = "fast_sigmoid",
) -> Tuple[LIFState, torch.Tensor]:
    z = dense(spikes_in, params)
    return lif_step(state, z, v_th=v_th, surrogate_alpha=surrogate_alpha,
                    surrogate_kind=surrogate_kind)
