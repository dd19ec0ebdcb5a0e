"""Fused spiking-conv + LIF over all T timesteps and its surrogate backward:
the wrappers of kernels ``csrc/spiking_conv_lif.cu`` (the inference forward
and the training forward that also saves the pre-reset membrane) and
``csrc/lif_bwd.cu`` (the reverse-time BPTT), their plain versions, and the
autograd Function that joins them with the conv backward.

For each t: dV_t = conv(spikes[t], w) + bias (bias only where the
block's receptive inputs hold no spike), then ``u = v + dV_t;
s = u >= v_th; v = u - v_th * s``.  The kernel keeps the membrane in
registers from ``v0`` to ``v_final`` (the reference's
``repro.kernels.spiking_conv_lif.spiking_conv_lif_pallas``).  It takes
``v0`` and returns ``v_final``, so a caller can run T in chunks and thread
the membrane between them.

Training (``SpikingConvLIFFn``, the reference's ``spiking_conv_lif_train``
custom_vjp): the forward also saves ``u`` (``spiking_conv_lif_fwd``, the
reference's ``spiking_conv_lif_fwd_pallas``); the backward runs
``lif_bwd`` (``lif_bwd_pallas``), then the conv backward over the folded
(T*B) batch: ``conv_grad_input`` (``conv_grad_input_pallas``) when the
input train needs a gradient, and ``conv_grad_weights`` (the reference's
XLA ``conv_grad_weights_xla``; on the card its tensor-core kernel's spike
instance, on the CPU a torch-op GEMM per tap).

``HoistedConvLIFFn`` is the same scheme for the hoisted first layer, whose
forward is kernel A's hoisted mode (``spiking_conv.spiking_conv_lif_hoisted``)
and whose input current is constant over T; its weight gradient takes the
kernel's analog instance, since its input is frames.

With ``count=True`` kernel B also writes the train's ``TrainCounts``
(``kernels.spiking_conv``), as the hoisted first layer does.

Given CPU tensors every wrapper computes through its plain version; given
CUDA tensors it launches its kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.core.surrogate import SURROGATE_KINDS
from repro_torch.kernels import _build
from repro_torch.kernels.ref import lif_bwd_ref, spiking_conv_lif_ref
from repro_torch.kernels.spiking_conv import (_conv_dims, _count_buffers,
                                              conv_grad_input,
                                              conv_grad_weights, needs_grad,
                                              plan_mma_tiles,
                                              spiking_conv_lif_hoisted,
                                              train_counts_plain)

__all__ = ["spiking_conv_lif", "spiking_conv_lif_plain",
           "spiking_conv_lif_fwd", "lif_bwd", "lif_bwd_plain",
           "SpikingConvLIFFn", "HoistedConvLIFFn"]


# The plain versions are the oracles themselves (per-t conv plus LIF; the
# reverse-time scan).
spiking_conv_lif_plain = spiking_conv_lif_ref
lif_bwd_plain = lif_bwd_ref


def _launch_fused(spikes: torch.Tensor, v0: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor, v_th: float, aprc: bool,
                  save_u: bool, count: bool = False
                  ) -> Tuple[torch.Tensor, ...]:
    """Kernel B (``save_u=False``; with ``count`` its counting instance) or
    C (``save_u=True``) on CUDA tensors."""
    fn = "spiking_conv_lif_fwd" if save_u else "spiking_conv_lif"
    dev = _build.check_cuda_args(fn, spikes=spikes, v0=v0, w=w, bias=bias)
    if spikes.dim() != 5:
        raise ValueError(f"{fn}: spikes must be (T, B, H, W, Cin), got "
                         f"{tuple(spikes.shape)}")
    h, wd, cin, cout, r, pad_lo, e_h, e_w = _conv_dims(spikes, w, bias,
                                                      aprc, fn)
    t, n = spikes.shape[:2]
    if tuple(v0.shape) != (n, e_h, e_w, cout):
        raise ValueError(f"{fn}: v0 must be {(n, e_h, e_w, cout)}, got "
                         f"{tuple(v0.shape)}")
    plan = plan_mma_tiles(e_w, r, cin, cout)
    s = torch.empty((t, n, e_h, e_w, cout), dtype=torch.float32, device=dev)
    v = torch.empty_like(v0)
    if save_u:
        outs = (s, v, torch.empty_like(s))
        extra = (outs[2].data_ptr(),)
    elif count:
        outs = (s, v, _count_buffers(t, n, e_h, cout, plan.cout_tile, dev))
        extra = (outs[2].t.data_ptr(), outs[2].rows.data_ptr())
    else:
        outs, extra = (s, v), (None, None)
    if t == 0 or v.numel() == 0:
        if t == 0:
            v.copy_(v0)
        if count:
            outs[2].rows.zero_()
        return outs
    _build.launch(dev, fn, _build.entry(
        "spiking_conv_lif", "spiking_conv_lif_fwd_launch" if save_u
        else "spiking_conv_lif_launch"),
        spikes.data_ptr(), v0.data_ptr(), w.data_ptr(), bias.data_ptr(),
        s.data_ptr(), v.data_ptr(), *extra, t, n, h, wd, cin, cout, r,
        pad_lo, e_h, e_w, plan.block_rows, plan.cout_tile, float(v_th))
    if save_u:
        spiking_conv_lif_fwd.launches += 1
    else:
        spiking_conv_lif.launches += 1
        if count:
            spiking_conv_lif.launches_counted += 1
    return outs


def spiking_conv_lif_fwd(spikes: torch.Tensor, v0: torch.Tensor,
                         w: torch.Tensor, bias: torch.Tensor, *,
                         v_th: float = 1.0, aprc: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The training forward: as ``spiking_conv_lif``, plus the pre-reset
    membrane train ``u`` (T, B, E_h, E_w, Cout).  Returns (s, v_final, u)."""
    if spikes.device.type == "cpu":
        return spiking_conv_lif_plain(spikes, v0, w, bias, v_th=v_th,
                                      aprc=aprc, save_u=True)
    return _launch_fused(spikes, v0, w, bias, v_th, aprc, save_u=True)


spiking_conv_lif_fwd.launches = 0


def lif_bwd(u: torch.Tensor, g_s: torch.Tensor, g_v: torch.Tensor, *,
            v_th: float, alpha: float, kind: str
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reverse-time surrogate BPTT (see ``kernels.ref.lif_bwd_ref``).
    u, g_s: (T, ...);  g_v: (...).  Returns (lam (T, ...), dv0)."""
    if u.device.type == "cpu":
        return lif_bwd_plain(u, g_s, g_v, v_th=v_th, alpha=alpha, kind=kind)
    fn = "lif_bwd"
    dev = _build.check_cuda_args(fn, u=u, g_s=g_s, g_v=g_v)
    if kind not in SURROGATE_KINDS:
        raise ValueError(f"{fn}: unknown surrogate {kind!r}; expected one "
                         f"of {SURROGATE_KINDS}")
    if u.dim() < 1 or g_s.shape != u.shape or g_v.shape != u.shape[1:]:
        raise ValueError(f"{fn}: u {tuple(u.shape)} and g_s "
                         f"{tuple(g_s.shape)} must be (T, ...) and g_v "
                         f"{tuple(g_v.shape)} their (...)")
    lam, dv0 = torch.empty_like(u), torch.empty_like(g_v)
    if u.shape[0] == 0:
        return lam, dv0.copy_(g_v)
    if dv0.numel() == 0:
        return lam, dv0
    _build.launch(dev, fn, _build.entry("lif_bwd"),
                  u.data_ptr(), g_s.data_ptr(), g_v.data_ptr(),
                  lam.data_ptr(), dv0.data_ptr(), u.shape[0], g_v.numel(),
                  # the kernel's Kind enum numbers the surrogates in this
                  # order
                  SURROGATE_KINDS.index(kind), float(v_th), float(alpha))
    lif_bwd.launches += 1
    return lam, dv0


lif_bwd.launches = 0


class SpikingConvLIFFn(torch.autograd.Function):
    """``spiking_conv_lif`` under autograd: Heaviside spikes forward,
    surrogate BPTT backward (the reference's ``spiking_conv_lif_train``).

    forward: kernel C, saving (spikes, w, u).  backward: kernel D from the
    cotangents of (s, v_final), then, on ``lam`` folded to (T*B, ...),
    kernel E for the input train when it needs a gradient and
    ``conv_grad_weights`` (its spike instance) for (dw, db).  Returns (dx,
    dv0, dw, db)."""

    @staticmethod
    def forward(ctx, spikes, v0, w, bias, v_th, aprc, alpha, kind):
        s, v, u = spiking_conv_lif_fwd(spikes.detach(), v0.detach(),
                                       w.detach(), bias.detach(), v_th=v_th,
                                       aprc=aprc)
        ctx.save_for_backward(spikes, w, u)
        ctx.opts = (v_th, aprc, alpha, kind)
        return s, v

    @staticmethod
    @once_differentiable
    def backward(ctx, g_s, g_v):
        spikes, w, u = ctx.saved_tensors
        v_th, aprc, alpha, kind = ctx.opts
        # autograd hands over materialized zeros for an unused output
        lam, dv0 = lif_bwd(u, g_s.contiguous(), g_v.contiguous(), v_th=v_th,
                           alpha=alpha, kind=kind)
        t, b = spikes.shape[:2]
        lam2 = lam.reshape((t * b,) + lam.shape[2:])
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv_grad_input(lam2, w, aprc=aprc).reshape(spikes.shape)
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            dw, db = conv_grad_weights(
                spikes.reshape((t * b,) + spikes.shape[2:]), lam2, aprc=aprc,
                r=w.shape[0], binary=True)
        dv0 = dv0 if ctx.needs_input_grad[1] else None
        return dx, dv0, dw, db, None, None, None, None


class HoistedConvLIFFn(torch.autograd.Function):
    """The hoisted first layer (``spiking_conv_lif_hoisted``) under
    autograd: Heaviside spikes forward, surrogate BPTT backward, for a
    current that is constant over the ``t`` steps.

    forward: kernel A's hoisted mode with ``save_u``, saving (frames, w,
    u).  backward: kernel D on u with the cotangents of (s, v_final) gives
    lam (t, ...) and dv0; the constant current's cotangent is dz = the sum
    of lam over t, added in ascending t; then ``conv_grad_weights`` (its
    analog instance: the frames are not spikes) for (dw, db), and kernel E
    for the frames when they need a gradient.
    Returns (dframes, dv0, dw, db).  Surrogates: kernel D's three."""

    @staticmethod
    def forward(ctx, frames, v0, w, bias, t, v_th, aprc, alpha, kind):
        s, v, u = spiking_conv_lif_hoisted(
            frames.detach(), v0.detach(), w.detach(), bias.detach(), t=t,
            v_th=v_th, aprc=aprc, save_u=True)
        ctx.save_for_backward(frames, w, u)
        ctx.opts = (v_th, aprc, alpha, kind)
        return s, v

    @staticmethod
    @once_differentiable
    def backward(ctx, g_s, g_v):
        frames, w, u = ctx.saved_tensors
        v_th, aprc, alpha, kind = ctx.opts
        # autograd hands over materialized zeros for an unused output
        lam, dv0 = lif_bwd(u, g_s.contiguous(), g_v.contiguous(), v_th=v_th,
                           alpha=alpha, kind=kind)
        dz = lam.new_zeros(lam.shape[1:])
        for lam_t in lam:
            dz = dz + lam_t
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv_grad_input(dz, w, aprc=aprc)
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            dw, db = conv_grad_weights(frames, dz, aprc=aprc, r=w.shape[0])
        dv0 = dv0 if ctx.needs_input_grad[1] else None
        return dx, dv0, dw, db, None, None, None, None, None


def spiking_conv_lif(spikes: torch.Tensor, v0: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor, *, v_th: float = 1.0,
                     aprc: bool = True, surrogate_alpha: float = 10.0,
                     surrogate_kind: str = "fast_sigmoid",
                     count: bool = False) -> Tuple:
    """spikes: (T, B, H, W, Cin);  v0: (B, E_h, E_w, Cout).  Returns the
    output spike train (T, B, E_h, E_w, Cout) and the final membrane, and
    with ``count`` the train's ``TrainCounts`` (on the CPU
    ``train_counts_plain``).

    With no gradient to build it runs kernel B (the reference's primal;
    with ``count`` its counting instance, counted in ``.launches_counted``
    besides ``.launches``); otherwise it goes through ``SpikingConvLIFFn``,
    whose backward applies the ``surrogate_kind`` surrogate scaled by
    ``surrogate_alpha``, and which counts nothing: ``count`` with a
    gradient raises, as ``save_u`` with ``count`` does in the hoisted
    mode."""
    if needs_grad(spikes, v0, w, bias):
        if count:
            raise ValueError("spiking_conv_lif: count is kernel B's; a "
                             "forward that builds a gradient runs C, which "
                             "does not count")
        return SpikingConvLIFFn.apply(spikes, v0, w, bias, float(v_th), aprc,
                                      float(surrogate_alpha), surrogate_kind)
    if spikes.device.type == "cpu":
        outs = spiking_conv_lif_plain(spikes, v0, w, bias, v_th=v_th,
                                      aprc=aprc)
        return outs + (train_counts_plain(outs[0]),) if count else outs
    return _launch_fused(spikes, v0, w, bias, v_th, aprc, save_u=False,
                         count=count)


spiking_conv_lif.launches = 0
spiking_conv_lif.launches_counted = 0
