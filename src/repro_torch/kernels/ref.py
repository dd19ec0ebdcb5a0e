"""Plain-PyTorch oracles for every kernel (the allclose targets).

These are also the kernels' plain versions: a wrapper given CPU tensors
computes through them, and ``chip_smoke.py`` holds each kernel against
them on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.snn_layers import conv2d
from repro_torch.core.surrogate import surrogate_grad
from repro_torch.device import full_fp32

__all__ = ["conv_pads", "spiking_conv_ref", "lif_fused_ref",
           "spiking_conv_lif_ref", "lif_bwd_ref", "conv_grad_input_ref",
           "conv_grad_weights_ref", "split_bf16x3", "tf32_round",
           "split_tf32x2", "tf32x3_product"]


def conv_pads(r: int, aprc: bool) -> Tuple[int, int]:
    """(pad_lo, pad_hi) of the forward conv; APRC = full, else SAME."""
    if aprc:
        return r - 1, r - 1
    lo = (r - 1) // 2
    return lo, r - 1 - lo


def spiking_conv_ref(spikes: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     *, aprc: bool = True) -> torch.Tensor:
    """Reference for the spike-driven conv: plain conv (full or same pad).

    spikes: (B, H, W, Cin);  w: (R, R, Cin, Cout);  b: (Cout,)
    returns dV: (B, E, E', Cout) with E = H+R-1 in APRC mode.
    """
    out = conv2d(spikes.float(), w.float(), aprc=aprc)
    return (out + b.float()).to(spikes.dtype)


def lif_fused_ref(v: torch.Tensor, z: torch.Tensor, v_th: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference fused LIF step: integrate, fire, reset-by-subtraction."""
    vf = v.float() + z.float()
    s = (vf >= v_th).to(v.dtype)
    v_new = (vf - v_th * s.float()).to(v.dtype)
    return v_new, s


def spiking_conv_lif_ref(spikes: torch.Tensor, v0: torch.Tensor,
                         w: torch.Tensor, b: torch.Tensor, *,
                         v_th: float = 1.0, aprc: bool = True,
                         save_u: bool = False) -> Tuple[torch.Tensor, ...]:
    """Oracle for the fused conv+LIF kernel: the explicit composition of
    ``spiking_conv_ref`` and ``lif_fused_ref``, a Python loop over T.

    spikes: (T, B, H, W, Cin);  v0: (B, E, E', Cout).
    Returns (spike train (T, B, E, E', Cout), final membrane), and with
    ``save_u`` also the pre-reset membrane train ``u_t = v_{t-1} + dV_t``
    (the training residual; at a threshold flip it says how close to
    ``v_th`` the membrane was).
    """
    v, s_seq, u_seq = v0, [], []
    for s_t in spikes:
        z = spiking_conv_ref(s_t, w, b, aprc=aprc).float()
        if save_u:
            u_seq.append(v.float() + z)
        v, s = lif_fused_ref(v, z, v_th)
        s_seq.append(s)
    if save_u:
        return torch.stack(s_seq), v, torch.stack(u_seq)
    return torch.stack(s_seq), v


def lif_bwd_ref(u: torch.Tensor, g_s: torch.Tensor, g_v: torch.Tensor, *,
                v_th: float, alpha: float, kind: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reverse-time surrogate BPTT of the fused layer (the reference's
    ``lif_bwd_xla``).  u: (T, ...) pre-reset membrane;  g_s: (T, ...)
    spike-train cotangent;  g_v: (...) final-membrane cotangent.  From
    ``c = g_v``, for t = T-1 ... 0: ``lam_t = c + (g_s[t] - v_th*c) *
    sg(u_t - v_th)`` and ``c = lam_t``.  Returns (lam (T, ...), dv0 = c)."""
    surr = surrogate_grad(u.float() - v_th, alpha, kind)
    c = g_v.float()
    lam = torch.empty_like(surr)
    for t in range(u.shape[0] - 1, -1, -1):
        c = c + (g_s[t].float() - v_th * c) * surr[t]
        lam[t] = c
    return lam, c


def conv_grad_input_ref(dz: torch.Tensor, w: torch.Tensor, *,
                        aprc: bool = True) -> torch.Tensor:
    """d(input) of the forward conv from its output cotangent: a plain conv
    of ``dz`` with the flipped, channel-swapped taps
    ``wt[dy, dx, co, ci] = w[R-1-dy, R-1-dx, ci, co]`` under pads
    ``(R-1-lo, R-1-hi)`` (none for APRC).

    dz: (N, E_h, E_w, Cout);  w: (R, R, Cin, Cout).  Returns (N, H, W, Cin).
    """
    r = w.shape[0]
    lo, hi = conv_pads(r, aprc)
    plo, phi = r - 1 - lo, r - 1 - hi
    x = F.pad(dz.float().permute(0, 3, 1, 2), (plo, phi, plo, phi))
    wt = w.float().flip(0, 1).permute(2, 3, 0, 1)      # (Cin, Cout, R, R)
    with full_fp32():
        out = F.conv2d(x, wt)
    return out.permute(0, 2, 3, 1)


def conv_grad_weights_ref(x: torch.Tensor, dz: torch.Tensor, *, aprc: bool,
                          r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dL/dw, dL/db) of the forward conv from its output cotangent: the
    reference's ``conv_grad_weights_xla`` (XLA ops, no Pallas kernel), one
    (Cin, N*E_h*E_w) @ (N*E_h*E_w, Cout) product per tap, in torch ops.
    The plain version of the weight-gradient kernel
    (``csrc/conv_grad_weights.cu``): ``spiking_conv.conv_grad_weights``
    computes through it on CPU tensors, and launches the kernel on CUDA
    tensors.

    x: (N, H, W, Cin) forward input;  dz: (N, E_h, E_w, Cout).
    """
    lo, hi = conv_pads(r, aprc)
    n, e_h, e_w, cout = dz.shape
    cin = x.shape[-1]
    xp = F.pad(x.float(), (0, 0, lo, hi, lo, hi))
    gz = dz.float().reshape(n * e_h * e_w, cout)
    with full_fp32():
        dw = torch.stack([
            torch.stack([xp[:, dy:dy + e_h, dx:dx + e_w]
                         .reshape(-1, cin).T @ gz for dx in range(r)])
            for dy in range(r)])
    return dw, dz.float().sum(dim=(0, 1, 2))


# -- the tensor-core kernels' operand splits ----------------------------------

def split_bf16x3(w: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The weight split of kernels B and C (``csrc/spiking_conv_lif.cu``),
    and the cotangent's of the weight gradient
    (``csrc/conv_grad_weights.cu``): ``hi = bf16(w)``, ``mid = bf16(w -
    hi)``, ``lo = bf16(w - hi - mid)``, each rounded to nearest even.  Three
    parts of 8 significant bits hold float32's 24, so ``hi + mid + lo == w``
    exactly, and a spike (0 or 1) times any part is exact in the tensor
    core."""
    w = w.float()
    hi = w.to(torch.bfloat16)
    r1 = w - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero (``cvt.rna.tf32.f32``'s rounding), as kernel E's
    ``to_tf32`` does it: add half a TF32 ulp to the bits, clear the 13
    dropped ones; returned as float32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32x2(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operand split of kernel E (``csrc/conv_grad_input.cu``), for the
    cotangent and the weights alike: ``hi = tf32(x)``, ``lo = tf32(x -
    hi)``."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def tf32x3_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product kernel E forms of two float32 operands from their TF32
    parts, ``a_lo*b_hi + a_hi*b_lo + a_hi*b_hi`` (the MMAs' products of
    TF32 values are exact), in float64."""
    a_hi, a_lo = (t.double() for t in split_tf32x2(a))
    b_hi, b_lo = (t.double() for t in split_tf32x2(b))
    return a_lo * b_hi + a_hi * b_lo + a_hi * b_hi
