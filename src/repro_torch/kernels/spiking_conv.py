"""Spike-driven convolution: the wrapper of kernel ``csrc/spiking_conv.cu``,
its plain version, and the padding and skip-table helpers.

``spiking_conv`` computes dV = conv(spikes, w) + bias in NHWC x RRIO with
APRC full padding or SAME padding (the reference's
``repro.kernels.spiking_conv.spiking_conv_pallas``).  Given CPU tensors it
computes through the plain version; given CUDA tensors it launches the
kernel or raises.

The skip table counts *nonzero* inputs, not a value sum: the first layer
feeds the analog direct-coded frame through the same conv, and a faint
block must not be skipped.  The kernel takes its skip per thread block
(one output row-block of one image); ``row_block_counts`` and
``skip_table_fraction`` compute the same table in PyTorch for the model's
``skip_fractions`` and for the tests.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import spiking_conv_ref

__all__ = ["spiking_conv", "spiking_conv_plain", "conv_pads",
           "row_block_counts", "skip_table_fraction", "plan_tiles"]

_MAX_THREADS = 512        # the kernels' __launch_bounds__
_MAX_SMEM = 227 * 1024    # bytes a block may use on sm_90
BLOCK_ROWS = 8            # output rows per thread block (and per skip cell)
# spiking_conv_launch(x, w, b, out, N, H, W, Cin, Cout, R, pad_lo, E_h, E_w,
#                     block_rows, cout_tile, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]

# The plain version is the oracle itself (conv plus bias).
spiking_conv_plain = spiking_conv_ref


def conv_pads(r: int, aprc: bool) -> Tuple[int, int]:
    """(pad_lo, pad_hi) of the forward conv; APRC = full, else SAME."""
    if aprc:
        return r - 1, r - 1
    lo = (r - 1) // 2
    return lo, r - 1 - lo


def plan_tiles(e_w: int, r: int, cin: int, cout: int) -> Tuple[int, int]:
    """(block_rows, cout_tile) of a launch: one thread per output pixel of
    a ``block_rows x E_w`` row-block, each thread owning ``cout_tile``
    consecutive output channels.  Rows shrink from ``BLOCK_ROWS`` only when
    the threads or the shared memory (halo rows plus the weight tile, the
    formula of ``csrc/conv_tile.cuh``) would not fit one block."""
    ct = 4 if cout <= 4 else 8 if cout <= 8 else 16
    w_pad, cin_p = e_w + r - 1, cin | 1
    br = BLOCK_ROWS
    while br >= 1:
        smem = 4 * ((br + r - 1) * w_pad * cin_p + r * r * cin * ct)
        if br * e_w <= _MAX_THREADS and smem <= _MAX_SMEM:
            return br, ct
        br //= 2
    raise ValueError(f"no tiling fits one thread block: E_w={e_w}, R={r}, "
                     f"Cin={cin}")


def _window_counts(row_tot: torch.Tensor, r: int, block_rows: int,
                   n_blocks: int) -> torch.Tensor:
    """counts[b, i] = sum of row_tot[b] over rows [i*br, i*br + br + r - 1)."""
    b = row_tot.shape[0]
    cs = torch.cumsum(row_tot, dim=1)
    cs = torch.cat([cs.new_zeros((b, 1)), cs], dim=1)
    starts = torch.arange(n_blocks, device=row_tot.device) * block_rows
    ends = torch.clamp(starts + block_rows + r - 1, max=row_tot.shape[1])
    return (cs[:, ends] - cs[:, starts]).to(torch.int32)


def row_block_counts(spikes_padded: torch.Tensor, r: int, block_rows: int,
                     n_blocks: int) -> torch.Tensor:
    """counts[b, i] = #nonzero entries in padded input rows
    [i*br, i*br + br + r - 1) — exactly the receptive rows of output
    row-block i."""
    row_tot = spikes_padded.count_nonzero(dim=(2, 3))   # (B, H_pad)
    return _window_counts(row_tot, r, block_rows, n_blocks)


def skip_table_fraction(spikes: torch.Tensor, r: int, *, aprc: bool = True,
                        block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """Fraction of the fused kernel's (T, B, row-block) skip-table cells
    that are skipped (zero receptive spikes), without running the conv.

    ``spikes`` is the (T, B, H, W, Cin) input train of one fused layer.
    The reference pads the train and counts rows of the padded copy; the
    padding rows hold no spikes, so this counts the unpadded rows and
    places them at their padded offsets — the same table, without the
    padded copy."""
    t, b, h, w, cin = spikes.shape
    pad_lo, _ = conv_pads(r, aprc)
    e_h = h + r - 1 if aprc else h
    n_blocks = -(-e_h // block_rows)                  # ceil
    h_pad = n_blocks * block_rows + r - 1
    row_tot = spikes.reshape(t * b, h, w * cin).count_nonzero(dim=2)
    padded = row_tot.new_zeros((t * b, h_pad))
    padded[:, pad_lo:pad_lo + h] = row_tot
    counts = _window_counts(padded, r, block_rows, n_blocks)
    # the reference's mean: the float32 sum times the float32 reciprocal
    inv = torch.tensor(1.0 / counts.numel(), dtype=torch.float32)
    return (counts == 0).float().sum() * inv.to(counts.device)


def _conv_dims(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               aprc: bool, fn: str):
    *_, h, wd, cin = x.shape
    r, r2, cin_w, cout = w.shape
    if r != r2 or cin_w != cin or tuple(b.shape) != (cout,):
        raise ValueError(f"{fn}: input {tuple(x.shape)}, weights "
                         f"{tuple(w.shape)} (R, R, Cin, Cout) and bias "
                         f"{tuple(b.shape)} do not fit together")
    pad_lo, _ = conv_pads(r, aprc)
    e_h, e_w = (h + r - 1, wd + r - 1) if aprc else (h, wd)
    return h, wd, cin, cout, r, pad_lo, e_h, e_w


def spiking_conv(spikes: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 *, aprc: bool = True) -> torch.Tensor:
    """dV = conv(spikes, w) + bias.  spikes: (B, H, W, Cin), B may fold
    T x batch; w: (R, R, Cin, Cout); bias: (Cout,).  Returns
    (B, E_h, E_w, Cout) with E = H+R-1 (APRC) or H (SAME)."""
    if spikes.device.type == "cpu":
        return spiking_conv_plain(spikes, w, bias, aprc=aprc)
    fn = "spiking_conv"
    dev = _build.check_cuda_args(fn, spikes=spikes, w=w, bias=bias)
    if spikes.dim() != 4:
        raise ValueError(f"{fn}: spikes must be (B, H, W, Cin), got "
                         f"{tuple(spikes.shape)}")
    h, wd, cin, cout, r, pad_lo, e_h, e_w = _conv_dims(spikes, w, bias,
                                                      aprc, fn)
    n = spikes.shape[0]
    block_rows, cout_tile = plan_tiles(e_w, r, cin, cout)
    out = torch.empty((n, e_h, e_w, cout), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load("spiking_conv", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.spiking_conv_launch(
            spikes.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            n, h, wd, cin, cout, r, pad_lo, e_h, e_w, block_rows, cout_tile,
            stream)
    _build.check_launch(lib, fn, rc)
    spiking_conv.launches += 1
    return out


spiking_conv.launches = 0
