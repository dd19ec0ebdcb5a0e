"""Spike-driven convolution: the wrappers of kernels ``csrc/spiking_conv.cu``
(the forward, kernel A, in its two modes), ``csrc/conv_grad_input.cu``
(its input gradient) and ``csrc/conv_grad_weights.cu`` (its weight
gradient), their plain versions, the autograd Function that joins them,
and the padding and skip-table helpers.

``spiking_conv`` (A's dV mode) computes dV = conv(spikes, w) + bias in
NHWC x RRIO with APRC full padding or SAME padding (the reference's
``repro.kernels.spiking_conv.spiking_conv_pallas``).
``spiking_conv_lif_hoisted`` (A's hoisted mode) is the hoisted first
layer: dV of the direct-coded frames once, then T steps of LIF on that
constant current (the reference's ``_lif_scan_const`` on
``spiking_conv_pallas``'s output), writing only the spike train, the final
membrane and, for training, the pre-reset membrane; its autograd Function
is ``kernels.spiking_conv_lif.HoistedConvLIFFn``.  Both sum their taps in
the plain path's order and rounding, so on an analog input (the frames)
they give the plain version's bits.  When a gradient is
needed it goes through ``SpikingConvFn`` (the reference's
``kernels/ops.py:_spiking_conv_vjp``): dx by ``conv_grad_input`` (the
reference's ``conv_grad_input_pallas``) when the input needs one, and
(dw, db) by ``conv_grad_weights`` (the reference's XLA
``conv_grad_weights_xla``; on the card a kernel of its own, on the CPU a
torch-op GEMM per tap).  Given CPU tensors every wrapper computes through
its plain version; given CUDA tensors it launches its kernel or raises.

The skip table counts *nonzero* inputs, not a value sum: the first layer
feeds the analog direct-coded frame through the same conv, and a faint
block must not be skipped.  The kernel takes its skip per thread block
(one output row-block of one image); ``row_block_counts`` and
``skip_table_fraction`` compute the same table in PyTorch from a train.

A caller that reports counts asks the hoisted mode (and kernel B,
``kernels.spiking_conv_lif``) for them with ``count=True``: the launch
that fires the train also writes its ``TrainCounts``, the spikes of each
step and channel and of each output row, so that nothing reads the train
again to count it.  ``skip_fraction_from_rows`` finishes the next layer's
skip table from those row counts (kernel ``csrc/skip_table.cu`` on the
card) with ``skip_table_fraction``'s bits.  Launches that count are
counted in ``.launches_counted`` besides ``.launches``; calls of
``skip_table_fraction``, the path for a train no launch counted, in its
``.calls``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (conv_grad_input_ref,
                                     conv_grad_weights_ref, conv_pads,
                                     spiking_conv_ref)

__all__ = ["spiking_conv", "spiking_conv_plain", "SpikingConvFn",
           "spiking_conv_lif_hoisted", "spiking_conv_lif_hoisted_plain",
           "conv_grad_input", "conv_grad_input_plain", "conv_grad_weights",
           "conv_grad_weights_plain", "conv_pads", "row_block_counts",
           "skip_table_blocks", "skip_table_fraction", "TrainCounts",
           "train_counts_plain", "skip_fraction_from_rows", "plan_tiles",
           "MmaPlan", "plan_mma_tiles", "WgradPlan", "plan_wgrad"]

_MAX_THREADS = 512        # the kernels' __launch_bounds__
_MAX_SMEM = 227 * 1024    # bytes a block may use on sm_90
BLOCK_ROWS = 8            # output rows per thread block (and per skip cell)
COUNT_STEPS = 8           # steps of kernel A's count slots (kCountSteps)
MMA_WARPS = 8             # warps of a tensor-core kernel block (mma_tile.cuh)
MMA_TILES = 2             # m16 tiles one warp holds
# the weight gradient (csrc/conv_grad_weights.cu): 16x8 accumulator tiles a
# warp holds (kAccTiles), its accumulation chains at most (two on each of
# an H100's 132 SMs), and a tile's positions and columns at most
WGRAD_ACC_TILES = 20
WGRAD_CHAINS = 264
WGRAD_MAX_POS = 256
WGRAD_MAX_COLS = 64

# The plain versions are the oracles themselves.
spiking_conv_plain = spiking_conv_ref
conv_grad_input_plain = conv_grad_input_ref
conv_grad_weights_plain = conv_grad_weights_ref


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether a call on ``tensors`` has to build an autograd graph."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


@functools.lru_cache(maxsize=None)
def plan_tiles(e_w: int, r: int, cin: int, cout: int) -> Tuple[int, int]:
    """(block_rows, cout_tile) of a launch of kernel A
    (``csrc/spiking_conv.cu``, both modes), the host's mirror of its
    tiling: one thread per output pixel and quad of four channels, a block
    of ``block_rows`` full output rows and ``cout_tile`` channels (a
    multiple of 4; wider layers add channel groups on the grid), at most
    ``_MAX_THREADS`` threads.  The channel tile takes as many quads of a
    row as fit, split evenly over the groups; rows then grow up to
    ``BLOCK_ROWS`` while the threads and the shared memory (halo rows, the
    weight tile and the counting mode's count slots, the formula of the
    source note) fit.  Cached per shape: the wrappers plan every
    call."""
    quads = -(-cout // 4)
    fit = min(quads, _MAX_THREADS // e_w)
    if fit >= 1:
        groups = -(-quads // fit)
        qt = -(-quads // groups)
        w_pad, cin_p = e_w + r - 1, cin | 1
        for br in range(min(BLOCK_ROWS, _MAX_THREADS // (e_w * qt)), 0, -1):
            smem = 4 * ((br + r - 1) * w_pad * cin_p + r * r * cin * 4 * qt
                        + 2 * COUNT_STEPS * (4 * qt + br))
            if smem <= _MAX_SMEM:
                return br, 4 * qt
    raise ValueError(f"no tiling fits one thread block: E_w={e_w}, R={r}, "
                     f"Cin={cin}")


class MmaPlan(NamedTuple):
    """The tiling of one launch of a tensor-core conv kernel (B, C or E)."""
    block_rows: int     # output rows of a block, and of its skip cell
    cout_tile: int      # output channels of a block: n_tiles n8 tiles
    n_tiles: int
    k_pad: int          # Cin padded with zeros to the MMA depth
    m_tiles: int        # m16 tiles over the block's block_rows * E_w pixels
    smem_bytes: int


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def plan_mma_tiles(e_w: int, r: int, cin: int, cout: int, *,
                   split: str = "bf16x3") -> MmaPlan:
    """The tiling of kernels B and C (``split="bf16x3"``: bf16 MMAs on three
    weight planes) or E (``"tf32x3"``: TF32 MMAs on two planes), the
    host's mirror of ``csrc/mma_tile.cuh``'s ``MmaDims``.

    A block takes all of the layer's channels up to 32 (``n_tiles`` <= 4
    n8 tiles; wider layers add groups on the grid) and a row-block of
    ``block_rows x E_w`` pixels in m16 tiles, two a warp, so at most 16
    (256 pixels).  K is Cin padded to 16 (bf16) or 8 (TF32).  Shared
    memory holds the weight planes and the halo rows, each row ``k_pad``
    plus 16 bytes, and for B and C a float32 staging copy of the raw rows
    and the membrane, one float a thread and accumulator site (``smem_bytes``),
    and for B's counting instance two count buffers besides.  Rows shrink
    from ``BLOCK_ROWS`` one at a time until the m-tiles and the shared
    memory fit, and where not even one row fits, the channel group
    shrinks."""
    if split not in ("bf16x3", "tf32x3"):
        raise ValueError(f"unknown operand split {split!r}")
    bf16 = split == "bf16x3"
    kp = _round_up(cin, 16 if bf16 else 8)
    cs = kp + (8 if bf16 else 4)
    w_pad = e_w + r - 1
    planes, elt = (3, 2) if bf16 else (2, 4)
    for nt in range(min(4, -(-cout // 8)), 0, -1):
        for br in range(BLOCK_ROWS, 0, -1):
            halo_pix = (br + r - 1) * w_pad
            m_tiles = -(-br * e_w // 16)
            smem = (planes * r * r * 8 * nt * cs + halo_pix * cs) * elt
            counts = 0
            if bf16:
                smem += 4 * (halo_pix * _round_up(cin, 4)
                             + 32 * MMA_WARPS * MMA_TILES * 4 * nt)
                counts = 4 * 2 * (8 * nt + br)
            if m_tiles <= MMA_WARPS * MMA_TILES and \
                    smem + counts <= _MAX_SMEM:
                return MmaPlan(br, 8 * nt, nt, kp, m_tiles, smem)
    raise ValueError(f"no tiling fits one thread block: E_w={e_w}, R={r}, "
                     f"Cin={cin}, Cout={cout}")


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


def skip_table_blocks(h: int, r: int, *, aprc: bool = True,
                      block_rows: int = BLOCK_ROWS) -> int:
    """Row-blocks of one image and step in the skip table of a fused layer
    whose input is ``h`` rows high: a (T, B)-batch's table has
    T * B * this many cells."""
    e_h = h + r - 1 if aprc else h
    return -(-e_h // block_rows)                      # ceil


def skip_table_fraction(spikes: torch.Tensor, r: int, *, aprc: bool = True,
                        block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """Fraction of the fused kernel's (T, B, row-block) skip-table cells
    that are skipped (zero receptive spikes), without running the conv.

    ``spikes`` is the (T, B, H, W, Cin) input train of one fused layer.
    The reference pads the train and counts rows of the padded copy; the
    padding rows hold no spikes, so this counts the unpadded rows and
    places them at their padded offsets — the same table, without the
    padded copy.  Calls are counted in ``.calls``."""
    skip_table_fraction.calls += 1
    t, b, h, w, cin = spikes.shape
    row_tot = spikes.reshape(t * b, h, w * cin).count_nonzero(dim=2)
    return _skip_fraction(row_tot, r, aprc, block_rows)


skip_table_fraction.calls = 0


def _skip_fraction(row_tot: torch.Tensor, r: int, aprc: bool,
                   block_rows: int) -> torch.Tensor:
    """The skip fraction of the (planes, H) nonzero counts of a train's
    rows: the rows placed at their padded offsets, a window of
    ``block_rows + r - 1`` padded rows a cell."""
    planes, h = row_tot.shape
    pad_lo, _ = conv_pads(r, aprc)
    n_blocks = skip_table_blocks(h, r, aprc=aprc, block_rows=block_rows)
    h_pad = n_blocks * block_rows + r - 1
    padded = row_tot.new_zeros((planes, h_pad))
    padded[:, pad_lo:pad_lo + h] = row_tot
    counts = _window_counts(padded, r, block_rows, n_blocks)
    # the reference's mean: the skipped cells, an exact integer rounded once
    # to float32 (the reference's float32 sum of ones, the same bits below
    # 2^24 cells), times the float32 reciprocal (a 0-d host tensor: a
    # launch argument, no copy to the card); an empty table's mean is NaN
    inv = torch.tensor(1.0 / counts.numel() if counts.numel() else
                       float("nan"), dtype=torch.float32)
    return (counts == 0).sum().float() * inv


class TrainCounts(NamedTuple):
    """The spike counts of a train (T, B, E_h, E_w, C), as the launch that
    fired it writes them (``count=True``)."""
    t: torch.Tensor       # (T, C) int32: the spikes of each step and channel
    rows: torch.Tensor    # (T, B, E_h) int32: those of each output row
    # (2,) int32, zero: the card's finisher's sum and ticket (None: it
    # makes its own)
    scratch: Optional[torch.Tensor] = None


def train_counts_plain(spikes: torch.Tensor) -> TrainCounts:
    """The plain version of the counting launches: torch's reductions of
    the 0/1 train ``spikes`` (T, B, E_h, E_w, C)."""
    return TrainCounts(spikes.count_nonzero(dim=(1, 2, 3)).int(),
                       spikes.count_nonzero(dim=(3, 4)).int())


def _count_buffers(t: int, n: int, e_h: int, cout: int, cout_tile: int,
                   dev: torch.device) -> TrainCounts:
    """A counting launch's outputs in one int32 buffer: the step-channel
    counts and the finisher's scratch zeroed (atomics add to them), the row
    counts too where several channel groups of ``cout_tile`` add to each
    row (one group stores them)."""
    n_t = t * cout
    buf = torch.empty(n_t + 2 + t * n * e_h, dtype=torch.int32, device=dev)
    (buf if cout > cout_tile else buf[:n_t + 2]).zero_()
    return TrainCounts(buf[:n_t].view(t, cout), buf[n_t + 2:].view(t, n, e_h),
                       buf[n_t:n_t + 2])


def skip_fraction_from_rows(counts: TrainCounts, r: int, *,
                            aprc: bool = True,
                            block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """``skip_table_fraction`` of the train whose ``TrainCounts`` these are
    (the input of a fused layer of kernel size ``r``), from its row counts
    alone, with the same bits: on the card kernel ``csrc/skip_table.cu``,
    one launch (counted in ``.launches``); on the CPU its plain version in
    torch ops.  An empty table's fraction is NaN, as the reference's mean
    of no cells, and needs no launch."""
    rows = counts.rows
    t, b, h = rows.shape
    if rows.device.type == "cpu":
        return _skip_fraction(rows.reshape(t * b, h), r, aprc, block_rows)
    fn = "skip_fraction_from_rows"
    n_blocks = skip_table_blocks(h, r, aprc=aprc, block_rows=block_rows)
    cells = t * b * n_blocks
    if cells >= 1 << 31:
        raise ValueError(f"{fn}: {cells} skip-table cells; the finisher "
                         f"counts them in int32")
    scratch = counts.scratch
    if scratch is None:
        scratch = torch.zeros(2, dtype=torch.int32, device=rows.device)
    dev = _build.check_cuda_args(fn, (torch.int32,), rows=rows,
                                 scratch=scratch)
    if cells == 0:
        return torch.full((), float("nan"), device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    pad_lo, _ = conv_pads(r, aprc)
    _build.launch(dev, fn, _build.entry("skip_table"), rows.data_ptr(),
                  scratch.data_ptr(), out.data_ptr(), t * b, h, pad_lo,
                  block_rows, r, n_blocks, 1.0 / cells)
    skip_fraction_from_rows.launches += 1
    return out


skip_fraction_from_rows.launches = 0


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


def _spiking_conv_primal(spikes: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor, aprc: bool) -> torch.Tensor:
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
    _build.launch(dev, fn, _build.entry("spiking_conv"),
                  spikes.data_ptr(), w.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), n, h, wd, cin, cout, r, pad_lo, e_h, e_w,
                  block_rows, cout_tile)
    spiking_conv.launches += 1
    return out


def spiking_conv(spikes: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 *, aprc: bool = True) -> torch.Tensor:
    """dV = conv(spikes, w) + bias.  spikes: (B, H, W, Cin), B may fold
    T x batch; w: (R, R, Cin, Cout); bias: (Cout,).  Returns
    (B, E_h, E_w, Cout) with E = H+R-1 (APRC) or H (SAME).
    Differentiable through ``SpikingConvFn``."""
    if needs_grad(spikes, w, bias):
        return SpikingConvFn.apply(spikes, w, bias, aprc)
    return _spiking_conv_primal(spikes, w, bias, aprc)


spiking_conv.launches = 0


def spiking_conv_lif_hoisted_plain(
        frames: torch.Tensor, v0: torch.Tensor, w: torch.Tensor,
        bias: torch.Tensor, *, t: int, v_th: float = 1.0, aprc: bool = True,
        save_u: bool = False) -> Tuple[torch.Tensor, ...]:
    """The plain version of the hoisted mode: ``spiking_conv_plain``, then
    ``t`` steps of the LIF recurrence on that constant current in
    ``core.snn_model._lif_scan``'s float operations (``v = v + dV``, the
    Heaviside of ``v - v_th``, ``v = v - v_th * s``).  Returns (spike train
    (t, B, E_h, E_w, Cout), final membrane), and with ``save_u`` also the
    pre-reset membrane train u."""
    z = spiking_conv_plain(frames, w, bias, aprc=aprc)
    v, s_seq, u_seq = v0, [], []
    for _ in range(t):
        v = v + z
        u_seq.append(v)
        s = (v - v_th >= 0.0).to(v.dtype)
        v = v - v_th * s
        s_seq.append(s)

    def stack(seq):
        return torch.stack(seq) if seq else z.new_empty((0,) + z.shape)

    if save_u:
        return stack(s_seq), v, stack(u_seq)
    return stack(s_seq), v


def spiking_conv_lif_hoisted(frames: torch.Tensor, v0: torch.Tensor,
                             w: torch.Tensor, bias: torch.Tensor, *, t: int,
                             v_th: float = 1.0, aprc: bool = True,
                             save_u: bool = False, count: bool = False
                             ) -> Tuple[torch.Tensor, ...]:
    """The hoisted first layer (kernel A's hoisted mode): frames (B, H, W,
    Cin), constant over the ``t`` steps; v0 (B, E_h, E_w, Cout) the
    membrane it starts from (the chunk carry).  Returns (spike train (t, B,
    E_h, E_w, Cout), final membrane), and with ``save_u`` (the training
    forward) also the pre-reset membrane train u, or with ``count`` the
    train's ``TrainCounts`` (on the CPU ``train_counts_plain``).  It builds
    no autograd graph: training goes through ``HoistedConvLIFFn``.
    Launches are counted in ``.launches`` (inference, ``.launches_counted``
    those with ``count``) and ``.launches_save_u`` (training forward),
    kernel instances as kernels B and C are."""
    fn = "spiking_conv_lif_hoisted"
    if save_u and count:
        raise ValueError(f"{fn}: save_u and count are two instances; ask "
                         f"for one")
    if frames.dim() != 4:
        raise ValueError(f"{fn}: frames must be (B, H, W, Cin), got "
                         f"{tuple(frames.shape)}")
    h, wd, cin, cout, r, pad_lo, e_h, e_w = _conv_dims(frames, w, bias,
                                                      aprc, fn)
    n = frames.shape[0]
    if tuple(v0.shape) != (n, e_h, e_w, cout):
        raise ValueError(f"{fn}: v0 must be {(n, e_h, e_w, cout)}, got "
                         f"{tuple(v0.shape)}")
    if t < 0:
        raise ValueError(f"{fn}: t must be >= 0, got {t}")
    if frames.device.type == "cpu":
        outs = spiking_conv_lif_hoisted_plain(frames, v0, w, bias, t=t,
                                              v_th=v_th, aprc=aprc,
                                              save_u=save_u)
        return outs + (train_counts_plain(outs[0]),) if count else outs
    dev = _build.check_cuda_args(fn, frames=frames, v0=v0, w=w, bias=bias)
    block_rows, cout_tile = plan_tiles(e_w, r, cin, cout)
    s = torch.empty((t, n, e_h, e_w, cout), dtype=torch.float32, device=dev)
    v = torch.empty_like(v0)
    if save_u:
        outs = (s, v, torch.empty_like(s))
    elif count:
        outs = (s, v, _count_buffers(t, n, e_h, cout, cout_tile, dev))
    else:
        outs = (s, v)
    if t == 0 or v.numel() == 0:
        v.copy_(v0)
        if count:
            outs[2].rows.zero_()
        return outs
    _build.launch(dev, fn, _build.entry(
                      "spiking_conv", "spiking_conv_lif_hoisted_launch"),
                  frames.data_ptr(), v0.data_ptr(), w.data_ptr(),
                  bias.data_ptr(), s.data_ptr(), v.data_ptr(),
                  outs[2].data_ptr() if save_u else None,
                  outs[2].t.data_ptr() if count else None,
                  outs[2].rows.data_ptr() if count else None, t, n, h, wd,
                  cin, cout, r, pad_lo, e_h, e_w, block_rows, cout_tile,
                  float(v_th))
    if save_u:
        spiking_conv_lif_hoisted.launches_save_u += 1
    else:
        spiking_conv_lif_hoisted.launches += 1
        if count:
            spiking_conv_lif_hoisted.launches_counted += 1
    return outs


spiking_conv_lif_hoisted.launches = 0
spiking_conv_lif_hoisted.launches_save_u = 0
spiking_conv_lif_hoisted.launches_counted = 0


def conv_grad_input(dz: torch.Tensor, w: torch.Tensor, *,
                    aprc: bool = True) -> torch.Tensor:
    """d(input) of ``spiking_conv`` from the cotangent of its output.
    dz: (N, E_h, E_w, Cout);  w: (R, R, Cin, Cout) forward weights.
    Returns (N, H, W, Cin)."""
    if dz.device.type == "cpu":
        return conv_grad_input_plain(dz, w, aprc=aprc)
    fn = "conv_grad_input"
    dev = _build.check_cuda_args(fn, dz=dz, w=w)
    if dz.dim() != 4:
        raise ValueError(f"{fn}: dz must be (N, E_h, E_w, Cout), got "
                         f"{tuple(dz.shape)}")
    n, e_h, e_w, cout = dz.shape
    r, r2, cin, cout_w = w.shape
    if r != r2 or cout_w != cout:
        raise ValueError(f"{fn}: cotangent {tuple(dz.shape)} and weights "
                         f"{tuple(w.shape)} (R, R, Cin, Cout) do not fit "
                         f"together")
    lo, hi = conv_pads(r, aprc)
    h, wd = e_h + r - 1 - lo - hi, e_w + r - 1 - lo - hi
    # the backward conv's own roles: its input is dz (Cout channels), its
    # output dx (Cin channels)
    plan = plan_mma_tiles(wd, r, cout, cin, split="tf32x3")
    out = torch.empty((n, h, wd, cin), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    _build.launch(dev, fn, _build.entry("conv_grad_input"),
                  dz.data_ptr(), w.data_ptr(), out.data_ptr(), n, e_h, e_w,
                  cout, cin, r, r - 1 - lo, h, wd, plan.block_rows,
                  plan.cout_tile)
    conv_grad_input.launches += 1
    return out


conv_grad_input.launches = 0


class WgradPlan(NamedTuple):
    """The plan of one call of the weight-gradient kernel
    (``csrc/conv_grad_weights.cu``): what fixes its bits, and its shared
    memory."""
    block_rows: int     # a tile: block_rows x block_cols output positions
    block_cols: int
    tap_groups: int     # groups of warps the R*R taps and the bias go to
    chains: int         # accumulation chains, summed in order at the end
    tiles: int
    m_tiles: int        # m16 tiles of a block's input channels: 1 or 2
    n_tiles: int        # n8 tiles of its output channels: 1, 2 or 4
    smem_bytes: int


def _wgrad_smem(br: int, bc: int, r: int, cin: int, cout: int,
                tap_groups: int, mt: int, nt: int, analog: bool) -> int:
    """The kernel's ``Layout``: the tap tables, then two raw float32
    stagings of a tile (the halo and the dz rows), then one region for
    (spike instance) the bf16 halo and dz planes or, at a chain's end, the
    warps' sums."""
    halo = (br + r - 1) * (bc + r - 1)
    tables = _round_up(8 * r * r, 16)
    red = (min(tap_groups, MMA_WARPS) * (WGRAD_ACC_TILES // (mt * nt))
           * mt * nt * 128 * 4)
    raw = 4 * (halo * _round_up(cin, 4) + _round_up(br * bc * cout, 4))
    xcs = _round_up(cin, 16) + 8
    zcs = 8 * ((3 * _round_up(cout, 8) // 8) | 1)
    staged = 0 if analog else 2 * (halo * xcs + _round_up(br * bc, 16) * zcs)
    return tables + 2 * raw + max(staged, red)


@functools.lru_cache(maxsize=None)
def plan_wgrad(n: int, e_h: int, e_w: int, r: int, cin: int, cout: int, *,
               analog: bool = False) -> WgradPlan:
    """The plan of the weight gradient of a conv with ``n`` images of
    ``e_h x e_w`` output positions, R x R taps, ``cin`` and ``cout``
    channels: the host's mirror of ``csrc/conv_grad_weights.cu``'s
    ``Plan``.

    A warp holds ``WGRAD_ACC_TILES`` 16x8 accumulator tiles: the m16 tiles
    of up to 32 input channels times the n8 tiles of up to 32 output
    channels times its tap slots.  The R*R taps and the bias go to the
    fewest tap groups (1, 2, 4 or 8 groups of the 8 warps, or more across
    the grid) whose slots fit; the warps of a group share a tile's k16
    steps.  A tile is whole rows up to ``WGRAD_MAX_COLS`` wide (a wider
    row splits evenly), as many rows as keep it to ``WGRAD_MAX_POS``
    positions and its shared memory to one block's (the accumulators take
    the registers of an SM, so one block runs on each).  The tiles go to
    up to ``WGRAD_CHAINS`` chains.  Cached per shape."""
    if min(cin, cout, r, e_h, e_w) < 1:
        raise ValueError(f"no weight-gradient plan for E={e_h}x{e_w}, "
                         f"R={r}, Cin={cin}, Cout={cout}")
    mt = 1 if cin <= 16 else 2
    nt = 1 if cout <= 8 else (2 if cout <= 16 else 4)
    need = -(-(r * r + 1) // (WGRAD_ACC_TILES // (mt * nt)))
    tap_groups = next((g for g in (1, 2, 4) if g >= need),
                      MMA_WARPS * -(-need // MMA_WARPS))
    bc = -(-e_w // -(-e_w // WGRAD_MAX_COLS))
    rows = range(min(e_h, max(1, WGRAD_MAX_POS // bc)), 0, -1)

    def smem(br):
        return _wgrad_smem(br, bc, r, cin, cout, tap_groups, mt, nt, analog)

    br = next((b for b in rows if smem(b) <= _MAX_SMEM), None)
    if br is None:
        raise ValueError(f"no weight-gradient tile fits one thread block: "
                         f"E_w={e_w}, R={r}, Cin={cin}, Cout={cout}")
    tiles = n * -(-e_h // br) * -(-e_w // bc)
    return WgradPlan(br, bc, tap_groups, min(tiles, WGRAD_CHAINS), tiles,
                     mt, nt, smem(br))


def _launch_wgrad(x: torch.Tensor, dz: torch.Tensor, aprc: bool, r: int,
                  binary: bool, max_blocks: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weight-gradient kernel on CUDA tensors: two launches (the tiles,
    then the chains' sum in order).  ``max_blocks`` caps the persistent
    blocks (0: as many as fit the card); the bits do not depend on it."""
    fn = "conv_grad_weights"
    if x.dim() != 4 or dz.dim() != 4:
        raise ValueError(f"{fn}: x must be (N, H, W, Cin) and dz (N, E_h, "
                         f"E_w, Cout), got {tuple(x.shape)} and "
                         f"{tuple(dz.shape)}")
    n, h, wd, cin = x.shape
    cout = dz.shape[3]
    lo, hi = conv_pads(r, aprc)
    e_h, e_w = h + lo + hi - r + 1, wd + lo + hi - r + 1
    if r < 1 or tuple(dz.shape[:3]) != (n, e_h, e_w) or min(cin, cout) < 1:
        raise ValueError(f"{fn}: input {tuple(x.shape)} and cotangent "
                         f"{tuple(dz.shape)} do not fit an R={r} conv "
                         f"(aprc={aprc}) with Cin, Cout >= 1")
    dev = _build.check_cuda_args(fn, x=x, dz=dz)
    dw = torch.empty((r, r, cin, cout), dtype=torch.float32, device=dev)
    db = torch.empty((cout,), dtype=torch.float32, device=dev)
    if n * e_h * e_w == 0:
        return dw.zero_(), db.zero_()
    plan = plan_wgrad(n, e_h, e_w, r, cin, cout, analog=not binary)
    partial = torch.empty((plan.chains, dw.numel() + cout),
                          dtype=torch.float32, device=dev)
    _build.launch(dev, fn, _build.entry("conv_grad_weights"),
                  x.data_ptr(), dz.data_ptr(), partial.data_ptr(),
                  dw.data_ptr(), db.data_ptr(), n, h, wd, cin, cout, r, lo,
                  e_h, e_w, plan.block_rows, plan.block_cols,
                  plan.tap_groups, plan.chains, max_blocks, int(not binary))
    conv_grad_weights.launches += 1
    if not binary:
        conv_grad_weights.launches_analog += 1
    return dw, db


def conv_grad_weights(x: torch.Tensor, dz: torch.Tensor, *, aprc: bool,
                      r: int, binary: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dL/dw, dL/db) of the forward conv (``spiking_conv``, the fused
    layers, the hoisted first layer) from its input ``x`` (N, H, W, Cin)
    and its output cotangent ``dz`` (N, E_h, E_w, Cout).  Returns dw (R, R,
    Cin, Cout) and db (Cout,).

    On CPU tensors the plain version (``conv_grad_weights_plain``: a
    torch-op GEMM per tap, the reference's ``conv_grad_weights_xla``); on
    CUDA tensors kernel ``csrc/conv_grad_weights.cu`` or it raises.
    ``binary`` is the caller's word, by its layer type, that ``x`` is a
    spike train: it takes the tensor-core instance, which still takes the
    analog route for a tile that is not all 0 and 1; otherwise the analog
    instance, right for any input.  Launches are counted in ``.launches``,
    those of the analog instance in ``.launches_analog`` besides.  The call
    is the span ``train.wgrad``, timed on the device (``obs.spans``)."""
    with obs.span("train.wgrad", device=dz):
        if dz.device.type == "cpu":
            return conv_grad_weights_plain(x, dz, aprc=aprc, r=r)
        return _launch_wgrad(x, dz, aprc, r, binary)


conv_grad_weights.launches = 0
conv_grad_weights.launches_analog = 0


class SpikingConvFn(torch.autograd.Function):
    """``spiking_conv`` under autograd: the forward kernel (A), then in the
    backward dx by ``conv_grad_input`` (E) when the input needs it and
    (dw, db) by ``conv_grad_weights`` on the spike train's instance."""

    @staticmethod
    def forward(ctx, spikes, w, bias, aprc):
        ctx.aprc = aprc
        ctx.save_for_backward(spikes, w)
        return _spiking_conv_primal(spikes.detach(), w.detach(),
                                    bias.detach(), aprc)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        spikes, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv_grad_input(g, w, aprc=ctx.aprc)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = conv_grad_weights(spikes, g, aprc=ctx.aprc,
                                       r=w.shape[0], binary=True)
        return dx, dw, db, None
