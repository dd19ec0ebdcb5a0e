"""The paper's two spiking networks, built from ``SNNConfig``.

  classification : 28x28-16c-32c-8c-10   (MNIST, §IV)
  segmentation   : 160x80x3-8C3-16C3-32C3-32C3-16C3-1C3-160x80x1 (MLND-Capstone)

Two execution orders, selected by ``snn_apply(..., backend=...)``:

``backend="ref"`` (timestep-outer): a loop over ``T`` timesteps; every conv
layer is a spiking LIF layer; the head (dense classifier / final conv mask)
accumulates membrane potential without firing.

``backend="batched"`` / ``backend="hopper"`` (layer-outer, time-batched):
each layer processes the whole (T, B) spatio-temporal block before the next
layer starts.  The convolution is time-invariant, so it runs once over the
folded ``T*B`` batch; only the elementwise LIF recurrence loops over ``T``.
Direct-coded input is constant over ``T``, so the first-layer conv is
hoisted out of the time loop entirely.  ``"batched"`` stays in plain
PyTorch ops; ``"hopper"`` runs the hand-written kernels: the hoisted
first-layer conv through ``kernels.spiking_conv`` and every deeper conv
layer through the fused ``kernels.spiking_conv_lif`` (time loop inside the
kernel, membrane in registers).  Given CPU tensors the kernel wrappers
compute through their plain versions, so ``"hopper"`` runs here too.
Under autograd both wrappers go through their ``autograd.Function``s
(surrogate BPTT with the selected surrogate, on the backward kernels), so
all three backends train to the same gradient.

Both orders compute the same math and also count per-layer per-channel
spikes, the actual-workload signal CBWS/balance evaluation consumes (paper
Fig. 2/7).  Whole-T execution is one chunk started from the zero carry,
and every readout is a sequential loop over t, so a chunked run only
has to thread the carry.

This is the counterpart of ``repro.core.snn_model``: same layouts (NHWC,
RRIO conv weights, (din, dout) dense weights), same names, same outputs.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.config import SNNConfig
from repro_torch.core import snn_layers as L
from repro_torch.core.neuron import LIFState
from repro_torch.core.surrogate import spike_fn
from repro_torch.device import resolve_device

__all__ = ["init_snn", "snn_apply", "SNNOutputs", "layer_shapes",
           "SNN_BACKENDS", "ChunkCarry", "ChunkOutputs", "init_chunk_carry",
           "chunk_lengths", "snn_apply_chunk", "snn_apply_chunked",
           "finalize_logits", "freeze_params", "SNN"]

SNN_BACKENDS = ("ref", "batched", "hopper")


class ChunkCarry(NamedTuple):
    """Per-layer state threaded between timestep chunks.

    ``conv_v``    — membrane per *spiking* conv layer (the segmentation
                    readout conv is non-firing and lives in ``readout_v``);
    ``dense_v``   — membrane per hidden (spiking) dense layer;
    ``readout_v`` — the non-firing readout accumulator: (B, head) for the
                    classifier, the grown-resolution (B, E_h, E_w, Cout)
                    membrane (pre-APRC-crop) for the segmentation head.
    """

    conv_v: Tuple[torch.Tensor, ...]
    dense_v: Tuple[torch.Tensor, ...]
    readout_v: torch.Tensor


class SNNOutputs(NamedTuple):
    logits: torch.Tensor          # (B, classes) or (B, H, W, 1) mask logits
    spike_counts: Tuple[torch.Tensor, ...]     # per conv layer: (Cout,)
    spike_totals: Tuple[torch.Tensor, ...]     # per conv layer: scalar
    timestep_counts: Tuple[torch.Tensor, ...]  # per conv layer: (T, Cout)
    # per fused conv layer of the hopper backend: scalar fraction of
    # (T, B, row-block) skip-table cells skipped
    # (kernels.spiking_conv.skip_table_fraction); empty on ref/batched
    skip_fractions: Tuple[torch.Tensor, ...] = ()


class ChunkOutputs(NamedTuple):
    """Per-chunk observability outputs (the SNNOutputs fields that make
    sense for a T-segment; logits exist once the run finalizes —
    ``finalize_logits`` divides the carried accumulator by the served T)."""

    spike_counts: Tuple[torch.Tensor, ...]     # per conv layer: (Cout,)
    spike_totals: Tuple[torch.Tensor, ...]     # per conv layer: scalar
    timestep_counts: Tuple[torch.Tensor, ...]  # per conv layer: (t_chunk, Cout)
    skip_fractions: Tuple[torch.Tensor, ...] = ()


def layer_shapes(cfg: SNNConfig) -> List[Tuple[int, int, int]]:
    """(H, W, C) after every conv layer (APRC growth accounted)."""
    h, w = cfg.input_hw
    shapes = []
    for cout in cfg.conv_channels:
        h, w = L.conv_out_hw(h, w, cfg.kernel_size, cfg.aprc)
        shapes.append((h, w, cout))
    return shapes


def chunk_lengths(t_total: int, chunk_timesteps: int) -> List[int]:
    """Partition ``t_total`` into segments of ``chunk_timesteps`` (the last
    segment carries the remainder)."""
    c = int(chunk_timesteps)
    if c < 1:
        raise ValueError(f"chunk_timesteps must be >= 1, got {chunk_timesteps}")
    if t_total < 1:
        raise ValueError(f"t_total must be >= 1, got {t_total}")
    return [c] * (t_total // c) + ([t_total % c] if t_total % c else [])


def init_chunk_carry(cfg: SNNConfig, batch: int, dtype=torch.float32,
                     device=None) -> ChunkCarry:
    """The zero carry a fresh request starts from (whole-T execution is
    exactly one chunk started from this), on ``device`` (default: the
    card)."""
    dev = resolve_device(device)
    shapes = layer_shapes(cfg)
    head_dim = cfg.dense_units[-1] if cfg.dense_units else None
    n_spiking = len(shapes) if head_dim is not None else len(shapes) - 1

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    conv_v = tuple(zeros(batch, *shapes[i]) for i in range(n_spiking))
    dense_v = tuple(zeros(batch, d) for d in cfg.dense_units[:-1])
    if head_dim is not None:
        readout_v = zeros(batch, head_dim)
    else:
        readout_v = zeros(batch, *shapes[-1])
    return ChunkCarry(conv_v=conv_v, dense_v=dense_v, readout_v=readout_v)


def finalize_logits(readout_v: torch.Tensor, cfg: SNNConfig,
                    t_total: int) -> torch.Tensor:
    """Carried readout accumulator -> logits: APRC center-crop (segmentation
    head) then divide by the served timestep count."""
    v = readout_v
    if not cfg.dense_units and cfg.aprc:
        h0, w0 = cfg.input_hw
        H, W = v.shape[-3], v.shape[-2]
        dh, dw = (H - h0) // 2, (W - w0) // 2
        v = v[..., dh:dh + h0, dw:dw + w0, :]
    return v / t_total


def init_snn(generator: torch.Generator, cfg: SNNConfig, *,
             device=None) -> Dict:
    """Random parameters from ``generator`` (a CPU ``torch.Generator``), in
    the reference's dict layout ``{"conv": [{"w", "b"}], "dense": [...]}``,
    on ``device`` (default: the card)."""
    dev = resolve_device(device)
    params: Dict = {"conv": [], "dense": []}
    cin = cfg.input_channels
    for cout in cfg.conv_channels:
        params["conv"].append(L.init_conv(cfg.kernel_size, cin, cout,
                                          generator=generator, device=dev))
        cin = cout
    if cfg.dense_units:
        h, w, c = layer_shapes(cfg)[-1]
        din = h * w * c
        for dout in cfg.dense_units:
            params["dense"].append(L.init_dense(din, dout,
                                                generator=generator,
                                                device=dev))
            din = dout
    return params


def freeze_params(params: Dict) -> Dict:
    """``params`` for many forwards that neither change them nor take a
    gradient (the serving cache): each dense layer also holds its
    exact-grid weights (``snn_layers.with_exact_grid``), computed here
    once instead of in every forward."""
    with torch.no_grad():
        return {**params, "dense": [L.with_exact_grid(dp)
                                    for dp in params["dense"]]}


def snn_apply(params: Dict, frames: torch.Tensor, cfg: SNNConfig,
              *, surrogate_alpha: float = 10.0,
              surrogate_kind: str = "fast_sigmoid", backend: str = "ref",
              schedule: Optional[Sequence] = None) -> SNNOutputs:
    """frames: (B, H, W, Cin) analog input in [0,1] (direct coding) or a
    pre-encoded spike train (T, B, H, W, Cin), on the parameters' device.

    backend: "ref" (timestep-outer loop), "batched" (time-batched layer
    pipeline, plain ops) or "hopper" (time-batched through the hand-written
    kernels).  ``schedule`` (a ``core.scheduler.build_schedule`` result)
    routes the hopper backend through CBWS-permuted weights; outputs are
    reported in canonical channel order regardless.
    """
    if frames.shape[-1] != cfg.input_channels:
        # the batched path's single-channel implicit-GEMM conv would
        # silently slice extra channels away; fail loudly here instead
        raise ValueError(
            f"frames carry {frames.shape[-1]} channels but the config "
            f"expects input_channels={cfg.input_channels} "
            f"(frames shape {tuple(frames.shape)})")
    if backend in ("batched", "hopper"):
        return _apply_time_batched(
            params, frames, cfg, surrogate_alpha=surrogate_alpha,
            surrogate_kind=surrogate_kind,
            use_kernels=(backend == "hopper"), schedule=schedule)
    if backend != "ref":
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {SNN_BACKENDS}")
    if frames.dim() == 4:
        z_in = frames.unsqueeze(0).expand((cfg.timesteps,) + frames.shape)
    else:
        z_in = frames
    B = z_in.shape[1]
    carry = init_chunk_carry(cfg, B, z_in.dtype, z_in.device)
    counts, t_counts, carry = _apply_ref_chunk(
        params, z_in, cfg, carry, surrogate_alpha=surrogate_alpha,
        surrogate_kind=surrogate_kind)
    return SNNOutputs(
        logits=finalize_logits(carry.readout_v, cfg, cfg.timesteps),
        spike_counts=tuple(counts),
        spike_totals=tuple(c.sum() for c in counts),
        timestep_counts=tuple(t_counts),
    )


def _apply_ref_chunk(params: Dict, z_chunk: torch.Tensor, cfg: SNNConfig,
                     carry: ChunkCarry, *, surrogate_alpha: float,
                     surrogate_kind: str):
    """One timestep segment of the reference (timestep-outer) path.

    ``z_chunk`` is a (t, B, H, W, Cin) slice; LIF/readout state enters and
    leaves through ``carry``.  Returns (per-layer spike counts for the
    chunk, per-layer (t, Cout) timestep counts, new carry)."""
    B = z_chunk.shape[1]
    n_conv = len(cfg.conv_channels)
    shapes = layer_shapes(cfg)
    head_dim = cfg.dense_units[-1] if cfg.dense_units else None
    dev = z_chunk.device

    conv_s = [LIFState(v=v) for v in carry.conv_v]
    if head_dim is None:
        # segmentation: the non-firing readout conv's membrane is the
        # readout accumulator
        conv_s = conv_s + [LIFState(v=carry.readout_v)]
    dense_s = [LIFState(v=v) for v in carry.dense_v]
    dense_p = [L.with_exact_grid(dp) for dp in params["dense"]]
    v_out = carry.readout_v
    cnts = [torch.zeros((c,), dtype=torch.float32, device=dev)
            for (_, _, c) in shapes]
    t_counts: List[List[torch.Tensor]] = [[] for _ in range(n_conv)]

    for z_t in z_chunk:
        x = z_t
        for i in range(n_conv):
            if i == n_conv - 1 and head_dim is None:
                # segmentation: last conv is the non-firing readout
                z = L.conv2d(x, params["conv"][i]["w"], aprc=cfg.aprc) \
                    + params["conv"][i]["b"]
                v = conv_s[i].v + z
                conv_s[i] = LIFState(v=v)
                s = (v >= cfg.v_threshold).to(v.dtype)  # mask spikes (metric only)
                x = v
            else:
                conv_s[i], s = L.spiking_conv_step(
                    params["conv"][i], conv_s[i], x, aprc=cfg.aprc,
                    v_th=cfg.v_threshold, surrogate_alpha=surrogate_alpha,
                    surrogate_kind=surrogate_kind)
                x = s
            s_t = s.sum(dim=(0, 1, 2))
            cnts[i] = cnts[i] + s_t
            t_counts[i].append(s_t)
        if head_dim is not None:
            x = x.reshape(B, -1)
            for j, dp in enumerate(dense_p[:-1]):
                dense_s[j], x = L.spiking_dense_step(
                    dp, dense_s[j], x, v_th=cfg.v_threshold,
                    surrogate_alpha=surrogate_alpha,
                    surrogate_kind=surrogate_kind)
            v_out = v_out + L.dense(x, dense_p[-1])
        else:
            v_out = x  # running readout membrane (already accumulated)

    new_carry = ChunkCarry(
        conv_v=tuple(st.v for st in conv_s[:len(carry.conv_v)]),
        dense_v=tuple(st.v for st in dense_s),
        readout_v=(conv_s[-1].v if head_dim is None else v_out))
    return cnts, [torch.stack(c) for c in t_counts], new_carry


def _lif_scan(z_seq, v_th: float, alpha: float, kind: str,
              v0: torch.Tensor, *, const_t: int = 0):
    """LIF recurrence over a current train z_seq (T, B, ...), or over the
    constant current z_seq (B, ...) for ``const_t`` steps (the hoisted first
    layer).  Returns (spike train (T, ...), per-step channel counts
    (T, C), final membrane); ``v0`` seeds the membrane (the chunk carry)."""
    zs = [z_seq] * const_t if const_t else z_seq
    v, s_seq, cnt = v0, [], []
    for z in zs:
        v = v + z
        s = spike_fn(v - v_th, alpha, kind)
        v = v - v_th * s
        s_seq.append(s)
        cnt.append(s.sum(dim=tuple(range(s.dim() - 1))))
    return torch.stack(s_seq), torch.stack(cnt), v


def _conv_plain(x: torch.Tensor, p: Dict, aprc: bool) -> torch.Tensor:
    """Synaptic-current conv, plain path (``snn_layers.conv2d``: a row's
    bits do not depend on its batch)."""
    return L.conv2d(x, p["w"], aprc=aprc) + p["b"]


def _conv_folded(x_seq: torch.Tensor, p: Dict, cfg: SNNConfig,
                 use_kernels: bool) -> torch.Tensor:
    """Time-batched synaptic current: fold (T, B) -> T*B and convolve once."""
    from repro_torch.kernels.spiking_conv import spiking_conv
    t, b = x_seq.shape[:2]
    x = x_seq.reshape((t * b,) + x_seq.shape[2:])
    if use_kernels:
        z = spiking_conv(x.contiguous(), p["w"].contiguous(),
                         p["b"].contiguous(), aprc=cfg.aprc)
    else:
        z = _conv_plain(x, p, cfg.aprc)
    return z.reshape((t, b) + z.shape[1:])


def _apply_time_batched(params: Dict, frames: torch.Tensor, cfg: SNNConfig,
                        *, surrogate_alpha: float, surrogate_kind: str,
                        use_kernels: bool,
                        schedule: Optional[Sequence]) -> SNNOutputs:
    """Layer-outer execution: each layer consumes the whole (T, B) block.
    Whole-T is exactly one chunk of ``_time_batched_chunk`` started from the
    zero carry."""
    hoist = frames.dim() == 4
    if hoist:
        T, B = cfg.timesteps, frames.shape[0]
    else:
        T, B = frames.shape[0], frames.shape[1]
    carry = init_chunk_carry(cfg, B, frames.dtype, frames.device)
    counts_t, skips, carry = _time_batched_chunk(
        params, frames, cfg, surrogate_alpha=surrogate_alpha,
        surrogate_kind=surrogate_kind, use_kernels=use_kernels,
        schedule=schedule, carry=carry, t_chunk=T)
    return SNNOutputs(
        logits=finalize_logits(carry.readout_v, cfg, cfg.timesteps),
        spike_counts=tuple(c.sum(dim=0) for c in counts_t),
        spike_totals=tuple(c.sum() for c in counts_t),
        timestep_counts=tuple(counts_t),
        skip_fractions=tuple(skips),
    )


def _time_batched_chunk(params: Dict, frames: torch.Tensor, cfg: SNNConfig,
                        *, surrogate_alpha: float, surrogate_kind: str,
                        use_kernels: bool, schedule: Optional[Sequence],
                        carry: ChunkCarry, t_chunk: int):
    """One timestep segment of the layer-outer pipeline.

    ``frames`` is either the (B, H, W, Cin) direct-coded input (constant
    over T — the hoisted first-layer conv is recomputed per chunk) or a
    (t_chunk, B, ...) spike-train slice.  All per-layer LIF membranes and
    the readout accumulator enter/leave via ``carry``; the readouts are
    sequential loops over t.  Returns (per-layer (t_chunk, Cout) counts,
    per-fused-layer skip fractions, new carry)."""
    from repro_torch.kernels.spiking_conv import (skip_table_fraction,
                                                  spiking_conv)
    from repro_torch.kernels.spiking_conv_lif import spiking_conv_lif

    T = t_chunk
    hoist = frames.dim() == 4
    B = frames.shape[0] if hoist else frames.shape[1]
    n_conv = len(cfg.conv_channels)
    head_dim = cfg.dense_units[-1] if cfg.dense_units else None
    v_th = cfg.v_threshold

    inv_perms: List[Optional[torch.Tensor]] = [None] * n_conv
    if use_kernels and schedule is not None:
        from repro_torch.core.scheduler import permute_conv_params
        params = permute_conv_params(params, list(schedule))
        inv_perms = [torch.as_tensor(s.out_perm, device=frames.device)
                     .argsort() for s in schedule]

    counts_t: List[torch.Tensor] = []      # per layer (t_chunk, Cout)
    skips: List[torch.Tensor] = []         # per fused layer: skip-cell fraction
    new_conv_v: List[torch.Tensor] = []    # per spiking conv layer: final v
    new_dense_v: List[torch.Tensor] = []   # per hidden dense layer: final v
    new_readout = carry.readout_v
    x = frames                             # (B,...) analog | (t,B,...) spikes

    def note_skip(train, r):
        # observability: the fused kernel's skip-table sparsity, computed on
        # the train the kernel sees
        if use_kernels and train.dim() == 5:
            skips.append(skip_table_fraction(train, r, aprc=cfg.aprc))

    for i in range(n_conv):
        p = params["conv"][i]
        w, b = p["w"].contiguous(), p["b"].contiguous()
        if i == n_conv - 1 and head_dim is None:
            # segmentation: non-firing conv readout — membrane accumulates
            # via a sequential loop over t
            if hoist and i == 0:        # degenerate single-layer net
                x = x.unsqueeze(0).expand((T,) + x.shape)
                hoist = False
            note_skip(x, w.shape[0])
            z = _conv_folded(x, p, cfg, use_kernels)
            v, cnt = carry.readout_v, []
            for z_t in z:
                v = v + z_t
                cnt.append((v >= v_th).to(z_t.dtype).sum(dim=(0, 1, 2)))
            new_readout, cnt = v, torch.stack(cnt)
        elif hoist and i == 0:
            # direct coding: input constant over T -> conv once, reuse
            if use_kernels:
                z1 = spiking_conv(x.contiguous(), w, b, aprc=cfg.aprc)
            else:
                z1 = _conv_plain(x, p, cfg.aprc)
            s, cnt, v_fin = _lif_scan(z1, v_th, surrogate_alpha,
                                      surrogate_kind, carry.conv_v[i],
                                      const_t=T)
            new_conv_v.append(v_fin)
            x = s
        else:
            if use_kernels:
                x = x.contiguous()
                note_skip(x, w.shape[0])
                s, v_fin = spiking_conv_lif(
                    x, carry.conv_v[i].contiguous(), w, b, v_th=float(v_th),
                    aprc=cfg.aprc, surrogate_alpha=surrogate_alpha,
                    surrogate_kind=surrogate_kind)
                cnt = s.sum(dim=(1, 2, 3))
            else:
                z = _conv_folded(x, p, cfg, use_kernels)
                s, cnt, v_fin = _lif_scan(z, v_th, surrogate_alpha,
                                          surrogate_kind, carry.conv_v[i])
            new_conv_v.append(v_fin)
            x = s
        if inv_perms[i] is not None:
            cnt = cnt[:, inv_perms[i]]
        counts_t.append(cnt.float())

    if head_dim is not None:
        # each dense layer's product for the whole chunk in one GEMM (its
        # rows are exact, so folding T into the rows changes no bit), then
        # the recurrences as sequential loops over t
        def folded(x_seq, dp):
            return L.dense(x_seq.reshape(T * B, -1), dp).reshape(T, B, -1)

        dense_p = [L.with_exact_grid(dp) for dp in params["dense"]]
        for j, dp in enumerate(dense_p[:-1]):
            v, xs = carry.dense_v[j], []
            for z_t in folded(x, dp):
                v = v + z_t
                s = spike_fn(v - v_th, surrogate_alpha, surrogate_kind)
                v = v - v_th * s
                xs.append(s)
            new_dense_v.append(v)
            x = torch.stack(xs)
        # readout accumulates, never fires: a sequential loop over t, not a
        # sum over the T axis, so a chunked run adds in the same order
        acc = carry.readout_v
        for z_t in folded(x, dense_p[-1]):
            acc = acc + z_t
        new_readout = acc

    return counts_t, skips, ChunkCarry(conv_v=tuple(new_conv_v),
                                       dense_v=tuple(new_dense_v),
                                       readout_v=new_readout)


def snn_apply_chunk(params: Dict, frames: torch.Tensor, carry: ChunkCarry,
                    cfg: SNNConfig, *, t_chunk: int,
                    surrogate_alpha: float = 10.0,
                    surrogate_kind: str = "fast_sigmoid",
                    backend: str = "batched",
                    schedule: Optional[Sequence] = None,
                    ) -> Tuple[ChunkOutputs, ChunkCarry]:
    """One timestep chunk of the network, any backend.

    ``frames`` is the (B, H, W, Cin) direct-coded input (constant over T)
    or a (t_chunk, B, ...) pre-encoded spike-train slice, on the device of
    ``carry``.  Returns the chunk's observability outputs and the updated
    carry; chained over a partition of T, the final carry is bit-identical
    to the whole-T run's internal state (``finalize_logits(carry.readout_v,
    cfg, T)`` reproduces its logits exactly).  This is what the serving
    engine runs per (bucket, backend, t_chunk) for chunk-boundary
    rescheduling."""
    if backend in ("batched", "hopper"):
        counts_t, skips, carry = _time_batched_chunk(
            params, frames, cfg, surrogate_alpha=surrogate_alpha,
            surrogate_kind=surrogate_kind, use_kernels=(backend == "hopper"),
            schedule=schedule, carry=carry, t_chunk=t_chunk)
    elif backend == "ref":
        if frames.dim() == 4:
            z = frames.unsqueeze(0).expand((t_chunk,) + frames.shape)
        else:
            z = frames
        _, counts_t, carry = _apply_ref_chunk(
            params, z, cfg, carry, surrogate_alpha=surrogate_alpha,
            surrogate_kind=surrogate_kind)
        skips = []
    else:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {SNN_BACKENDS}")
    return ChunkOutputs(
        spike_counts=tuple(c.sum(dim=0) for c in counts_t),
        spike_totals=tuple(c.sum() for c in counts_t),
        timestep_counts=tuple(counts_t),
        skip_fractions=tuple(skips),
    ), carry


def snn_apply_chunked(params: Dict, frames: torch.Tensor, cfg: SNNConfig,
                      *, chunk_timesteps: int,
                      surrogate_alpha: float = 10.0,
                      surrogate_kind: str = "fast_sigmoid",
                      backend: str = "batched",
                      schedule: Optional[Sequence] = None) -> SNNOutputs:
    """Chunked run: T in segments of ``chunk_timesteps`` with the
    membrane/readout state carried between segments.

    Bit-identical to the whole-T ``snn_apply`` for every partition of T:
    every T-recurrence is sequential per element, the readouts are
    sequential loops, and the hoisted first-layer conv is deterministic,
    so chunk boundaries change nothing but where the carry is held.
    ``timestep_counts`` are the chunks' counts concatenated along T; spike
    counts/totals are their (integer-exact) sums; ``skip_fractions`` is the
    chunk-length-weighted mean."""
    hoist = frames.dim() == 4
    t_total = cfg.timesteps if hoist else frames.shape[0]
    B = frames.shape[0] if hoist else frames.shape[1]
    carry = init_chunk_carry(cfg, B, frames.dtype, frames.device)
    parts: List[ChunkOutputs] = []
    t_done = 0
    for c in chunk_lengths(t_total, chunk_timesteps):
        xin = frames if hoist else frames[t_done:t_done + c]
        out, carry = snn_apply_chunk(
            params, xin, carry, cfg, t_chunk=c,
            surrogate_alpha=surrogate_alpha, surrogate_kind=surrogate_kind,
            backend=backend, schedule=schedule)
        parts.append(out)
        t_done += c
    timestep_counts = tuple(
        torch.cat([p.timestep_counts[i] for p in parts], dim=0)
        for i in range(len(parts[0].timestep_counts)))
    skip_fractions: Tuple[torch.Tensor, ...] = ()
    if parts[0].skip_fractions:
        weights = [p.timestep_counts[0].shape[0] / t_total for p in parts]
        skip_fractions = tuple(
            sum(w * p.skip_fractions[j] for w, p in zip(weights, parts))
            for j in range(len(parts[0].skip_fractions)))
    return SNNOutputs(
        logits=finalize_logits(carry.readout_v, cfg, cfg.timesteps),
        spike_counts=tuple(c.sum(dim=0) for c in timestep_counts),
        spike_totals=tuple(c.sum() for c in timestep_counts),
        timestep_counts=timestep_counts,
        skip_fractions=skip_fractions,
    )


class SNN(nn.Module):
    """The network as a module that owns its parameters.

    ``params`` (the ``init_snn`` / ``interop.from_jax_params`` dict) is
    moved to ``device`` (default: the card); without it the parameters are
    drawn from ``generator``.  ``forward`` is ``snn_apply`` on them."""

    def __init__(self, cfg: SNNConfig, params: Optional[Dict] = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        if params is None:
            if generator is None:
                raise ValueError("SNN needs params or a torch.Generator")
            params = init_snn(generator, cfg, device=dev)
        self.cfg = cfg

        def plist(layers, key):
            return nn.ParameterList(
                nn.Parameter(p[key].detach().to(dev)) for p in layers)

        self.conv_w = plist(params["conv"], "w")
        self.conv_b = plist(params["conv"], "b")
        self.dense_w = plist(params["dense"], "w")
        self.dense_b = plist(params["dense"], "b")

    def param_dict(self) -> Dict:
        """The parameters in the reference's dict layout (no copies)."""
        return {"conv": [{"w": w, "b": b}
                         for w, b in zip(self.conv_w, self.conv_b)],
                "dense": [{"w": w, "b": b}
                          for w, b in zip(self.dense_w, self.dense_b)]}

    def forward(self, frames: torch.Tensor, *, backend: str = "hopper",
                schedule: Optional[Sequence] = None,
                surrogate_alpha: float = 10.0,
                surrogate_kind: str = "fast_sigmoid") -> SNNOutputs:
        return snn_apply(self.param_dict(), frames, self.cfg,
                         surrogate_alpha=surrogate_alpha,
                         surrogate_kind=surrogate_kind, backend=backend,
                         schedule=schedule)
