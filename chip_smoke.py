#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one NVIDIA card of compute capability 9.0+ and ``nvcc``; imports
neither JAX nor the JAX package.  Phases, each printing one JSON line:

  env     torch/CUDA versions, the card, its power limit
  build   the kernels, built from ``src/repro_torch/kernels/csrc`` in
          parallel into ``build/repro_torch``
  kernel  each kernel against its plain version, at snn-mnist's main-path
          shapes (batch 256, T=8) and at SAME-pad, 5x5, all-zero, faint
          analog and CBWS-permuted cases; kernel, plain and library times.
          The training kernels run on what the train step gives them: the
          training forward (C) on the layers' input trains, the LIF
          backward (D) on C's u with random cotangents, for every
          surrogate, and the input gradient (E) on D's lam folded to
          (T*B, ...), plus SAME-pad, 5x5, ragged and mostly-zero cases
  model   full-width snn-mnist, batch 256: backend="hopper" with an
          aprc+cbws schedule against backend="batched" (plain ops), both
          on the card; launch counts per forward
  profile one hopper forward's device time by kernel (torch.profiler)
          against its time between CUDA events: the device's idle share
  serve   the serve launcher answering a few requests (the main path of
          inference; kernels A and B's launch counts are read around it)
  train   (a) one loss and gradient at full width, batch 256: hopper
          against batched, with the forward's threshold flips counted;
          (b) the training launcher, 10 SGD steps on each backend (the
          main path of training; kernels C, D and E's launch counts are
          read around the hopper run); (c) one train step's time and its
          device time by kernel
  lif_fused   kernel F through ops.lif_fused against its plain version at
          (4096, 512) in float32 and bfloat16, (17, 300) and layer 1's
          membrane (262144, 32), the T=1 path's shape:
          max error 0, kernel, plain and bound times, and the device time
          of both by the profiler
  t1_contract layer 1 at batch 256 through the kernel-ops layer: kernel A
          on the first step of its input train, then F, equals kernel B
          with T=1 (the spike-train rule below); F's launch count is read
          around this two-kernel path
  chunk   snn_apply_chunked(backend="hopper", aprc+cbws) at batch 256 for
          chunks of 1, 2 and 3 steps equals whole T bit for bit (logits,
          counts, skip fractions); ops.spiking_conv_lif_chunked gradients
          equal whole T bit for bit
  bucket_rows logits at batch 1, 2, 3, 4, 8 and 16 equal the rows of
          batch 16 bit for bit, on each backend (ref, batched, hopper)
  engine  the continuous-batching ServingEngine (hopper, aprc+cbws, 2
          lanes, micro-batches of at most 16) replaying 512 requests with
          exponential gaps of mean 1 ms on the virtual clock, whole T and in
          chunks of 3 steps, then threaded on the wall clock: every request
          resolves once, with the logits of a batch-1 forward of its frame,
          the same in both virtual runs; kernels A and B's launch counts
          are read around each run; the virtual runs also give each
          micro-batch's measured dispatch time and the lanes' busy share

then the card's name and power limit as nvidia-smi gives them, the
kernels' summary line and, last, ``{"ok": true, "device": {...}}``.  A
failed check raises, and the script exits nonzero.

The comparison rule for the spike trains.  The kernels sum the taps in
another order than the plain path (which sums exactly and rounds once),
so a membrane within a few ulps of v_th can
fire in one and not in the other (a threshold flip), and that site's
train differs from then on.  So a spike train passes when at most
``MAX_FLIP_FRACTION`` of its sites (batch x pixel x channel) differ, every
differing site first differs at a step where the plain pre-reset membrane
lay within ``FLIP_BAND`` of v_th, and the final membranes of all agreeing
sites agree to ``V_ATOL``.  dV of the conv kernel agrees to 1e-5 (abs and
rel).  The saved membrane u agrees to ``U_ATOL`` where the trains agree;
the LIF backward to ``BWD_TOL`` (rel and abs: it repeats the plain
version's float operations); the input gradient to ``DX_TOL`` of its
largest value.  The model's logits agree with batched to ``LOGITS_ATOL``
beyond their threshold-flip bound: the readout adds ``w[j] / T`` per
spike, so the last train's differing sites bound how far each image's
logits may move (``compare_trains``; 0 for an image without a flip).  A
train step's loss agrees with batched to ``LOSS_ATOL`` beyond twice the
mean of the images' largest flip bounds; with no threshold flip in the
forward, every gradient leaf agrees to a relative norm of ``GRAD_REL``.
All plain versions and yardsticks run with TF32 off.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

MAX_FLIP_FRACTION = 1e-5   # sites of a spike train that may differ
FLIP_BAND = 1e-4           # |u - v_th| at a site's first differing step
V_ATOL = 1e-4              # final membrane at sites whose trains agree
DV_TOL = 1e-5              # conv kernel dV, abs and rel
U_ATOL = 1e-5              # saved pre-reset membrane, where trains agree
BWD_TOL = 1e-6             # LIF backward lam and dv0, rel and abs
DX_TOL = 1e-5              # input gradient, relative to its largest value
LOGITS_ATOL = 1e-3         # model logits, beyond their threshold-flip bound
LOSS_ATOL = 1e-5           # train-step loss, beyond its threshold-flip bound
GRAD_REL = 1e-4            # ||g_hopper - g_batched|| / ||g_batched||
FLIP_GRAD_REL = 1e-2       # the same, when the forward had threshold flips
TRAJ_TOL = 1e-3            # 10-step loss trajectories, rel and abs
MIN_LOSS_DROP = 0.05       # the hopper run's first loss minus its last
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
# outside the tensor cores — the kernels run on the float32 FMA pipes
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
BATCH, SEED = 256, 0


def emit(phase: str, **rec) -> None:
    print(json.dumps({"phase": phase, **rec}), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one call of ``fn`` on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# -- work and bounds ---------------------------------------------------------

def tap_flops(imgs, r: int, cout: int, pad_lo: int, e_h: int, e_w: int,
              br: int) -> float:
    """FLOPs of the taps of every (image, row-block) whose receptive rows
    hold a nonzero input (the conv kernels' skip): imgs (N, H, W, Cin),
    output rows e_h in blocks of br, pad_lo rows of padding above."""
    import torch
    from repro_torch.kernels.spiking_conv import row_block_counts
    n_img, h, _, cin = imgs.shape
    n_blocks = -(-e_h // br)
    padded = torch.zeros((n_img, n_blocks * br + r - 1, 1, 1),
                         device=imgs.device)
    padded[:, pad_lo:pad_lo + h, 0, 0] = (imgs != 0).sum(dim=(2, 3)).float()
    live = row_block_counts(padded, r, br, n_blocks) != 0   # (N, n_blocks)
    rows = torch.full((n_blocks,), br, device=imgs.device)
    rows[-1] = e_h - (n_blocks - 1) * br
    live_rows = float((live.float() * rows).sum())
    return 2.0 * r * r * cin * cout * e_w * live_rows


def conv_work(x, w, aprc: bool, lif: bool, save_u: bool = False):
    """(bytes, FLOPs) one call must move and compute on this input: each
    input byte read once, each output written once; the taps of every
    (image, row-block) whose receptive rows hold a nonzero input (the
    kernel's skip), plus 4 FLOPs per membrane update for the LIF; with
    ``save_u`` also the pre-reset membrane written."""
    from repro_torch.kernels.spiking_conv import conv_pads, plan_tiles
    r, _, cin, cout = w.shape
    *lead, h, wd, _ = x.shape
    lo, _ = conv_pads(r, aprc)
    e_h, e_w = (h + r - 1, wd + r - 1) if aprc else (h, wd)
    br, _ = plan_tiles(e_w, r, cin, cout)
    imgs = x.reshape(-1, h, wd, cin)
    flops = tap_flops(imgs, r, cout, lo, e_h, e_w, br)
    n_out = imgs.shape[0] * e_h * e_w * cout
    out_bytes = 4 * n_out * (2 if save_u else 1)
    in_bytes = 4 * (x.numel() + w.numel() + cout)
    if lif:
        flops += 4.0 * n_out
        membranes = 4 * n_out // lead[0]
        in_bytes += membranes                   # v0
        out_bytes += membranes                  # v_final
    return in_bytes + out_bytes, flops


def grad_input_work(dz, w, aprc: bool):
    """(bytes, FLOPs) of the input gradient: dz read once, dx written once,
    the transposed taps of every row-block with a nonzero cotangent."""
    from repro_torch.kernels.spiking_conv import conv_pads, plan_tiles
    r, _, cin, cout = w.shape
    n, e_h, e_w, _ = dz.shape
    lo, hi = conv_pads(r, aprc)
    h, wd = e_h + r - 1 - lo - hi, e_w + r - 1 - lo - hi
    br, _ = plan_tiles(wd, r, cout, cin)
    flops = tap_flops(dz, r, cin, r - 1 - lo, h, wd, br)
    return 4 * (dz.numel() + w.numel() + n * h * wd * cin), flops


# per element and step of the LIF backward: u - v_th, the surrogate (at
# most 6 operations), then c + (g_s - v_th * c) * sg (4)
LIF_BWD_FLOPS = 10


def lif_bwd_work(u):
    """(bytes, FLOPs) of the LIF backward: u, g_s read and lam written per
    step, g_v read and dv0 written once."""
    t, m = u.shape[0], u[0].numel()
    return 4 * (3 * t * m + 2 * m), float(LIF_BWD_FLOPS * t * m)


def bound(nbytes: float, flops: float):
    t_mem, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FP32
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


# -- comparison rules --------------------------------------------------------

def check_train(name, s, v, s_p, v_p, u_p, v_th):
    """The spike-train rule of the module doc; returns its numbers."""
    import torch
    diff = s != s_p
    site_diff = diff.any(dim=0)
    n_sites, n_mis = site_diff.numel(), int(site_diff.sum())
    worst_u = 0.0
    if n_mis:
        first = diff.float().argmax(dim=0)
        u_first = u_p.gather(0, first.unsqueeze(0))[0][site_diff]
        worst_u = float((u_first - v_th).abs().max())
    agree = ~site_diff
    v_err = float((v - v_p).abs()[agree].max()) if bool(agree.any()) else 0.0
    rec = {"sites": n_sites, "mismatched_sites": n_mis,
           "mismatch_fraction": n_mis / n_sites,
           "max_abs_u_minus_vth_at_flip": worst_u,
           "max_abs_err_v_agreeing": v_err,
           "spikes": float(s.sum()), "spikes_plain": float(s_p.sum())}
    if n_mis / n_sites > MAX_FLIP_FRACTION:
        fail(f"{name}: {n_mis}/{n_sites} sites differ (> {MAX_FLIP_FRACTION})")
    if worst_u > FLIP_BAND:
        fail(f"{name}: a site differs where the plain membrane was "
             f"{worst_u} from v_th (> {FLIP_BAND}): not a threshold flip")
    if v_err > V_ATOL:
        fail(f"{name}: final membrane differs by {v_err} (> {V_ATOL})")
    return rec


def check_dx(name, got, want):
    """The input gradient agrees to DX_TOL of its largest value."""
    err = float((got - want).abs().max())
    if got.shape != want.shape or err > DX_TOL * float(want.abs().max()):
        fail(f"{name}: dx {tuple(got.shape)} differs from the plain "
             f"{tuple(want.shape)} by up to {err}")
    return err


def check_dv(name, got, want):
    import torch
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=DV_TOL, rtol=DV_TOL):
        fail(f"{name}: dV differs by up to {err}")
    return err


# -- phases ------------------------------------------------------------------

def phase_env():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), capability=list(cap),
         nvidia_smi=smi, tf32_cudnn=torch.backends.cudnn.allow_tf32,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32)
    if cap < (9, 0):
        fail(f"compute capability {cap} < (9, 0): the kernels are sm_90a")
    return smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build(_build.KERNELS)
    seconds = time.perf_counter() - t0
    lines = [ln.strip() for log in reports.values()
             for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ptxas.txt").write_text(
        "\n\n".join(f"== {k}\n{v}" for k, v in reports.items()))
    spills = [ln for ln in lines if "spill" in ln and not
              ln.startswith("0 bytes stack frame, 0 bytes spill stores, "
                            "0 bytes spill loads")]
    emit("build", seconds=seconds, built=sorted(reports),
         ptxas=lines, nonzero_spills=spills)


def _model_trains(cfg, params, frames):
    """The spike trains entering snn-mnist layers 1 and 2, made by the plain
    versions from the frames (the inputs the main path gives kernel B)."""
    import torch
    from repro_torch.core.snn_model import _lif_scan, layer_shapes
    from repro_torch.kernels.spiking_conv import spiking_conv_plain
    from repro_torch.kernels.spiking_conv_lif import spiking_conv_lif_plain
    conv, v_th = params["conv"], cfg.v_threshold
    z0 = spiking_conv_plain(frames, conv[0]["w"], conv[0]["b"])
    s0, _, _ = _lif_scan(z0, v_th, 10.0, "fast_sigmoid",
                         torch.zeros_like(z0), const_t=cfg.timesteps)
    v1 = frames.new_zeros((frames.shape[0],) + layer_shapes(cfg)[1])
    s1, _ = spiking_conv_lif_plain(s0, v1, conv[1]["w"], conv[1]["b"],
                                   v_th=v_th)
    return s0.contiguous(), s1.contiguous()


def phase_kernels(cfg, params, frames, trains):
    """Every kernel against its plain version; returns the summary entries
    of the main-path shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.aprc import filter_magnitudes
    from repro_torch.core.cbws import cbws_partition_equal
    from repro_torch.core.snn_layers import conv_out_hw
    from repro_torch.core.snn_model import layer_shapes
    from repro_torch.kernels.spiking_conv import (spiking_conv,
                                                  spiking_conv_plain)
    from repro_torch.kernels.spiking_conv_lif import (spiking_conv_lif,
                                                      spiking_conv_lif_plain)
    from repro_torch.device import full_fp32
    dev, v_th = frames.device, cfg.v_threshold
    conv = params["conv"]
    s0, s1 = trains
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def spikes(*shape, rate):
        return (torch.rand(shape, generator=gen) < rate).float().to(dev)

    summary = {}

    # kernel A: the hoisted first layer, then its other cases
    w0, b0 = conv[0]["w"], conv[0]["b"]
    got = spiking_conv(frames, w0, b0)
    err = check_dv("spiking_conv layer0", got, spiking_conv_plain(frames, w0,
                                                                  b0))
    nbytes, flops = conv_work(frames, w0, True, lif=False)
    w_oihw = w0.permute(3, 2, 0, 1).contiguous()
    x_nchw = frames.permute(0, 3, 1, 2)

    def library():
        with full_fp32():
            return F.conv2d(x_nchw, w_oihw, b0, padding=2)

    rec = {"shape": list(frames.shape), "max_abs_err": err,
           "ms": cuda_ms(lambda: spiking_conv(frames, w0, b0)),
           "plain_ms": cuda_ms(lambda: spiking_conv_plain(frames, w0, b0)),
           "library_ms": cuda_ms(library)}
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
    rec["bytes"], rec["flops"] = nbytes, flops
    emit("kernel", name="spiking_conv", case="snn-mnist layer 0", **rec)
    summary["spiking_conv"] = [rec]

    a_cases = {
        "same-pad 3x3": (spikes(64, 32, 32, 16, rate=0.2),
                         rand(3, 3, 16, 32, scale=0.1), rand(32, scale=0.1),
                         False),
        "5x5 taps": (spikes(64, 28, 28, 8, rate=0.2),
                     rand(5, 5, 8, 16, scale=0.1), rand(16, scale=0.1), True),
        "all-zero input": (torch.zeros((64, 30, 30, 16), device=dev),
                           conv[1]["w"], conv[1]["b"] + 0.25, True),
    }
    faint = torch.zeros((4, 28, 28, 1), device=dev)
    faint[0, 5, 9, 0] = 0.2
    faint[3, 27, 0, 0] = 0.01
    a_cases["faint analog frame"] = (faint, w0, b0, True)
    for case, (x, w, b, aprc) in a_cases.items():
        got = spiking_conv(x, w, b, aprc=aprc)
        err = check_dv(f"spiking_conv {case}", got,
                       spiking_conv_plain(x, w, b, aprc=aprc))
        if case == "faint analog frame" and not bool(
                (got[0] != b0).any() and (got[3] != b0).any()):
            fail("spiking_conv skipped a faint analog frame")
        emit("kernel", name="spiking_conv", case=case, shape=list(x.shape),
             max_abs_err=err)

    # kernel B: snn-mnist layers 1 and 2 at the main path's inputs
    summary["spiking_conv_lif"] = []
    for layer, x in ((1, s0), (2, s1)):
        w, b = conv[layer]["w"], conv[layer]["b"]
        v0 = torch.zeros((BATCH,) + layer_shapes(cfg)[layer], device=dev)
        s, v = spiking_conv_lif(x, v0, w, b, v_th=v_th)
        s_p, v_p, u_p = spiking_conv_lif_plain(x, v0, w, b, v_th=v_th,
                                               save_u=True)
        rec = check_train(f"spiking_conv_lif layer{layer}", s, v, s_p, v_p,
                          u_p, v_th)
        del s_p, v_p, u_p
        nbytes, flops = conv_work(x, w, True, lif=True)
        rec.update(
            shape=list(x.shape), max_abs_err=rec["max_abs_err_v_agreeing"],
            ms=cuda_ms(lambda: spiking_conv_lif(x, v0, w, b, v_th=v_th),
                       reps=10),
            plain_ms=cuda_ms(lambda: spiking_conv_lif_plain(
                x, v0, w, b, v_th=v_th), reps=10),
            library_ms=None, bytes=nbytes, flops=flops)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
        emit("kernel", name="spiking_conv_lif", case=f"snn-mnist layer "
             f"{layer}", **rec)
        summary["spiking_conv_lif"].append(rec)

    # build_schedule's output lanes are contiguous stripes (the identity
    # permutation), so the lanes here are equal-size CBWS groups of layer
    # 1's filter magnitudes, which do reorder the output channels
    w1, b1 = conv[1]["w"], conv[1]["b"]
    perm = torch.as_tensor(cbws_partition_equal(
        filter_magnitudes(w1, "abs"), 4).permutation(), device=dev)
    b_cases = {
        "same-pad 3x3": (spikes(8, 32, 32, 32, 16, rate=0.2),
                         rand(3, 3, 16, 32, scale=0.15),
                         rand(32, scale=0.05), False, None),
        "5x5 taps": (spikes(8, 32, 28, 28, 8, rate=0.2),
                     rand(5, 5, 8, 16, scale=0.1), rand(16, scale=0.05),
                     True, None),
        "all-zero train": (torch.zeros((8, 64, 30, 30, 16), device=dev),
                           conv[1]["w"], torch.full((32,), 0.3, device=dev),
                           True, None),
        "cbws-permuted weights": (s0[:, :64].contiguous(),
                                  w1[..., perm].contiguous(), b1[perm], True,
                                  perm),
    }
    for case, (x, w, b, aprc, out_perm) in b_cases.items():
        e_h, e_w = conv_out_hw(x.shape[2], x.shape[3], w.shape[0], aprc)
        v0 = rand(x.shape[1], e_h, e_w, w.shape[-1], scale=0.3)
        s, v = spiking_conv_lif(x, v0, w, b, v_th=v_th, aprc=aprc)
        if out_perm is None:
            s_p, v_p, u_p = spiking_conv_lif_plain(
                x, v0, w, b, v_th=v_th, aprc=aprc, save_u=True)
        else:
            # plain on the canonical weights, then the lanes' channel order
            inv = out_perm.argsort()
            s_p, v_p, u_p = spiking_conv_lif_plain(
                x, v0[..., inv], w1, b1, v_th=v_th,
                aprc=aprc, save_u=True)
            s_p, v_p, u_p = s_p[..., out_perm], v_p[..., out_perm], \
                u_p[..., out_perm]
        rec = check_train(f"spiking_conv_lif {case}", s, v, s_p, v_p, u_p,
                          v_th)
        if case == "all-zero train" and not (rec["spikes"] > 0 and
                                             rec["mismatched_sites"] == 0):
            fail("spiking_conv_lif: the bias-only skip path did not fire "
                 "exactly like the plain version")
        emit("kernel", name="spiking_conv_lif", case=case,
             shape=list(x.shape), **rec)
    return summary


def phase_train_kernels(cfg, params, trains):
    """Kernels C, D and E against their plain versions on what the train
    step gives them; returns their summary entries."""
    import torch
    from repro_torch.core.snn_model import layer_shapes
    from repro_torch.core.surrogate import SURROGATE_KINDS
    from repro_torch.device import full_fp32
    from repro_torch.kernels import ref
    from repro_torch.kernels.spiking_conv import conv_grad_input
    from repro_torch.kernels.spiking_conv_lif import (lif_bwd,
                                                      spiking_conv_lif_fwd)
    dev, v_th, conv = trains[0].device, cfg.v_threshold, params["conv"]
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    summary = {"spiking_conv_lif_fwd": [], "lif_bwd": [],
               "conv_grad_input": []}
    lams = {}
    for layer, x in ((1, trains[0]), (2, trains[1])):
        w, b = conv[layer]["w"], conv[layer]["b"]
        v0 = torch.zeros((BATCH,) + layer_shapes(cfg)[layer], device=dev)
        # kernel C: kernel B's outputs plus u
        s, v, u = spiking_conv_lif_fwd(x, v0, w, b, v_th=v_th)
        s_p, v_p, u_p = ref.spiking_conv_lif_ref(x, v0, w, b, v_th=v_th,
                                                 save_u=True)
        rec = check_train(f"spiking_conv_lif_fwd layer{layer}", s, v, s_p,
                          v_p, u_p, v_th)
        agree = (s == s_p).all(dim=0)
        u_err = float((u - u_p).abs()[:, agree].max())
        if u_err > U_ATOL:
            fail(f"spiking_conv_lif_fwd layer{layer}: u differs by {u_err} "
                 f"(> {U_ATOL}) where the trains agree")
        del s, v, s_p, v_p, u_p
        nbytes, flops = conv_work(x, w, True, lif=True, save_u=True)
        rec.update(
            shape=list(x.shape), max_abs_err=max(
                u_err, rec["max_abs_err_v_agreeing"]),
            max_abs_err_u_agreeing=u_err,
            ms=cuda_ms(lambda: spiking_conv_lif_fwd(x, v0, w, b, v_th=v_th),
                       reps=10),
            plain_ms=cuda_ms(lambda: ref.spiking_conv_lif_ref(
                x, v0, w, b, v_th=v_th, save_u=True), reps=10),
            library_ms=None, bytes=nbytes, flops=flops)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
        emit("kernel", name="spiking_conv_lif_fwd",
             case=f"snn-mnist layer {layer}", **rec)
        summary["spiking_conv_lif_fwd"].append(rec)

        # kernel D on C's u, every surrogate; fast_sigmoid (the default)
        # is the main path's and its lam feeds kernel E
        g_s, g_v = randn(*u.shape), randn(*u.shape[1:])
        nbytes, flops = lif_bwd_work(u)
        for kind in SURROGATE_KINDS:
            kw = dict(v_th=v_th, alpha=10.0, kind=kind)
            lam, dv0 = lif_bwd(u, g_s, g_v, **kw)
            lam_p, dv0_p = ref.lif_bwd_ref(u, g_s, g_v, **kw)
            errs = [float((a - b_).abs().max()) for a, b_ in
                    ((lam, lam_p), (dv0, dv0_p))]
            if not (torch.allclose(lam, lam_p, atol=BWD_TOL, rtol=BWD_TOL)
                    and torch.allclose(dv0, dv0_p, atol=BWD_TOL,
                                       rtol=BWD_TOL)):
                fail(f"lif_bwd layer{layer} {kind}: lam/dv0 differ by "
                     f"{errs}")
            del lam_p, dv0_p
            rec = {"shape": list(u.shape), "surrogate": kind,
                   "max_abs_err": max(errs),
                   "bit_identical": errs == [0.0, 0.0],
                   "ms": cuda_ms(lambda: lif_bwd(u, g_s, g_v, **kw)),
                   "plain_ms": cuda_ms(lambda: ref.lif_bwd_ref(u, g_s, g_v,
                                                               **kw)),
                   "library_ms": None, "bytes": nbytes, "flops": flops}
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
            emit("kernel", name="lif_bwd", case=f"snn-mnist layer {layer}",
                 **rec)
            if kind == "fast_sigmoid":
                summary["lif_bwd"].append(rec)
                lams[layer] = lam.reshape((-1,) + lam.shape[2:])
            del lam, dv0
        del u, g_s, g_v

    # kernel E on lam folded to (T*B, ...): layer 2's backward, then 1's
    for layer in (2, 1):
        dz, w = lams.pop(layer), conv[layer]["w"]
        got = conv_grad_input(dz, w)
        want = ref.conv_grad_input_ref(dz, w)
        err = check_dx(f"conv_grad_input layer{layer}", got, want)
        del got, want
        nbytes, flops = grad_input_work(dz, w, True)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        g_nchw = dz.permute(0, 3, 1, 2)
        n, e_h, e_w, _ = dz.shape
        r = w.shape[0]
        x_size = (n, w.shape[2], e_h - r + 1, e_w - r + 1)

        def library():
            with full_fp32():
                return torch.nn.grad.conv2d_input(x_size, w_oihw, g_nchw,
                                                  padding=r - 1)

        rec = {"shape": list(dz.shape), "max_abs_err": err,
               "ms": cuda_ms(lambda: conv_grad_input(dz, w)),
               "plain_ms": cuda_ms(lambda: ref.conv_grad_input_ref(dz, w)),
               "library_ms": cuda_ms(library), "bytes": nbytes,
               "flops": flops}
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
        emit("kernel", name="conv_grad_input",
             case=f"snn-mnist layer {layer} backward", **rec)
        summary["conv_grad_input"].append(rec)
        del dz

    sparse = randn(64, 34, 34, 8)
    sparse[:, 3:30] = 0.0                # rows 3..29: whole blocks skip
    e_cases = {
        "same-pad 3x3": (randn(64, 32, 32, 32), randn(3, 3, 16, 32), False),
        "5x5 taps": (randn(64, 32, 32, 16), randn(5, 5, 8, 16), True),
        "ragged rows": (randn(64, 29, 29, 8), randn(3, 3, 16, 8), True),
        "mostly-zero cotangent": (sparse, conv[2]["w"], True),
    }
    for case, (dz, w, aprc) in e_cases.items():
        err = check_dx(f"conv_grad_input {case}",
                       conv_grad_input(dz, w, aprc=aprc),
                       ref.conv_grad_input_ref(dz, w, aprc=aprc))
        emit("kernel", name="conv_grad_input", case=case,
             shape=list(dz.shape), max_abs_err=err)
    return summary


def phase_model(cfg, params, frames, trains):
    import torch
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.core.snn_model import snn_apply
    from repro_torch.kernels.spiking_conv import (skip_table_fraction,
                                                  spiking_conv)
    from repro_torch.kernels.spiking_conv_lif import spiking_conv_lif
    sched = build_schedule(params, cfg, "aprc+cbws")
    spiking_conv.launches = spiking_conv_lif.launches = 0
    got = snn_apply(params, frames, cfg, backend="hopper", schedule=sched)
    torch.cuda.synchronize()
    launches = {"spiking_conv": spiking_conv.launches,
                "spiking_conv_lif": spiking_conv_lif.launches}
    if launches != {"spiking_conv": 1, "spiking_conv_lif": 2}:
        fail(f"one hopper forward launched {launches}, expected 1 and 2")
    want = snn_apply(params, frames, cfg, backend="batched")
    want_skips = [float(skip_table_fraction(t, cfg.kernel_size))
                  for t in trains]
    # a threshold flip (the kernels sum in float32 in their own order, the
    # plain path exactly) moves an image's logits by at most its flip
    # bound; every logit is held to that bound plus LOGITS_ATOL
    flips, flip_bound = compare_trains(cfg, params, frames, sched)
    forward_ms = cuda_ms(lambda: snn_apply(params, frames, cfg,
                                           backend="hopper", schedule=sched),
                         reps=10)
    err = (got.logits - want.logits).abs().double()
    flipped = flip_bound.amax(dim=1) > 0
    logit_err = float(err[~flipped].max()) if bool((~flipped).any()) else 0.0
    logit_err_flipped = float(err[flipped].max()) if bool(
        flipped.any()) else 0.0
    excess = float((err - flip_bound).max())
    totals = [(float(a), float(b)) for a, b in zip(got.spike_totals,
                                                   want.spike_totals)]
    rel = [abs(a - b) / max(b, 1.0) for a, b in totals]
    skips = [float(f) for f in got.skip_fractions]
    emit("model", config=cfg.name, batch=BATCH, timesteps=cfg.timesteps,
         schedule="aprc+cbws", launches_per_forward=launches,
         threshold_flips_per_layer=flips,
         images_with_a_flip=int(flipped.sum()),
         max_abs_err_logits=logit_err,
         max_abs_err_logits_flipped_images=logit_err_flipped,
         max_flip_bound=float(flip_bound.max()),
         max_abs_err_logits_beyond_flip_bound=excess,
         spike_totals=totals,
         spike_totals_rel_diff=rel, skip_fractions=skips,
         skip_fractions_plain=want_skips,
         forward_ms=forward_ms,
         forward_ms_batched=cuda_ms(lambda: snn_apply(
             params, frames, cfg, backend="batched"), reps=10))
    if tuple(got.logits.shape) != (BATCH, cfg.dense_units[-1]) or not bool(
            torch.isfinite(got.logits).all()):
        fail(f"logits {tuple(got.logits.shape)} not finite/of the "
             f"expected shape")
    if any(f > MAX_FLIP_FRACTION * n for f, n in flips):
        fail(f"threshold flips per layer {flips} exceed {MAX_FLIP_FRACTION}")
    if excess > LOGITS_ATOL:
        fail(f"hopper logits differ from batched by {excess} beyond their "
             f"threshold-flip bound (> {LOGITS_ATOL})")
    if max(rel) > 1e-5:
        fail(f"hopper spike totals differ from batched by {max(rel)} "
             f"(> 1e-5)")
    if len(skips) != 2 or max(abs(a - b) for a, b in
                              zip(skips, want_skips)) > 1e-3:
        fail(f"skip fractions {skips} vs the plain trains' {want_skips}")
    phase_profile(lambda: snn_apply(params, frames, cfg, backend="hopper",
                                    schedule=sched), forward_ms,
                  "hopper forward")


def device_time(call, reps: int):
    """Device ms per call of ``call`` by kernel name, and its device
    launches, from the profiler's CUDA activity over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    by_kernel, launches = {}, 0
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + dev_us / 1e3 / reps
            launches += e.count
    return by_kernel, launches


def phase_profile(call, call_ms: float, what: str, reps: int = 3):
    """Where one call's time goes (a hopper forward, a train step): device
    time by kernel (the profiler's CUDA activity), against the call's time
    between CUDA events without the profiler (``call_ms``): the rest is
    the device idle, waiting for the host to launch the next kernel."""
    by_kernel, launches = device_time(call, reps)
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    emit("profile", what=what, calls=reps, call_ms=call_ms,
         device_ms_per_call=device_ms,
         device_idle_share=max(0.0, 1.0 - device_ms / call_ms),
         device_launches_per_call=launches / reps,
         top_device_ms=[[k[:90], v] for k, v in top])


def phase_serve(cfg, steps: int = 8):
    """The main path of inference: the serve launcher answering requests.
    Returns the kernels' launch counts over the run."""
    from repro_torch.launch.serve import serve
    reset_counts()
    s = serve(cfg, backend="hopper", schedule="aprc+cbws", batch=BATCH,
              steps=steps, seed=SEED, device="cuda")
    launches = read_counts()
    emit("serve", config=cfg.name, batch=BATCH, requests=steps + 1,
         timed_requests=steps, frames=s["frames"], seconds=s["seconds"],
         fps=s["fps"], spikes_per_frame=s["spikes_per_frame"],
         device=s["device"], launches=launches)
    if launches["spiking_conv"] == 0 or launches["spiking_conv_lif"] == 0:
        fail(f"the serve run did not go through every kernel: {launches}")
    return ({k: launches[k] for k in ("spiking_conv", "spiking_conv_lif")},
            s["fps"])


def _counters():
    from repro_torch.kernels import lif as f
    from repro_torch.kernels import spiking_conv as a
    from repro_torch.kernels import spiking_conv_lif as b
    return {"spiking_conv": a.spiking_conv,
            "spiking_conv_lif": b.spiking_conv_lif,
            "spiking_conv_lif_fwd": b.spiking_conv_lif_fwd,
            "lif_bwd": b.lif_bwd, "conv_grad_input": a.conv_grad_input,
            "lif_fused": f.lif_fused}


def reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in _counters().items()}


def _forward_trains(cfg, params, frames, hopper: bool, sched=None):
    """The spike trains of snn-mnist's three conv layers, computed the way
    backend hopper (kernels, through the CBWS-permuted weights of
    ``sched`` if given) or batched (plain ops) computes them, each in the
    canonical channel order."""
    import torch
    from repro_torch.core.scheduler import permute_conv_params
    from repro_torch.core.snn_model import (_conv_folded, _conv_plain,
                                            _lif_scan, layer_shapes)
    from repro_torch.kernels.spiking_conv import spiking_conv
    from repro_torch.kernels.spiking_conv_lif import spiking_conv_lif
    inv = [None] * len(params["conv"])
    if sched is not None:
        params = permute_conv_params(params, list(sched))
        inv = [torch.as_tensor(l.out_perm, device=frames.device).argsort()
               for l in sched]
    conv, v_th = params["conv"], cfg.v_threshold
    with torch.no_grad():
        z0 = (spiking_conv(frames, conv[0]["w"], conv[0]["b"]) if hopper
              else _conv_plain(frames, conv[0], cfg.aprc))
        s, _, _ = _lif_scan(z0, v_th, 10.0, "fast_sigmoid",
                            torch.zeros_like(z0), const_t=cfg.timesteps)
        trains = [s]
        for i in range(1, len(conv)):
            v0 = frames.new_zeros((frames.shape[0],) + layer_shapes(cfg)[i])
            if hopper:
                s, _ = spiking_conv_lif(s.contiguous(), v0, conv[i]["w"],
                                        conv[i]["b"], v_th=v_th)
            else:
                s, _, _ = _lif_scan(_conv_folded(s, conv[i], cfg, False),
                                    v_th, 10.0, "fast_sigmoid", v0)
            trains.append(s)
    return [t if p is None else t[..., p] for t, p in zip(trains, inv)]


def compare_trains(cfg, params, frames, sched=None):
    """Threshold flips between the hopper and batched spike trains: per
    layer [differing sites, sites], and per image and class how far the
    readout's logits (and so the loss) may move because of them.  The
    readout adds ``w[j] / T`` for each spike of the last train, so
    ``|d logit_ik| <= sum over differing (t, j) of |w_jk| / T``; where the
    trains agree the bound is 0, since both backends sum the readout
    exactly (float64 on the exact grid) and then round alike."""
    import torch
    assert len(params["dense"]) == 1, "snn-mnist reads out its last conv"
    flips, last = [], None
    for t_h, t_b in zip(_forward_trains(cfg, params, frames, True, sched),
                        _forward_trains(cfg, params, frames, False)):
        diff = t_h != t_b
        sites = diff.any(dim=0)
        flips.append([int(sites.sum()), sites.numel()])
        last = diff
    per_image = last.sum(dim=0).flatten(1).double()
    bound = (per_image @ params["dense"][0]["w"].abs().double()
             / cfg.timesteps)
    return flips, bound


def _loss_and_grads(cfg, params, x, y, backend):
    import torch
    from repro_torch.core.snn_train import make_loss_fn
    keys = [(kind, i, k) for kind in ("conv", "dense")
            for i in range(len(params[kind])) for k in ("w", "b")]
    leaves = [params[kind][i][k].detach().clone().requires_grad_(True)
              for kind, i, k in keys]
    it = iter(leaves)
    tree = {kind: [{k: next(it) for k in ("w", "b")} for _ in params[kind]]
            for kind in ("conv", "dense")}
    loss = make_loss_fn(cfg, backend=backend)(tree, x, y)
    grads = torch.autograd.grad(loss, leaves)
    names = [f"{kind}{i}.{k}" for kind, i, k in keys]
    return float(loss.detach()), dict(zip(names, grads))


def phase_train(cfg, steps: int = 10, lr: float = 1e-2):
    """(a) one loss and gradient, hopper against batched; (b) the training
    launcher on both backends (the main path of training); (c) one train
    step's time and profile.  Returns the launch counts of the hopper
    run of (b)."""
    import numpy as np
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch.core.snn_model import init_snn
    from repro_torch.core.snn_train import make_train_step
    from repro_torch.data.synthetic import mnist_like
    from repro_torch.launch.train import train
    params = init_snn(torch.Generator().manual_seed(SEED), cfg,
                      device="cuda")
    x, y = (torch.from_numpy(a).cuda() for a in mnist_like(BATCH, seed=0))

    # (a) one loss and gradient at full width
    loss_h, g_h = _loss_and_grads(cfg, params, x, y, "hopper")
    loss_b, g_b = _loss_and_grads(cfg, params, x, y, "batched")
    # the cross-entropy moves by at most twice an image's largest logit
    # change, so flips widen the loss bound by the mean of that
    flips, flip_bound = compare_trains(cfg, params, x)
    loss_bound = LOSS_ATOL + float(2 * flip_bound.amax(dim=1).mean())
    rel = {k: float((g_h[k] - g_b[k]).norm() / g_b[k].norm())
           for k in g_b}
    n_flips = sum(f for f, _ in flips)
    grad_bound = GRAD_REL if n_flips == 0 else FLIP_GRAD_REL
    emit("train", part="a: one loss and gradient, hopper against batched",
         config=cfg.name, batch=BATCH, timesteps=cfg.timesteps,
         loss_hopper=loss_h, loss_batched=loss_b,
         loss_abs_diff=abs(loss_h - loss_b), loss_bound=loss_bound,
         threshold_flips_per_layer=flips, grad_rel_diff=rel,
         grad_rel_bound=grad_bound,
         grad_norms={k: float(g.norm()) for k, g in g_b.items()})
    if abs(loss_h - loss_b) > loss_bound:
        fail(f"train loss hopper {loss_h} vs batched {loss_b} "
             f"(> {loss_bound}, {n_flips} flips)")
    if any(f > MAX_FLIP_FRACTION * n for f, n in flips):
        fail(f"threshold flips per layer {flips} exceed {MAX_FLIP_FRACTION}")
    if not all(float(g.abs().max()) > 0 for g in g_h.values()):
        fail("a hopper gradient leaf is zero")
    if max(rel.values()) > grad_bound:
        fail(f"hopper gradients differ from batched: {rel} "
             f"(> {grad_bound}, {n_flips} flips)")
    del g_h, g_b

    # (b) the launcher, 10 SGD steps on each backend
    runs, counts = {}, {}
    for backend in ("hopper", "batched"):
        reset_counts()
        runs[backend] = train(cfg, backend=backend, lr=lr, steps=steps,
                              batch=BATCH, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        counts[backend] = read_counts()
    h, b = runs["hopper"]["losses"], runs["batched"]["losses"]
    emit("train", part="b: the training launcher", steps=steps, lr=lr,
         losses_hopper=h, losses_batched=b,
         median_step_ms={k: r["median_step_ms"] for k, r in runs.items()},
         frames_per_s={k: r["frames_per_s"] for k, r in runs.items()},
         accuracy={k: r["accuracy"] for k, r in runs.items()},
         launches=counts, device=runs["hopper"]["device"])
    if not np.allclose(h, b, rtol=TRAJ_TOL, atol=TRAJ_TOL):
        fail(f"loss trajectories differ: hopper {h} batched {b}")
    if not h[0] - h[-1] >= MIN_LOSS_DROP:
        fail(f"the hopper loss fell by {h[0] - h[-1]} (< {MIN_LOSS_DROP})")
    # per step A 1, C 2, D 2, E 2 (E never for the frames), and the
    # held-out evaluation's forward A 1, B 2
    want = {"spiking_conv": steps + 1, "spiking_conv_lif": 2,
            "spiking_conv_lif_fwd": 2 * steps, "lif_bwd": 2 * steps,
            "conv_grad_input": 2 * steps, "lif_fused": 0}
    if counts["hopper"] != want:
        fail(f"the hopper train run launched {counts['hopper']}, expected "
             f"{want}")
    if any(v != 0 for v in counts["batched"].values()):
        fail(f"the batched train run launched kernels: {counts['batched']}")

    # (c) one train step between CUDA events, and where its time goes
    mom = tree_map(torch.zeros_like, params)
    step_ms = {}
    for backend in ("hopper", "batched"):
        step = make_train_step(cfg, backend=backend, lr=lr)
        step_ms[backend] = cuda_ms(lambda: step(params, mom, x, y), reps=5,
                                   warmup=2)
    emit("train", part="c: one train step", batch=BATCH, step_ms=step_ms,
         trained_frames_per_s={k: BATCH / v * 1e3
                               for k, v in step_ms.items()})
    step = make_train_step(cfg, backend="hopper", lr=lr)
    phase_profile(lambda: step(params, mom, x, y), step_ms["hopper"],
                  "hopper train step")
    return counts["hopper"]


# -- slice 3: kernel F, the ops layer, chunked execution, the engine ----------

# the element-wise LIF step: two reads and two writes per element; four
# operations (add, compare, multiply, subtract)
LIF_FUSED_FLOPS = 4
ENGINE_REQUESTS, ENGINE_GAP_S, ENGINE_CHUNK = 512, 1e-3, 3


def phase_lif_fused():
    """Kernel F against its plain version, called as the T=1 two-kernel
    path calls it (``ops.lif_fused``, which hands the tensors to the
    wrapper as they are); returns the summary entry of layer 1's membrane
    shape, the one that path launches."""
    import torch
    from repro_torch.kernels.lif import lif_fused_plain
    from repro_torch.kernels.ops import lif_fused
    gen = torch.Generator().manual_seed(SEED + 3)
    cases = [((4096, 512), torch.float32), ((4096, 512), torch.bfloat16),
             ((17, 300), torch.float32), ((262144, 32), torch.float32)]
    summary = None
    for shape, dtype in cases:
        v = torch.randn(shape, generator=gen).to(dtype).cuda()
        z = torch.randn(shape, generator=gen).to(dtype).cuda()
        v.view(-1)[::7], z.view(-1)[::7] = 1.0, 0.0      # v + z == v_th
        got = lif_fused(v, z, 1.0)
        want = lif_fused_plain(v, z, 1.0)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        if err != 0.0 or any(a.dtype != dtype for a in got):
            fail(f"lif_fused {shape} {dtype}: differs from the plain "
                 f"version by {err}")
        n = v.numel()
        nbytes = 4 * n * v.element_size()
        rec = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
               "max_abs_err": err,
               "ms": cuda_ms(lambda: lif_fused(v, z, 1.0)),
               "plain_ms": cuda_ms(lambda: lif_fused_plain(v, z, 1.0)),
               "library_ms": None, "bytes": nbytes,
               "flops": float(LIF_FUSED_FLOPS * n)}
        # a call this small can take less device time than the wrapper's
        # host time, which the CUDA events above then include
        for key, fn in (("device_ms", lif_fused),
                        ("plain_device_ms", lif_fused_plain)):
            by_kernel, _ = device_time(lambda: fn(v, z, 1.0), reps=20)
            rec[key] = sum(by_kernel.values())
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, rec["flops"])
        emit("lif_fused", **rec)
        if shape == (262144, 32):
            summary = [rec]
    return summary


def phase_t1_contract(cfg, params, frames):
    """Layer 1 at batch 256, one timestep, through the kernel-ops layer:
    ``ops.spiking_conv`` (A) then ``ops.lif_fused`` (F) equals
    ``ops.spiking_conv_lif`` (B) with T=1.  Returns F's launches on the
    two-kernel path."""
    import torch
    from repro_torch.core.snn_model import layer_shapes
    from repro_torch.kernels import ops
    trains = _model_trains(cfg, params, frames)
    x = trains[0][:1].contiguous()             # layer 1's input, step 0
    del trains
    w, b = params["conv"][1]["w"], params["conv"][1]["b"]
    v0 = (torch.randn((BATCH,) + layer_shapes(cfg)[1],
                      generator=torch.Generator().manual_seed(SEED + 4))
          * 0.5).cuda()
    s_b, v_b = ops.spiking_conv_lif(x, v0, w, b, v_th=cfg.v_threshold)
    reset_counts()
    z = ops.spiking_conv(x[0], w, b)
    v2, s2 = ops.lif_fused(v0.reshape(-1, v0.shape[-1]),
                           z.reshape(-1, z.shape[-1]), cfg.v_threshold)
    torch.cuda.synchronize()
    launches = read_counts()
    u = (v0 + z)[None]
    rec = check_train("t1_contract", s_b, v_b, s2.reshape(s_b.shape),
                      v2.reshape(v_b.shape), u, cfg.v_threshold)
    emit("t1_contract", layer=1, batch=BATCH, launches=launches, **rec)
    if launches["spiking_conv"] != 1 or launches["lif_fused"] != 1:
        fail(f"the two-kernel path launched {launches}, expected A 1, F 1")
    return launches["lif_fused"]


def phase_chunk(cfg, params, frames):
    """Chunked execution on the kernels is bit-identical to whole T."""
    import torch
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.core.snn_model import snn_apply, snn_apply_chunked
    from repro_torch.kernels import ops
    sched = build_schedule(params, cfg, "aprc+cbws")
    want = snn_apply(params, frames, cfg, backend="hopper", schedule=sched)
    recs = {}
    for ct in (1, 2, 3):
        got = snn_apply_chunked(params, frames, cfg, chunk_timesteps=ct,
                                backend="hopper", schedule=sched)
        same = {
            "logits": torch.equal(got.logits, want.logits),
            "timestep_counts": all(torch.equal(a, b) for a, b in zip(
                got.timestep_counts, want.timestep_counts)),
            "skip_fractions_abs_diff": max(
                abs(float(a) - float(b)) for a, b in
                zip(got.skip_fractions, want.skip_fractions))}
        recs[ct] = same
        if not (same["logits"] and same["timestep_counts"]
                and same["skip_fractions_abs_diff"] < 1e-6):
            fail(f"chunked hopper forward (ct={ct}) differs from whole T: "
                 f"{same}")
    # BPTT through the chunked fused layer, layer 1 at batch 256: the
    # reference's loss s.sum() + v.sum() (every cotangent exactly 1, so the
    # weight gradient is an exact count)
    trains = _model_trains(cfg, params, frames)
    x = trains[0]
    del trains
    w, b = params["conv"][1]["w"], params["conv"][1]["b"]
    grads = {}
    with torch.inference_mode(False):
        for ct in (None, 1, 3):
            ws, bs = w.clone().requires_grad_(True), \
                b.clone().requires_grad_(True)
            v0 = torch.zeros((BATCH, 32, 32, 32), device=x.device,
                             requires_grad=True)
            xs = x.clone().requires_grad_(True)
            if ct is None:
                s, v = ops.spiking_conv_lif(xs, v0, ws, bs)
            else:
                s, v = ops.spiking_conv_lif_chunked(xs, v0, ws, bs,
                                                    chunk_timesteps=ct)
            (s.sum() + v.sum()).backward()
            grads[ct] = [t.grad for t in (ws, bs, xs, v0)]
    grad_same = {ct: all(torch.equal(a, b_)
                         for a, b_ in zip(grads[ct], grads[None]))
                 for ct in (1, 3)}
    emit("chunk", batch=BATCH, schedule="aprc+cbws", forward=recs,
         grads_bit_identical=grad_same)
    if not all(grad_same.values()):
        fail(f"chunked fused-layer gradients differ from whole T: "
             f"{grad_same}")


def phase_bucket_rows(cfg, params, frames):
    """A row's logits do not depend on the batch it runs in, on every
    backend the engine serves with."""
    from repro_torch.core.snn_model import SNN_BACKENDS, snn_apply
    diffs = {}
    for backend in SNN_BACKENDS:
        full = snn_apply(params, frames[:16], cfg, backend=backend).logits
        diffs[backend] = {}
        for n in (1, 2, 3, 4, 8, 16):
            got = snn_apply(params, frames[:n], cfg, backend=backend).logits
            diffs[backend][n] = float((got - full[:n]).abs().max())
    emit("bucket_rows", max_abs_diff=diffs)
    if any(d != 0.0 for per in diffs.values() for d in per.values()):
        fail(f"rows depend on the batch: {diffs}")


def phase_engine(cfg, params, serve_fps):
    """The serving engine on the card: 512 requests replayed whole T and in
    chunks on the virtual clock, then threaded on the wall clock.  Every
    request resolves once with the logits of a batch-1 forward of its
    frame."""
    import numpy as np
    import torch
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.core.snn_model import snn_apply
    from repro_torch.serving import EngineConfig, ServingEngine
    rng = np.random.default_rng(SEED)
    req_frames = rng.random((ENGINE_REQUESTS, *cfg.input_hw,
                             cfg.input_channels), dtype=np.float32)
    arrivals = np.cumsum(rng.exponential(ENGINE_GAP_S, ENGINE_REQUESTS))
    sched = build_schedule(params, cfg, "aprc+cbws")
    with torch.inference_mode():
        x = torch.from_numpy(req_frames).cuda()
        single = np.stack([snn_apply(params, x[i:i + 1], cfg,
                                     backend="hopper",
                                     schedule=sched).logits[0].cpu().numpy()
                           for i in range(ENGINE_REQUESTS)])
    runs = {}
    for name, kw in (("virtual whole-T", {}),
                     ("virtual chunked", {"chunk_timesteps": ENGINE_CHUNK}),
                     ("threaded whole-T", {"threaded": True})):
        # the virtual runs' dispatch walls (pad, forward, host copy), kept
        # as measured: the lanes' busy share says how close the load is
        # to their capacity
        walls = []
        if "threaded" not in kw:
            kw["service_time_fn"] = lambda lane, wall, t: (
                walls.append(wall), wall)[1]
        eng = ServingEngine(params, cfg, EngineConfig(
            backend="hopper", schedule_mode="aprc+cbws", num_lanes=2,
            max_batch=16, keep_logits=True, device="cuda", **kw))
        rids = [eng.submit(f, arrival=float(a))
                for f, a in zip(req_frames, arrivals)]
        eng.warmup()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        s = eng.run()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        out = ([r.rid for r in eng.completed] + [r.rid for r in eng.rejected]
               + [r.rid for r in eng.expired])
        if sorted(out) != sorted(rids) or len(eng.completed) != len(rids):
            fail(f"engine {name}: {len(eng.completed)} of {len(rids)} "
                 f"served, {len(out)} resolved, {len(set(out))} distinct")
        logits = {r.rid: r.logits for r in eng.completed}
        mismatched = [rid for rid in rids
                      if not np.array_equal(logits[rid], single[rid])]
        runs[name] = logits
        rec = {"run": name, "requests": len(rids), "served": s["served"],
               "fps": s["fps"], "p50_ms": s["p50_latency_s"] * 1e3,
               "p99_ms": s["p99_latency_s"] * 1e3, "rounds": s["rounds"],
               "request_balance": s["request_balance"],
               "chunks_dispatched": s["chunks_dispatched"],
               "skip_sparsity": s["skip_sparsity"],
               "host_seconds": seconds, "launches": launches,
               "dispatches": len(walls) if walls else None,
               "mean_dispatch_ms": (statistics.mean(walls) * 1e3 if walls
                                    else None),
               "lane_busy_share": (sum(walls) / (2 * s["wall_s"]) if walls
                                   else None),
               "mean_queue_depth": s["mean_queue_depth"],
               "rows_differing_from_batch1": len(mismatched),
               "serve_phase_fps": serve_fps}
        emit("engine", **rec)
        if mismatched:
            fail(f"engine {name}: {len(mismatched)} requests' logits differ "
                 f"from a batch-1 forward (rids {mismatched[:5]})")
        if launches["spiking_conv"] == 0 or launches["spiking_conv_lif"] == 0:
            fail(f"engine {name} did not go through kernels A and B: "
                 f"{launches}")
    a, b = runs["virtual whole-T"], runs["virtual chunked"]
    if any(not np.array_equal(a[k], b[k]) for k in a):
        fail("chunked engine logits differ from whole-T")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              f"run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.config import get_snn
    from repro_torch.core.snn_model import init_snn

    t0 = time.perf_counter()
    smi = phase_env()
    phase_build()
    cfg = get_snn("snn-mnist")
    with torch.inference_mode():
        params = init_snn(torch.Generator().manual_seed(SEED), cfg,
                          device="cuda")
        frames = torch.from_numpy(np.random.default_rng(SEED).random(
            (BATCH, *cfg.input_hw, cfg.input_channels),
            dtype=np.float32)).cuda()
        trains = _model_trains(cfg, params, frames)
        summary = phase_kernels(cfg, params, frames, trains)
        summary.update(phase_train_kernels(cfg, params, trains))
        phase_model(cfg, params, frames, trains)
        del trains
        # kernels A and B count the serve run, C, D and E the train run,
        # F the two-kernel path of the ops layer
        launches, serve_fps = phase_serve(cfg)
    launches.update({k: v for k, v in phase_train(cfg).items()
                     if k not in launches})
    with torch.inference_mode():
        summary["lif_fused"] = phase_lif_fused()
        launches["lif_fused"] = phase_t1_contract(cfg, params, frames)
        phase_chunk(cfg, params, frames)
        phase_bucket_rows(cfg, params, frames)
    phase_engine(cfg, params, serve_fps)
    kernels = []
    csrc, tpu = "src/repro_torch/kernels/csrc/", "src/repro/kernels/"
    sources = {
        "spiking_conv": (csrc + "spiking_conv.cu",
                         tpu + "spiking_conv.py:149"),
        "spiking_conv_lif": (csrc + "spiking_conv_lif.cu",
                             tpu + "spiking_conv_lif.py:208"),
        "spiking_conv_lif_fwd": (csrc + "spiking_conv_lif.cu",
                                 tpu + "spiking_conv_lif.py:234"),
        "lif_bwd": (csrc + "lif_bwd.cu", tpu + "spiking_conv_lif.py:297"),
        "conv_grad_input": (csrc + "conv_grad_input.cu",
                            tpu + "spiking_conv.py:266"),
        "lif_fused": (csrc + "lif_fused.cu", tpu + "lif.py:39")}
    for name, recs in summary.items():
        # per snn-mnist forward or train step: the sum over the kernel's
        # main-path shapes
        bytes_, flops = sum(r["bytes"] for r in recs), sum(r["flops"]
                                                           for r in recs)
        bound_ms, bound_by = bound(bytes_, flops)
        lib = [r["library_ms"] for r in recs]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": sum(r["ms"] for r in recs),
            "plain_ms": sum(r["plain_ms"] for r in recs),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None if None in lib else sum(lib),
            "shapes": [r["shape"] for r in recs]})
    emit("done", seconds=time.perf_counter() - t0)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
