#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one NVIDIA card of compute capability 9.0+ and ``nvcc``; imports
neither JAX nor the JAX package.  Phases, each printing one JSON line:

  env     torch/CUDA versions, the card, its power limit
  build   the kernels, built from ``src/repro_torch/kernels/csrc`` in
          parallel into ``build/repro_torch``; the registers and spills
          of each instance of the tensor-core kernels (B/C, E) and the
          shared memory of their main-path plans
  kernel  each kernel against its plain version, at snn-mnist's main-path
          shapes (batch 256, T=8) and at SAME-pad, 5x5, all-zero, faint
          analog and CBWS-permuted cases (B and C also on a faint analog
          train, which drives their float32 path); kernel A in both modes:
          dV, and the hoisted first layer with and without SAVE_U (also
          ragged, nonzero-v0, T=1 and T=3 cases), bit for bit on analog
          frames; kernel, plain and library times (A's modes also their
          device time by the profiler), and bounds: ``bound_fp32_ms``
          (bytes against float32 FLOPs) and ``bound_ms``, which for B, C
          and E counts the three split products of every tap at the
          tensor-core peak of their pipe (bf16, TF32).
          The training kernels run on what the train step gives them: the
          training forward (C) on the layers' input trains, the LIF
          backward (D) on C's u (and on the hoisted mode's u at layer 0)
          with random cotangents, for every surrogate, and the input
          gradient (E) on D's lam folded to (T*B, ...), plus SAME-pad,
          5x5, ragged and mostly-zero cases; the weight gradient
          (``conv_grad_weights``, its spike instance on layers 1-2's
          trains and D's lam, its analog instance on layer 0's frames and
          the sum of its lam over T) against the plain torch-op GEMMs,
          with ``torch.nn.grad.conv2d_weight`` as its library time
  model   full-width snn-mnist, batch 256: backend="hopper" with an
          aprc+cbws schedule against backend="batched" (plain ops), both
          on the card; each layer's threshold flips (none in layer 0,
          whose kernel gives the plain path's bits); kernel launch counts
          per forward (every inference launch counting, and the
          skip-table finisher once a fused layer); the logits-only forward
          (``logits_only=True``) gives the same logits bits
  counts  the counting launches at the benchmark's shapes (snn-mnist at
          batch 1024, snn-seg at 16, skewed weights, CBWS-permuted): each
          layer's counting launch (hoisted mode, B) gives the bits of its
          launch without counts and counts equal to the reductions of its
          own train, whole and in two chunks; the finisher the bits of its
          plain version on the same row counts and of skip_table_fraction
          on the train; the epilogue's cost (counting against plain
          launches, device time); one forward counting through them alone
  profile one hopper forward's device time by kernel (torch.profiler)
          against its time between CUDA events: the device's idle share;
          the same for the logits-only forward and the batched one
  serve   the serve launcher answering a few requests (the main path of
          inference; the hoisted mode's and kernel B's launch counts are
          read around it)
  train   (a) one loss and gradient at full width, batch 256: hopper
          against batched, with the forward's threshold flips counted;
          (b) the training launcher, 10 SGD steps on each backend (the
          main path of training; the hoisted mode's SAVE_U and kernels C,
          D and E's launch counts are read around the hopper run); (c)
          one train step's time and its device time by kernel
  lif_fused   kernel F through ops.lif_fused against its plain version at
          (4096, 512) in float32 and bfloat16, (17, 300) and layer 1's
          membrane (262144, 32), the T=1 path's shape:
          max error 0, kernel, plain and bound times, and the device time
          of both by the profiler
  t1_contract layer 1 at batch 256 through the kernel-ops layer: kernel A
          on the first step of its input train, then F, equals kernel B
          with T=1 (the spike-train rule below); A's dV mode's and F's
          launch counts are read around this two-kernel path
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
          the same in both virtual runs; the hoisted mode's and kernel
          B's launch counts are read around each run; the virtual runs
          also give each micro-batch's measured dispatch time and the
          lanes' busy share
  seg     snn-seg (the paper's second net, T=16) at full width on
          ``road_like(16, seed=0)`` frames, He-normal weights from seed 0:
          (a) the main path through the facade, ``Session("snn-seg",
          ServeSpec(backend="hopper", schedule_mode="aprc+cbws"))``:
          ``infer`` (launches per forward counted: hoisted mode 1, B 4, A's
          dV mode 1 for the Cout=1 readout), ``serve`` and the serve
          launcher; (b) hopper against batched at batch 16: threshold flips
          per layer (none in layer 0) and the logits within the seg bound
          below; (c) one gradient of the reference's segmentation test loss
          ``sum(logits ** 2)``, hopper against batched, with its launches
          (the hoisted mode's SAVE_U 1, C 4, D 5, E 5, A's dV mode 1);
          (d) forward ms at batch 1 and 16, logits-only and batched, and
          the profiles of the forwards and of the gradient; then every kernel
          against its plain version at seg's shapes (the hoisted mode with
          Cin=3 and T=16, B and C at layers 1-4, D at layers 0-4, E at the
          readout, whose cotangent has one channel, and at layers 4-1,
          A's dV mode at Cout=1), with kernel, plain, library and bound
          times
  api     snn-mnist at batch 256 through ``repro_torch.api.Session`` on the
          card: ``infer`` equals ``snn_apply(backend="hopper", schedule=
          ...)`` bit for bit, 24 ``serve_forever`` requests equal ``infer``
          bit for bit, ``train_step`` (its first loss equals the raw
          step's) and ``evaluate`` (equals ``core.snn_train.accuracy``)
  mesh    the mesh runtime (``repro_torch.dist``) at full width:
          snn-mnist at batch 256 through ``Session`` with a data=1 mesh
          equals the unsharded ``Session.infer`` bit for bit (logits,
          counts, skip fractions; FPS of both); two contiguous halves
          through the kernels give the whole batch's logits, and their
          gradient rows the whole batch's rows, bit for bit; a mesh
          ``train_step`` at batch 32 within the gradient tolerance (atol
          5e-5, rtol 5e-4) of the unsharded step (ms of both); a threaded
          engine on lanes pinned by ``DeviceMesh.lane_devices`` accounts
          for every request through a lane crash and serves the mesh
          infer's bits; snn-seg (batch 16, T=16) through the mesh infer
          equals the unsharded bits; ``DeviceMesh(("data", 2))`` raises
          on one card (with two cards, data=2 equals data=1 instead)
  entry   the user-facing entry points: (a) the serve launcher with a
          ServeSpec file (hopper, aprc+cbws), single-shot at batch 256
          (its predictions equal ``Session.infer``'s bits) and ``--engine
          --trace-out`` at 512 requests (the file parses, one lane "X"
          event per micro-batch, one flow per request; the write's ms);
          (b) the train launcher with a TrainSpec file, 10 steps: its
          losses equal phase ``train``'s flag path's and the raw
          ``make_train_step``'s bit for bit; (c) the four
          ``examples/torch_*.py`` at the reference's defaults on hopper
          (quickstart's asserts hold), and the Fig. 7 ablation on snn-seg
          (80x160, T=12, 4 frames, ``skew_channels(sigma=1.2, seed=1)``)
          on hopper and on batched: per mode the threshold flips per
          layer, the per-layer count bound (the sum of |hopper - batched|
          spike counts over (t, channel) is at most T x the differing
          sites) and the logits within the seg bound below, under SAME
          pad for 'none' and 'cbws'; launches counted around each run
          (the ablation: hoisted 1, B 4, A's dV mode 1 a forward)
  lm      the LM substrate's serving path (``repro_torch.models``; plain
          PyTorch products, no SNN kernel: every kernel's launch count
          stays 0 around it), float32 weights from seed 0 made on the
          card, TF32 off: (a) qwen2.5-3b at full width and depth (36
          layers, d_model 2048, 16 heads over 2 KV heads, d_ff 11008,
          vocab 151936: 3.09 B parameters, 12.3 GB) through the serve
          launcher, ``--arch qwen2.5-3b --full-config --batch 4
          --prompt-len 64 --new 32`` (bfloat16 caches); (b) gemma3-4b at
          full width and depth (34 layers, 5 local to 1 global, window
          1024: 3.88 B parameters, 15.5 GB), batch 1, prompt 2048, then 16
          decode steps (both chunking branches of attention, the roll into
          the ring, ring slots that wrap).  For each, on the launcher's
          weights: prefill and 8 (qwen) or 16 (gemma) teacher-forced decode
          steps with float32 caches against ``forward`` over the prompt
          and the fed tokens (gemma's forward runs over 3072 tokens, a
          whole number of query chunks; later tokens change nothing at the
          compared positions); prefill ms (CUDA events, median of 3) and
          tokens/s against its FLOPs over the float32 peak
          (``counting.step_flops`` less the head of all tokens but the
          last, whose logits a prefill never computes);
          decode-step ms (median of the launcher's steps, each ended by a
          sync) and tokens/s against the parameter bytes over the HBM
          rate; device ms and launches of one decode step (the profiler);
          peak memory.  Then the card against the port's own code in
          float64 on the CPU, at full width with depth cut to 2 layers
          (the pattern's first and its first of another kind, so one
          sliding and one global layer of gemma3-4b) on weights from
          seed 0, and the same card run once more with TF32 products
          (recorded, then TF32 off again):
          qwen2.5-3b (batch 4, prompt 64, 4 decode steps), gemma3-4b
          (batch 1, prompt 1024: a full ring, 4 steps that wrap it), and
          (c) hubert-xlarge's ``encode_step`` on (2, 1024, 512) frames and
          pixtral-12b's prefill of 256 patches before 64 tokens, batch 2,
          then 2 decode steps.  (d) The DeepSeek layers: deepseek-moe-16b
          at full width and depth (28 layers, a dense one then 27 of 64
          routed experts top-6 and 2 shared: 16.38 B parameters, 65.5 GB)
          through the serve launcher as (a) does, and deepseek-v3-671b at
          full width cut to depth 2 (an MLA + dense layer, then an MLA +
          MoE layer of 256 experts top-8 and 1 shared: 13.94 B
          parameters, 55.8 GB) through ``serve_lm`` at batch 1, prompt
          2048 (both query-chunk branches of MLA), 16 decode steps; the
          MoE runs at its configured capacity factor 1.25, and the
          decode-against-forward check (prompt 64, 8 steps) at 2 x E / k
          on the same weights, so no token drops (the routed tokens
          whose experts differ between the forward and the prefill or a
          decode step are counted, with the near-tie margin); beside the
          decode step's bound on all parameter bytes (the dense dispatch
          reads every expert) the bound on the active ones
          (``count_params(active_only=True)``); the prefill's dropped
          (token, choice) pairs (``moe.recorded_routes``).  Their float64
          checks: deepseek-moe-16b at depth 2 (its dense layer and a MoE
          layer; the card's routing must equal float64's choice for
          choice), deepseek-v3-671b at depth 1 (an MLA + dense layer: its
          depth-2 cut would need 112 GB in float64 on the host).  (e) The
          state mixers: rwkv6-7b at full width and depth (32 time-mix
          layers with the channel-mix FFN: 7.00 B parameters, 28.0 GB)
          through the serve launcher, ``--batch 4 --prompt-len 256 --new
          32`` (two chunks of 128), and jamba-v0.1-52b at full width cut
          to its first period of 8 layers (7 Mamba, 1 attention; 4 dense
          and 4 MoE FFNs of 16 experts top-2: 13.30 B parameters, 53.2 GB)
          through ``serve_lm`` at batch 1, prompt 2048 (16 Mamba chunks),
          16 decode steps, its MoE at 1.25; decode against forward on a
          prompt of 128 and 128 steps (a forward of 256: a chunked scan
          takes a length shorter than its chunk or a multiple of it), at
          2 x E / k for jamba; their float64 checks at depth 2 (rwkv6: two
          time-mix layers; jamba: its first layer, Mamba + dense, and its
          attention layer)
  lm_train LM training on the card (``models.lm.make_train_step``:
          float32, TF32 off, AdamW in place; no SNN kernel launches):
          (a) qwen2.5-3b at full width and depth through the train
          launcher, ``--arch qwen2.5-3b --full-config --batch 4 --seq 256
          --steps 6`` with ``--checkpoint-every`` past the steps, so the
          final blocking save alone writes (params, m and v, 37.0 GB, under
          ``build/`` or the temp dir, whichever has the room; free disk
          and memory as ``df`` and ``free`` give them): the losses (finite,
          the first within 1.5 of ln V), median step ms and trained
          tokens/s beside the FLOPs bound (``counting.step_flops``'s
          "train", remat included, over the float32 peak), peak memory
          (under 80 GB), the save's seconds and bytes; then two steps of
          ``make_train_step`` on one batch lower the loss (the reference's
          ``test_loss_decreases_two_steps``), one step's time (CUDA
          events), device time, launches and idle share (the profiler),
          and the clip and AdamW alone against their bytes bound (ten
          passes of the parameters' bytes).  (b) The loss and every
          gradient leaf of ``loss_fn`` on the card against the port's code
          in float64 on the CPU, at full width, depth 2, batch 2, seq 64:
          qwen2.5-3b, deepseek-moe-16b (its dense and a MoE layer at
          factor 1.25, routing equal to float64's choice for choice),
          rwkv6-7b and jamba-v0.1-52b's first two layers (Mamba with a
          dense and with a MoE FFN), each within ``LM_F64_TOL`` of
          max(1, max|float64|) per leaf, and once more with TF32 products,
          which must exceed it.  (c) ``ResilientLoop`` on qwen2.5-3b at
          full width, depth 2: two uninterrupted runs of 7 steps against
          each other (their spread is the tolerance: 0 when the card's
          backward is run-to-run bitwise), a loop whose step raises after
          its backward at step 5 (checkpoints every 2) ends at the
          uninterrupted params, a second loop resumes from step 6 and
          ends at the uninterrupted step 7, and bfloat16 card tensors make
          a checkpoint round trip into their own storage.  (d)
          ``Prefetcher(device="cuda")``: batches in order, equal to
          ``token_batches``' bits
  dryrun  the LM accounting (``launch/cells.py``, ``dryrun.py``,
          ``comm_analysis.py``; host-side, on ``meta`` tensors): (a)
          qwen2.5-3b x train_4k on the production mesh (data=16,
          model=16) as rank 0 of a fake group of 256, in two processes
          of their own (``python -m repro_torch.launch.dryrun``, each
          within ``DRYRUN_TIMEOUT``), one mesh typed ``cpu``, one
          ``cuda``: both end ``ok`` with equal collectives, FLOPs and
          memory, and the record is printed; (b) phase ``lm_train``'s
          configuration (qwen2.5-3b whole, float32 params and moments,
          batch 4, seq 256, remat) traced on one device: its argument
          bytes equal the live state's and batch's on the card exactly,
          its peak lies within ``DRYRUN_PEAK_BAND`` of the card's peak
          over two raw train steps (``max_memory_allocated`` less what the
          process held before), and its counted FLOPs over
          ``counting.step_flops``
  lm_mesh  the sharded LM (``sharding.partitioning``, the bodies on
          local shards, ``dist.spmd``; no SNN kernel launches): (a)
          qwen2.5-3b at full width, 2 layers, on a mesh data=1 x model=1
          over a real NCCL group of one (this process): weights built
          leaf by leaf equal ``init_params``', a prefill (batch 4, 64
          tokens) and 8 decode steps under ``serve`` and 3 steps of the
          launcher's ``train_lm`` under ``tp_fsdp`` against the unsharded
          path on the same weights, bit for bit, or the first differing
          tensor named and held to ``LM_MESH_TOL`` x max(1, |ref|); a
          decode step's ms, device ms and launches, sharded and not, and
          peak memory; then the train launcher's ``--mesh 1x1`` (reduced,
          its rank spawned on NCCL) against its one-device losses; (b)
          the split mixers' code on the same group: jamba-v0.1-52b (its
          first two layers: Mamba with a dense FFN and with the MoE) and
          rwkv6-7b at full width, 2 layers, the same prefill and decode
          steps and 3 raw train steps, bit for bit the same way; (c)
          with two or more cards, ``--mesh 1x2`` and ``2x1`` within 1e-5

then the card's name and power limit as nvidia-smi gives them, the
kernels' summary line (each kernel's times, bounds and shapes summed over
its main-path shapes of both nets, its launches over the counted runs) and,
last, ``{"ok": true, "device": {...}}``.  A failed check raises, and the
script exits nonzero; so does a deprecation warning of the port's facade
(every call here passes ``spec=``).

The comparison rule for the spike trains.  Kernels B and C sum the taps
of a spike train in another order than the plain path (which sums exactly
and rounds once), so a membrane within a few ulps of v_th can
fire in one and not in the other (a threshold flip), and that site's
train differs from then on.  So a spike train passes when at most
``MAX_FLIP_FRACTION`` of its sites (batch x pixel x channel) differ, every
differing site first differs at a step where the plain pre-reset membrane
lay within ``FLIP_BAND`` of v_th, and the final membranes of all agreeing
sites agree to ``V_ATOL``.  Kernel A sums an analog input's taps in the
plain path's order and rounding, so on the frames (and on an all-zero
input) its dV, and the hoisted mode's trains, u and final membranes, equal
the plain version's bit for bit; on a spike input, which the plain path
sums exactly in float64, A's dV agrees to ``DV_TOL`` (abs and rel).  The
saved membrane u agrees to ``U_ATOL`` where the trains agree; the LIF
backward to ``BWD_TOL`` (rel and abs: it repeats the plain
version's float operations); the input gradient to ``DX_TOL`` of its
largest value.  The model's logits agree with batched to ``LOGITS_ATOL``
beyond their threshold-flip bound: the readout adds ``w[j] / T`` per
spike, so the last train's differing sites bound how far each image's
logits may move (``compare_trains``; 0 for an image without a flip).  A
train step's loss agrees with batched to ``LOSS_ATOL`` beyond twice the
mean of the images' largest flip bounds; with no threshold flip in the
forward, every gradient leaf agrees to a relative norm of ``GRAD_REL``
(``FLIP_GRAD_REL`` with flips).

The seg bound.  snn-seg's readout is the non-firing conv of layer 4's
train: logits = crop(sum over t of dV_t) / T, dV_t = conv(s4_t, w5) + b5,
summed over t in the same order on both backends.  A site of layer 4's
train that differs at step t moves dV_t by |w5[dy, dx, c]| at each output
of its 3x3 window, so a pixel's flip bound is conv(D, |w5|) / T, D the
number of differing steps of each site (0 where the trains agree).  On top
comes the rounding: kernel A's dV of a spike input (float32, its own
order) and the plain path's (exact in float64, rounded once) differ by at
most ``DV_TOL`` * (1 + |dV_t|) (the dV rule), the running sum rounds once
more a step (2^-23 |v_t|) and the division by T once (2^-24 |logit|), with
|dV_t| and |v_t| the larger of the two backends'.  A pixel's logits agree
to the sum of its flip and rounding bounds, and the loss sum(logits ** 2)
to the sum over pixels of e (2 |l| + e), e that bound.
All plain versions and yardsticks run with TF32 off.

The LM bounds.  Decode against forward on the same weights, float32
caches, within ``tests/test_decode.py``'s bounds: ``LM_PREFILL_TOL`` for
the prefill's logits and ``LM_DECODE_TOL`` for each decode step's, times
max(1, max|forward logit|).  Those checks use prompts at least as long as
the sliding window: a shorter prompt leaves the reference's max_len
buffer in place of the ring, and its decode then attends past the window
(the reference's behaviour, which the port keeps; ``ROADMAP.md`` queue
3).  The card's float32 logits agree with the port's code in float64 on
the CPU to ``LM_F64_TOL`` times max(1, max|float64 logit|): a float32
product over at most 18432 terms of unit-scale operands is good to about
1e-6 of its scale, and two layers and float32 norms, rope and softmax on
both sides add little (measured on an H100: 1.5e-7 to 3.2e-6).  The same
card runs with TF32 products (a 10-bit mantissa) must exceed the
tolerance, so that it would see them (measured: 4.0e-5 to 1.8e-3; the
random weights keep these logits under 1, so the floor of 1 makes the
errors absolute).  1e-5 lies between the two, 3x from the largest float32
error and 4x from the smallest TF32 one.
"""
from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

MAX_FLIP_FRACTION = 1e-5   # sites of a spike train that may differ
FLIP_BAND = 1e-4           # |u - v_th| at a site's first differing step
V_ATOL = 1e-4              # final membrane at sites whose trains agree
DV_TOL = 1e-5              # kernel A's dV on a spike input, abs and rel
U_ATOL = 1e-5              # saved pre-reset membrane, where trains agree
BWD_TOL = 1e-6             # LIF backward lam and dv0, rel and abs
DX_TOL = 1e-5              # input gradient, relative to its largest value
DW_TOL = 1e-5              # weight gradient, relative to its largest value
LOGITS_ATOL = 1e-3         # model logits, beyond their threshold-flip bound
LOSS_ATOL = 1e-5           # train-step loss, beyond its threshold-flip bound
GRAD_REL = 1e-4            # ||g_hopper - g_batched|| / ||g_batched||
FLIP_GRAD_REL = 1e-2       # the same, when the forward had threshold flips
TRAJ_TOL = 1e-3            # 10-step loss trajectories, rel and abs
MIN_LOSS_DROP = 0.05       # the hopper run's first loss minus its last
LM_PREFILL_TOL = 1e-3      # LM prefill against forward, x max(1, |logit|)
LM_DECODE_TOL = 2e-3       # LM decode against forward, x max(1, |logit|)
LM_F64_TOL = 1e-5          # LM on the card against float64 on the CPU
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
# outside the tensor cores (kernels A, D, F), and the dense tensor-core
# rates of the pipes kernels B and C (bf16) and E (TF32) use
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
# the products of one tap on the tensor cores: three bf16 weight planes
# (B, C), three TF32 products (E)
SPLIT_PRODUCTS = 3
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


def host_ms(fn, calls: int = 200) -> float:
    """Host ms of one call of ``fn``: ``calls`` calls back to back on an
    input whose device time is below the host's, so the wall time is the
    host's (a wrapper's checks, allocations and launch)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


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
    """(bytes, FLOPs, tap FLOPs) one call must move and compute on this
    input: each input byte read once, each output written once; the taps
    of every (image, row-block) whose receptive rows hold a nonzero input
    (the kernel's skip, at its row-blocks: kernel A's SIMT plan, or with
    the LIF kernels B and C's tensor-core plan), plus 4 FLOPs per membrane
    update for the LIF; with ``save_u`` also the pre-reset membrane
    written."""
    from repro_torch.kernels.spiking_conv import (conv_pads, plan_mma_tiles,
                                                  plan_tiles)
    r, _, cin, cout = w.shape
    *lead, h, wd, _ = x.shape
    lo, _ = conv_pads(r, aprc)
    e_h, e_w = (h + r - 1, wd + r - 1) if aprc else (h, wd)
    br = (plan_mma_tiles(e_w, r, cin, cout).block_rows if lif
          else plan_tiles(e_w, r, cin, cout)[0])
    imgs = x.reshape(-1, h, wd, cin)
    flops = taps = tap_flops(imgs, r, cout, lo, e_h, e_w, br)
    n_out = imgs.shape[0] * e_h * e_w * cout
    out_bytes = 4 * n_out * (2 if save_u else 1)
    in_bytes = 4 * (x.numel() + w.numel() + cout)
    if lif:
        flops += 4.0 * n_out
        membranes = 4 * n_out // lead[0]
        in_bytes += membranes                   # v0
        out_bytes += membranes                  # v_final
    return in_bytes + out_bytes, flops, taps


def hoisted_work(x, w, t: int, aprc: bool, save_u: bool):
    """(bytes, FLOPs) of kernel A's hoisted mode: the frames, weights, bias
    and v0 read once, the spike train (and u) of every step and v_final
    written once; the taps of every (image, row-block) with a nonzero input
    (as for the dV mode), plus 4 FLOPs per membrane update."""
    nbytes, flops, _ = conv_work(x, w, aprc, lif=False)
    n_out = (nbytes - 4 * (x.numel() + w.numel() + w.shape[-1])) // 4
    # conv_work's dV stands for v0 read; then s (and u) of every step and
    # v_final written
    out_planes = t * (2 if save_u else 1) + 1
    return nbytes + 4 * n_out * out_planes, flops + 4.0 * t * n_out


def grad_input_work(dz, w, aprc: bool):
    """(bytes, FLOPs) of the input gradient: dz read once, dx written once,
    the transposed taps of every row-block with a nonzero cotangent."""
    from repro_torch.kernels.spiking_conv import conv_pads, plan_mma_tiles
    r, _, cin, cout = w.shape
    n, e_h, e_w, _ = dz.shape
    lo, hi = conv_pads(r, aprc)
    h, wd = e_h + r - 1 - lo - hi, e_w + r - 1 - lo - hi
    br = plan_mma_tiles(wd, r, cout, cin, split="tf32x3").block_rows
    flops = tap_flops(dz, r, cin, r - 1 - lo, h, wd, br)
    return 4 * (dz.numel() + w.numel() + n * h * wd * cin), flops


def wgrad_work(x, dz, r: int):
    """(bytes, FLOPs) of the weight gradient: x and dz read once, dw and
    db written once; the forward conv's products over every position, 2 *
    M * R * R * Cin * Cout (skybench/work.py's count)."""
    cin, (n, e_h, e_w, cout) = x.shape[-1], dz.shape
    return (4 * (x.numel() + dz.numel() + r * r * cin * cout + cout),
            2.0 * n * e_h * e_w * r * r * cin * cout)


# per element and step of the LIF backward: u - v_th, the surrogate (at
# most 6 operations), then c + (g_s - v_th * c) * sg (4)
LIF_BWD_FLOPS = 10


def lif_bwd_work(u):
    """(bytes, FLOPs) of the LIF backward: u, g_s read and lam written per
    step, g_v read and dv0 written once."""
    t, m = u.shape[0], u[0].numel()
    return 4 * (3 * t * m + 2 * m), float(LIF_BWD_FLOPS * t * m)


def bound(nbytes: float, flops: float, peak: float = PEAK_FP32):
    """The least ms the card could take: bytes at the memory rate against
    operations at ``peak`` (float32 outside the tensor cores by default),
    and which of the two bounds it."""
    t_mem, t_ops = nbytes / PEAK_BYTES, flops / peak
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def set_bounds(rec, nbytes, flops, taps=None, peak=None):
    """A kernel record's bounds: bound_fp32_ms (bytes against float32
    FLOPs), and bound_ms, which for a tensor-core kernel (``peak`` given)
    counts the split's products of every tap at that pipe's peak."""
    rec["bytes"], rec["flops"] = nbytes, flops
    rec["bound_fp32_ms"], by = bound(nbytes, flops)
    if peak is None:
        rec["bound_ms"], rec["bound_by"] = rec["bound_fp32_ms"], by
    else:
        rec["tap_flops"], rec["peak_flops"] = taps, peak
        rec["mma_flops"] = SPLIT_PRODUCTS * taps
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, rec["mma_flops"],
                                                 peak)
    return rec


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


def check_dw(name, got, want):
    """The weight gradient (dw, db) agrees to DW_TOL of its largest
    value."""
    err = 0.0
    for a, b in zip(got, want):
        e = float((a - b).abs().max())
        if a.shape != b.shape or e > DW_TOL * float(b.abs().max()):
            fail(f"{name}: {tuple(a.shape)} differs from the plain "
                 f"{tuple(b.shape)} by up to {e}")
        err = max(err, e)
    return err


def wgrad_row(case, x, dz, binary: bool):
    """The weight-gradient kernel (the spike instance, or the analog one)
    on (x, dz) against the plain torch-op GEMMs: its record, emitted, with
    its times, the plain version's and the library's
    (``torch.nn.grad.conv2d_weight``, float32) and its bounds (the spike
    instance's three bf16 products of every tap at the tensor cores'
    peak; the analog instance's float32 FMAs)."""
    import torch
    from repro_torch.device import full_fp32
    from repro_torch.kernels import ref
    from repro_torch.kernels.spiking_conv import conv_grad_weights
    r = 3
    name = "conv_grad_weights" + ("" if binary else "_analog")

    def call():
        return conv_grad_weights(x, dz, aprc=True, r=r, binary=binary)

    err = check_dw(f"{name} {case}", call(),
                   ref.conv_grad_weights_ref(x, dz, aprc=True, r=r))
    cin, cout = x.shape[-1], dz.shape[-1]
    x_nchw, g_nchw = x.permute(0, 3, 1, 2), dz.permute(0, 3, 1, 2)

    def library():
        with full_fp32():
            return torch.nn.grad.conv2d_weight(x_nchw, (cout, cin, r, r),
                                               g_nchw, padding=r - 1)

    nbytes, flops = wgrad_work(x, dz, r)
    rec = {"shape": [list(x.shape), list(dz.shape)], "max_abs_err": err,
           "ms": cuda_ms(call), "device_ms": device_ms(call),
           "plain_ms": cuda_ms(lambda: ref.conv_grad_weights_ref(
               x, dz, aprc=True, r=r), reps=5),
           "library_ms": cuda_ms(library, reps=5)}
    if binary:
        set_bounds(rec, nbytes, flops, flops, PEAK_BF16)
    else:
        set_bounds(rec, nbytes, flops)
    emit("kernel", name=name, case=case, **rec)
    return name, rec


def check_dv(name, got, want):
    import torch
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=DV_TOL, rtol=DV_TOL):
        fail(f"{name}: dV differs by up to {err}")
    return err


def check_exact(name, got, want):
    """Kernel A on an analog (or all-zero) input: each output has the plain
    version's bits.  Returns the largest difference (0)."""
    import torch
    if len(got) != len(want):
        fail(f"{name}: {len(got)} outputs, the plain version {len(want)}")
    for k, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or not torch.equal(a, b):
            err = (float((a - b).abs().max()) if a.shape == b.shape
                   else float("inf"))
            fail(f"{name}: output {k} differs from the plain version by "
                 f"up to {err}")
    return 0.0


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


def ptxas_entries(log: str):
    """Registers and spills of each tensor-core kernel instance in a ptxas
    report: [kernel, NT, SAVE_U, registers, spill stores, spill loads]; of
    the weight gradient's, [kernel, MT, NT, ANALOG, ...]."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?"
                      r"(spiking_conv_lif_kernel|conv_grad_input_kernel)"
                      r"ILi(\d)E(?:Lb([01])E)?", ln)
        w = re.search(r"Compiling entry function '\S*?"
                      r"conv_grad_weights_kernelILi(\d)ELi(\d)ELb([01])E",
                      ln)
        if m:
            cur = {"kernel": m.group(1), "n_tiles": int(m.group(2)),
                   "save_u": m.group(3) == "1"}
            out.append(cur)
            continue
        if w:
            cur = {"kernel": "conv_grad_weights_kernel",
                   "m_tiles": int(w.group(1)), "n_tiles": int(w.group(2)),
                   "analog": w.group(3) == "1"}
            out.append(cur)
            continue
        if "Compiling entry function" in ln:
            cur = None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and cur is not None and "spill_stores" not in cur:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None and "registers" not in cur:
            cur["registers"] = int(m.group(1))
    return out


def phase_build():
    from repro_torch.analysis import check_cuda_abi
    from repro_torch.kernels import _build
    from repro_torch.kernels.spiking_conv import plan_mma_tiles, plan_wgrad
    # the ctypes declarations against the sources' C entry points
    checked = []
    findings = check_cuda_abi(checked=checked)
    emit("build", cuda_abi_entries=sorted({e for _, _, e in checked}),
         cuda_abi_findings=[str(f) for f in findings])
    if findings:
        fail("cuda-abi: " + "; ".join(str(f) for f in findings))
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
    # the two tensor-core sources: each instance's registers and spills,
    # and the dynamic shared memory of the main path's launches (their
    # plans; ptxas reports static shared memory only)
    plans = {
        "B/C layer 1": plan_mma_tiles(32, 3, 16, 32),
        "B/C layer 2": plan_mma_tiles(34, 3, 32, 8),
        "E layer-2 backward": plan_mma_tiles(32, 3, 8, 32, split="tf32x3"),
        "E layer-1 backward": plan_mma_tiles(30, 3, 32, 16, split="tf32x3")}
    for name in ("spiking_conv_lif", "conv_grad_input"):
        if name in reports:
            emit("build", source=f"csrc/{name}.cu",
                 instances=ptxas_entries(reports[name]),
                 main_path_plans={k: p._asdict() for k, p in plans.items()
                                  if k.startswith("E") ==
                                  (name == "conv_grad_input")})
    if "conv_grad_weights" in reports:
        n = BATCH * 8
        emit("build", source="csrc/conv_grad_weights.cu",
             instances=ptxas_entries(reports["conv_grad_weights"]),
             main_path_plans={
                 "layer 1": plan_wgrad(n, 32, 32, 3, 16, 32)._asdict(),
                 "layer 2": plan_wgrad(n, 34, 34, 3, 32, 8)._asdict(),
                 "layer 0": plan_wgrad(BATCH, 30, 30, 3, 1, 16,
                                       analog=True)._asdict()})


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
    from repro_torch.kernels.spiking_conv import (
        spiking_conv, spiking_conv_lif_hoisted,
        spiking_conv_lif_hoisted_plain, spiking_conv_plain)
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

    # kernel A's dV mode: the first layer's conv (the T=1 path of the ops
    # layer, and the conv the hoisted mode computes), then its other cases
    w0, b0 = conv[0]["w"], conv[0]["b"]
    got = spiking_conv(frames, w0, b0)
    err = check_exact("spiking_conv layer0", [got],
                      [spiking_conv_plain(frames, w0, b0)])
    nbytes, flops, _ = conv_work(frames, w0, True, lif=False)
    w_oihw = w0.permute(3, 2, 0, 1).contiguous()
    x_nchw = frames.permute(0, 3, 1, 2)

    def library():
        with full_fp32():
            return F.conv2d(x_nchw, w_oihw, b0, padding=2)

    one = frames[:1]
    rec = {"shape": list(frames.shape), "max_abs_err": err,
           "ms": cuda_ms(lambda: spiking_conv(frames, w0, b0)),
           "device_ms": device_ms(lambda: spiking_conv(frames, w0, b0)),
           # the wrapper's host time, at batch 1, beside one PyTorch op's
           "host_ms_batch1": host_ms(lambda: spiking_conv(one, w0, b0)),
           "torch_op_host_ms_batch1": host_ms(lambda: one + 1.0),
           "plain_ms": cuda_ms(lambda: spiking_conv_plain(frames, w0, b0)),
           "library_ms": cuda_ms(library)}
    set_bounds(rec, nbytes, flops)
    emit("kernel", name="spiking_conv", case="snn-mnist layer 0", **rec)
    summary["spiking_conv"] = [rec]

    def analog(*shape):
        return torch.rand(shape, generator=gen).to(dev)

    # (input, w, b, aprc, exact): the plain path sums a spike input exactly
    # in float64 and rounds once, an analog one in A's order
    a_cases = {
        "same-pad 3x3": (spikes(64, 32, 32, 16, rate=0.2),
                         rand(3, 3, 16, 32, scale=0.1), rand(32, scale=0.1),
                         False, False),
        "5x5 taps": (spikes(64, 28, 28, 8, rate=0.2),
                     rand(5, 5, 8, 16, scale=0.1), rand(16, scale=0.1), True,
                     False),
        "same-pad 3x3 analog": (analog(64, 32, 32, 16),
                                rand(3, 3, 16, 32, scale=0.1),
                                rand(32, scale=0.1), False, True),
        "5x5 taps analog": (analog(64, 28, 28, 2), rand(5, 5, 2, 16),
                            rand(16, scale=0.1), True, True),
        "all-zero input": (torch.zeros((64, 30, 30, 16), device=dev),
                           conv[1]["w"], conv[1]["b"] + 0.25, True, True),
    }
    faint = torch.zeros((4, 28, 28, 1), device=dev)
    faint[0, 5, 9, 0] = 0.2
    faint[3, 27, 0, 0] = 0.01
    a_cases["faint analog frame"] = (faint, w0, b0, True, True)
    for case, (x, w, b, aprc, exact) in a_cases.items():
        got = spiking_conv(x, w, b, aprc=aprc)
        want = spiking_conv_plain(x, w, b, aprc=aprc)
        err = (check_exact(f"spiking_conv {case}", [got], [want]) if exact
               else check_dv(f"spiking_conv {case}", got, want))
        if case == "faint analog frame" and not bool(
                (got[0] != b0).any() and (got[3] != b0).any()):
            fail("spiking_conv skipped a faint analog frame")
        emit("kernel", name="spiking_conv", case=case, shape=list(x.shape),
             bit_exact=exact, max_abs_err=err)

    # kernel A's hoisted mode: the main path (the zero carry, T=8), with
    # and without SAVE_U, then its other cases, all bit for bit
    T = cfg.timesteps
    v0 = torch.zeros((BATCH,) + layer_shapes(cfg)[0], device=dev)
    for save_u in (False, True):
        name = "spiking_conv_lif_hoisted" + ("_save_u" if save_u else "")
        kw = dict(t=T, v_th=v_th, save_u=save_u)
        got = spiking_conv_lif_hoisted(frames, v0, w0, b0, **kw)
        err = check_exact(f"{name} layer0", got,
                          spiking_conv_lif_hoisted_plain(frames, v0, w0, b0,
                                                         **kw))
        nbytes, flops = hoisted_work(frames, w0, T, True, save_u)
        rec = {"shape": list(frames.shape), "timesteps": T,
               "spikes": float(got[0].sum()), "max_abs_err": err,
               "ms": cuda_ms(lambda: spiking_conv_lif_hoisted(
                   frames, v0, w0, b0, **kw)),
               "device_ms": device_ms(lambda: spiking_conv_lif_hoisted(
                   frames, v0, w0, b0, **kw)),
               "host_ms_batch1": host_ms(lambda: spiking_conv_lif_hoisted(
                   one, v0[:1], w0, b0, **kw)),
               "plain_ms": cuda_ms(lambda: spiking_conv_lif_hoisted_plain(
                   frames, v0, w0, b0, **kw), reps=10),
               "library_ms": None}
        del got
        set_bounds(rec, nbytes, flops)
        emit("kernel", name=name, case="snn-mnist layer 0", **rec)
        summary[name] = [rec]
    x64 = frames[:64]
    h_cases = {
        "same-pad 3x3": (x64, rand(3, 3, 1, 16, scale=0.5),
                         rand(16, scale=0.1), False, 0.0, T),
        "5x5 taps": (analog(64, 28, 28, 2), rand(5, 5, 2, 8, scale=0.3),
                     rand(8, scale=0.1), True, 0.0, T),
        "all-zero frames": (torch.zeros_like(x64), w0, b0 + 0.25, True, 0.0,
                            T),
        "ragged rows": (frames[:64, :27, :25].contiguous(), w0, b0, True,
                        0.0, T),
        "nonzero v0": (x64, w0, b0, True, 0.5, T),
        "T=1": (x64, w0, b0, True, 0.5, 1),
        "T=3": (x64, w0, b0, True, 0.5, 3),
    }
    for case, (x, w, b, aprc, v0_scale, t) in h_cases.items():
        e_h, e_w = conv_out_hw(x.shape[1], x.shape[2], w.shape[0], aprc)
        v0 = rand(x.shape[0], e_h, e_w, w.shape[-1], scale=v0_scale)
        for save_u in (False, True):
            kw = dict(t=t, v_th=v_th, aprc=aprc, save_u=save_u)
            got = spiking_conv_lif_hoisted(x, v0, w, b, **kw)
            check_exact(f"spiking_conv_lif_hoisted {case}", got,
                        spiking_conv_lif_hoisted_plain(x, v0, w, b, **kw))
            if not save_u:
                check_counted(f"spiking_conv_lif_hoisted {case}",
                              spiking_conv_lif_hoisted(x, v0, w, b,
                                                       count=True, **kw),
                              *got)
            spiked = float(got[0].sum())
            if case == "all-zero frames" and not spiked > 0:
                fail("spiking_conv_lif_hoisted: the bias-only skip path "
                     "did not fire")
            emit("kernel", name="spiking_conv_lif_hoisted", case=case,
                 shape=list(x.shape), timesteps=t, save_u=save_u,
                 spikes=spiked, bit_exact=True)

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
        nbytes, flops, taps = conv_work(x, w, True, lif=True)
        rec.update(
            shape=list(x.shape), max_abs_err=rec["max_abs_err_v_agreeing"],
            ms=cuda_ms(lambda: spiking_conv_lif(x, v0, w, b, v_th=v_th),
                       reps=10),
            plain_ms=cuda_ms(lambda: spiking_conv_lif_plain(
                x, v0, w, b, v_th=v_th), reps=10),
            library_ms=None)
        set_bounds(rec, nbytes, flops, taps, PEAK_BF16)
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
        # values that are not 0 or 1 at the even steps: those (block, step)
        # cells take the kernel's float32 tap sum, the odd steps the MMAs
        "faint analog train": (faint_train(gen, dev), w1, b1, True, None),
    }
    for case, (x, w, b, aprc, out_perm) in b_cases.items():
        e_h, e_w = conv_out_hw(x.shape[2], x.shape[3], w.shape[0], aprc)
        v0 = rand(x.shape[1], e_h, e_w, w.shape[-1], scale=0.3)
        s, v = spiking_conv_lif(x, v0, w, b, v_th=v_th, aprc=aprc)
        check_counted(f"spiking_conv_lif {case}", spiking_conv_lif(
            x, v0, w, b, v_th=v_th, aprc=aprc, count=True), s, v)
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


def faint_train(gen, dev):
    """A (8, 64, 30, 30, 16) input of layer 1's width whose even steps hold
    faint analog values in (0, 0.5) where the odd steps hold spikes (rate
    0.2): not a spike train, as a caller of the public wrappers may pass."""
    import torch
    x = (torch.rand((8, 64, 30, 30, 16), generator=gen) < 0.2).float()
    x[::2] *= torch.rand(x[::2].shape, generator=gen) * 0.5
    return x.to(dev)


def phase_train_kernels(cfg, params, frames, trains):
    """Kernels C, D and E against their plain versions on what the train
    step gives them (D also on layer 0's u from the hoisted mode's
    SAVE_U); returns their summary entries."""
    import torch
    from repro_torch.core.snn_model import layer_shapes
    from repro_torch.core.surrogate import SURROGATE_KINDS
    from repro_torch.device import full_fp32
    from repro_torch.kernels import ref
    from repro_torch.kernels.spiking_conv import (conv_grad_input,
                                                  spiking_conv_lif_hoisted)
    from repro_torch.kernels.spiking_conv_lif import (lif_bwd,
                                                      spiking_conv_lif_fwd)
    dev, v_th, conv = trains[0].device, cfg.v_threshold, params["conv"]
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    summary = {"spiking_conv_lif_fwd": [], "lif_bwd": [],
               "conv_grad_input": [], "conv_grad_weights": [],
               "conv_grad_weights_analog": []}
    lams = {}

    def check_lif_bwd(layer, u):
        """Kernel D on u, every surrogate; fast_sigmoid (the default) is
        the main path's, its record goes to the summary and its lam is
        returned."""
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
                   "library_ms": None}
            set_bounds(rec, nbytes, flops)
            emit("kernel", name="lif_bwd", case=f"snn-mnist layer {layer}",
                 **rec)
            if kind == "fast_sigmoid":
                summary["lif_bwd"].append(rec)
                main = lam
            del lam, dv0
        return main

    # layer 0: the hoisted mode's u (the frames need no gradient, so its
    # lam feeds only the weight gradient)
    v0 = torch.zeros((BATCH,) + layer_shapes(cfg)[0], device=dev)
    _, _, u = spiking_conv_lif_hoisted(frames, v0, conv[0]["w"],
                                       conv[0]["b"], t=cfg.timesteps,
                                       v_th=v_th, save_u=True)
    del v0
    lams[0] = check_lif_bwd(0, u).sum(dim=0)
    del u
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
        nbytes, flops, taps = conv_work(x, w, True, lif=True, save_u=True)
        rec.update(
            shape=list(x.shape), max_abs_err=max(
                u_err, rec["max_abs_err_v_agreeing"]),
            max_abs_err_u_agreeing=u_err,
            ms=cuda_ms(lambda: spiking_conv_lif_fwd(x, v0, w, b, v_th=v_th),
                       reps=10),
            plain_ms=cuda_ms(lambda: ref.spiking_conv_lif_ref(
                x, v0, w, b, v_th=v_th, save_u=True), reps=10),
            library_ms=None)
        set_bounds(rec, nbytes, flops, taps, PEAK_BF16)
        emit("kernel", name="spiking_conv_lif_fwd",
             case=f"snn-mnist layer {layer}", **rec)
        summary["spiking_conv_lif_fwd"].append(rec)

        # kernel D on C's u; the main path's lam feeds kernel E
        lam = check_lif_bwd(layer, u)
        lams[layer] = lam.reshape((-1,) + lam.shape[2:])
        del u, lam

    # the weight gradient on what the train step gives it: layers 1 and 2's
    # trains and lam folded to (T*B, ...), layer 0's frames and its lam
    # summed over T
    for layer, x in ((1, trains[0]), (2, trains[1]), (0, frames)):
        name, rec = wgrad_row(f"snn-mnist layer {layer}",
                              x.reshape((-1,) + x.shape[-3:]), lams[layer],
                              binary=layer > 0)
        summary[name].append(rec)
    del lams[0]

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
               "library_ms": cuda_ms(library)}
        set_bounds(rec, nbytes, flops, flops, PEAK_TF32)
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

    # kernel C on an input that is not a spike train (see faint_train)
    x, w, b = faint_train(gen, dev), conv[1]["w"], conv[1]["b"]
    v0 = randn(64, 32, 32, 32) * 0.3
    s, v, u = spiking_conv_lif_fwd(x, v0, w, b, v_th=v_th)
    s_p, v_p, u_p = ref.spiking_conv_lif_ref(x, v0, w, b, v_th=v_th,
                                             save_u=True)
    rec = check_train("spiking_conv_lif_fwd faint analog train", s, v, s_p,
                      v_p, u_p, v_th)
    agree = (s == s_p).all(dim=0)
    u_err = float((u - u_p).abs()[:, agree].max())
    if u_err > U_ATOL:
        fail(f"spiking_conv_lif_fwd faint analog train: u differs by "
             f"{u_err} (> {U_ATOL}) where the trains agree")
    emit("kernel", name="spiking_conv_lif_fwd", case="faint analog train",
         shape=list(x.shape), max_abs_err_u_agreeing=u_err, **rec)
    return summary


def phase_model(cfg, params, frames, trains):
    import torch
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.core.snn_model import snn_apply
    from repro_torch.kernels.spiking_conv import skip_table_fraction
    sched = build_schedule(params, cfg, "aprc+cbws")
    reset_counts()
    got = snn_apply(params, frames, cfg, backend="hopper", schedule=sched)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts().items() if v}
    if launches != counted_forwards(1, 2):
        fail(f"one hopper forward launched {launches}, expected the "
             f"hoisted mode 1 and B 2, all counting, and the finisher 2")
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
    batched_ms = cuda_ms(lambda: snn_apply(params, frames, cfg,
                                           backend="batched"), reps=10)
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
         forward_ms=forward_ms, forward_ms_batched=batched_ms)
    if tuple(got.logits.shape) != (BATCH, cfg.dense_units[-1]) or not bool(
            torch.isfinite(got.logits).all()):
        fail(f"logits {tuple(got.logits.shape)} not finite/of the "
             f"expected shape")
    if any(f > MAX_FLIP_FRACTION * n for f, n in flips):
        fail(f"threshold flips per layer {flips} exceed {MAX_FLIP_FRACTION}")
    if flips[0][0]:
        fail(f"layer 0's train differs from the plain path's at "
             f"{flips[0][0]} sites: kernel A's hoisted mode must give its "
             f"bits")
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
    # the logits-only forward (the serving cache's logits entries, the
    # training loss): the same logits bits, without the counting work
    only = snn_apply(params, frames, cfg, backend="hopper", schedule=sched,
                     logits_only=True)
    if not torch.equal(only.logits, got.logits) or only.spike_counts:
        fail("the logits-only hopper forward differs from the full one")
    only_ms = cuda_ms(lambda: snn_apply(params, frames, cfg,
                                        backend="hopper", schedule=sched,
                                        logits_only=True), reps=10)
    phase_profile(lambda: snn_apply(params, frames, cfg, backend="hopper",
                                    schedule=sched, logits_only=True),
                  only_ms, "hopper forward, logits only")
    phase_profile(lambda: snn_apply(params, frames, cfg, backend="batched"),
                  batched_ms, "batched forward")


COUNT_BATCHES = {"snn-mnist": 1024, "snn-seg": 16}   # the benchmark's


def check_counted(name, outs, want_s, want_v):
    """A counting launch's (s, v, TrainCounts): the train and membrane of
    the same launch without counts, bit for bit, and counts equal to
    torch's reductions of that train (``train_counts_plain``).  Returns
    the counts."""
    import torch
    from repro_torch.kernels.spiking_conv import train_counts_plain
    s, v, c = outs
    check_exact(f"{name}, counting", [s, v], [want_s, want_v])
    plain = train_counts_plain(s)
    for part in ("t", "rows"):
        a, b = getattr(c, part), getattr(plain, part)
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"{name}: the launch's {part} counts differ from the "
                 f"reductions of its train at "
                 f"{int((a != b).sum()) if a.shape == b.shape else -1} "
                 f"entries")
    return c


def phase_counts():
    """The counting launches at the benchmark's shapes (snn-mnist at batch
    1024 on ``mnist_like`` digits, snn-seg at batch 16 on ``road_like``
    frames, skewed weights through an aprc+cbws schedule's permutation):
    every layer's counting launch (the hoisted mode, B) gives the bits of
    the launch without counts, and counts equal to the reductions of its
    own train, whole T and as two chunks; the finisher gives the bits of
    its plain version on the same row counts and of ``skip_table_fraction``
    on the train; the epilogue's device cost (counted against plain
    launches, device time by the profiler); then one hopper
    forward counts through these launches alone (launches per forward,
    ``skip_table_fraction.calls`` unchanged, its counts and skip fractions
    those of the layers' trains bit for bit).  Returns the summary entries
    of the counting instances and the finisher."""
    import torch
    from repro_torch.config import get_snn
    from repro_torch.core import build_schedule, init_snn, layer_shapes
    from repro_torch.core.scheduler import permute_conv_params
    from repro_torch.core.snn_model import skew_channels, snn_apply
    from repro_torch.data.synthetic import mnist_like, road_like
    from repro_torch.kernels.spiking_conv import (
        BLOCK_ROWS, _skip_fraction, skip_fraction_from_rows,
        skip_table_blocks, skip_table_fraction, spiking_conv_lif_hoisted,
        spiking_conv_lif_hoisted_plain, train_counts_plain)
    from repro_torch.kernels.spiking_conv_lif import (spiking_conv_lif,
                                                      spiking_conv_lif_plain)
    summary = {"spiking_conv_lif_hoisted_counted": [],
               "spiking_conv_lif_counted": [], "skip_fraction_from_rows": []}
    for net in ("snn-mnist", "snn-seg"):
        cfg, batch = get_snn(net), COUNT_BATCHES[net]
        params = skew_channels(init_snn(torch.Generator().manual_seed(SEED),
                                        cfg, device="cuda"), 1.0, seed=SEED)
        h, w = cfg.input_hw
        frames = (mnist_like(batch, seed=SEED) if cfg.dense_units else
                  road_like(batch, h=h, w=w, seed=SEED))[0]
        x = torch.from_numpy(frames).cuda()
        dev = x.device
        sched = build_schedule(params, cfg, "aprc+cbws")
        conv = permute_conv_params(params, list(sched))["conv"]
        shapes, T, r = layer_shapes(cfg), cfg.timesteps, cfg.kernel_size
        n_spiking = len(conv) - (0 if cfg.dense_units else 1)
        kw = dict(v_th=cfg.v_threshold, aprc=cfg.aprc)
        trains, counts, inp = [], [], x
        for i in range(n_spiking):
            w, b = conv[i]["w"].contiguous(), conv[i]["b"].contiguous()
            v0 = torch.zeros((batch,) + shapes[i], device=dev)
            hoisted = i == 0
            if hoisted:
                name = "spiking_conv_lif_hoisted_counted"

                def run(count, steps=T, v=v0, xs=inp, w=w, b=b):
                    return spiking_conv_lif_hoisted(xs, v, w, b, t=steps,
                                                    count=count, **kw)

                def plain(xs=inp, v=v0, w=w, b=b):
                    return train_counts_plain(spiking_conv_lif_hoisted_plain(
                        xs, v, w, b, t=T, **kw)[0])
                nbytes, flops = hoisted_work(inp, w, T, cfg.aprc, False)
                taps, peak = None, None
            else:
                name = "spiking_conv_lif_counted"

                def run(count, steps=T, v=v0, xs=inp, w=w, b=b):
                    return spiking_conv_lif(xs, v, w, b, count=count, **kw)

                def plain(xs=inp, v=v0, w=w, b=b):
                    return train_counts_plain(spiking_conv_lif_plain(
                        xs, v, w, b, **kw)[0])
                nbytes, flops, taps = conv_work(inp, w, cfg.aprc, lif=True)
                peak = PEAK_BF16
            case = f"{net} layer {i}"
            s, v = run(False)
            c = check_counted(f"{name} {case}", run(True), s, v)
            # two chunks threading the membrane: their counts, joined, are
            # the whole run's
            half = T // 2
            if hoisted:
                s1, v1, c1 = run(True, steps=half)
                s2, v2, c2 = run(True, steps=T - half, v=v1)
            else:
                s1, v1, c1 = run(True, xs=inp[:half].contiguous())
                s2, v2, c2 = run(True, v=v1, xs=inp[half:].contiguous())
            if not (torch.equal(torch.cat([c1.t, c2.t]), c.t) and
                    torch.equal(torch.cat([c1.rows, c2.rows]), c.rows)):
                fail(f"{name} {case}: the counts of two chunks differ from "
                     f"the whole run's")
            del s1, v1, c1, s2, v2, c2
            count_bytes = 4 * (c.t.numel() + c.rows.numel())
            # the device's time (the profiler's: a seg layer's launch is
            # shorter than the host's), the counts' zero fill included
            dev_ms = device_ms(lambda: run(True))
            dev_ms_plain = device_ms(lambda: run(False))
            rec = {"shape": list(inp.shape), "timesteps": T,
                   "spikes": int(c.t.sum()), "max_abs_err": 0.0,
                   "ms": cuda_ms(lambda: run(True)),
                   "ms_without_count": cuda_ms(lambda: run(False)),
                   "device_ms": dev_ms,
                   "device_ms_without_count": dev_ms_plain,
                   "epilogue_share": dev_ms / dev_ms_plain - 1.0,
                   "count_bytes": count_bytes,
                   # what the model ran before the counting launches: the
                   # reductions of the train and its next skip table
                   "reductions_ms": cuda_ms(lambda: (
                       train_counts_plain(s),
                       skip_table_fraction(s, r, aprc=cfg.aprc)), reps=5),
                   "plain_ms": cuda_ms(plain, reps=3, warmup=1),
                   "library_ms": None}
            set_bounds(rec, nbytes + count_bytes, flops, taps, peak)
            emit("kernel", name=name, case=case, **rec)
            summary[name].append(rec)
            trains.append(s)
            counts.append(c)
            del v
            inp = s

        # the finisher on each fused layer's input (every conv layer's
        # after the first; snn-mnist's last train feeds its dense layers):
        # the plain version's bits on the same row counts, and
        # skip_table_fraction's on the train
        fused = len(cfg.conv_channels) - 1
        for i, (s, c) in enumerate(zip(trains[:fused], counts[:fused])):
            t, n, h = c.rows.shape
            got = skip_fraction_from_rows(c, r, aprc=cfg.aprc)
            want = _skip_fraction(c.rows.reshape(t * n, h), r, cfg.aprc,
                                  BLOCK_ROWS)
            from_train = skip_table_fraction(s, r, aprc=cfg.aprc)
            if not (torch.equal(got, want) and torch.equal(got, from_train)):
                fail(f"skip_fraction_from_rows {net} layer {i + 1}: "
                     f"{float(got)!r}, plain {float(want)!r}, from the "
                     f"train {float(from_train)!r}")
            cells = t * n * skip_table_blocks(h, r, aprc=cfg.aprc)
            rec = {"shape": list(c.rows.shape), "cells": cells,
                   "skip_fraction": float(got), "max_abs_err": 0.0,
                   "ms": cuda_ms(lambda: skip_fraction_from_rows(
                       c, r, aprc=cfg.aprc)),
                   "device_ms": device_ms(lambda: skip_fraction_from_rows(
                       c, r, aprc=cfg.aprc)),
                   "plain_ms": cuda_ms(lambda: _skip_fraction(
                       c.rows.reshape(t * n, h), r, cfg.aprc, BLOCK_ROWS)),
                   "library_ms": None}
            set_bounds(rec, 4 * c.rows.numel() + 4, float(cells))
            emit("kernel", name="skip_fraction_from_rows",
                 case=f"{net} layer {i + 1}'s input", **rec)
            summary["skip_fraction_from_rows"].append(rec)

        # one forward: it counts through the launches above alone
        calls = skip_table_fraction.calls
        reset_counts()
        out = snn_apply(params, x, cfg, backend="hopper", schedule=sched)
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_counts().items() if v}
        readout = {} if cfg.dense_units else {"spiking_conv": 1}
        if launches != counted_forwards(1, n_spiking - 1, **readout):
            fail(f"one {net} forward at batch {batch} launched {launches}")
        if skip_table_fraction.calls != calls:
            fail(f"one {net} forward called skip_table_fraction")
        for i, c in enumerate(counts):
            inv = torch.as_tensor(sched[i].out_perm, device=dev).argsort()
            if not torch.equal(out.timestep_counts[i],
                               c.t[:, inv].float()):
                fail(f"{net} forward: layer {i}'s counts are not its "
                     f"counting launch's")
        if len(out.skip_fractions) != fused or any(
                not torch.equal(f, skip_table_fraction(s, r, aprc=cfg.aprc))
                for f, s in zip(out.skip_fractions, trains)):
            fail(f"{net} forward: its skip fractions are not those of its "
                 f"layers' trains")
        emit("counts", config=net, batch=batch, timesteps=T,
             launches_per_forward=launches,
             skip_fractions=[float(f) for f in out.skip_fractions],
             spike_totals=[float(v) for v in out.spike_totals])
        del trains, counts, out
    return summary


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


def device_ms(call, reps: int = 20) -> float:
    """Device ms of one call of ``call``, by the profiler: a small call can
    take less device time than its wrapper's host time, which the CUDA
    events of ``cuda_ms`` include."""
    return sum(device_time(call, reps)[0].values())


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
    path = tuple(counted_forwards(1, 2))
    if any(launches[k] == 0 for k in path):
        fail(f"the serve run did not go through every kernel: {launches}")
    return {k: launches[k] for k in path}, s["fps"]


def _counters():
    """Each kernel's launch counter: (wrapper, attribute).  The hoisted
    mode's wrapper counts its kernel instances apart; the counting
    instances of the hoisted mode and of B are counted in ``*_counted``
    besides their plain ``launches``, and the weight gradient's analog
    instance in ``launches_analog`` besides its ``launches``."""
    from repro_torch.kernels import lif as f
    from repro_torch.kernels import spiking_conv as a
    from repro_torch.kernels import spiking_conv_lif as b
    return {"spiking_conv": (a.spiking_conv, "launches"),
            "spiking_conv_lif_hoisted": (a.spiking_conv_lif_hoisted,
                                         "launches"),
            "spiking_conv_lif_hoisted_counted": (a.spiking_conv_lif_hoisted,
                                                 "launches_counted"),
            "spiking_conv_lif_hoisted_save_u": (a.spiking_conv_lif_hoisted,
                                                "launches_save_u"),
            "spiking_conv_lif": (b.spiking_conv_lif, "launches"),
            "spiking_conv_lif_counted": (b.spiking_conv_lif,
                                         "launches_counted"),
            "skip_fraction_from_rows": (a.skip_fraction_from_rows,
                                        "launches"),
            "spiking_conv_lif_fwd": (b.spiking_conv_lif_fwd, "launches"),
            "lif_bwd": (b.lif_bwd, "launches"),
            "conv_grad_input": (a.conv_grad_input, "launches"),
            "conv_grad_weights": (a.conv_grad_weights, "launches"),
            "conv_grad_weights_analog": (a.conv_grad_weights,
                                         "launches_analog"),
            "lif_fused": (f.lif_fused, "launches")}


def counted_forwards(n: int, b_layers: int, **more):
    """The launches of ``n`` forwards that report counts: the hoisted mode
    and each of the ``b_layers`` layers of kernel B in their counting
    instances, and the skip-table finisher once a fused layer (the B layers
    and a readout conv, given in ``more`` as ``spiking_conv``)."""
    fused = b_layers + more.get("spiking_conv", 0)
    return {"spiking_conv_lif_hoisted": n,
            "spiking_conv_lif_hoisted_counted": n,
            "spiking_conv_lif": b_layers * n,
            "spiking_conv_lif_counted": b_layers * n,
            "skip_fraction_from_rows": fused * n,
            **{k: v * n for k, v in more.items()}}


def reset_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def _forward_trains(cfg, params, frames, hopper: bool, sched=None):
    """The spike trains of the spiking conv layers (snn-mnist's three,
    snn-seg's five: its readout conv does not fire), computed the way
    backend hopper (kernels, through the CBWS-permuted weights of
    ``sched`` if given) or batched (plain ops) computes them, each in the
    canonical channel order."""
    import torch
    from repro_torch.core.scheduler import permute_conv_params
    from repro_torch.core.snn_model import (_conv_folded, _conv_plain,
                                            _lif_scan, layer_shapes)
    from repro_torch.kernels.spiking_conv import spiking_conv_lif_hoisted
    from repro_torch.kernels.spiking_conv_lif import spiking_conv_lif
    inv = [None] * len(params["conv"])
    if sched is not None:
        params = permute_conv_params(params, list(sched))
        inv = [torch.as_tensor(l.out_perm, device=frames.device).argsort()
               for l in sched]
    conv, v_th = params["conv"], cfg.v_threshold
    with torch.no_grad():
        v0 = frames.new_zeros((frames.shape[0],) + layer_shapes(cfg)[0])
        if hopper:
            s, _ = spiking_conv_lif_hoisted(frames, v0, conv[0]["w"],
                                            conv[0]["b"], t=cfg.timesteps,
                                            v_th=v_th, aprc=cfg.aprc)
        else:
            s, _, _ = _lif_scan(_conv_plain(frames, conv[0], cfg.aprc), v_th,
                                10.0, "fast_sigmoid", v0,
                                const_t=cfg.timesteps)
        trains = [s]
        n_spiking = len(conv) if cfg.dense_units else len(conv) - 1
        for i in range(1, n_spiking):
            v0 = frames.new_zeros((frames.shape[0],) + layer_shapes(cfg)[i])
            if hopper:
                s, _ = spiking_conv_lif(s.contiguous(), v0, conv[i]["w"],
                                        conv[i]["b"], v_th=v_th,
                                        aprc=cfg.aprc)
            else:
                s, _, _ = _lif_scan(_conv_folded(s, conv[i], cfg, False),
                                    v_th, 10.0, "fast_sigmoid", v0)
            trains.append(s)
    return [t if p is None else t[..., p] for t, p in zip(trains, inv)]


def _train_flips(cfg, params, frames, sched=None):
    """Per spiking layer [differing sites, sites] between the hopper and
    batched trains, and the last layer's two trains (hopper, batched)."""
    flips = []
    for t_h, t_b in zip(_forward_trains(cfg, params, frames, True, sched),
                        _forward_trains(cfg, params, frames, False)):
        sites = (t_h != t_b).any(dim=0)
        flips.append([int(sites.sum()), sites.numel()])
    return flips, (t_h, t_b)


def compare_trains(cfg, params, frames, sched=None):
    """Threshold flips between the hopper and batched spike trains: per
    layer [differing sites, sites], and per image and class how far the
    readout's logits (and so the loss) may move because of them.  The
    readout adds ``w[j] / T`` for each spike of the last train, so
    ``|d logit_ik| <= sum over differing (t, j) of |w_jk| / T``; where the
    trains agree the bound is 0, since both backends sum the readout
    exactly (float64 on the exact grid) and then round alike."""
    assert len(params["dense"]) == 1, "snn-mnist reads out its last conv"
    flips, (t_h, t_b) = _train_flips(cfg, params, frames, sched)
    per_image = (t_h != t_b).sum(dim=0).flatten(1).double()
    bound = (per_image @ params["dense"][0]["w"].abs().double()
             / cfg.timesteps)
    return flips, bound


def _value_and_grads(params, loss_fn):
    """``loss_fn(params)`` and its gradient by leaf name ("conv0.w", ...)."""
    import torch
    keys = [(kind, i, k) for kind in ("conv", "dense")
            for i in range(len(params[kind])) for k in ("w", "b")]
    with torch.inference_mode(False), torch.enable_grad():
        leaves = [params[kind][i][k].detach().clone().requires_grad_(True)
                  for kind, i, k in keys]
        it = iter(leaves)
        tree = {kind: [{k: next(it) for k in ("w", "b")}
                       for _ in params[kind]] for kind in ("conv", "dense")}
        loss = loss_fn(tree)
        grads = torch.autograd.grad(loss, leaves)
    names = [f"{kind}{i}.{k}" for kind, i, k in keys]
    return float(loss.detach()), dict(zip(names, grads))


def _loss_and_grads(cfg, params, x, y, backend):
    from repro_torch.api import TrainSpec
    from repro_torch.core.snn_train import make_loss_fn
    loss_fn = make_loss_fn(cfg, spec=TrainSpec(backend=backend))
    return _value_and_grads(params, lambda p: loss_fn(p, x, y))


def phase_train(cfg, steps: int = 10, lr: float = 1e-2):
    """(a) one loss and gradient, hopper against batched; (b) the training
    launcher on both backends (the main path of training); (c) one train
    step's time and profile.  Returns the launch counts and the losses of
    the hopper run of (b)."""
    import numpy as np
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch.api import TrainSpec
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
    # per step the hoisted mode's SAVE_U 1, C 2, D 3 (layer 0 too), E 2
    # (never for the frames), the weight gradient 3 (layer 0's the analog
    # instance), and the held-out evaluation's forward: the hoisted mode 1,
    # B 2, none counting (it reads only the logits)
    want = {"spiking_conv": 0, "spiking_conv_lif_hoisted": 1,
            "spiking_conv_lif_hoisted_counted": 0,
            "spiking_conv_lif_hoisted_save_u": steps,
            "spiking_conv_lif": 2, "spiking_conv_lif_counted": 0,
            "skip_fraction_from_rows": 0,
            "spiking_conv_lif_fwd": 2 * steps,
            "lif_bwd": 3 * steps, "conv_grad_input": 2 * steps,
            "conv_grad_weights": 3 * steps,
            "conv_grad_weights_analog": steps, "lif_fused": 0}
    if counts["hopper"] != want:
        fail(f"the hopper train run launched {counts['hopper']}, expected "
             f"{want}")
    if any(v != 0 for v in counts["batched"].values()):
        fail(f"the batched train run launched kernels: {counts['batched']}")

    # (c) one train step between CUDA events, and where its time goes
    mom = tree_map(torch.zeros_like, params)
    step_ms = {}
    for backend in ("hopper", "batched"):
        step = make_train_step(cfg, spec=TrainSpec(backend=backend, lr=lr))
        step_ms[backend] = cuda_ms(lambda: step(params, mom, x, y), reps=5,
                                   warmup=2)
    emit("train", part="c: one train step", batch=BATCH, step_ms=step_ms,
         trained_frames_per_s={k: BATCH / v * 1e3
                               for k, v in step_ms.items()})
    step = make_train_step(cfg, spec=TrainSpec(backend="hopper", lr=lr))
    phase_profile(lambda: step(params, mom, x, y), step_ms["hopper"],
                  "hopper train step")
    return counts["hopper"], h


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
               "library_ms": None}
        # a call this small can take less device time than the wrapper's
        # host time, which the CUDA events above then include
        for key, fn in (("device_ms", lif_fused),
                        ("plain_device_ms", lif_fused_plain)):
            by_kernel, _ = device_time(lambda: fn(v, z, 1.0), reps=20)
            rec[key] = sum(by_kernel.values())
        set_bounds(rec, nbytes, float(LIF_FUSED_FLOPS * n))
        emit("lif_fused", **rec)
        if shape == (262144, 32):
            summary = [rec]
    return summary


def phase_t1_contract(cfg, params, frames):
    """Layer 1 at batch 256, one timestep, through the kernel-ops layer:
    ``ops.spiking_conv`` (A's dV mode) then ``ops.lif_fused`` (F) equals
    ``ops.spiking_conv_lif`` (B) with T=1.  Returns A's and F's launches on
    the two-kernel path."""
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
    return {k: launches[k] for k in ("spiking_conv", "lif_fused")}


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
        if launches["spiking_conv_lif_hoisted"] == 0 or \
                launches["spiking_conv_lif"] == 0:
            fail(f"engine {name} did not go through the hoisted mode and "
                 f"kernel B: {launches}")
    a, b = runs["virtual whole-T"], runs["virtual chunked"]
    if any(not np.array_equal(a[k], b[k]) for k in a):
        fail("chunked engine logits differ from whole-T")


# -- slice 6: snn-seg on the card, the facade -----------------------------------

SEG_BATCH, SEG_STEPS = 16, 4
API_REQUESTS = 24


def seg_logit_bound(cfg, params, frames, sched):
    """The seg rule of the module doc: per layer [differing sites, sites]
    between the hopper and batched trains, and per pixel how far the
    logits may differ: the flip bound (conv(D, |w5|) / T over the
    differing steps D of each site of the last train) plus the rounding
    bound of kernel A's dV against the plain path's, on each backend's own
    last train."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.scheduler import permute_conv_params
    from repro_torch.core.snn_model import finalize_logits
    from repro_torch.kernels.ref import conv_pads
    from repro_torch.kernels.spiking_conv import (spiking_conv,
                                                  spiking_conv_plain)
    flips, (s_h, s_b) = _train_flips(cfg, params, frames, sched)
    t, b = s_b.shape[:2]
    r = cfg.kernel_size
    pad = conv_pads(r, cfg.aprc)[0]         # seg's odd R: symmetric
    w5, b5 = params["conv"][-1]["w"], params["conv"][-1]["b"]
    # (a) the flips: each differing (t, site) moves dV_t by |w5| over the
    # site's 3x3 window
    d = (s_h != s_b).double().sum(dim=0)                    # (B, H, W, C)
    w_abs = w5.abs().double().permute(3, 2, 0, 1)           # OIHW
    flip = F.conv2d(d.permute(0, 3, 1, 2), w_abs, padding=pad)
    flip = finalize_logits(flip.permute(0, 2, 3, 1), cfg, t)
    # (b) the rounding: per step DV_TOL * (1 + |dV_t|), the running sum's
    # rounding 2^-23 |v_t| a step, the division's 2^-24 |logit|; dV_t and
    # v_t the larger of the two backends' (the hopper readout through the
    # CBWS-permuted weights it runs on)
    w5h = permute_conv_params(params, list(sched))["conv"][-1] \
        if sched is not None else params["conv"][-1]
    perm_in = (torch.as_tensor(sched[-2].out_perm, device=s_h.device)
               if sched is not None else None)
    x_h = s_h if perm_in is None else s_h[..., perm_in]
    z_h = spiking_conv(x_h.reshape((t * b,) + x_h.shape[2:]).contiguous(),
                       w5h["w"].contiguous(), w5h["b"].contiguous(),
                       aprc=cfg.aprc)
    z_b = spiking_conv_plain(s_b.reshape((t * b,) + s_b.shape[2:]), w5, b5,
                             aprc=cfg.aprc)
    z = torch.maximum(z_h.abs(), z_b.abs()).double().reshape(
        (t, b) + z_b.shape[1:])
    v = torch.maximum(z_h.reshape(z.shape).cumsum(0).abs(),
                      z_b.reshape(z.shape).cumsum(0).abs()).double()
    per_step = (DV_TOL * (1.0 + z) + 2.0 ** -23 * v).sum(dim=0)
    rnd = finalize_logits(per_step, cfg, t)
    logit = finalize_logits(v[-1], cfg, t)
    return flips, flip + rnd + 2.0 ** -24 * logit, flip


def phase_seg(cfg, batch: int = SEG_BATCH):
    """snn-seg on the card, through the facade: the main path (Session.infer
    and serve, the serve launcher), hopper against batched (forward and one
    gradient), each kernel at seg's main-path shapes, and the timings.
    Returns (summary entries, launch counts of the main path)."""
    import numpy as np
    import torch
    from repro_torch.api import ServeSpec, Session
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.core.snn_model import snn_apply
    from repro_torch.data.synthetic import road_like
    from repro_torch.launch.serve import serve
    h, w = cfg.input_hw
    frames_np, _ = road_like(batch, h=h, w=w, seed=SEED)
    sess = Session(cfg, ServeSpec(backend="hopper",
                                  schedule_mode="aprc+cbws"),
                   seed=SEED, device="cuda")
    params = sess.params
    sched = build_schedule(params, cfg, "aprc+cbws")
    x = torch.from_numpy(frames_np).cuda()
    out_shape = (batch, h, w, 1)

    # (a) the main path: one Session.infer, counted
    sess.infer(frames_np)                          # builds the engine
    torch.cuda.synchronize()
    reset_counts()
    out = sess.infer(frames_np)
    torch.cuda.synchronize()
    fwd_launches = {k: v for k, v in read_counts().items() if v}
    want = counted_forwards(1, 4, spiking_conv=1)
    if fwd_launches != want:
        fail(f"one snn-seg forward launched {fwd_launches}, expected {want}")
    if out.logits.shape != out_shape or not np.isfinite(out.logits).all():
        fail(f"snn-seg logits {out.logits.shape} not finite/of shape "
             f"{out_shape}")
    with torch.inference_mode():
        raw = snn_apply(params, x, cfg, backend="hopper", schedule=sched)
        if not np.array_equal(raw.logits.cpu().numpy(), out.logits):
            fail("Session.infer's snn-seg logits differ from snn_apply's")
    stats = sess.serve(frames_np, steps=SEG_STEPS)
    reset_counts()
    launcher = serve(cfg, backend="hopper", schedule="aprc+cbws",
                     batch=batch, steps=SEG_STEPS, seed=SEED, device="cuda")
    serve_launches = read_counts()
    if any(serve_launches[k] != n * (SEG_STEPS + 1)
           for k, n in want.items()):
        fail(f"the snn-seg serve run launched {serve_launches}")
    emit("seg", part="a: the main path", config=cfg.name, batch=batch,
         timesteps=cfg.timesteps, launches_per_forward=fwd_launches,
         spikes_per_frame=stats["spikes_per_frame"],
         session_serve_fps=stats["fps"], launcher_fps=launcher["fps"],
         launcher_launches=serve_launches,
         spike_totals=[float(t) for t in out.spike_totals],
         skip_fractions=[float(f) for f in out.skip_fractions])

    # (b) hopper against batched: flips, logits within the seg bound
    with torch.inference_mode():
        got = snn_apply(params, x, cfg, backend="hopper", schedule=sched)
        ref = snn_apply(params, x, cfg, backend="batched")
        flips, bound, flip = seg_logit_bound(cfg, params, x, sched)
    err = (got.logits - ref.logits).abs().double()
    excess = float((err - bound).max())
    totals = [(float(a), float(c)) for a, c in zip(got.spike_totals,
                                                   ref.spike_totals)]
    emit("seg", part="b: hopper against batched", batch=batch,
         threshold_flips_per_layer=flips,
         pixels_with_a_flip_bound=int((flip > 0).sum()),
         max_abs_err_logits=float(err.max()),
         max_flip_bound=float(flip.max()), max_bound=float(bound.max()),
         max_abs_err_logits_beyond_bound=excess,
         max_abs_logit=float(ref.logits.abs().max()),
         spike_totals=totals)
    if any(f > MAX_FLIP_FRACTION * n for f, n in flips):
        fail(f"snn-seg threshold flips per layer {flips} exceed "
             f"{MAX_FLIP_FRACTION}")
    if flips[0][0]:
        fail(f"snn-seg layer 0's train differs at {flips[0][0]} sites: "
             f"kernel A's hoisted mode must give the plain path's bits")
    if excess > 0:
        fail(f"snn-seg hopper logits exceed the seg bound by {excess}")
    del got, ref, flip

    # (c) one gradient of sum(logits ** 2), hopper against batched
    def seg_loss(backend):
        def loss(p):
            kw = {"schedule": sched} if backend == "hopper" else {}
            o = snn_apply(p, x, cfg, backend=backend, logits_only=True, **kw)
            return (o.logits ** 2).sum()
        return loss

    def peak_gb(fn):
        """fn() and the device memory it took at its peak, in GB."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - base) / 1e9

    reset_counts()
    (loss_h, g_h), peak_h = peak_gb(
        lambda: _value_and_grads(params, seg_loss("hopper")))
    grad_launches = {k: v for k, v in read_counts().items() if v}
    want_grad = {"spiking_conv_lif_hoisted_save_u": 1,
                 "spiking_conv_lif_fwd": 4, "lif_bwd": 5,
                 "conv_grad_input": 5, "spiking_conv": 1,
                 "conv_grad_weights": 6, "conv_grad_weights_analog": 1}
    (loss_b, g_b), peak_b = peak_gb(
        lambda: _value_and_grads(params, seg_loss("batched")))
    rel = {k: float((g_h[k] - g_b[k]).norm() / g_b[k].norm()) for k in g_b}
    n_flips = sum(f for f, _ in flips)
    grad_bound = GRAD_REL if n_flips == 0 else FLIP_GRAD_REL
    # |sum l_h^2 - sum l_b^2| <= sum e (2 |l_b| + e) for |l_h - l_b| <= e
    with torch.inference_mode():
        lb = snn_apply(params, x, cfg, backend="batched",
                       logits_only=True).logits.abs().double()
    loss_bound = float((bound * (2 * lb + bound)).sum())
    del lb
    grad_ms = cuda_ms(lambda: _value_and_grads(params, seg_loss("hopper")),
                      reps=3, warmup=1)
    grad_ms_batched = cuda_ms(
        lambda: _value_and_grads(params, seg_loss("batched")), reps=3,
        warmup=1)
    emit("seg", part="c: one gradient, hopper against batched",
         batch=batch, loss="sum(logits ** 2)", loss_hopper=loss_h,
         loss_batched=loss_b, loss_abs_diff=abs(loss_h - loss_b),
         loss_bound=loss_bound, grad_rel_diff=rel,
         grad_rel_bound=grad_bound, launches=grad_launches,
         grad_ms=grad_ms, grad_ms_batched=grad_ms_batched,
         peak_memory_gb={"hopper": peak_h, "batched": peak_b})
    if grad_launches != want_grad:
        fail(f"the snn-seg gradient launched {grad_launches}, expected "
             f"{want_grad}")
    if abs(loss_h - loss_b) > loss_bound:
        fail(f"snn-seg loss hopper {loss_h} vs batched {loss_b} "
             f"(> {loss_bound})")
    if not all(float(g.abs().max()) > 0 for g in g_h.values()):
        fail("a hopper snn-seg gradient leaf is zero")
    if max(rel.values()) > grad_bound:
        fail(f"snn-seg hopper gradients differ from batched: {rel} "
             f"(> {grad_bound}, {n_flips} flips)")
    del g_h, g_b
    with torch.inference_mode():
        phase_profile(lambda: _value_and_grads(params, seg_loss("hopper")),
                      grad_ms, "snn-seg hopper gradient", reps=2)

    # (d) the timings
    with torch.inference_mode():
        def fwd(xx, logits_only=False):
            return lambda: snn_apply(params, xx, cfg, backend="hopper",
                                     schedule=sched, logits_only=logits_only)

        times = {"forward_ms_batch1": cuda_ms(fwd(x[:1]), reps=10),
                 "forward_ms": cuda_ms(fwd(x), reps=10),
                 "forward_ms_logits_only": cuda_ms(fwd(x, True), reps=10),
                 "forward_ms_batched": cuda_ms(lambda: snn_apply(
                     params, x, cfg, backend="batched"), reps=5)}
        emit("seg", part="d: timings", batch=batch, **times)
        phase_profile(fwd(x), times["forward_ms"], "snn-seg hopper forward")
        phase_profile(fwd(x, True), times["forward_ms_logits_only"],
                      "snn-seg hopper forward, logits only")
        phase_profile(lambda: snn_apply(params, x, cfg, backend="batched"),
                      times["forward_ms_batched"], "snn-seg batched forward",
                      reps=2)
        summary = phase_seg_kernels(cfg, params, x)
    launches = {k: fwd_launches.get(k, 0) + grad_launches.get(k, 0)
                for k in set(fwd_launches) | set(grad_launches)}
    return summary, launches


def phase_seg_kernels(cfg, params, frames):
    """Every kernel of snn-seg's path against its plain version at its
    main-path shapes: the hoisted mode (Cin=3, T=16) with and without
    SAVE_U bit for bit, B and C at layers 1-4 (layer 3: the 208 KB plan),
    D at all five layers, E at the readout (one input channel) and layers
    4-1, A's dV mode at the readout (Cout=1), the weight gradient at every
    layer (its analog instance at layer 0); returns the summary
    entries."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.snn_model import layer_shapes
    from repro_torch.device import full_fp32
    from repro_torch.kernels import ref
    from repro_torch.kernels.spiking_conv import (
        conv_grad_input, spiking_conv, spiking_conv_lif_hoisted,
        spiking_conv_lif_hoisted_plain, spiking_conv_plain)
    from repro_torch.kernels.spiking_conv_lif import (
        lif_bwd, spiking_conv_lif, spiking_conv_lif_fwd,
        spiking_conv_lif_plain)
    dev, v_th, conv = frames.device, cfg.v_threshold, params["conv"]
    T, n = cfg.timesteps, frames.shape[0]
    gen = torch.Generator(device="cpu").manual_seed(SEED + 6)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    summary = {k: [] for k in ("spiking_conv_lif_hoisted",
                               "spiking_conv_lif_hoisted_save_u",
                               "spiking_conv_lif", "spiking_conv_lif_fwd",
                               "lif_bwd", "conv_grad_input", "spiking_conv",
                               "conv_grad_weights",
                               "conv_grad_weights_analog")}
    case = "snn-seg layer {}"

    # layer 0: the hoisted mode; its u feeds D
    w0, b0 = conv[0]["w"], conv[0]["b"]
    v0 = torch.zeros((n,) + layer_shapes(cfg)[0], device=dev)
    us = []
    for save_u in (False, True):
        name = "spiking_conv_lif_hoisted" + ("_save_u" if save_u else "")
        kw = dict(t=T, v_th=v_th, save_u=save_u)
        got = spiking_conv_lif_hoisted(frames, v0, w0, b0, **kw)
        err = check_exact(f"{name} snn-seg layer0", got,
                          spiking_conv_lif_hoisted_plain(frames, v0, w0, b0,
                                                         **kw))
        nbytes, flops = hoisted_work(frames, w0, T, True, save_u)
        rec = {"shape": list(frames.shape), "timesteps": T,
               "spikes": float(got[0].sum()), "max_abs_err": err,
               "ms": cuda_ms(lambda: spiking_conv_lif_hoisted(
                   frames, v0, w0, b0, **kw)),
               "device_ms": device_ms(lambda: spiking_conv_lif_hoisted(
                   frames, v0, w0, b0, **kw)),
               "plain_ms": cuda_ms(lambda: spiking_conv_lif_hoisted_plain(
                   frames, v0, w0, b0, **kw), reps=5),
               "library_ms": None}
        set_bounds(rec, nbytes, flops)
        emit("kernel", name=name, case=case.format(0), **rec)
        summary[name].append(rec)
        s_in = got[0]
        if save_u:
            us.append(got[2])
        del got

    # layers 1-4: B, then C (its u feeds D), on the plain trains, each kept
    # for the weight gradient
    trains_in = []
    for layer in range(1, len(conv) - 1):
        trains_in.append(s_in.reshape((-1,) + s_in.shape[2:]))
        w, b = conv[layer]["w"], conv[layer]["b"]
        v0 = torch.zeros((n,) + layer_shapes(cfg)[layer], device=dev)
        s_p, v_p, u_p = spiking_conv_lif_plain(s_in, v0, w, b, v_th=v_th,
                                               save_u=True)
        for name, save_u in (("spiking_conv_lif", False),
                             ("spiking_conv_lif_fwd", True)):
            fn = spiking_conv_lif_fwd if save_u else spiking_conv_lif
            got = fn(s_in, v0, w, b, v_th=v_th)
            rec = check_train(f"{name} snn-seg layer{layer}", got[0], got[1],
                              s_p, v_p, u_p, v_th)
            u_err = 0.0
            if save_u:
                agree = (got[0] == s_p).all(dim=0)
                u_err = float((got[2] - u_p).abs()[:, agree].max())
                if u_err > U_ATOL:
                    fail(f"{name} snn-seg layer{layer}: u differs by {u_err}"
                         f" (> {U_ATOL}) where the trains agree")
                us.append(got[2])
            nbytes, flops, taps = conv_work(s_in, w, True, lif=True,
                                            save_u=save_u)
            rec.update(
                shape=list(s_in.shape),
                max_abs_err=max(u_err, rec["max_abs_err_v_agreeing"]),
                ms=cuda_ms(lambda: fn(s_in, v0, w, b, v_th=v_th), reps=10),
                plain_ms=cuda_ms(lambda: spiking_conv_lif_plain(
                    s_in, v0, w, b, v_th=v_th, save_u=save_u), reps=3),
                library_ms=None)
            set_bounds(rec, nbytes, flops, taps, PEAK_BF16)
            emit("kernel", name=name, case=case.format(layer), **rec)
            summary[name].append(rec)
            del got
        s_in = s_p
        del v_p, u_p

    # the readout: A's dV mode on layer 4's train folded to (T*B, ...)
    w5, b5 = conv[-1]["w"], conv[-1]["b"]
    x5 = s_in.reshape((-1,) + s_in.shape[2:])
    del s_in
    err = check_dv("spiking_conv snn-seg readout", spiking_conv(x5, w5, b5),
                   spiking_conv_plain(x5, w5, b5))
    nbytes, flops, _ = conv_work(x5, w5, True, lif=False)
    w_oihw, x_nchw = w5.permute(3, 2, 0, 1).contiguous(), x5.permute(0, 3,
                                                                     1, 2)

    def library():
        with full_fp32():
            return F.conv2d(x_nchw, w_oihw, b5, padding=2)

    rec = {"shape": list(x5.shape), "max_abs_err": err,
           "ms": cuda_ms(lambda: spiking_conv(x5, w5, b5)),
           "device_ms": device_ms(lambda: spiking_conv(x5, w5, b5)),
           "plain_ms": cuda_ms(lambda: spiking_conv_plain(x5, w5, b5),
                               reps=5),
           "library_ms": cuda_ms(library)}
    set_bounds(rec, nbytes, flops)
    emit("kernel", name="spiking_conv", case="snn-seg readout (Cout=1)",
         **rec)
    summary["spiking_conv"].append(rec)

    # D on every layer's u (the default surrogate), its lam feeding E
    lams = []
    for layer, u in enumerate(us):
        g_s, g_v = randn(*u.shape), randn(*u.shape[1:])
        kw = dict(v_th=v_th, alpha=10.0, kind="fast_sigmoid")
        lam, dv0 = lif_bwd(u, g_s, g_v, **kw)
        lam_p, dv0_p = ref.lif_bwd_ref(u, g_s, g_v, **kw)
        errs = [float((a - c).abs().max()) for a, c in
                ((lam, lam_p), (dv0, dv0_p))]
        if not (torch.allclose(lam, lam_p, atol=BWD_TOL, rtol=BWD_TOL) and
                torch.allclose(dv0, dv0_p, atol=BWD_TOL, rtol=BWD_TOL)):
            fail(f"lif_bwd snn-seg layer{layer}: lam/dv0 differ by {errs}")
        del lam_p, dv0_p
        nbytes, flops = lif_bwd_work(u)
        rec = {"shape": list(u.shape), "surrogate": "fast_sigmoid",
               "max_abs_err": max(errs), "bit_identical": errs == [0.0, 0.0],
               "ms": cuda_ms(lambda: lif_bwd(u, g_s, g_v, **kw)),
               "plain_ms": cuda_ms(lambda: ref.lif_bwd_ref(u, g_s, g_v, **kw),
                                   reps=5),
               "library_ms": None}
        set_bounds(rec, nbytes, flops)
        emit("kernel", name="lif_bwd", case=case.format(layer), **rec)
        summary["lif_bwd"].append(rec)
        lams.append(lam.reshape((-1,) + lam.shape[2:]) if layer
                    else lam.sum(dim=0))
        del g_s, g_v, lam, dv0
    del us

    # the weight gradient: layers 1-4 on their trains and lam, the readout
    # (Cout = 1) on layer 4's train and a cotangent, layer 0 (the analog
    # instance) on the frames and its lam summed over T
    dz5 = randn(T * n, *layer_shapes(cfg)[-1])
    w_cases = [(f"snn-seg layer {layer}", trains_in[layer - 1], lams[layer],
                True) for layer in range(1, len(lams))]
    w_cases += [("snn-seg readout (Cout=1)", x5, dz5, True),
                ("snn-seg layer 0", frames, lams[0], False)]
    for label, x, dz, binary in w_cases:
        name, rec = wgrad_row(label, x, dz, binary)
        summary[name].append(rec)
    del trains_in, w_cases, x5, dz5

    # E: the readout's (its cotangent has one channel), then layers 4-1
    e_cases = [("snn-seg readout backward (Cout=1)",
                randn(T * n, *layer_shapes(cfg)[-1]), w5)]
    e_cases += [(f"snn-seg layer {layer} backward", lams[layer],
                 conv[layer]["w"]) for layer in range(len(lams) - 1, 0, -1)]
    del lams
    for label, dz, w in e_cases:
        got = conv_grad_input(dz, w)
        err = check_dx(f"conv_grad_input {label}", got,
                       ref.conv_grad_input_ref(dz, w))
        del got
        nbytes, flops = grad_input_work(dz, w, True)
        r = w.shape[0]
        w_oihw, g_nchw = w.permute(3, 2, 0, 1).contiguous(), dz.permute(
            0, 3, 1, 2)
        x_size = (dz.shape[0], w.shape[2], dz.shape[1] - r + 1,
                  dz.shape[2] - r + 1)

        def library():
            with full_fp32():
                return torch.nn.grad.conv2d_input(x_size, w_oihw, g_nchw,
                                                  padding=r - 1)

        rec = {"shape": list(dz.shape), "max_abs_err": err,
               "ms": cuda_ms(lambda: conv_grad_input(dz, w)),
               "plain_ms": cuda_ms(lambda: ref.conv_grad_input_ref(dz, w)),
               "library_ms": cuda_ms(library)}
        set_bounds(rec, nbytes, flops, flops, PEAK_TF32)
        emit("kernel", name="conv_grad_input", case=label, **rec)
        summary["conv_grad_input"].append(rec)
    return summary


def phase_api(cfg, frames):
    """snn-mnist at batch 256 through the facade on the card:
    ``Session.infer`` equals ``snn_apply(backend="hopper", schedule=...)``
    bit for bit, a handful of ``serve_forever`` requests equal ``infer``
    bit for bit, and ``train_step`` and ``evaluate`` run (the first loss
    and the accuracy equal the raw step's and ``accuracy``'s)."""
    import numpy as np
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch.api import ServeSpec, Session, TrainSpec
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.core.snn_model import snn_apply
    from repro_torch.core.snn_train import accuracy, make_train_step
    from repro_torch.data.synthetic import mnist_like
    frames_np = frames.cpu().numpy()
    sess = Session(cfg, ServeSpec(backend="hopper", schedule_mode="aprc+cbws",
                                  num_lanes=2, max_batch=16),
                   seed=SEED, device="cuda")
    sess.infer(frames_np)
    reset_counts()
    out = sess.infer(frames_np)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts().items() if v}
    with torch.inference_mode():
        raw = snn_apply(sess.params, frames, cfg, backend="hopper",
                        schedule=build_schedule(sess.params, cfg,
                                                "aprc+cbws"))
        raw = raw.logits.cpu().numpy()
    infer_equal = bool(np.array_equal(out.logits, raw))
    with sess.serve_forever() as live:
        handles = [live.submit(f) for f in frames_np[:API_REQUESTS]]
        live_logits = [h.result(timeout=120.0) for h in handles]
    live_equal = all(np.array_equal(got, out.logits[i])
                     for i, got in enumerate(live_logits))
    served = live.summary()["served"]
    tr = Session(cfg, TrainSpec(backend="hopper", lr=1e-2), seed=SEED,
                 device="cuda")
    x0, y0 = mnist_like(BATCH, seed=0)
    step = make_train_step(cfg, spec=TrainSpec(backend="hopper", lr=1e-2))
    _, _, raw_loss = step(tr.params, tree_map(torch.zeros_like, tr.params),
                          *(torch.from_numpy(a).cuda() for a in (x0, y0)))
    losses = [tr.train_step(*mnist_like(BATCH, seed=i)) for i in range(3)]
    xe, ye = mnist_like(BATCH, seed=10_000)
    acc = tr.evaluate(xe, ye)
    raw_acc = accuracy(tr.params, cfg, *(torch.from_numpy(a).cuda()
                                         for a in (xe, ye)),
                       backend="hopper")
    emit("api", config=cfg.name, batch=BATCH,
         infer_launches=launches, infer_equals_snn_apply=infer_equal,
         live_requests=len(handles), live_served=served,
         live_equals_infer=live_equal, train_losses=losses,
         first_loss_equals_raw_step=losses[0] == float(raw_loss),
         accuracy=acc, accuracy_raw=raw_acc)
    if launches != counted_forwards(1, 2):
        fail(f"Session.infer launched {launches}")
    if not infer_equal:
        fail("Session.infer's logits differ from snn_apply's")
    if served != len(handles) or not live_equal:
        fail(f"serve_forever: {served} of {len(handles)} served, bits "
             f"equal to infer: {live_equal}")
    if not (all(np.isfinite(losses)) and losses[0] == float(raw_loss)):
        fail(f"Session.train_step losses {losses} (raw step "
             f"{float(raw_loss)})")
    if acc != raw_acc:
        fail(f"Session.evaluate {acc} != accuracy {raw_acc}")


# -- slice 8: the mesh runtime ---------------------------------------------------

MESH_TRAIN_BATCH, MESH_REPS, MESH_REQUESTS = 32, 8, 64
GRAD_ATOL, GRAD_RTOL = 5e-5, 5e-4     # the reference's gradient tolerance


def _outputs_equal(a, b) -> bool:
    """Two host ``SNNOutputs``: logits and every count field bit for bit."""
    import numpy as np
    fields = ("spike_counts", "spike_totals", "timestep_counts",
              "skip_fractions")
    return bool(np.array_equal(a.logits, b.logits)) and all(
        len(getattr(a, f)) == len(getattr(b, f)) and all(
            np.array_equal(x, y) for x, y in zip(getattr(a, f),
                                                 getattr(b, f)))
        for f in fields)


def phase_mesh(cfg, frames):
    """The mesh runtime (``repro_torch.dist``) on the card, at full width:
    (a) snn-mnist at batch 256 through ``Session`` with ``mesh={"data":
    1}`` equals the unsharded ``Session.infer`` bit for bit (logits,
    counts, skip fractions), with both FPS; (b) the shard split through
    the kernels: two contiguous halves give the whole batch's logits, and
    (c) the halves' gradient rows are the whole batch's rows, bit for bit;
    (d) a mesh ``train_step`` at batch 32 against the unsharded step
    (params within the gradient tolerance) with both step times; (e) a
    threaded engine on ``DeviceMesh(("data", 1)).lane_devices(2)`` through
    a lane crash: every request accounted for, served logits equal to the
    mesh infer's bits; (f) snn-seg, batch 16, T=16, mesh infer against
    unsharded bits; (g) ``DeviceMesh(("data", 2))`` raises on one card,
    or, with two cards, data=2 equals data=1 bit for bit.  Returns the
    launches of the mesh infer and the mesh train step."""
    import numpy as np
    import torch
    from torch.utils._pytree import tree_leaves
    from repro_torch.api import ServeSpec, Session, TrainSpec
    from repro_torch.config import get_snn
    from repro_torch.core.snn_model import snn_apply
    from repro_torch.core.snn_train import make_grad_rows_fn
    from repro_torch.data.synthetic import mnist_like, road_like
    from repro_torch.dist import DeviceMesh
    from repro_torch.runtime.faults import FaultPlan
    t0 = time.perf_counter()
    counted = {}

    def add(launches):
        for k, v in launches.items():
            counted[k] = counted.get(k, 0) + v

    def fps(sess, x):
        _, seconds, _ = _timed_counted(
            lambda: [sess.infer(x) for _ in range(MESH_REPS)])
        return MESH_REPS * x.shape[0] / seconds

    # (a) mesh infer against the unsharded session
    frames_np = frames.cpu().numpy()
    flat = Session(cfg, ServeSpec(backend="hopper"), seed=SEED,
                   device="cuda")
    mesh = Session(cfg, ServeSpec(backend="hopper", mesh={"data": 1}),
                   seed=SEED, device="cuda")
    want = flat.infer(frames_np)
    got, _, launches = _timed_counted(lambda: mesh.infer(frames_np))
    add(launches)
    infer_equal = _outputs_equal(got, want)
    # in turns (mesh, unsharded, unsharded, mesh): host-clock numbers
    # compare only within one call
    order = [("mesh", mesh), ("unsharded", flat), ("unsharded", flat),
             ("mesh", mesh)]
    rates = {"mesh": [], "unsharded": []}
    for name, sess in order:
        rates[name].append(fps(sess, frames_np))
    emit("mesh", part="a: mesh infer, data=1", config=cfg.name, batch=BATCH,
         equals_unsharded=infer_equal, fps_mesh=rates["mesh"],
         fps_unsharded=rates["unsharded"], launches=launches,
         skip_fractions=[float(f) for f in got.skip_fractions])
    if not infer_equal:
        fail("mesh infer (data=1) differs from the unsharded Session.infer")
    if launches != counted_forwards(1, 2):
        fail(f"mesh infer launched {launches}")

    # (b) the shard split of a forward, through the kernels
    with torch.inference_mode():
        whole = snn_apply(mesh.params, frames, cfg, backend="hopper",
                          logits_only=True).logits
        halves = torch.cat([snn_apply(mesh.params, h, cfg, backend="hopper",
                                      logits_only=True).logits
                            for h in frames.chunk(2)])
    split_fwd = bool(torch.equal(whole, halves))
    # (c) the shard split of the gradient rows
    xs, ys = (torch.from_numpy(a).cuda()
              for a in mnist_like(MESH_TRAIN_BATCH // 2, seed=1))
    rows_fn = make_grad_rows_fn(cfg, spec=TrainSpec(backend="hopper"))
    loss, grads = rows_fn(mesh.params, xs, ys)
    parts = [rows_fn(mesh.params, xs[s], ys[s])
             for s in (slice(0, len(xs) // 2), slice(len(xs) // 2, None))]
    split_grad = bool(torch.equal(loss, torch.cat([p[0] for p in parts])))
    split_grad &= all(torch.equal(g, torch.cat(hs)) for g, *hs in zip(
        tree_leaves(grads), *(tree_leaves(p[1]) for p in parts)))
    emit("mesh", part="b, c: shard split through the kernels",
         forward_batch=BATCH, forward_halves_equal_whole=split_fwd,
         grad_rows=len(xs), grad_halves_equal_whole=split_grad)
    if not (split_fwd and split_grad):
        fail(f"shard split: forward bits equal {split_fwd}, gradient rows "
             f"equal {split_grad}")

    # (d) a mesh train step against the unsharded step
    x, y = mnist_like(MESH_TRAIN_BATCH, seed=0)
    tspec = TrainSpec(backend="hopper", lr=1e-2)
    steps = {}
    for name, spec in (("unsharded", tspec),
                       ("mesh", TrainSpec(backend="hopper", lr=1e-2,
                                          mesh={"data": 1}))):
        sess = Session(cfg, spec, seed=SEED, device="cuda")
        loss, seconds, launches = _timed_counted(
            lambda: sess.train_step(x, y))
        first = sess.params                 # a new dict every step
        # two more steps for the time (the params move; the work does not)
        times = [seconds] + [_timed_counted(lambda: sess.train_step(x, y))[1]
                             for _ in range(2)]
        steps[name] = (first, loss, statistics.median(times), launches)
    add(steps["mesh"][3])
    pairs = list(zip(tree_leaves(steps["mesh"][0]),
                     tree_leaves(steps["unsharded"][0])))
    close = all(torch.allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)
                for a, b in pairs)
    max_err = max(float((a - b).abs().max()) for a, b in pairs)
    emit("mesh", part="d: mesh train_step, data=1", batch=MESH_TRAIN_BATCH,
         loss_mesh=steps["mesh"][1], loss_unsharded=steps["unsharded"][1],
         params_within_grad_tol=close, params_max_abs_err=max_err,
         step_ms_mesh=steps["mesh"][2] * 1e3,
         step_ms_unsharded=steps["unsharded"][2] * 1e3,
         launches_mesh=steps["mesh"][3],
         launches_unsharded=steps["unsharded"][3])
    if not close:
        fail(f"mesh train_step params differ from the unsharded step's by "
             f"up to {max_err}")
    want_d = {"spiking_conv_lif_hoisted_save_u": MESH_TRAIN_BATCH,
              "spiking_conv_lif_fwd": 2 * MESH_TRAIN_BATCH,
              "lif_bwd": 3 * MESH_TRAIN_BATCH,
              "conv_grad_input": 2 * MESH_TRAIN_BATCH,
              "conv_grad_weights": 3 * MESH_TRAIN_BATCH,
              "conv_grad_weights_analog": MESH_TRAIN_BATCH}
    if steps["mesh"][3] != want_d:
        fail(f"mesh train_step launched {steps['mesh'][3]}, expected "
             f"{want_d}")

    # (e) a threaded engine on pinned lanes through a lane crash
    eng = flat.engine(ServeSpec(backend="hopper", num_lanes=2, threaded=True,
                                max_batch=16),
                      lane_devices=DeviceMesh(("data", 1)).lane_devices(2),
                      fault_plan=FaultPlan(crashes=((0, 0),)))
    rids = [eng.submit(f, arrival=0.0) for f in frames_np[:MESH_REQUESTS]]
    eng.run()
    snap = eng.snapshot()
    accounted = (snap.served + snap.rejected + snap.deadline_missed
                 + snap.cancelled)
    served = {r.rid: r.logits for r in eng.completed}
    lanes_equal = all(np.array_equal(served[rid], got.logits[i])
                      for i, rid in enumerate(rids) if rid in served)
    emit("mesh", part="e: threaded engine, pinned lanes, lane 0 crashes",
         requests=len(rids), served=snap.served, accounted=accounted,
         lane_devices=list(snap.lane_devices), lanes_alive=snap.lanes_alive,
         served_equal_mesh_infer=lanes_equal)
    if accounted != len(rids) or not snap.served or not lanes_equal:
        fail(f"pinned lanes: {accounted} of {len(rids)} accounted, "
             f"{snap.served} served, bits equal {lanes_equal}")

    # (f) snn-seg through the mesh infer
    seg = get_snn("snn-seg")
    seg_x, _ = road_like(SEG_BATCH, h=seg.input_hw[0], w=seg.input_hw[1],
                         seed=SEED)
    seg_flat = Session(seg, ServeSpec(backend="hopper"), seed=SEED,
                       device="cuda").infer(seg_x)
    seg_mesh = Session(seg, ServeSpec(backend="hopper", mesh={"data": 1}),
                       seed=SEED, device="cuda").infer(seg_x)
    seg_equal = _outputs_equal(seg_mesh, seg_flat)
    emit("mesh", part="f: snn-seg mesh infer, data=1", batch=SEG_BATCH,
         timesteps=seg.timesteps, equals_unsharded=seg_equal,
         skip_fractions=[float(f) for f in seg_mesh.skip_fractions])
    if not seg_equal:
        fail("snn-seg mesh infer differs from the unsharded Session.infer")

    # (g) more cards than present
    cards = torch.cuda.device_count()
    if cards >= 2:
        two = Session(cfg, ServeSpec(backend="hopper", mesh={"data": 2}),
                      seed=SEED, device="cuda").infer(frames_np)
        ok, ran = _outputs_equal(two, got), "data=2 against data=1"
    else:
        try:
            DeviceMesh(("data", 2))
            ok = False
        except ValueError as e:
            ok = "CUDA devices are visible" in str(e)
        ran = "DeviceMesh(data=2) raises on one card"
    emit("mesh", part="g: more cards than present", cards=cards, ran=ran,
         passed=ok)
    if not ok:
        fail(f"mesh check '{ran}' failed")
    emit("mesh", part="phase", seconds=time.perf_counter() - t0)
    return counted


# -- slice 7: the launchers on the facade, the examples ------------------------

ENTRY_ENGINE_STEPS, ENTRY_ENGINE_BATCH = 64, 8     # 512 requests


def _example(name: str):
    """``examples/torch_<name>.py`` as a module."""
    import importlib.util
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _timed_counted(fn):
    """fn(), its host seconds (done when its results are on the host) and
    the kernel launches it made."""
    import torch
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {k: v for k, v in
                                           read_counts().items() if v}


def phase_entry(cfg, train_losses):
    """The user-facing entry points on the card: (a) the serve launcher
    with a ServeSpec file, single-shot (predictions equal Session.infer's
    bits) and ``--engine --trace-out`` at 512 requests (one lane "X" event
    per micro-batch, one flow per request); (b) the train launcher with a
    TrainSpec file (losses equal the flag path's and the raw step's bit for
    bit); (c) the four examples at the reference's defaults on hopper, the
    Fig. 7 ablation also on batched, with threshold flips per layer, the
    count bound and the seg logit bound per mode.  Returns the launch
    counts of the launchers' and the ablation's hopper runs."""
    import tempfile
    import numpy as np
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch.api import ServeSpec, Session, TrainSpec
    from repro_torch.config import get_snn
    from repro_torch.core.snn_model import init_snn, snn_apply
    from repro_torch.core.snn_train import make_train_step
    from repro_torch.data.synthetic import mnist_like, road_like
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    counted = {}

    def add(launches):
        for k, v in launches.items():
            counted[k] = counted.get(k, 0) + v

    quiet = ["--device", "cuda", "--log-level", "warning"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        sspec = ServeSpec(backend="hopper", schedule_mode="aprc+cbws")
        (tmp / "serve.json").write_text(json.dumps(sspec.to_dict()))
        tspec = TrainSpec(backend="hopper", lr=1e-2)
        (tmp / "train.json").write_text(json.dumps(tspec.to_dict()))

        # (a) the serve launcher: single-shot, then the traced engine
        steps = 8
        s, _, launches = _timed_counted(lambda: serve_launcher.main(
            ["--spec-file", str(tmp / "serve.json"), "--batch", str(BATCH),
             "--steps", str(steps)] + quiet))
        add(launches)
        rng = np.random.default_rng(SEED)
        last = [rng.random((BATCH, *cfg.input_hw, cfg.input_channels),
                           dtype=np.float32) for _ in range(steps + 1)][-1]
        want = Session(cfg, sspec, seed=SEED, device="cuda").infer(last)
        equal = bool(np.array_equal(s["logits"], want.logits)
                     and np.array_equal(s["predictions"],
                                        want.logits.argmax(-1)))
        emit("entry", part="a: serve launcher, --spec-file, single-shot",
             batch=BATCH, requests=steps + 1, fps=s["fps"],
             seconds=s["seconds"], launches=launches,
             predictions_equal_session_infer=equal, device=s["device"])
        if not equal:
            fail("the serve launcher's --spec-file predictions differ from "
                 "Session.infer's")
        if launches != counted_forwards(steps + 1, 2):
            fail(f"the serve launcher launched {launches}")
        trace_path = tmp / "trace.json"
        n_req = ENTRY_ENGINE_STEPS * ENTRY_ENGINE_BATCH
        s, seconds, launches = _timed_counted(lambda: serve_launcher.main(
            ["--spec-file", str(tmp / "serve.json"), "--engine",
             "--steps", str(ENTRY_ENGINE_STEPS),
             "--batch", str(ENTRY_ENGINE_BATCH),
             "--trace-out", str(trace_path)] + quiet))
        add(launches)
        events = json.loads(trace_path.read_text())["traceEvents"]
        ph = [e["ph"] for e in events]
        emit("entry", part="a: serve launcher, --engine --trace-out",
             requests=n_req, served=s["served"], fps=s["fps"],
             p50_ms=s["p50_latency_s"] * 1e3,
             p99_ms=s["p99_latency_s"] * 1e3, rounds=s["rounds"],
             micro_batches=s["micro_batches"], trace_events=len(events),
             lane_x_events=ph.count("X"), flow_starts=ph.count("s"),
             flow_ends=ph.count("f"), trace_write_ms=s["trace_write_ms"],
             trace_bytes=trace_path.stat().st_size, host_seconds=seconds,
             launches=launches)
        if s["served"] != n_req or len(events) != s["trace_events"]:
            fail(f"traced engine: {s['served']} of {n_req} served, "
                 f"{len(events)} events in the file, {s['trace_events']} "
                 f"written")
        if ph.count("X") != s["micro_batches"] or not \
                ph.count("s") == ph.count("f") == n_req:
            fail(f"the trace file has {ph.count('X')} lane events for "
                 f"{s['micro_batches']} micro-batches and {ph.count('s')}/"
                 f"{ph.count('f')} flows for {n_req} requests")
        if launches.get("spiking_conv_lif_hoisted", 0) < s["micro_batches"]:
            fail(f"the traced engine launched {launches} for "
                 f"{s['micro_batches']} micro-batches")

        # (b) the train launcher: spec file, flag path, raw step
        r, _, launches = _timed_counted(lambda: train_launcher.main(
            ["--spec-file", str(tmp / "train.json"), "--steps",
             str(len(train_losses)), "--batch", str(BATCH)] + quiet))
        add(launches)
    params = init_snn(torch.Generator().manual_seed(SEED), cfg,
                      device="cuda")
    mom = tree_map(torch.zeros_like, params)
    step = make_train_step(cfg, spec=tspec)
    raw = []
    for i in range(len(train_losses)):
        x, y = (torch.from_numpy(a).cuda() for a in mnist_like(BATCH, seed=i))
        params, mom, loss = step(params, mom, x, y)
        raw.append(float(loss))
    emit("entry", part="b: train launcher, --spec-file", batch=BATCH,
         losses=r["losses"], losses_flag_path=train_losses,
         losses_raw_step=raw, median_step_ms=r["median_step_ms"],
         accuracy=r["accuracy"], launches=launches)
    if not r["losses"] == list(train_losses) == raw:
        fail("the train launcher's --spec-file losses differ from the flag "
             "path's or the raw step's")

    # (c) the four examples, at the reference's defaults on hopper
    q, seconds, launches = _timed_counted(
        lambda: _example("quickstart").run(device="cuda"))
    emit("entry", part="c: examples/torch_quickstart.py", seconds=seconds,
         loss_first=q["losses"][0], loss_last=q["losses"][-1],
         accuracy=q["accuracy"], single_shot_fps=q["single_shot_fps"],
         live_served=q["live"]["served"],
         live_p50_ms=q["live"]["p50_latency_s"] * 1e3,
         live_p99_ms=q["live"]["p99_latency_s"] * 1e3,
         live_accuracy=q["live_accuracy"], launches=launches)
    m, seconds, launches = _timed_counted(
        lambda: _example("snn_mnist_train").run(device="cuda"))
    emit("entry", part="c: examples/torch_snn_mnist_train.py",
         seconds=seconds, train_seconds=m["train_seconds"],
         loss_first=m["losses"][0], loss_last=m["losses"][-1],
         accuracy=m["accuracy"], table1_xc7z045_model=m["table1"],
         spearman=m["spearman"], launches=launches)
    b, seconds, launches = _timed_counted(
        lambda: _example("serve_batched").serve_snn_batched(
            get_snn("snn-mnist"), device="cuda"))
    emit("entry", part="c: examples/torch_serve_batched.py",
         seconds=seconds, ms_per_batch=b["ms_per_batch"], fps=b["fps"],
         speedup_vs_ref=b["speedup"], launches=launches)
    if not launches.get("spiking_conv_lif_hoisted"):
        fail(f"torch_serve_batched.py did not run the kernels: {launches}")

    # the Fig. 7 ablation on snn-seg, hopper and batched
    sim = _example("snn_accelerator_sim")
    seg = get_snn("snn-seg")
    runs = {}
    for backend in ("hopper", "batched"):
        runs[backend], seconds, launches = _timed_counted(
            lambda: sim.simulate(seg, backend=backend, device="cuda"))
        runs[backend]["seconds"] = seconds
        if backend == "hopper":
            add(launches)
            want = counted_forwards(3, 4, spiking_conv=1)
            if launches != want:
                fail(f"the ablation's three hopper forwards launched "
                     f"{launches}, expected {want}")
    h_run, b_run = runs["hopper"], runs["batched"]
    t = h_run["timesteps"]
    params = init_snn(torch.Generator().manual_seed(SEED), seg,
                      device="cuda")
    x = torch.from_numpy(road_like(h_run["frames"], h=seg.input_hw[0],
                                   w=seg.input_hw[1], seed=0)[0]).cuda()
    for mode in sim.MODES:
        hm, bm = h_run["modes"][mode], b_run["modes"][mode]
        vcfg, vparams, sched = sim.variant(seg, params, mode, t)
        with torch.inference_mode():
            flips, bound, _ = seg_logit_bound(vcfg, vparams, x, sched)
            got = snn_apply(vparams, x, vcfg, backend="hopper",
                            schedule=sched, logits_only=True).logits
            ref = snn_apply(vparams, x, vcfg, backend="batched",
                            logits_only=True).logits
        excess = float(((got - ref).abs().double() - bound).max())
        dcounts = [float(np.abs(a - c).sum()) for a, c in
                   zip(hm["timestep_counts"], bm["timestep_counts"])]
        emit("entry", part="c: examples/torch_snn_accelerator_sim.py",
             mode=mode, aprc=vcfg.aprc, frames=h_run["frames"], timesteps=t,
             balance_xc7z045_model={"hopper": hm["balance"],
                                    "batched": bm["balance"],
                                    "paper": hm["paper_balance"]},
             barrier_balance={"hopper": hm["barrier_balance"],
                              "batched": bm["barrier_balance"]},
             fps_model={"hopper": hm["fps"], "batched": bm["fps"]},
             mj_per_frame_model={"hopper": hm["mj_per_frame"],
                                 "batched": bm["mj_per_frame"]},
             threshold_flips_per_layer=flips,
             count_abs_diff_per_layer=dcounts,
             max_abs_err_logits=float((got - ref).abs().max()),
             max_abs_err_logits_beyond_bound=excess,
             seconds={k: r["seconds"] for k, r in runs.items()})
        if any(f > MAX_FLIP_FRACTION * n for f, n in flips):
            fail(f"ablation {mode}: threshold flips per layer {flips} exceed "
                 f"{MAX_FLIP_FRACTION}")
        if any(d > t * f for d, (f, _) in zip(dcounts, flips)):
            fail(f"ablation {mode}: count differences {dcounts} exceed T x "
                 f"the differing sites {flips}")
        if excess > 0:
            fail(f"ablation {mode}: hopper logits exceed the seg bound by "
                 f"{excess}")
    emit("entry", part="c: the ablation's gain",
         gain_xc7z045_model={k: r["gain"] for k, r in runs.items()},
         paper_gain=1.4)
    return counted


# -- the LM serving path (phase lm) --------------------------------------------

def _lm_consistency(cfg, params, tokens, prompt_len: int, steps: int,
                    forward_len: int):
    """Decode against forward on the same weights, float32 caches (the
    check of ``tests/test_decode.py``): prefill ``tokens[:, :prompt_len]``,
    then ``steps`` teacher-forced decode steps; the forward runs over
    ``tokens[:, :forward_len]`` (causal, so positions past the compared
    ones change nothing).  Returns the largest error of the prefill and of
    the decode logits, each over max(1, max|forward logit|), and for a MoE
    the routing of both sides compared token for token
    (``_route_flips``)."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.layers.moe import recorded_routes
    with torch.inference_mode(), recorded_routes(params) as routes:
        full = transformer.forward(params, cfg, tokens=tokens[:, :forward_len],
                                   remat=False)[0]
        last, caches = transformer.prefill(
            params, cfg, tokens=tokens[:, :prompt_len], remat=False,
            max_len=prompt_len + steps, cache_dtype=torch.float32)
        outs = [last]
        for i in range(steps):
            pos = prompt_len + i
            logits, caches = transformer.decode_step(
                params, caches, cfg, token=tokens[:, pos:pos + 1], pos=pos)
            outs.append(logits)
        errs = []
        for i, got in enumerate(outs):
            want = full[:, prompt_len - 1 + i].float()
            scale = max(1.0, float(want.abs().max()))
            errs.append(float((got[:, 0].float() - want).abs().max()) / scale)
    return errs[0], max(errs[1:]), _route_flips(routes, tokens.shape[0],
                                                forward_len)


def _route_flips(routes, batch: int, forward_len: int):
    """The recorded routes of ``_lm_consistency`` (each MoE layer's
    forward, prefill, then each decode step): the tokens whose set of
    experts differs between the forward and the prefill or a decode step
    at the same position, over the tokens compared, and the smallest k-th
    gate margin of the forward in the layers where one differs (a flip
    needs a near tie); None without a MoE."""
    import torch
    if not routes:
        return None
    by_layer = {}
    for r in routes:
        by_layer.setdefault(r["layer"], []).append(r)
    flips, compared, margins = 0, 0, []
    for fwd, *later in by_layer.values():
        got = torch.cat([r["top_idx"].reshape(batch, -1, r["top_idx"]
                                               .shape[-1]) for r in later],
                        dim=1)
        want = fwd["top_idx"].reshape(batch, forward_len, -1)[
            :, :got.shape[1]]
        differ = (got.sort(-1).values != want.sort(-1).values).any(-1)
        flips += int(differ.sum())
        compared += differ.numel()
        if differ.any():
            margins.append(fwd["margin"])
    return {"flipped_tokens": flips, "tokens_compared": compared,
            "forward_min_gate_margin_where_flipped": min(margins,
                                                         default=None)}


def _no_drop(cfg):
    """``cfg`` with the MoE's capacity factor at 2 x E / k: every expert
    has a slot for every token (C >= T; an expert takes a token at most
    once), so no token drops and decode equals forward.  The weights do
    not change: the routing reads the factor from the config handed to
    ``forward``, ``prefill`` and ``decode_step``."""
    import dataclasses
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=2 * cfg.moe.num_experts / cfg.moe.top_k))


def _cut(cfg, kinds):
    """``cfg`` at full width with one layer of each (mixer, ffn) in
    ``kinds``, in that order."""
    import dataclasses
    return dataclasses.replace(cfg, num_layers=len(kinds),
                               stages=tuple((1, (k,)) for k in kinds))


def _route_diff(card, ref):
    """(choices whose expert, position or keep differ, the smallest k-th
    gate margin of the reference run) between two runs' recorded
    routes."""
    diff = abs(len(card) - len(ref))
    for a, b in zip(card, ref):
        for key in ("top_idx", "pos", "keep"):
            diff += int((a[key].cpu() != b[key].cpu()).sum())
    margin = min((r["margin"] for r in ref), default=None)
    return diff, margin


def _f64_check(cfg, seed: int, batch: int, prompt_len: int, steps: int,
               layers: int = 2, kinds=None):
    """Full width, depth cut to ``layers`` (2: the pattern's first, then
    its first of another kind if it has one: gemma's sliding and global
    layers, a DeepSeek's dense and MoE layers; 1: the first), or to the
    pattern's entries at the indices ``kinds``, through the
    config's frontend: the card's float32 logits (the encoder's
    ``encode_step``, or a prefill, with the patches first for pixtral, and
    ``steps`` decode steps) against the port's own code in float64 on the
    CPU, on the same weights and inputs; and once more on the card with
    TF32 products, to show the tolerance would see them.  The MoE layers'
    routing of the card's and the float64 run (``moe.recorded_routes``)
    is compared choice for choice.  Returns the output's shape, its
    largest error over max(1, max|float64 logit|), the TF32 run's, and the
    routing's differences and smallest k-th gate margin."""
    import numpy as np
    import torch
    from repro_torch.models import lm, transformer
    from repro_torch.models.layers.moe import recorded_routes
    pattern = cfg.pattern()
    other = next((k for k in pattern if k != pattern[0]), pattern[1])
    cut = _cut(cfg, [pattern[i] for i in kinds] if kinds
               else (pattern[0], other)[:layers])
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(seed), cut)
    rng = np.random.default_rng(seed)
    if cut.frontend == "frames":
        frames = torch.from_numpy(rng.standard_normal(
            (batch, prompt_len, cut.frontend_dim)).astype(np.float32))
    else:
        toks = torch.from_numpy(rng.integers(
            0, cut.vocab_size, (batch, prompt_len + steps), dtype=np.int32))
    patches = None
    if cut.frontend == "patches+tokens":
        patches = torch.from_numpy(rng.standard_normal(
            (batch, cut.num_patches, cut.frontend_dim)).astype(np.float32))
    off = 0 if patches is None else cut.num_patches

    def run(p):
        dev, dt = p.final_norm.scale.device, p.final_norm.scale.dtype
        if cut.frontend == "frames":
            return lm.make_encode_step(cut)(p, {"frames": frames.to(dev, dt)})
        last, caches = transformer.prefill(
            p, cut, tokens=toks[:, :prompt_len].to(dev),
            patches=None if patches is None else patches.to(dev, dt),
            remat=False, max_len=off + prompt_len + steps, cache_dtype=dt)
        outs = [last]
        for i in range(steps):
            pos = prompt_len + i
            last, caches = lm.make_decode_step(cut)(
                p, caches, toks[:, pos:pos + 1].to(dev), off + pos)
            outs.append(last)
        return torch.cat(outs, 1)

    with torch.inference_mode():
        with recorded_routes(params) as card_routes:
            card = run(params).double().cpu()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            card_tf32 = run(params).double().cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        params.to(device="cpu", dtype=torch.float64)
        with recorded_routes(params) as ref_routes:
            ref = run(params)
    del params
    scale = max(1.0, float(ref.abs().max()))
    if not torch.isfinite(card).all():
        fail(f"lm {cfg.name}: non-finite logits on the card")
    diff, margin = _route_diff(card_routes, ref_routes)
    return (list(card.shape), float((card - ref).abs().max()) / scale,
            float((card_tf32 - ref).abs().max()) / scale,
            {"moe_calls": len(ref_routes), "route_differences": diff,
             "min_gate_margin": margin})


def _lm_measure(cfg, s, params, prompt_len: int, batch: int):
    """The card's numbers of one LM: prefill ms (CUDA events, median of 3)
    and tokens/s, decode-step ms (the launcher's steps, each ended by a
    sync: median) and tokens/s, device ms and launches of one decode step
    (the profiler), each beside its bound: for a decode step the
    parameter bytes over the HBM rate (what the dense MoE dispatch reads:
    every expert's weights), and beside it the active parameters' bytes
    (``count_params(active_only=True)``: the routed top-k experts only;
    all of a dense LM's); for the prefill its FLOPs over the float32
    peak.  The prefill's FLOPs are ``counting.step_flops`` less the head of
    every token but the last: it counts the logits of every token, and a
    prefill computes the last token's only."""
    import numpy as np
    import torch
    from repro_torch.config import ShapeConfig
    from repro_torch.models import counting, transformer
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (batch, prompt_len), dtype=np.int32)).cuda()
    with torch.inference_mode():
        prefill_ms = cuda_ms(lambda: transformer.prefill(
            params, cfg, tokens=toks, remat=False, max_len=prompt_len + 1),
            reps=3, warmup=1)
        _, caches = transformer.prefill(params, cfg, tokens=toks,
                                        remat=False, max_len=prompt_len + 1)
        tok = toks[:, :1]
        by_kernel, launches = device_time(lambda: transformer.decode_step(
            params, caches, cfg, token=tok, pos=prompt_len), reps=3)
    step_ms = statistics.median(s["decode_step_seconds"]) * 1e3
    n_params = counting.count_params(cfg)
    n_active = counting.count_params(cfg, active_only=True)
    step_flops = counting.step_flops(cfg, ShapeConfig(
        "prefill", prompt_len, batch, "prefill"))["fwd"]
    flops = step_flops - (batch * prompt_len - batch) * 2.0 * cfg.d_model \
        * cfg.vocab_size
    decode_device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {
        "params": n_params, "param_bytes": 4 * n_params,
        "active_params": n_active,
        "prefill_tokens": batch * prompt_len,
        "prefill_ms": prefill_ms,
        "prefill_ms_first_call": s["prefill_seconds"] * 1e3,
        "prefill_tokens_per_s": batch * prompt_len / prefill_ms * 1e3,
        "prefill_flops": flops,
        "prefill_step_flops": step_flops,
        "prefill_bound_ms": flops / PEAK_FP32 * 1e3,
        "decode_step_ms": step_ms,
        "decode_step_ms_all": [x * 1e3 for x in s["decode_step_seconds"]],
        "decode_tokens_per_s": batch / step_ms * 1e3,
        "decode_bound_ms": 4 * n_params / PEAK_BYTES * 1e3,
        "decode_bound_active_ms": 4 * n_active / PEAK_BYTES * 1e3,
        "decode_device_ms": decode_device_ms,
        "decode_device_idle_share": max(0.0, 1 - decode_device_ms / step_ms),
        "decode_launches_per_step": launches / 3,
        "decode_top_device_ms": [[k[:80], v] for k, v in top],
    }


def _lm_dropped(cfg, params, batch: int, prompt_len: int, seed: int):
    """The MoE's dropped (token, choice) pairs in the prefill of the
    launcher's prompts (numpy ``seed``), at the configured capacity factor:
    a recorded prefill (``moe.recorded_routes``), untimed."""
    import numpy as np
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.layers.moe import recorded_routes
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt_len), dtype=np.int32)).cuda()
    with torch.inference_mode(), recorded_routes(params) as routes:
        transformer.prefill(params, cfg, tokens=toks, remat=False,
                            max_len=prompt_len + 1)
    dropped = [int((~r["keep"]).sum()) for r in routes]
    return {"moe_layers": len(routes), "capacity": routes[0]["capacity"],
            "choices_per_layer": batch * prompt_len * cfg.moe.top_k,
            "dropped_choices": sum(dropped),
            "dropped_choices_per_layer": dropped,
            "min_gate_margin": min(r["margin"] for r in routes)}


def _lm_serve(name, cfg, r, serve):
    """One LM served on the card by ``serve()`` (``serve_lm``'s dict): its
    launches (no SNN kernel), peak memory, decode against forward on the
    same weights (``_no_drop`` for a MoE), its dropped tokens at the
    configured capacity factor, and ``_lm_measure``'s numbers."""
    import numpy as np
    import torch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s = serve()
    torch.cuda.synchronize()
    launcher_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = {k: v for k, v in read_counts().items() if v}
    params = s.pop("params")
    if counts:
        fail(f"lm {name}: the LM path launched SNN kernels {counts}")
    if not np.isfinite(s["logits"]).all():
        fail(f"lm {name}: non-finite logits")
    # the consistency check: prompts at least the window long (a shorter
    # one leaves the reference's max_len buffer, whose decode attends past
    # the window; ROADMAP queue 3)
    window = cfg.attn.window if cfg.attn else 0
    check_prompt = r.get("check_prompt", r["prompt"])
    if window and check_prompt < window:
        fail(f"lm {name}: prompt {check_prompt} < window {window}")
    toks = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (r["batch"], r["forward_len"]),
        dtype=np.int32)).cuda()
    check_cfg = _no_drop(cfg)
    prefill_err, decode_err, flips = _lm_consistency(
        check_cfg, params, toks, check_prompt, r["check_steps"],
        r["forward_len"])
    extra = {}
    if cfg.moe is not None:
        extra["moe_prefill"] = _lm_dropped(cfg, params, r["batch"],
                                           r["prompt"], 0)
    numbers = _lm_measure(cfg, s, params, r["prompt"], r["batch"])
    emit("lm", part=name, layers=cfg.num_layers, d_model=cfg.d_model,
         batch=r["batch"], prompt_len=r["prompt"], new=r["new"],
         generated=s["tokens"].shape, sample=s["tokens"][0, :8].tolist(),
         launcher_seconds=launcher_s, peak_memory_bytes=peak,
         decode_vs_forward={
             "prefill_err": prefill_err, "decode_err": decode_err,
             "prefill_tol": LM_PREFILL_TOL, "decode_tol": LM_DECODE_TOL,
             "prompt_len": check_prompt, "decode_steps": r["check_steps"],
             "capacity_factor": (check_cfg.moe.capacity_factor
                                 if cfg.moe else None),
             "route_flips": flips, "cache_dtype": "float32"},
         snn_kernel_launches=counts, device=s["device"], **extra,
         **numbers)
    if prefill_err > LM_PREFILL_TOL or decode_err > LM_DECODE_TOL:
        fail(f"lm {name}: decode against forward: prefill {prefill_err} "
             f"(bound {LM_PREFILL_TOL}), decode {decode_err} (bound "
             f"{LM_DECODE_TOL})")


def phase_lm():
    """The LM substrate's serving path on the card (module doc, phase
    ``lm``).  Returns nothing: it launches none of the SNN kernels."""
    import torch
    from repro_torch.config import get_arch
    from repro_torch.launch import serve as serve_launcher
    t_phase = time.perf_counter()
    emit("lm", tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         float32_matmul_precision=torch.get_float32_matmul_precision())
    if torch.backends.cuda.matmul.allow_tf32:
        fail("lm: TF32 matmuls are on; the LM runs in full float32")

    def launcher(arch, r):
        return lambda: serve_launcher.main([
            "--arch", arch, "--full-config", "--batch", str(r["batch"]),
            "--prompt-len", str(r["prompt"]), "--new", str(r["new"]),
            "--log-level", "error"])

    runs = {"qwen2.5-3b": dict(batch=4, prompt=64, new=32, check_steps=8,
                                forward_len=72),
            "gemma3-4b": dict(batch=1, prompt=2048, new=17, check_steps=16,
                              forward_len=3072),
            "deepseek-moe-16b": dict(batch=4, prompt=64, new=32,
                                     check_steps=8, forward_len=72),
            # attention-free, its prompt two chunks of the time-mix; the
            # check's prompt plus steps a whole number of chunks
            "rwkv6-7b": dict(batch=4, prompt=256, new=32, check_prompt=128,
                             check_steps=128, forward_len=256)}
    for arch, r in runs.items():
        t0 = time.perf_counter()
        _lm_serve(f"{arch} full width and depth, serve launcher",
                  get_arch(arch), r, launcher(arch, r))
        emit("lm", part=f"{arch}: seconds", seconds=time.perf_counter() - t0)
    # deepseek-v3-671b at full width, depth 2 (an MLA + dense layer, then
    # an MLA + MoE layer, the config's order) through serve_lm, the
    # launcher's loop, on the cut config
    v3 = get_arch("deepseek-v3-671b")
    v3_cut = _cut(v3, (v3.pattern()[0], v3.pattern()[-1]))
    r = dict(batch=1, prompt=2048, new=17, check_prompt=64, check_steps=8,
             forward_len=72)
    t0 = time.perf_counter()
    _lm_serve("deepseek-v3-671b full width, depth 2 (MLA + dense, MLA + "
              "MoE), serve_lm", v3_cut, r, lambda: serve_launcher.serve_lm(
                  v3_cut, batch=r["batch"], prompt_len=r["prompt"],
                  new=r["new"], device="cuda"))
    emit("lm", part="deepseek-v3-671b: seconds",
         seconds=time.perf_counter() - t0)
    # jamba-v0.1-52b at full width, its first period of 8 layers (7 Mamba,
    # 1 attention; 4 dense and 4 MoE FFNs): a long prompt, 16 Mamba chunks
    jamba = get_arch("jamba-v0.1-52b")
    jamba_cut = _cut(jamba, jamba.pattern()[:8])
    r = dict(batch=1, prompt=2048, new=17, check_prompt=128, check_steps=128,
             forward_len=256)
    t0 = time.perf_counter()
    _lm_serve("jamba-v0.1-52b full width, its first 8 layers (7 Mamba, "
              "1 attention, 4 MoE), serve_lm", jamba_cut, r,
              lambda: serve_launcher.serve_lm(
                  jamba_cut, batch=r["batch"], prompt_len=r["prompt"],
                  new=r["new"], device="cuda"))
    emit("lm", part="jamba-v0.1-52b: seconds",
         seconds=time.perf_counter() - t0)
    # the card against float64 on the CPU, full width, depth 2 (v3: 1),
    # each through its frontend: (c) hubert's encode_step on frames,
    # pixtral's prefill with its 256 patches before the tokens
    checks = {"qwen2.5-3b": dict(batch=4, prompt_len=64, steps=4),
              "gemma3-4b": dict(batch=1, prompt_len=1024, steps=4),
              "hubert-xlarge": dict(batch=2, prompt_len=1024, steps=0),
              "pixtral-12b": dict(batch=2, prompt_len=64, steps=2),
              "deepseek-moe-16b": dict(batch=4, prompt_len=64, steps=4),
              "deepseek-v3-671b": dict(batch=1, prompt_len=64, steps=4,
                                       layers=1),
              "rwkv6-7b": dict(batch=2, prompt_len=64, steps=4),
              # its first layer (Mamba + dense) and its attention layer
              "jamba-v0.1-52b": dict(batch=2, prompt_len=64, steps=4,
                                     kinds=(0, 4))}
    for arch, c in checks.items():
        cfg = get_arch(arch)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        shape, err, tf32_err, routes = _f64_check(cfg, SEED, **c)
        emit("lm", part=f"{arch}: card float32 against CPU float64, full "
             f"width, {c.get('layers', 2)} layers, frontend {cfg.frontend}",
             shape=shape, max_err_over_scale=err, tol=LM_F64_TOL,
             tf32_max_err_over_scale=tf32_err,
             tf32_after=torch.backends.cuda.matmul.allow_tf32,
             seconds=time.perf_counter() - t0, **routes, **c)
        want_len = (c["prompt_len"] if cfg.is_encoder_only
                    else 1 + c["steps"])
        if shape != [c["batch"], want_len, cfg.vocab_size]:
            fail(f"lm {arch}: output shape {shape}")
        if err > LM_F64_TOL:
            fail(f"lm {arch}: card against float64 {err} > {LM_F64_TOL}")
        if routes["route_differences"]:
            fail(f"lm {arch}: the card's routing differs from float64's in "
                 f"{routes['route_differences']} choices (smallest k-th "
                 f"gate margin {routes['min_gate_margin']})")
        if tf32_err <= LM_F64_TOL:
            fail(f"lm {arch}: with TF32 products the error {tf32_err} is "
                 f"within {LM_F64_TOL}: the check would not see them")
        if torch.backends.cuda.matmul.allow_tf32:
            fail(f"lm {arch}: TF32 was left on after the TF32 run")
    torch.cuda.empty_cache()
    emit("lm", part="phase", seconds=time.perf_counter() - t_phase)


# -- LM training (phase lm_train) ----------------------------------------------

LM_TRAIN_ARCH = "qwen2.5-3b"
LM_TRAIN = dict(batch=4, seq=256, steps=6)


def _host_room():
    """Free disk beside the checkout and in the temp dir, and the host's
    memory, as ``df`` and ``free`` give them."""
    import tempfile
    dirs = [str(ROOT), tempfile.gettempdir()]
    df = subprocess.run(["df", "-B1", "--output=target,avail"] + dirs,
                        capture_output=True, text=True, timeout=60)
    free = subprocess.run(["free", "-b"], capture_output=True, text=True,
                          timeout=60)
    room = {d: shutil.disk_usage(d).free for d in dirs}
    return room, df.stdout.strip().splitlines(), \
        free.stdout.strip().splitlines()


def _ckpt_dir(need: float) -> Path:
    """A directory for a checkpoint of ``need`` bytes: under ``build/``
    beside the checkout (gitignored) if it has the room, else in the temp
    dir; fails if neither has."""
    import tempfile
    for base in (ROOT / "build", Path(tempfile.gettempdir())):
        base.mkdir(parents=True, exist_ok=True)
        if shutil.disk_usage(base).free > 1.1 * need:
            d = base / "lm_train_ckpt"
            shutil.rmtree(d, ignore_errors=True)
            return d
    fail(f"lm_train: no filesystem holds a {need / 1e9:.1f} GB checkpoint")


def _train_batch(cfg, batch: int, seq: int, seed: int):
    import torch
    from repro_torch.data.synthetic import token_batches
    b = next(token_batches(cfg.vocab_size, batch, seq, seed=seed))
    return {k: torch.from_numpy(v).cuda() for k, v in b.items()}


def _lm_train_launcher(cfg, smi: str):
    """(a) The train launcher at full width and depth, then two steps of
    ``make_train_step`` on one batch, one step's profile and the clip and
    AdamW alone."""
    import math

    import numpy as np
    import torch
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import counting, lm
    from repro_torch.optim import adam
    n_params = counting.count_params(cfg)
    ckpt_bytes = 3 * 4 * n_params           # params, m and v in float32
    room, df, free = _host_room()
    emit("lm_train", part="host room", disk_free_bytes=room, df=df,
         free=free, checkpoint_bytes_needed=ckpt_bytes)
    ckpt = _ckpt_dir(ckpt_bytes)
    r = LM_TRAIN
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_launcher.main([
        "--arch", LM_TRAIN_ARCH, "--full-config", "--batch", str(r["batch"]),
        "--seq", str(r["seq"]), "--steps", str(r["steps"]),
        "--checkpoint-every", str(r["steps"] + 1), "--ckpt-dir", str(ckpt),
        "--log-level", "error"])
    launcher_s = time.perf_counter() - t0
    # the final save reached the disk: its manifest and at least its bytes
    final = ckpt / f"step_{r['steps']}"
    npz = final / "arrays.npz"
    on_disk = npz.stat().st_size if npz.exists() else 0
    saved = (final / "manifest.json").exists() and \
        on_disk >= out["save_bytes"]
    shutil.rmtree(ckpt, ignore_errors=True)
    tokens = r["batch"] * r["seq"]
    flops = counting.step_flops(cfg, ShapeConfig(
        "train", r["seq"], r["batch"], "train"))["train"]
    bound_ms = flops / PEAK_FP32 * 1e3
    losses = out["losses"]
    emit("lm_train", part=f"(a) {LM_TRAIN_ARCH} full width and depth, "
         f"train launcher", layers=cfg.num_layers, d_model=cfg.d_model,
         params=n_params, **r, losses=losses, ln_vocab=math.log(
             cfg.vocab_size), median_step_ms=out["median_step_ms"],
         step_ms=out["step_ms"], tokens_per_s=out["tokens_per_s"],
         train_flops=flops, bound_ms=bound_ms,
         bound_tokens_per_s=tokens / bound_ms * 1e3,
         share_of_bound=bound_ms / out["median_step_ms"],
         peak_memory_bytes=out["peak_memory_bytes"],
         save_seconds=out["save_seconds"], save_bytes=out["save_bytes"],
         save_gb_per_s=out["save_bytes"] / out["save_seconds"] / 1e9,
         save_bytes_on_disk=on_disk,
         ckpt_dir=str(ckpt), launcher_seconds=launcher_s,
         steps_done=out["steps_done"], resumed_from=out["resumed_from"],
         device=out["device"], nvidia_smi=smi)
    if out["steps_done"] != r["steps"] or out["resumed_from"] is not None:
        fail(f"lm_train: the launcher ran {out['steps_done']} steps "
             f"(resumed from {out['resumed_from']})")
    if not np.isfinite(losses).all():
        fail(f"lm_train: non-finite losses {losses}")
    # random weights give logits of about unit variance, which add about
    # 0.5 to ln V
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.5:
        fail(f"lm_train: first loss {losses[0]} is not near ln V = "
             f"{math.log(cfg.vocab_size)}")
    if out["peak_memory_bytes"] >= 80e9:
        fail(f"lm_train: peak memory {out['peak_memory_bytes']} >= 80 GB")
    if out["save_bytes"] != ckpt_bytes + 4:      # and the int32 step
        fail(f"lm_train: the save wrote {out['save_bytes']} bytes, not "
             f"params, m and v")
    if not saved:
        fail(f"lm_train: the final save is not on disk: {final} holds "
             f"{on_disk} bytes of arrays.npz, the save {out['save_bytes']}")
    # two steps on one batch lower the loss (the reference's
    # test_loss_decreases_two_steps), at full width and depth
    torch.cuda.empty_cache()
    state = lm.init_train_state(
        torch.Generator(device="cuda").manual_seed(SEED), cfg)
    b = _train_batch(cfg, r["batch"], r["seq"], SEED + 2)
    step = lm.make_train_step(cfg, total_steps=100)
    _, m1 = step(state, b)
    _, m2 = step(state, b)
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    emit("lm_train", part="(a) two steps of make_train_step on one batch",
         losses=[l1, l2], grad_norms=[float(m1["grad_norm"]),
                                     float(m2["grad_norm"])],
         lrs=[float(m1["lr"]), float(m2["lr"])])
    if not l2 < l1:
        fail(f"lm_train: two steps on one batch did not lower the loss: "
             f"{l1} -> {l2}")
    # one step's time (CUDA events) and its device time by kernel
    step_ms = cuda_ms(lambda: step(state, b), reps=2, warmup=0)
    by_kernel, launches = device_time(lambda: step(state, b), reps=1)
    dev_ms = sum(by_kernel.values())
    gemm_ms = sum(v for k, v in by_kernel.items()
                  if "gemm" in k.lower() or "sgemm" in k.lower())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    # the clip and AdamW alone, on grads of the params' shapes
    grads = {n: torch.full_like(p, 1e-3)
             for n, p in state.params.named_parameters()}
    lr = torch.full((), 1e-6, device="cuda")

    def optimizer():
        g, _ = adam.clip_by_global_norm(grads, 1.0)
        adam.update(g, state.opt, state.params, lr=lr)

    opt_ms = cuda_ms(optimizer, reps=3, warmup=1)
    opt_kernels, opt_launches = device_time(optimizer, reps=1)
    opt_dev_ms = sum(opt_kernels.values())
    # the clip reads the grads twice and writes them; AdamW reads g, m, v
    # and p and writes m, v and p
    opt_bound_ms = 10 * 4 * n_params / PEAK_BYTES * 1e3
    emit("lm_train", part="(a) one train step at full width and depth",
         step_ms=step_ms, device_ms=dev_ms,
         device_idle_share=max(0.0, 1 - dev_ms / step_ms),
         launches_per_step=launches, gemm_device_ms=gemm_ms,
         bound_ms=bound_ms, top_device_ms=[[k[:90], v] for k, v in top],
         optimizer_ms=opt_ms, optimizer_device_ms=opt_dev_ms,
         optimizer_launches=opt_launches,
         optimizer_bound_ms=opt_bound_ms,
         optimizer_top_device_ms=[[k[:90], v] for k, v in sorted(
             opt_kernels.items(), key=lambda kv: -kv[1])[:6]])
    del state, grads, step
    torch.cuda.empty_cache()


def _f64_grad_check(cfg, seed: int, batch: int = 2, seq: int = 64):
    """The loss and every gradient leaf of ``loss_fn`` (remat, as the train
    step runs it) on the card in float32, then with TF32 products, against
    the port's code in float64 on the CPU, on the same weights and tokens;
    the MoE layers' routing of the card and of float64 compared choice
    for choice.  Returns the largest error of the loss and of any leaf,
    each over max(1, max|float64|), the worst leaf, the TF32 run's, and
    the routing's differences."""
    import numpy as np
    import torch
    from repro_torch.models import lm, transformer
    from repro_torch.models.layers.moe import recorded_routes
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(seed), cfg)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq + 1), dtype=np.int32)
    host = {"tokens": torch.from_numpy(toks[:, :-1]),
            "labels": torch.from_numpy(toks[:, 1:])}

    def run(p):
        dev = p.final_norm.scale.device
        b = {k: v.to(dev) for k, v in host.items()}
        with torch.no_grad(), recorded_routes(p) as routes:
            lm.loss_fn(p, cfg, b, remat=False)
        names, leaves = zip(*p.named_parameters())
        loss, _ = lm.loss_fn(p, cfg, b)
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), dict(zip(names, grads)), routes

    loss32, g32, card_routes = run(params)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        loss_tf, g_tf, _ = run(params)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    params.to(device="cpu", dtype=torch.float64)
    loss64, g64, ref_routes = run(params)
    del params
    errs, tf_errs = {}, {}
    for n, ref in g64.items():
        scale = max(1.0, float(ref.abs().max()))
        for got, out in ((g32, errs), (g_tf, tf_errs)):
            d = got.pop(n).cpu().double()
            out[n] = float(d.sub_(ref).abs_().max()) / scale
    worst = max(errs, key=errs.get)
    lscale = max(1.0, abs(loss64))
    diff, margin = _route_diff(card_routes, ref_routes)
    return {"loss64": loss64, "loss_err": abs(loss32 - loss64) / lscale,
            "grad_err": errs[worst], "worst_leaf": worst,
            "tf32_loss_err": abs(loss_tf - loss64) / lscale,
            "tf32_grad_err": max(tf_errs.values()),
            "leaves": len(errs), "moe_calls": len(ref_routes),
            "route_differences": diff, "min_gate_margin": margin}


def _params_equal(a, b):
    """(equal bit for bit, the largest difference) of two lists of
    tensors."""
    diff = max(float((x.double() - y.double()).abs().max())
               for x, y in zip(a, b))
    return diff == 0.0, diff


def _lm_train_loop(cfg):
    """(c) ``ResilientLoop`` on the card at full width, depth 2: a step
    that raises after its backward at step 5 rolls back and replays to the
    uninterrupted run's params; a second loop resumes; a bfloat16 round
    trip of card tensors."""
    import itertools

    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models import lm
    from repro_torch.optim import adam
    from repro_torch.runtime.fault_tolerance import LoopConfig, ResilientLoop
    cut = _cut(cfg, cfg.pattern()[:2])
    b = _train_batch(cut, 2, 64, SEED + 3)
    step = lm.make_train_step(cut, total_steps=100)

    def fresh():
        return lm.init_train_state(
            torch.Generator(device="cuda").manual_seed(SEED), cut)

    def params_of(st):
        return [p.detach().to("cpu", copy=True)
                for p in st.params.parameters()]

    runs = []
    for _ in range(2):
        st, snaps = fresh(), {}
        for i in range(7):
            step(st, b)
            if i + 1 in (6, 7):
                snaps[i + 1] = params_of(st)
        runs.append(snaps)
        del st
    bitwise, spread = _params_equal(runs[0][6], runs[1][6])
    ckpt = _ckpt_dir(3 * 4 * sum(p.numel() for p in runs[0][6]) * 3)
    clip, fired = adam.clip_by_global_norm, []

    def raising_clip(grads, max_norm):
        raise RuntimeError("injected fault after the backward at step 5")

    def flaky(st, batch):
        if int(st.opt.step) == 4 and not fired:
            fired.append(True)
            adam.clip_by_global_norm = raising_clip
            try:
                return step(st, batch)
            finally:
                adam.clip_by_global_norm = clip
        return step(st, batch)

    st = fresh()
    ck = Checkpointer(str(ckpt), keep=2)
    loop = ResilientLoop(flaky, ck, LoopConfig(checkpoint_every=2,
                                               max_steps=6))
    t0 = time.perf_counter()
    loop.run(st, itertools.repeat(b))
    loop_s = time.perf_counter() - t0
    same, diff = _params_equal(params_of(st), runs[0][6])
    save_s, save_bytes = ck.last_save_seconds, ck.last_save_bytes
    del st
    st2 = fresh()
    loop2 = ResilientLoop(step, Checkpointer(str(ckpt), keep=2), LoopConfig(
        checkpoint_every=2, max_steps=7))
    loop2.run(st2, itertools.repeat(b))
    same2, diff2 = _params_equal(params_of(st2), runs[0][7])
    del st2
    # bfloat16 card tensors through a Checkpointer, restored in place
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tree = {"w": torch.randn((1024, 2048), generator=gen, device="cuda")
            .to(torch.bfloat16), "s": torch.arange(
                7, dtype=torch.int32, device="cuda")}
    want = {k: v.clone() for k, v in tree.items()}
    ck.save(100, tree, blocking=True)
    for v in tree.values():
        v.zero_()
    ptrs = {k: v.data_ptr() for k, v in tree.items()}
    ck.restore(100, tree)
    bf16_ok = all(torch.equal(tree[k], want[k]) and
                  tree[k].data_ptr() == ptrs[k] for k in tree)
    shutil.rmtree(ckpt, ignore_errors=True)
    tol = spread
    emit("lm_train", part="(c) ResilientLoop on the card, full width, "
         "depth 2", layers=cut.num_layers, two_runs_bitwise=bitwise,
         two_runs_spread=spread, failures=loop.stats.failures,
         steps_done=loop.stats.steps_done,
         rolled_back_to=10 - loop.stats.steps_done,
         rollback_equals_uninterrupted=same, rollback_max_diff=diff,
         resumed_from=loop2.stats.resumed_from,
         resume_equals_uninterrupted=same2, resume_max_diff=diff2,
         loop_seconds=loop_s, final_save_seconds=save_s,
         final_save_bytes=save_bytes, bf16_round_trip=bf16_ok)
    if len(loop.stats.failures) != 1 or loop2.stats.resumed_from != 6:
        fail(f"lm_train: the loop's failures {loop.stats.failures}, resumed "
             f"from {loop2.stats.resumed_from}")
    if diff > tol or diff2 > tol:
        fail(f"lm_train: the rolled-back run differs from the "
             f"uninterrupted one by {diff} and {diff2} (two uninterrupted "
             f"runs: {spread})")
    if not bf16_ok:
        fail("lm_train: bfloat16 card tensors did not round-trip in place")


def phase_lm_train(smi: str):
    """LM training on the card (module doc, phase ``lm_train``): no SNN
    kernel launches in it."""
    import numpy as np
    import torch
    from repro_torch.config import get_arch
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.data.synthetic import token_batches
    t_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("lm_train: TF32 matmuls are on; the LM trains in full float32")
    reset_counts()
    cfg = get_arch(LM_TRAIN_ARCH)
    t0 = time.perf_counter()
    _lm_train_launcher(cfg, smi)
    emit("lm_train", part="(a) seconds", seconds=time.perf_counter() - t0)
    # (b) the card against float64 on the CPU, full width, depth 2
    ds = get_arch("deepseek-moe-16b")
    jamba = get_arch("jamba-v0.1-52b")
    checks = {"qwen2.5-3b": _cut(cfg, cfg.pattern()[:2]),
              "deepseek-moe-16b": _cut(ds, (ds.pattern()[0],
                                            ds.pattern()[-1])),
              "rwkv6-7b": _cut(get_arch("rwkv6-7b"),
                               get_arch("rwkv6-7b").pattern()[:2]),
              "jamba-v0.1-52b": _cut(jamba, jamba.pattern()[:2])}
    for arch, cut in checks.items():
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        r = _f64_grad_check(cut, SEED)
        emit("lm_train", part=f"(b) {arch}: loss and gradients, card "
             f"float32 against CPU float64, full width, 2 layers",
             kinds=cut.pattern(), batch=2, seq=64, tol=LM_F64_TOL,
             capacity_factor=cut.moe.capacity_factor if cut.moe else None,
             tf32_after=torch.backends.cuda.matmul.allow_tf32,
             seconds=time.perf_counter() - t0, **r)
        if max(r["loss_err"], r["grad_err"]) > LM_F64_TOL:
            fail(f"lm_train {arch}: card against float64: loss "
                 f"{r['loss_err']}, gradient {r['grad_err']} "
                 f"({r['worst_leaf']}) > {LM_F64_TOL}")
        if r["route_differences"]:
            fail(f"lm_train {arch}: the card's routing differs from "
                 f"float64's in {r['route_differences']} choices "
                 f"(smallest k-th gate margin {r['min_gate_margin']})")
        if max(r["tf32_loss_err"], r["tf32_grad_err"]) <= LM_F64_TOL:
            fail(f"lm_train {arch}: with TF32 products the errors are "
                 f"within {LM_F64_TOL}: the check would not see them")
        if torch.backends.cuda.matmul.allow_tf32:
            fail(f"lm_train {arch}: TF32 was left on after the TF32 run")
    # (c) the loop's semantics on the card
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _lm_train_loop(cfg)
    emit("lm_train", part="(c) seconds", seconds=time.perf_counter() - t0)
    # (d) the Prefetcher onto the card
    host = [b for b, _ in zip(token_batches(cfg.vocab_size, 4, 256,
                                            seed=SEED + 5), range(6))]
    got = list(Prefetcher(iter(host), device="cuda"))
    same = len(got) == len(host) and all(
        g[k].device.type == "cuda" and np.array_equal(g[k].cpu().numpy(),
                                                      h[k])
        for g, h in zip(got, host) for k in h)
    counts = {k: v for k, v in read_counts().items() if v}
    emit("lm_train", part="(d) Prefetcher onto the card", batches=len(got),
         equal_in_order=same, snn_kernel_launches=counts)
    if not same:
        fail("lm_train: the Prefetcher's card batches differ from "
             "token_batches'")
    if counts:
        fail(f"lm_train: the LM training path launched SNN kernels {counts}")
    torch.cuda.empty_cache()
    emit("lm_train", part="phase", seconds=time.perf_counter() - t_phase)


DRYRUN_CELL = ("qwen2.5-3b", "train_4k")
DRYRUN_TIMEOUT = 300      # seconds a dry-run subprocess may take
DRYRUN_PEAK_BAND = 0.2    # the traced peak against the card's, relative


def _dryrun_cli(mesh_device: str):
    """``python -m repro_torch.launch.dryrun`` on ``DRYRUN_CELL`` (256
    fake ranks, in its own process), its mesh typed ``mesh_device``."""
    import os
    arch, shape = DRYRUN_CELL
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh-device", mesh_device,
         "--log-level", "error"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _dryrun_record(proc, mesh_device: str):
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"dryrun: the {mesh_device} mesh's dry run took more than "
             f"{DRYRUN_TIMEOUT} s")
    if proc.returncode:
        fail(f"dryrun: the {mesh_device} mesh's dry run exited "
             f"{proc.returncode}: {err[-3000:]}")
    rec = json.loads(out.strip().splitlines()[-1])
    if rec["status"] != "ok":
        fail(f"dryrun: {DRYRUN_CELL} on the {mesh_device} mesh ended "
             f"{rec['status']}: {rec.get('error')}")
    return rec


def phase_dryrun(smi: str):
    """The LM accounting (module doc, phase ``dryrun``): host-side traces
    on ``meta`` tensors, and one card measurement to hold them to."""
    import torch
    from repro_torch.config import ShapeConfig, get_arch
    from repro_torch.launch import cells
    from repro_torch.models import counting, lm
    t_phase = time.perf_counter()
    reset_counts()
    # (a) a production cell at 256 fake ranks, on a cpu- and a cuda-typed
    # mesh, side by side with (b)
    procs = {kind: _dryrun_cli(kind) for kind in ("cpu", "cuda")}
    # (b) phase lm_train's configuration on one device, traced ...
    cfg = get_arch(LM_TRAIN_ARCH)
    r = LM_TRAIN
    shape = ShapeConfig("lm_train", r["seq"], r["batch"], "train")
    prog = cells.build_cell(cfg, shape, None, param_dtype=torch.float32,
                            opt_dtype=torch.float32, remat=True)
    tr = prog.trace()
    analytic = counting.step_flops(cfg, shape)["train"]
    # ... and its steps on the card: the state's bytes and the peak of
    # two raw train steps, less what the process held before
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    state = lm.init_train_state(
        torch.Generator(device="cuda").manual_seed(SEED), cfg)
    tensors = (list(state.params.parameters()) + [state.opt.step]
               + list(state.opt.m.values()) + list(state.opt.v.values()))
    live_state = sum(t.numel() * t.element_size() for t in tensors)
    b = _train_batch(cfg, r["batch"], r["seq"], SEED + 2)
    live_batch = sum(t.numel() * t.element_size() for t in b.values())
    step = lm.make_train_step(cfg, total_steps=100)
    peaks = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(state, b)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
    card_peak = max(peaks)
    del state, b, step, tensors
    torch.cuda.empty_cache()
    state_bytes, batch_bytes = tr.bytes_by_argument
    rel = (tr.peak_bytes - card_peak) / card_peak
    emit("dryrun", part=f"(b) {LM_TRAIN_ARCH} whole, float32 params and "
         f"moments, batch {r['batch']}, seq {r['seq']}, remat, one device: "
         f"the meta trace against the card", traced_state_bytes=state_bytes,
         live_state_bytes=live_state, traced_batch_bytes=batch_bytes,
         live_batch_bytes=live_batch, traced_peak_bytes=tr.peak_bytes,
         card_peak_bytes=card_peak, card_step_peaks=peaks,
         peak_rel_diff=rel, band=DRYRUN_PEAK_BAND,
         traced_output_bytes=tr.output_bytes, counted_flops=tr.flops,
         analytic_flops=analytic, counted_over_analytic=tr.flops / analytic,
         trace_seconds=tr.seconds, nvidia_smi=smi)
    if state_bytes != live_state or batch_bytes != live_batch:
        fail(f"dryrun: traced argument bytes {state_bytes} + {batch_bytes} "
             f"against the live state's {live_state} and batch's "
             f"{live_batch}")
    if abs(rel) > DRYRUN_PEAK_BAND:
        fail(f"dryrun: the traced peak {tr.peak_bytes} B is {rel:+.1%} of "
             f"the card's {card_peak} B (band {DRYRUN_PEAK_BAND:.0%})")
    if tr.events:
        fail(f"dryrun: one device issued {len(tr.events)} collectives")
    recs = {kind: _dryrun_record(p, kind) for kind, p in procs.items()}
    cpu, cuda = recs["cpu"], recs["cuda"]
    emit("dryrun", part=f"(a) {DRYRUN_CELL[0]} x {DRYRUN_CELL[1]}, 256 "
         f"fake ranks, cuda-typed mesh", record=cuda,
         cpu_mesh_trace_s=cpu["trace_s"])
    for key in ("collectives", "cost", "memory"):
        if cpu[key] != cuda[key]:
            fail(f"dryrun: the cuda-typed mesh's {key} differ from the "
                 f"cpu-typed mesh's: {cuda[key]} against {cpu[key]}")
    counts = {k: v for k, v in read_counts().items() if v}
    if counts:
        fail(f"dryrun: the dry run launched SNN kernels {counts}")
    emit("dryrun", part="phase", seconds=time.perf_counter() - t_phase)


LM_MESH_ARCH = "qwen2.5-3b"
LM_MESH = dict(batch=4, prompt=64, new=8, steps=3, seq=64)
# the split mixers on the group of one: Mamba (with jamba's MoE) and RWKV6
LM_MESH_MIXERS = ("jamba-v0.1-52b", "rwkv6-7b")
LM_MESH_TOL = 1e-6       # where the group of one's bits differ (module doc)


def _first_difference(pairs):
    """(name, max |a - b| / max(1, max|b|)) of the first pair of tensors
    in ``pairs`` ([(name, a, b)]) whose bits differ; None when all are
    equal."""
    for name, a, b in pairs:
        if not torch_equal(a, b):
            return name, rel_err(a, b)
    return None


def torch_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(a, b))


def rel_err(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def _local(t):
    """A DTensor's local shard: on a group of one, the whole tensor."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _lm_mesh_serve(cfg, ctx):
    """(a) prefill and decode: the whole model against its group-of-one
    layout, from one generator; returns the record."""
    import numpy as np
    import torch
    from repro_torch.models import transformer
    from repro_torch.sharding import partitioning
    from repro_torch.sharding.context import use_sharding
    b, prompt, new = LM_MESH["batch"], LM_MESH["prompt"], LM_MESH["new"]
    whole = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    sharded = partitioning.init_params(
        ctx, torch.Generator(device="cuda").manual_seed(SEED), cfg,
        device="cuda")
    pairs = [(f"init {n}", _local(q), p) for (n, p), q in zip(
        whole.named_parameters(), sharded.parameters())]
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (b, prompt + new), dtype=np.int32)).cuda()
    runs = {}
    with torch.inference_mode():
        for name, params, c in (("whole", whole, None), ("mesh", sharded,
                                                         ctx)):
            with use_sharding(c):
                lg, caches = transformer.prefill(
                    params, cfg, tokens=toks[:, :prompt],
                    max_len=prompt + new, cache_dtype=torch.float32)
                logits = [_local(lg)]
                for i in range(new):
                    lg, caches = transformer.decode_step(
                        params, caches, cfg,
                        token=toks[:, prompt + i:prompt + i + 1],
                        pos=prompt + i)
                    logits.append(_local(lg))
                pos = prompt + new - 1
                tok = toks[:, -1:]
                step = (lambda p=params, cc=caches: transformer.decode_step(
                    p, cc, cfg, token=tok, pos=pos))
                ms = cuda_ms(step, reps=10, warmup=2)
                by_kernel, launches = device_time(step, reps=3)
            runs[name] = {"logits": logits, "caches": caches, "ms": ms,
                          "device_ms": sum(by_kernel.values()),
                          "launches": launches / 3}
    peak = torch.cuda.max_memory_allocated() - mem0
    w, m = runs["whole"], runs["mesh"]
    for i, (a, c) in enumerate(zip(m["logits"], w["logits"])):
        pairs.append(("prefill logits" if i == 0 else
                      f"decode step {i} logits", a, c))
    for i, (cm, cw) in enumerate(zip(m["caches"], w["caches"])):
        for part in ("mixer", "ffn"):
            for k in cw[part]:
                pairs.append((f"layers.{i}.{part}.{k} cache after "
                              f"{new} steps", _local(cm[part][k]),
                              cw[part][k]))
    diff = _first_difference(pairs)
    rec = {"compared": len(pairs), "bit_equal": diff is None,
           "first_difference": diff, "batch": b, "prompt": prompt,
           "decode_steps": new,
           "decode_step_ms": {"whole": w["ms"], "mesh": m["ms"]},
           "decode_device_ms": {"whole": w["device_ms"],
                                "mesh": m["device_ms"]},
           "decode_launches_per_step": {"whole": w["launches"],
                                        "mesh": m["launches"]},
           "mesh_peak_memory_bytes": peak}
    del whole, sharded, runs
    return rec


def _lm_mesh_train(cfg, ctx):
    """(a) 3 steps of the launcher's ``train_lm``: one device against the
    group of one; the record."""
    import tempfile
    import torch
    from repro_torch.launch.train import train_lm
    kw = dict(steps=LM_MESH["steps"], batch=LM_MESH["batch"],
              seq=LM_MESH["seq"], seed=SEED,
              checkpoint_every=LM_MESH["steps"] + 1, device="cuda")
    out, prof = {}, {}
    for name, c in (("whole", None), ("mesh", ctx)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as d:
            out[name] = train_lm(cfg, ckpt_dir=d, ctx=c, **kw)
        prof[name] = _lm_mesh_step_profile(cfg, c)
    w, m = out["whole"], out["mesh"]
    return {"losses": {"whole": w["losses"], "mesh": m["losses"]},
            "bit_equal": w["losses"] == m["losses"],
            "max_loss_err": max(abs(a - b) / max(1.0, abs(b))
                                for a, b in zip(m["losses"], w["losses"])),
            "median_step_ms": {"whole": w["median_step_ms"],
                               "mesh": m["median_step_ms"]},
            "peak_memory_bytes": {"whole": w["peak_memory_bytes"],
                                  "mesh": m["peak_memory_bytes"]},
            "save_seconds": {"whole": w["save_seconds"],
                             "mesh": m["save_seconds"]},
            "step_device_ms": {k: v[0] for k, v in prof.items()},
            "step_launches": {k: v[1] for k, v in prof.items()}, **kw}


def _lm_mesh_train_bits(cfg, ctx):
    """(b) ``LM_MESH["steps"]`` raw train steps of the whole model and of
    its group-of-one layout from one generator: the losses and whether
    they are equal bit for bit."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    from repro_torch.sharding import partitioning
    from repro_torch.sharding.context import use_sharding
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_MESH["batch"], LM_MESH["seq"] + 1),
        dtype=np.int32)).cuda()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].long()}
    losses = {}
    for name, c in (("whole", None), ("mesh", ctx)):
        g = torch.Generator(device="cuda").manual_seed(SEED)
        state = (lm.init_train_state(g, cfg, device="cuda") if c is None
                 else partitioning.init_train_state(c, g, cfg,
                                                    device="cuda"))
        step = lm.make_train_step(cfg)
        with use_sharding(c):
            losses[name] = [float(step(state, batch)[1]["loss"])
                            for _ in range(LM_MESH["steps"])]
        del state, step
        torch.cuda.empty_cache()
    w, m = losses["whole"], losses["mesh"]
    return {"losses": losses, "bit_equal": w == m,
            "max_loss_err": max(abs(a - b) / max(1.0, abs(b))
                                for a, b in zip(m, w))}


def _lm_mesh_step_profile(cfg, ctx):
    """(device ms, launches) of one train step (after a warm one), the
    profiler's, on the whole model or its layout under ``ctx``."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    from repro_torch.sharding import partitioning
    from repro_torch.sharding.context import use_sharding
    g = torch.Generator(device="cuda").manual_seed(SEED)
    state = (lm.init_train_state(g, cfg, device="cuda") if ctx is None
             else partitioning.init_train_state(ctx, g, cfg, device="cuda"))
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_MESH["batch"], LM_MESH["seq"]),
        dtype=np.int32)).cuda()
    batch = {"tokens": toks, "labels": toks.long()}
    step = lm.make_train_step(cfg)
    with use_sharding(ctx):
        by_kernel, launches = device_time(
            lambda: float(step(state, batch)[1]["loss"]), reps=1)
    del state
    torch.cuda.empty_cache()
    return sum(by_kernel.values()), launches


def _lm_mesh_launcher(mesh: str):
    """The train launcher's ``--mesh`` on the cards (reduced qwen2.5-3b,
    its spawned ranks on nccl) against its one-device run."""
    import tempfile
    from repro_torch.launch import train as train_launcher
    args = ["--arch", LM_MESH_ARCH, "--steps", str(LM_MESH["steps"]),
            "--batch", "4", "--seq", "64", "--log-level", "error"]
    with tempfile.TemporaryDirectory() as d:
        one = train_launcher.main(args + ["--ckpt-dir", f"{d}/one"])
        t0 = time.perf_counter()
        r = train_launcher.main(args + ["--mesh", mesh, "--ckpt-dir",
                                        f"{d}/mesh"])
        seconds = time.perf_counter() - t0
    return {"mesh": r["mesh"], "profile": r["profile"],
            "losses": {"whole": one["losses"], "mesh": r["losses"]},
            "bit_equal": one["losses"] == r["losses"],
            "max_loss_err": max(abs(a - b) / max(1.0, abs(b)) for a, b in
                                zip(r["losses"], one["losses"])),
            "peak_memory_bytes_per_rank": r["peak_memory_bytes_per_rank"],
            "seconds_with_spawn": seconds}


def phase_lm_mesh():
    """The sharded LM on the card (module doc, phase ``lm_mesh``): (a)
    qwen2.5-3b at full width, 2 layers, on a mesh data=1 x model=1 over a
    real NCCL group of one, its prefill, 8 decode steps and 3 train steps
    against the unsharded path on the same weights, bit for bit (a
    difference is named by its first tensor and held to
    ``LM_MESH_TOL`` x max(1, |ref|)); the launcher's ``--mesh 1x1``
    through its spawned rank; (b) the split mixers' code on the same
    group: jamba-v0.1-52b (Mamba, MoE) and rwkv6-7b at full width, 2
    layers, their prefill, decode steps and 3 raw train steps against
    the unsharded path, bit for bit the same way; (c) with two or more
    cards, the launcher on 1x2 and 2x1 within the LM tolerance 1e-5;
    (d) each record's launches, device ms and peak memory.  No SNN
    kernel runs in it."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.config import get_arch
    from repro_torch.dist.mesh import make_test_mesh
    from repro_torch.sharding.context import ShardingCtx, make_rules
    t_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("lm_mesh: TF32 matmuls are on; the LM runs in full float32")
    reset_counts()
    full = get_arch(LM_MESH_ARCH)
    cfg = _cut(full, full.pattern()[:2])
    store = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_test_mesh((1, 1))
        t0 = time.perf_counter()
        serve = _lm_mesh_serve(cfg, ShardingCtx(mesh, make_rules("serve")))
        emit("lm_mesh", part="(a) prefill and decode, 1x1 serve against "
             "one device", arch=cfg.name, layers=cfg.num_layers,
             seconds=time.perf_counter() - t0, **serve)
        t0 = time.perf_counter()
        train = _lm_mesh_train(cfg, ShardingCtx(mesh, make_rules(
            "tp_fsdp")))
        emit("lm_mesh", part="(a) train_lm, 1x1 tp_fsdp against one "
             "device", arch=cfg.name, seconds=time.perf_counter() - t0,
             **train)
        checks = [(cfg.name, "serve", serve["first_difference"]),
                  (cfg.name, "train", None if train["bit_equal"] else
                   ("losses", train["max_loss_err"]))]
        del serve, train
        for arch in LM_MESH_MIXERS:
            full = get_arch(arch)
            mcfg = _cut(full, full.pattern()[:2])
            t0 = time.perf_counter()
            r = _lm_mesh_serve(mcfg, ShardingCtx(mesh, make_rules("serve")))
            emit("lm_mesh", part="(b) prefill and decode, 1x1 serve "
                 "against one device", arch=mcfg.name,
                 layers=mcfg.num_layers, kinds=list(mcfg.pattern()),
                 seconds=time.perf_counter() - t0, **r)
            checks.append((arch, "serve", r["first_difference"]))
            t0 = time.perf_counter()
            r = _lm_mesh_train_bits(mcfg, ShardingCtx(mesh, make_rules(
                "tp_fsdp")))
            emit("lm_mesh", part="(b) train steps, 1x1 tp_fsdp against "
                 "one device", arch=mcfg.name,
                 seconds=time.perf_counter() - t0, **r)
            checks.append((arch, "train", None if r["bit_equal"] else
                           ("losses", r["max_loss_err"])))
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    for arch, what, err in checks:
        if err is not None and err[1] > LM_MESH_TOL:
            fail(f"lm_mesh: the group of one's {what} of {arch} differs "
                 f"from one device at {err[0]} by {err[1]} > "
                 f"{LM_MESH_TOL}")
    t0 = time.perf_counter()
    launcher = _lm_mesh_launcher("1x1")
    emit("lm_mesh", part="(a) the launcher --mesh 1x1 (reduced, spawned "
         "nccl rank) against its one-device run",
         seconds=time.perf_counter() - t0, **launcher)
    if not launcher["bit_equal"] and launcher["max_loss_err"] > LM_MESH_TOL:
        fail(f"lm_mesh: the launcher's --mesh 1x1 losses differ by "
             f"{launcher['max_loss_err']}")
    if torch.cuda.device_count() >= 2:
        for shape in ("1x2", "2x1"):
            t0 = time.perf_counter()
            r = _lm_mesh_launcher(shape)
            emit("lm_mesh", part=f"(c) the launcher --mesh {shape}",
                 seconds=time.perf_counter() - t0, **r)
            if r["max_loss_err"] > 1e-5:
                fail(f"lm_mesh: --mesh {shape} losses differ by "
                     f"{r['max_loss_err']} > 1e-5")
    else:
        emit("lm_mesh", part="(c) skipped: one card visible")
    counts = {k: v for k, v in read_counts().items() if v}
    if counts:
        fail(f"lm_mesh: the sharded LM launched SNN kernels {counts}")
    torch.cuda.empty_cache()
    emit("lm_mesh", part="phase", seconds=time.perf_counter() - t_phase)


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
    # the facade's deprecation shims must not be reached from here
    warnings.filterwarnings("error", category=DeprecationWarning,
                            message=r".*repro_torch\.api")
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
        summary.update(phase_train_kernels(cfg, params, frames, trains))
        phase_model(cfg, params, frames, trains)
        del trains
        summary.update(phase_counts())
        # the hoisted mode and kernel B count the serve run; the hoisted
        # mode's SAVE_U and C, D and E the train run; A's dV mode and F
        # the two-kernel path of the ops layer
        launches, serve_fps = phase_serve(cfg)
    train_launches, train_losses = phase_train(cfg)
    launches.update({k: v for k, v in train_launches.items()
                     if k not in launches})
    with torch.inference_mode():
        summary["lif_fused"] = phase_lif_fused()
        launches.update(phase_t1_contract(cfg, params, frames))
        phase_chunk(cfg, params, frames)
        phase_bucket_rows(cfg, params, frames)
    phase_engine(cfg, params, serve_fps)
    # snn-seg's path (its own launch counts) and the facade
    seg_summary, seg_launches = phase_seg(get_snn("snn-seg"))
    for name, recs in seg_summary.items():
        summary.setdefault(name, []).extend(recs)
    for name, n in seg_launches.items():
        launches[name] = launches.get(name, 0) + n
    phase_api(cfg, frames)
    # the mesh runtime (its own counts)
    for name, n in phase_mesh(cfg, frames).items():
        launches[name] = launches.get(name, 0) + n
    # the launchers on the facade and the four examples (their own counts)
    for name, n in phase_entry(cfg, train_losses).items():
        launches[name] = launches.get(name, 0) + n
    # the LM substrate's serving path and its training (no SNN kernel)
    phase_lm()
    phase_lm_train(smi)
    phase_dryrun(smi)
    phase_lm_mesh()
    kernels = []
    csrc, tpu = "src/repro_torch/kernels/csrc/", "src/repro/kernels/"
    # each TPU kernel's pl.pallas_call site
    sources = {
        "spiking_conv": (csrc + "spiking_conv.cu",
                         tpu + "spiking_conv.py:184"),
        "spiking_conv_lif_hoisted": (csrc + "spiking_conv.cu",
                                     tpu + "spiking_conv.py:184"),
        "spiking_conv_lif_hoisted_save_u": (csrc + "spiking_conv.cu",
                                            tpu + "spiking_conv.py:184"),
        "spiking_conv_lif_hoisted_counted": (csrc + "spiking_conv.cu",
                                             tpu + "spiking_conv.py:184"),
        "spiking_conv_lif": (csrc + "spiking_conv_lif.cu",
                             tpu + "spiking_conv_lif.py:181"),
        "spiking_conv_lif_counted": (csrc + "spiking_conv_lif.cu",
                                     tpu + "spiking_conv_lif.py:181"),
        # no TPU kernel: the reference builds the table with XLA ops
        "skip_fraction_from_rows": (csrc + "skip_table.cu", None),
        "spiking_conv_lif_fwd": (csrc + "spiking_conv_lif.cu",
                                 tpu + "spiking_conv_lif.py:181"),
        "lif_bwd": (csrc + "lif_bwd.cu", tpu + "spiking_conv_lif.py:329"),
        "conv_grad_input": (csrc + "conv_grad_input.cu",
                            tpu + "spiking_conv.py:294"),
        # no TPU kernel: the reference's conv_grad_weights_xla, XLA ops
        "conv_grad_weights": (csrc + "conv_grad_weights.cu", None),
        "conv_grad_weights_analog": (csrc + "conv_grad_weights.cu", None),
        "lif_fused": (csrc + "lif_fused.cu", tpu + "lif.py:49")}
    for name, recs in summary.items():
        # the sum over the kernel's main-path shapes: per snn-mnist forward
        # or train step, plus per snn-seg forward or gradient
        tot = set_bounds(
            {}, sum(r["bytes"] for r in recs), sum(r["flops"] for r in recs),
            sum(r.get("tap_flops", 0) for r in recs),
            recs[0].get("peak_flops"))
        lib = [r["library_ms"] for r in recs]
        dev_ms = [r.get("device_ms") for r in recs]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": sum(r["ms"] for r in recs),
            "plain_ms": sum(r["plain_ms"] for r in recs),
            "bound_ms": tot["bound_ms"], "bound_by": tot["bound_by"],
            "bound_fp32_ms": tot["bound_fp32_ms"],
            "library_ms": None if None in lib else sum(lib),
            "device_ms": None if None in dev_ms else sum(dev_ms),
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
