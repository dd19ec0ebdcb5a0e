#!/usr/bin/env python3
"""The mesh runtime on every card of one host: shards on several cards
at once, held against one card.

    python3 scripts/mesh_cards.py            # all visible cards (>= 2)

Builds the kernels, then for each data size N in 1, 2, 4 that the host
has cards for (``DeviceMesh(("data", N))`` = ``cuda:0..N-1``):

  infer   ``Session.infer`` of snn-mnist (hopper, full width) at batch 256
          through a data=N mesh equals data=1 bit for bit (logits, counts,
          skip fractions); FPS of each N, measured in turns (1, N, N, 1)
  train   one ``MeshRunner.train_step`` at batch 32 from the same params:
          the new params are bit-identical at every N; step ms of each N,
          measured in turns (1, N, N, 1)
  gate    at the largest N (4, or 2 on a host of two or three cards) the
          median infer FPS is above data=1's and the median train step is
          faster than data=1's: shards on several cards run at once
  seg     snn-seg (batch 16, T=16) through a data=N mesh equals data=1
  lanes   a threaded engine with 2N lanes pinned round-robin to the N
          cards (``DeviceMesh.lane_devices``) through a lane-0 crash:
          every request accounted for, served logits equal to the mesh
          infer's bits, N distinct cards in the snapshot

Each check prints one JSON line; then the cards' names and power limits
as nvidia-smi gives them, and last ``{"ok": ...}``.  Exits nonzero when a
check or the gate fails, or when fewer than two cards are visible.
Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

BATCH, TRAIN_BATCH, SEG_BATCH, REPS, REQUESTS, SEED = 256, 32, 16, 8, 128, 0
TRAIN_REPS = 3


def emit(check: str, **rec) -> None:
    print(json.dumps({"check": check, **rec}), flush=True)


def equal_outputs(a, b) -> bool:
    import numpy as np
    fields = ("spike_counts", "spike_totals", "timestep_counts",
              "skip_fractions")
    return bool(np.array_equal(a.logits, b.logits)) and all(
        len(getattr(a, f)) == len(getattr(b, f)) and all(
            np.array_equal(x, y) for x, y in zip(getattr(a, f),
                                                 getattr(b, f)))
        for f in fields)


def synced_seconds(fn) -> float:
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    t0 = time.perf_counter()
    fn()
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    return time.perf_counter() - t0


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("mesh_cards: needs two or more cards", file=sys.stderr)
        return 2
    from torch.utils._pytree import tree_leaves
    from repro_torch.api import ServeSpec, Session, TrainSpec
    from repro_torch.config import get_snn
    from repro_torch.data.synthetic import mnist_like, road_like
    from repro_torch.dist import DeviceMesh, workers
    from repro_torch.kernels import _build
    from repro_torch.runtime.faults import FaultPlan
    _build.build()
    cards = torch.cuda.device_count()
    sizes = [n for n in (1, 2, 4) if n <= cards]
    ok = True
    cfg = get_snn("snn-mnist")
    frames = np.random.default_rng(SEED).random(
        (BATCH, *cfg.input_hw, cfg.input_channels), dtype=np.float32)

    def session(c, n, spec=ServeSpec):
        return Session(c, spec(backend="hopper", mesh={"data": n}),
                       seed=SEED, device="cuda")

    # infer: bits and FPS, in turns against data=1
    sess = {n: session(cfg, n) for n in sizes}
    out = {n: s.infer(frames) for n, s in sess.items()}      # warm
    infer_fps = {}
    for n in sizes[1:]:
        fps = {1: [], n: []}
        for m in (1, n, n, 1):
            sec = synced_seconds(lambda: [sess[m].infer(frames)
                                          for _ in range(REPS)])
            fps[m].append(REPS * BATCH / sec)
        same = equal_outputs(out[n], out[1])
        ok &= same
        infer_fps[n] = fps
        emit("infer", data=n, batch=BATCH, equals_data1=same,
             fps=fps[n], fps_data1=fps[1],
             shard_devices=[str(d) for d in
                            sess[n]._runner().shard_devices])

    # train: params bit-identical at every N, step ms in turns
    x, y = mnist_like(TRAIN_BATCH, seed=0)
    train = {n: session(cfg, n, lambda **k: TrainSpec(lr=1e-2, **k))
             for n in sizes}
    params = {}
    for n, s in train.items():
        s.train_step(x, y)                   # from the same params: warm
        params[n] = s.params
    step_ms = {}
    for n in sizes[1:]:
        same = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(
            tree_leaves(params[n]), tree_leaves(params[1])))
        ok &= same
        ms = {1: [], n: []}
        for m in (1, n, n, 1):
            ms[m] += [synced_seconds(lambda: train[m].train_step(x, y)) * 1e3
                      for _ in range(TRAIN_REPS)]
        step_ms[n] = ms
        emit("train", data=n, batch=TRAIN_BATCH, params_equal_data1=same,
             step_ms=ms[n], step_ms_data1=ms[1])

    # the gate: more cards give more frames and faster steps
    n = sizes[-1]
    fps_n = statistics.median(infer_fps[n][n])
    fps_1 = statistics.median(infer_fps[n][1])
    ms_n = statistics.median(step_ms[n][n])
    ms_1 = statistics.median(step_ms[n][1])
    gate = fps_n > fps_1 and ms_n < ms_1
    ok &= gate
    emit("gate", data=n, fps=fps_n, fps_data1=fps_1,
         fps_ratio=fps_n / fps_1, step_ms=ms_n, step_ms_data1=ms_1,
         step_speedup=ms_1 / ms_n, passed=gate)

    # seg through the mesh
    seg = get_snn("snn-seg")
    seg_x, _ = road_like(SEG_BATCH, h=seg.input_hw[0], w=seg.input_hw[1],
                         seed=SEED)
    seg_out = {n: session(seg, n).infer(seg_x) for n in sizes}
    for n in sizes[1:]:
        same = equal_outputs(seg_out[n], seg_out[1])
        ok &= same
        emit("seg", data=n, batch=SEG_BATCH, timesteps=seg.timesteps,
             equals_data1=same)

    # lanes pinned across the cards, through a lane crash
    n = sizes[-1]
    lanes = DeviceMesh(("data", n)).lane_devices(2 * n)
    eng = sess[1].engine(ServeSpec(backend="hopper", num_lanes=2 * n,
                                   threaded=True, max_batch=16),
                         lane_devices=lanes,
                         fault_plan=FaultPlan(crashes=((0, 0),)))
    rids = [eng.submit(frames[i % BATCH], arrival=0.0)
            for i in range(REQUESTS)]
    s = eng.run()
    snap = eng.snapshot()
    served = {r.rid: r.logits for r in eng.completed}
    same = all(np.array_equal(served[rid], out[1].logits[i % BATCH])
               for i, rid in enumerate(rids) if rid in served)
    accounted = (snap.served + snap.rejected + snap.deadline_missed
                 + snap.cancelled)
    good = (same and accounted == len(rids) and snap.served > 0
            and len(set(snap.lane_devices)) == n)
    ok &= good
    emit("lanes", data=n, lanes=2 * n, requests=len(rids),
         served=snap.served, accounted=accounted,
         lane_devices=list(snap.lane_devices), lanes_alive=snap.lanes_alive,
         served_equal_mesh_infer=same, fps=s["fps"],
         p50_ms=s["p50_latency_s"] * 1e3, p99_ms=s["p99_latency_s"] * 1e3)

    workers.shutdown()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())
    print(json.dumps({"ok": bool(ok), "cards": cards}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
