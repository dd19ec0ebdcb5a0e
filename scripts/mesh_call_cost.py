#!/usr/bin/env python3
"""Where the time of one sharded ``Session.infer`` call goes.

    python3 scripts/mesh_call_cost.py [--device cpu] [--data N]

snn-mnist (hopper, full width) at batch 256 through a data=N mesh
(default: every visible card; ``--device cpu`` takes N host entries, to
rehearse the script).  The shard function runs in each worker wrapped so
that it stamps the host clock (``time.perf_counter``, CLOCK_MONOTONIC,
one clock for every process of the host) around its parts: the frames'
copy to the card (with the graph's capture on the first call), the
replay (or the eager forward) up to a sync, and the read-back to the
host (one packed copy after a replay).  The calling side stamps the call's start, the dispatch
(``workers.run_shards``) and the end.  Prints the median of each span
over the calls, in ms, and the same call at data=1 (eager, in the
calling thread) for comparison; then the cards' names and power limits.
Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

BATCH, CALLS, SEED = 256, 40, 0


class Stamped:
    """The runner's ``_infer_shard`` split into stamped parts; returns
    (its result, {part: (start, end)})."""

    def __call__(self, dev, params, graphs, cfg, kw, logits_only, frames):
        import torch
        runner = importlib.import_module("repro_torch.dist.runner")
        from repro_torch.serving.batcher import to_device, to_host
        stamps = {}
        t0 = time.perf_counter()
        with torch.inference_mode():
            if dev.type == "cuda" and graphs is not None:
                with torch.cuda.device(dev):
                    key = (frames.shape, logits_only,
                           tuple(sorted(kw.items())))
                    if key not in graphs:
                        graphs[key] = runner._capture(
                            lambda x: runner.snn_apply(
                                params, x, cfg, logits_only=logits_only,
                                **kw), to_device(frames, dev))
                    x, graph, packed, layout = graphs[key]
                    x.copy_(torch.from_numpy(frames))
                    t1 = time.perf_counter()
                    graph.replay()
                    torch.cuda.synchronize(dev)
                    t2 = time.perf_counter()
                    host = runner._unpack(packed.cpu().numpy(), layout)
            else:
                x = to_device(frames, dev)
                t1 = time.perf_counter()
                out = runner.snn_apply(params, x, cfg,
                                       logits_only=logits_only, **kw)
                t2 = time.perf_counter()
                host = to_host(out)
        t3 = time.perf_counter()
        stamps.update(copy_in=(t0, t1), compute=(t1, t2),
                      read_back=(t2, t3))
        return host, stamps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch
    from repro_torch.api import ServeSpec, Session
    from repro_torch.config import get_snn
    from repro_torch.dist import runner, workers
    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < 2):
        print("mesh_call_cost: needs two or more cards", file=sys.stderr)
        return 2
    n = args.data or (torch.cuda.device_count() if args.device == "cuda"
                      else 4)
    cfg = get_snn("snn-mnist")
    frames = np.random.default_rng(SEED).random(
        (BATCH, *cfg.input_hw, cfg.input_channels), dtype=np.float32)
    calls = []
    real_run = workers.run_shards

    def run_shards(fn, devices, shard_args, version, params, frozen):
        t0 = time.perf_counter()
        out = real_run(Stamped(), devices, shard_args, version, params,
                       frozen)
        t1 = time.perf_counter()
        calls[-1]["dispatch"] = (t0, t1)
        calls[-1]["shards"] = [s for _, s in out]
        return [r for r, _ in out]

    workers.run_shards = run_shards
    rec = {}
    for data in (1, n):
        sess = Session(cfg, ServeSpec(backend="hopper", mesh={"data": data}),
                       seed=SEED, device=args.device)
        totals, spans = [], {}
        for i in range(CALLS + 1):
            calls.append({})
            t0 = time.perf_counter()
            sess.infer(frames)
            t1 = time.perf_counter()
            c = calls.pop()
            if i == 0:
                continue                     # warm: capture, params
            totals.append((t1 - t0) * 1e3)
            if "dispatch" not in c:
                continue
            d0, d1 = c["dispatch"]
            add = spans.setdefault
            add("before_dispatch", []).append((d0 - t0) * 1e3)
            add("after_dispatch", []).append((t1 - d1) * 1e3)
            add("dispatch", []).append((d1 - d0) * 1e3)
            add("first_shard_starts", []).append(
                (min(s["copy_in"][0] for s in c["shards"]) - d0) * 1e3)
            add("last_shard_starts", []).append(
                (max(s["copy_in"][0] for s in c["shards"]) - d0) * 1e3)
            add("last_shard_ends", []).append(
                (max(s["read_back"][1] for s in c["shards"]) - d0) * 1e3)
            for part in ("copy_in", "compute", "read_back"):
                add(f"shard_{part}_max", []).append(max(
                    (s[part][1] - s[part][0]) for s in c["shards"]) * 1e3)
        rec[f"data={data}"] = {
            "call_ms": statistics.median(totals),
            "fps": BATCH / statistics.median(totals) * 1e3,
            **{k: statistics.median(v) for k, v in spans.items()}}
    workers.shutdown()
    print(json.dumps({"batch": BATCH, "calls": CALLS, **rec}))
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
