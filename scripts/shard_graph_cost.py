#!/usr/bin/env python3
"""What one mesh shard costs its host, eager and replayed from a CUDA
graph, on one card.

    python3 scripts/shard_graph_cost.py

For snn-mnist (hopper, full width) at batch 64 (a quarter of 256, a
data=4 shard) and 256: the median ms of the eager forward's launches
alone, of the eager forward with its read-back (``to_host``: the work of
``dist.runner._infer_shard`` without a graph), of the graph's replay with
the frames' copy and the packed read-back (``_infer_shard`` in a worker),
and of each read-back alone; and whether the replay gives the eager
forward's bits (logits, counts, skip fractions).  Prints one JSON line
per batch, then the card's name and power limit.  Imports neither JAX
nor the JAX package.
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

REPS, SEED = 20, 0


def median_ms(fn) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("shard_graph_cost: needs a card", file=sys.stderr)
        return 2
    from repro_torch.config import get_snn
    from repro_torch.core.snn_model import freeze_params, init_snn, snn_apply
    from repro_torch.dist.runner import _capture, _unpack
    from repro_torch.serving.batcher import to_host
    cfg = get_snn("snn-mnist")
    params = freeze_params(init_snn(torch.Generator().manual_seed(SEED), cfg,
                                    device="cuda"))
    fields = ("spike_counts", "spike_totals", "timestep_counts",
              "skip_fractions")
    for batch in (64, 256):
        frames = np.random.default_rng(SEED).random(
            (batch, *cfg.input_hw, cfg.input_channels), dtype=np.float32)
        x = torch.from_numpy(frames).cuda()
        with torch.inference_mode():
            def fwd(t):
                return snn_apply(params, t, cfg, backend="hopper")

            eager_out = fwd(x)
            eager = to_host(eager_out)
            static_x, graph, packed, layout = _capture(fwd, x.clone())

            def read_back():
                return _unpack(packed.cpu().numpy(), layout)

            def replay():
                static_x.copy_(torch.from_numpy(frames))
                graph.replay()
                return read_back()

            got = replay()
            same = bool(np.array_equal(got.logits, eager.logits)) and all(
                np.array_equal(a, b) for f in fields
                for a, b in zip(getattr(got, f), getattr(eager, f)))
            rec = {
                "batch": batch, "replay_equals_eager": same,
                "eager_launch_ms": median_ms(lambda: fwd(x)),
                "eager_with_read_back_ms": median_ms(lambda: to_host(fwd(
                    torch.from_numpy(frames).cuda()))),
                "graph_with_read_back_ms": median_ms(replay),
                "packed_read_back_ms": median_ms(read_back),
                "eager_read_back_ms": median_ms(lambda: to_host(eager_out))}
        print(json.dumps(rec), flush=True)
        if not same:
            return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
