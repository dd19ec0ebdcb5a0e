#!/usr/bin/env python3
"""Frames per second of the serve launcher's single-shot path on one card,
against a plain forward of the same requests.

    python3 scripts/serve_launcher_cost.py [--src DIR] [--reps 3]

``--src`` imports ``repro_torch`` from ``DIR`` (default: this checkout's
``src``), so the same script times another tree's launcher.  For
``snn-mnist`` (batch 256, T=8) and ``snn-seg`` (batch 16, T=16), both
hopper with aprc+cbws and weights from seed 0, each repeat times:

  launcher  ``launch.serve.serve`` answering 16 requests of uniform
            [0, 1) frames after one untimed request (its own FPS)
  forward   the same 16 requests through ``snn_apply(backend="hopper",
            schedule=...)`` under ``inference_mode``, each done when its
            class predictions are on the host (what the launcher did
            before it moved onto ``repro_torch.api.Session``)
  session   the same 16 requests through ``Session.infer`` of one session
            made before the first repeat (the launcher makes its own)
  parts     the same 16 requests through ``Session.infer``'s single-shot
            engine, split into host ms per request, with a synchronize
            between the parts: stacking the frames (``pad_frames``), the
            cache entry (the frames' copy to the card and the forward), and
            copying the outputs to the host (``to_host``)

Prints one JSON line per net (every repeat's FPS and parts, then the
medians), then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REQUESTS = 16
NETS = {"snn-mnist": 256, "snn-seg": 16}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serve_launcher_cost: no card", file=sys.stderr)
        return 2
    from repro_torch.config import get_snn
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.core.snn_model import init_snn, snn_apply
    from repro_torch.api import ServeSpec, Session
    from repro_torch.launch.serve import serve
    from repro_torch.serving.batcher import pad_frames, to_host

    for name, batch in NETS.items():
        cfg = get_snn(name)
        params = init_snn(torch.Generator().manual_seed(0), cfg,
                          device="cuda")
        sched = build_schedule(params, cfg, "aprc+cbws")
        rng = np.random.default_rng(0)
        shape = (batch, *cfg.input_hw, cfg.input_channels)
        requests = [rng.random(shape, dtype=np.float32)
                    for _ in range(REQUESTS + 1)]

        def forward(frames):
            x = torch.from_numpy(frames).cuda()
            out = snn_apply(params, x, cfg, backend="hopper", schedule=sched)
            return out.logits.argmax(dim=-1).cpu()

        sess = Session(cfg, ServeSpec(backend="hopper",
                                      schedule_mode="aprc+cbws"),
                       device="cuda")
        sess.infer(requests[0])
        eng = sess._single_shot_engine(batch)
        entry = eng.cache.get(batch, "hopper")

        def parts():
            ms = {"pad_frames": 0.0, "entry": 0.0, "to_host": 0.0}
            for frames in requests[1:]:
                t0 = time.perf_counter()
                x = pad_frames(list(frames), batch)
                t1 = time.perf_counter()
                out = entry(eng.params, x)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                to_host(out)
                t3 = time.perf_counter()
                for k, a, b in (("pad_frames", t0, t1), ("entry", t1, t2),
                                ("to_host", t2, t3)):
                    ms[k] += (b - a) * 1e3 / REQUESTS
            return ms

        fps = {"launcher": [], "forward": [], "session": []}
        split = []
        for _ in range(args.reps):
            s = serve(cfg, backend="hopper", schedule="aprc+cbws",
                      batch=batch, steps=REQUESTS, seed=0, device="cuda")
            fps["launcher"].append(s["fps"])
            with torch.inference_mode():
                forward(requests[0])
                t0 = time.perf_counter()
                for frames in requests[1:]:
                    forward(frames)
                seconds = time.perf_counter() - t0
            fps["forward"].append(REQUESTS * batch / seconds)
            t0 = time.perf_counter()
            for frames in requests[1:]:
                sess.infer(frames)
            fps["session"].append(REQUESTS * batch /
                                  (time.perf_counter() - t0))
            to_host(entry(eng.params, pad_frames(list(requests[0]), batch)))
            split.append(parts())
        print(json.dumps({"config": name, "batch": batch,
                          "requests": REQUESTS, "fps": fps,
                          "median_fps": {k: statistics.median(v)
                                         for k, v in fps.items()},
                          "parts_ms": split,
                          "median_parts_ms": {
                              k: statistics.median(p[k] for p in split)
                              for k in split[0]},
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
