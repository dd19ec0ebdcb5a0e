"""Serving launcher: SNN frame inference through the selectable backend.

    PYTHONPATH=src python -m repro_torch.launch.serve --snn snn-mnist \
        --backend hopper --schedule aprc+cbws --batch 256 --steps 8
    PYTHONPATH=src python -m repro_torch.launch.serve --snn snn-mnist \
        --backend batched --batch 4 --steps 2 --device cpu

It answers ``--steps`` requests, each a batch of ``--batch`` frames made
from ``--seed`` with numpy, through ``snn_apply``, on random weights drawn
from the same seed: the synchronous single-batch loop of the reference's
``Session.serve``, without its engine.  One untimed request first builds
the kernels and warms the caches.  A request is answered when its class
predictions are on the host.
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.config import SNNConfig, get_snn
from repro_torch.core.scheduler import build_schedule
from repro_torch.core.snn_model import SNN, SNN_BACKENDS
from repro_torch.device import resolve_device

log = logging.getLogger("repro_torch.serve")

SCHEDULES = ("auto", "none", "cbws", "aprc+cbws")


def resolve_schedule(mode: str, backend: str) -> Optional[str]:
    """'auto' = aprc+cbws on the hopper backend, none otherwise; a schedule
    on another backend is an error (only the kernel backend applies one)."""
    if mode == "auto":
        return "aprc+cbws" if backend == "hopper" else None
    if mode == "none":
        return None
    if backend != "hopper":
        raise ValueError(f"--schedule {mode} applies to the hopper backend "
                         f"only, not to backend={backend!r}")
    return mode


def serve(cfg: SNNConfig, *, backend: str = "hopper",
          schedule: str = "auto", batch: int = 256, steps: int = 8,
          seed: int = 0, device=None) -> Dict:
    """Answer ``steps`` requests of ``batch`` frames; returns the counts
    and times of the timed requests."""
    dev = resolve_device(device)
    mode = resolve_schedule(schedule, backend)
    rng = np.random.default_rng(seed)
    model = SNN(cfg, generator=torch.Generator().manual_seed(seed),
                device=dev)
    sched = (build_schedule(model.param_dict(), cfg, mode)
             if mode is not None else None)
    shape = (batch, *cfg.input_hw, cfg.input_channels)
    requests = [rng.random(shape, dtype=np.float32)
                for _ in range(steps + 1)]

    def answer(frames: np.ndarray):
        x = torch.from_numpy(frames).to(dev)
        out = model(x, backend=backend, schedule=sched)
        return out, out.logits.argmax(dim=-1).cpu()

    with torch.inference_mode():
        answer(requests[0])                       # build + warm, untimed
        t0 = time.perf_counter()
        for frames in requests[1:]:
            out, _ = answer(frames)
        seconds = time.perf_counter() - t0
    done = steps * batch
    return {
        "frames": done,
        "seconds": seconds,
        "fps": done / seconds if seconds > 0 else 0.0,
        "spikes_per_frame": sum(float(t) for t in out.spike_totals) / batch,
        "backend": backend,
        "schedule": mode or "none",
        "timesteps": cfg.timesteps,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--snn", default="snn-mnist")
    ap.add_argument("--backend", default="hopper", choices=SNN_BACKENDS)
    ap.add_argument("--schedule", default="auto", choices=SCHEDULES)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=8,
                    help="timed requests (after one untimed warm-up)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    s = serve(get_snn(args.snn), backend=args.backend, schedule=args.schedule,
              batch=args.batch, steps=args.steps, seed=args.seed,
              device=args.device)
    log.info("served %d frames in %.4fs (%.1f FPS, backend=%s, "
             "schedule=%s, T=%d, total_spikes/frame=%.0f, device=%s)",
             s["frames"], s["seconds"], s["fps"], s["backend"], s["schedule"],
             s["timesteps"], s["spikes_per_frame"], s["device"])


if __name__ == "__main__":
    main()
