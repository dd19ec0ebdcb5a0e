"""Serving launcher: SNN frame inference through the selectable backend.

    PYTHONPATH=src python -m repro_torch.launch.serve --snn snn-mnist \
        --backend hopper --schedule aprc+cbws --batch 256 --steps 8
    PYTHONPATH=src python -m repro_torch.launch.serve --snn snn-mnist \
        --backend batched --batch 4 --steps 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --snn snn-mnist \
        --engine --lanes 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --snn snn-mnist \
        --engine --threaded --lanes 2 --slo-ms 50 --slo-action degrade
    PYTHONPATH=src python -m repro_torch.launch.serve --snn snn-mnist \
        --forever --lanes 2      # live submission + per-request futures

Weights are random, drawn from ``--seed``; frames are made from the same
seed with numpy.  The default path answers ``--steps`` requests, each a
batch of ``--batch`` frames, through ``snn_apply``: the synchronous
single-batch loop of the reference's ``Session.serve``.  One untimed
request first builds the kernels and warms the caches.  A request is
answered when its class predictions are on the host.

``--engine`` replays an open-loop trace of ``--steps`` x ``--batch``
single-frame requests with exponential gaps of mean 1 ms (numpy seed 0,
the reference launcher's trace) through the continuous-batching
``serving.ServingEngine`` (FIFO windows, CBWS-balanced micro-batch lanes
of at most ``--batch`` frames); ``--threaded`` runs its lanes as worker
threads on the wall clock, ``--chunk-timesteps`` reschedules at chunk
boundaries, ``--slo-ms`` adds admission-time latency-budget control
(reject or degrade, ``--slo-action``), ``--deadline-ms`` a per-request
deadline.  ``--forever`` demonstrates live submission (``serve_forever``
+ per-request futures, threaded lanes, ``--max-queue`` backpressure).
The reference launcher reaches the engine through its ``repro.api``
facade, which the port does not have yet, so this one builds the
``EngineConfig`` itself.
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
from repro_torch.core.snn_model import SNN, SNN_BACKENDS, init_snn
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


def serve_engine(cfg: SNNConfig, *, backend: str = "hopper",
                 schedule: str = "auto", lanes: int = 2, batch: int = 8,
                 steps: int = 8, threaded: bool = False,
                 forever: bool = False, chunk_timesteps: Optional[int] = None,
                 slo_ms: Optional[float] = None, slo_action: str = "reject",
                 max_queue: Optional[int] = None,
                 deadline_ms: Optional[float] = None, seed: int = 0,
                 device=None) -> Dict:
    """Serve ``steps * batch`` single-frame requests through the
    continuous-batching engine: replayed on the open-loop exponential-gap
    trace (``forever=False``), or submitted live to ``serve_forever``.
    Returns the engine's metrics summary, plus the live outcomes."""
    from repro_torch.serving import EngineConfig, ServingEngine
    dev = resolve_device(device)
    ecfg = EngineConfig(
        backend=backend, schedule_mode=resolve_schedule(schedule, backend),
        num_lanes=lanes, max_batch=batch, threaded=threaded or forever,
        chunk_timesteps=chunk_timesteps,
        latency_budget_s=slo_ms / 1e3 if slo_ms else None,
        slo_action=slo_action, max_queue=max_queue,
        default_deadline_s=deadline_ms / 1e3 if deadline_ms else None,
        device=str(dev))
    params = init_snn(torch.Generator().manual_seed(seed), cfg, device=dev)
    eng = ServingEngine(params, cfg, ecfg)
    frames = np.random.default_rng(seed).random(
        (batch, *cfg.input_hw, cfg.input_channels), dtype=np.float32)
    n = steps * batch
    if forever:
        eng.serve_forever()
        handles = [eng.submit_live(frames[i % batch]) for i in range(n)]
        snap = eng.snapshot()
        log.info("mid-burst snapshot: served=%d queued=%d in_flight=%d "
                 "lanes=%d/%d", snap.served, snap.queued, snap.in_flight,
                 snap.lanes_alive, snap.lanes_total)
        # exception() instead of result(): with --slo-ms an over-budget
        # submission resolves to SLORejected, an outcome to count here
        outcomes = [h.exception(timeout=60.0) for h in handles]
        s = eng.shutdown()
        s["futures_resolved"] = sum(e is None for e in outcomes)
        s["futures_failed"] = sum(e is not None for e in outcomes)
    else:
        gaps = np.random.default_rng(0).exponential(1e-3, n)
        for i, arr in enumerate(np.cumsum(gaps)):
            eng.submit(frames[i % batch], arrival=float(arr))
        s = eng.run()
    s["mode"] = ("forever" if forever else
                 "threaded" if threaded else "virtual")
    s["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")
    return s


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--snn", default="snn-mnist")
    ap.add_argument("--backend", default="hopper", choices=SNN_BACKENDS)
    ap.add_argument("--schedule", default="auto", choices=SCHEDULES)
    ap.add_argument("--batch", type=int, default=None,
                    help="frames per request (default 256), or the engine's "
                         "largest micro-batch (default 8, at most 16)")
    ap.add_argument("--steps", type=int, default=8,
                    help="timed requests (after one untimed warm-up), or "
                         "x --batch single-frame engine requests")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine", action="store_true",
                    help="serve through the continuous-batching engine on "
                         "an open-loop exponential-gap trace")
    ap.add_argument("--forever", action="store_true",
                    help="live serving demo: serve_forever() with "
                         "submissions while the engine runs (threaded)")
    ap.add_argument("--lanes", type=int, default=2,
                    help="engine micro-batch lanes")
    ap.add_argument("--threaded", action="store_true",
                    help="run engine lanes as worker threads on the wall "
                         "clock")
    ap.add_argument("--chunk-timesteps", type=int, default=None,
                    help="engine: run T in chunks of this many timesteps, "
                         "rescheduling at every chunk boundary")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="admission latency budget in ms; over-budget "
                         "requests are rejected/degraded")
    ap.add_argument("--slo-action", default="reject",
                    choices=("reject", "degrade"),
                    help="what to do with over-budget requests")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded-queue backpressure: live submissions "
                         "beyond this depth fail fast with QueueFull")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="default per-request deadline in ms; requests "
                         "expired in queue fail with DeadlineExceeded")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = get_snn(args.snn)
    if args.engine or args.forever:
        s = serve_engine(
            cfg, backend=args.backend, schedule=args.schedule,
            lanes=args.lanes, batch=args.batch or 8, steps=args.steps,
            threaded=args.threaded, forever=args.forever,
            chunk_timesteps=args.chunk_timesteps, slo_ms=args.slo_ms,
            slo_action=args.slo_action, max_queue=args.max_queue,
            deadline_ms=args.deadline_ms, seed=args.seed, device=args.device)
        log.info("engine[%s] served %.0f frames in %.0f rounds (%.1f FPS, "
                 "backend=%s, lanes=%d, p50=%.1fms, p99=%.1fms, "
                 "balance=%.3f, rejected=%.0f, degraded=%.0f, "
                 "deadline_missed=%.0f, device=%s)", s["mode"], s["served"],
                 s["rounds"], s["fps"], args.backend, args.lanes,
                 s["p50_latency_s"] * 1e3, s["p99_latency_s"] * 1e3,
                 s["request_balance"], s["rejected"], s["degraded"],
                 s["deadline_missed"], s["device"])
        return
    s = serve(cfg, backend=args.backend, schedule=args.schedule,
              batch=args.batch or 256, steps=args.steps, seed=args.seed,
              device=args.device)
    log.info("served %d frames in %.4fs (%.1f FPS, backend=%s, "
             "schedule=%s, T=%d, total_spikes/frame=%.0f, device=%s)",
             s["frames"], s["seconds"], s["fps"], s["backend"], s["schedule"],
             s["timesteps"], s["spikes_per_frame"], s["device"])


if __name__ == "__main__":
    main()
