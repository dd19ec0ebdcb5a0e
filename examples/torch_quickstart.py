"""Quickstart: the whole Skydiver stack of the PyTorch port through the
``repro_torch.api`` facade (the reference's ``examples/quickstart.py``).

Train the paper's classification SNN with surrogate gradients on the
time-batched hot path, evaluate it, serve a batch single-shot, then go
live: ``Session.serve_forever()`` accepts submissions while the
worker-thread engine runs and returns a future per request.

    PYTHONPATH=src python examples/torch_quickstart.py --steps 150
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu \
        --steps 20 --batch 8

One ``TrainSpec`` and one ``ServeSpec`` carry backend, timesteps,
surrogate and lanes end to end; ``hopper``, the default, runs the kernels
on the card.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np

from repro_torch import api
from repro_torch.config import SNNConfig
from repro_torch.core import SNN_BACKENDS
from repro_torch.data.synthetic import mnist_like
from repro_torch.obs.log import configure_logging, get_logger

log = get_logger("examples")


def run(cfg: Optional[SNNConfig] = None, *, params: Optional[Dict] = None,
        steps: int = 150, batch: int = 32, timesteps: int = 4,
        backend: str = "hopper", lanes: int = 2, device=None) -> Dict:
    """Train ``cfg`` (default: ``snn-mnist``) from ``params`` (default:
    fresh weights from seed 0), serve single-shot and live; returns the
    losses, accuracies and serving summaries.  Raises ``AssertionError``
    if the loss did not fall or a live future's logits differ from
    ``Session.infer``'s bits."""
    # --- train (surrogate-gradient SGD on the deployed dataflow) ----------
    train_spec = api.TrainSpec(backend=backend, lr=1e-3, timesteps=timesteps)
    sess = api.Session(cfg if cfg is not None else "snn-mnist", train_spec,
                       params=params, device=device)
    log.info("training %s via %s", sess.cfg.name, train_spec)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        losses.append(sess.train_step(*mnist_like(batch, seed=i)))
        if i % 25 == 0 or i == steps - 1:
            log.info("step %4d loss %.4f", i, losses[-1])
    train_s = time.perf_counter() - t0
    xte, yte = mnist_like(256, seed=10_000)
    acc = sess.evaluate(xte, yte)
    log.info("trained %d steps in %.1fs, held-out acc %.2f%%", steps,
             train_s, acc * 100)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training must reduce loss: {losses[0]} -> "
                             f"{losses[-1]}")

    # --- single-shot serving (same session, same params) ------------------
    single = sess.serve(xte[:8], steps=4)
    log.info("single-shot: %.1f FPS (%.0f spikes/frame)", single["fps"],
             single["spikes_per_frame"])

    # --- live serving: submit while the engine runs -----------------------
    # one padding bucket (8), as the single-shot check below uses
    serve_spec = api.ServeSpec(backend=backend, num_lanes=lanes, max_batch=8,
                               buckets=(8,))
    with sess.serve_forever(serve_spec) as live:
        handles = [live.submit(f) for f in xte[:24]]
        # live introspection mid-burst: a consistent MetricsSnapshot while
        # requests are still in flight
        snap = live.metrics()
        log.info("mid-run snapshot: served=%d queued=%d in_flight=%d "
                 "outstanding=%d lanes=%d/%d", snap.served, snap.queued,
                 snap.in_flight, snap.outstanding, snap.lanes_alive,
                 snap.lanes_total)
        logits = [h.result(timeout=60.0) for h in handles]
    summ = live.summary()
    log.info("live: served %.0f requests on %d lanes (p50 %.1fms, p99 "
             "%.1fms, %.1f FPS)", summ["served"], lanes,
             summ["p50_latency_s"] * 1e3, summ["p99_latency_s"] * 1e3,
             summ["fps"])

    # futures resolve bit-identically to the single-shot path
    want = sess.infer(xte[:8]).logits
    for i in range(8):
        if not np.array_equal(want[i], logits[i]):
            raise AssertionError(f"live != single-shot logits (row {i})")
    live_acc = float((np.argmax(np.stack(logits), axis=-1)
                      == yte[:24]).mean())
    log.info("live accuracy on the submitted slice: %.1f%%", live_acc * 100)
    return {"losses": losses, "train_seconds": train_s, "accuracy": acc,
            "single_shot_fps": single["fps"], "live": summ,
            "live_accuracy": live_acc}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--timesteps", type=int, default=4)
    ap.add_argument("--backend", default="hopper", choices=SNN_BACKENDS,
                    help="execution backend to train AND serve through")
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    configure_logging("info")
    return run(steps=args.steps, batch=args.batch, timesteps=args.timesteps,
               backend=args.backend, lanes=args.lanes, device=args.device)


if __name__ == "__main__":
    main()
