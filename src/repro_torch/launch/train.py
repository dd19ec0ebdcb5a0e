"""Training launcher: surrogate-gradient SGD of an SNN through the
selectable backend.

    PYTHONPATH=src python -m repro_torch.launch.train --snn snn-mnist \
        --backend hopper --steps 50 --batch 256 --lr 1e-2
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 2 --batch 4

Step i trains on ``mnist_like(batch, seed=i)`` with SGD and momentum 0.9
(``core.snn_train.make_train_step`` with a ``TrainSpec``), from random
weights drawn from ``--seed``; then the accuracy on ``mnist_like(256,
seed=10_000)`` is evaluated through the same backend.  A step is done when its loss is on
the host.  The reference's ``--snn`` path of ``repro.launch.train``,
without its facade, mesh and checkpointing.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import statistics
import time
from typing import Dict

import torch
from torch.utils._pytree import tree_map

from repro_torch.api.specs import TrainSpec
from repro_torch.config import SNNConfig, get_snn
from repro_torch.core.snn_model import SNN_BACKENDS, init_snn
from repro_torch.core.snn_train import accuracy, make_train_step
from repro_torch.core.surrogate import SURROGATE_KINDS
from repro_torch.data.synthetic import mnist_like
from repro_torch.device import resolve_device

log = logging.getLogger("repro_torch.train")

EVAL_BATCH, EVAL_SEED = 256, 10_000


def train(cfg: SNNConfig, *, backend: str = "hopper",
          surrogate: str = "fast_sigmoid", lr: float = 1e-3,
          steps: int = 50, batch: int = 256, seed: int = 0,
          device=None) -> Dict:
    """Take ``steps`` SGD steps of ``batch`` frames, then evaluate; returns
    the loss of every step, the step times and the held-out accuracy."""
    dev = resolve_device(device)
    params = init_snn(torch.Generator().manual_seed(seed), cfg, device=dev)
    mom = tree_map(torch.zeros_like, params)
    step = make_train_step(cfg, spec=TrainSpec(
        backend=backend, lr=lr, surrogate_kind=surrogate))

    def to_dev(x, y):
        return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    losses, seconds = [], []
    for i in range(steps):
        x, y = to_dev(*mnist_like(batch, seed=i))
        t0 = time.perf_counter()
        params, mom, loss = step(params, mom, x, y)
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
        if i % 10 == 0 or i == steps - 1:
            log.info("step %5d loss %.4f step_ms %.2f backend=%s", i,
                     losses[-1], seconds[-1] * 1e3, backend)
    # the median step: the first one also builds and warms the kernels
    step_s = statistics.median(seconds) if seconds else 0.0
    acc = accuracy(params, cfg, *to_dev(*mnist_like(EVAL_BATCH,
                                                     seed=EVAL_SEED)),
                   backend=backend)
    return {
        "losses": losses,
        "step_ms": [s * 1e3 for s in seconds],
        "median_step_ms": step_s * 1e3,
        "frames_per_s": batch / step_s if step_s > 0 else 0.0,
        "accuracy": acc,
        "backend": backend,
        "surrogate": surrogate,
        "timesteps": cfg.timesteps,
        "batch": batch,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--snn", default="snn-mnist")
    ap.add_argument("--backend", default="hopper", choices=SNN_BACKENDS)
    ap.add_argument("--surrogate", default="fast_sigmoid",
                    choices=SURROGATE_KINDS)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--timesteps", type=int, default=0,
                    help="override the config's timesteps (0 = keep)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = get_snn(args.snn)
    if args.timesteps:
        cfg = dataclasses.replace(cfg, timesteps=args.timesteps)
    r = train(cfg, backend=args.backend, surrogate=args.surrogate,
              lr=args.lr, steps=args.steps, batch=args.batch, seed=args.seed,
              device=args.device)
    log.info("trained %d steps of %d frames (backend=%s, surrogate=%s, "
             "T=%d): loss %.4f -> %.4f, median step %.2f ms, %.1f trained "
             "frames/s, held-out accuracy %.2f%%, device=%s", len(r["losses"]),
             r["batch"], r["backend"], r["surrogate"], r["timesteps"],
             r["losses"][0] if r["losses"] else float("nan"),
             r["losses"][-1] if r["losses"] else float("nan"),
             r["median_step_ms"], r["frames_per_s"], r["accuracy"] * 100,
             r["device"])


if __name__ == "__main__":
    main()
