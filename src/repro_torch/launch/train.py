"""Training launcher: surrogate-gradient SGD of an SNN through the
``repro_torch.api`` facade.

    PYTHONPATH=src python -m repro_torch.launch.train --snn snn-mnist \
        --backend hopper --steps 50 --batch 256 --lr 1e-2
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 2 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.train --spec-file train.json
    PYTHONPATH=src python -m repro_torch.launch.train --mesh data=2 \
        --device cpu --steps 2 --batch 4

The flags build one validated ``TrainSpec`` (backend, surrogate, lr,
timesteps), or ``--spec-file`` loads one from JSON
(``api.spec_from_dict``), and ``--mesh`` (``dist.parse_mesh``) layers
over either: the step then shards the batch over the mesh's entries
(per-example gradient rows combined on the host, the same params at any
shard count).  A ``Session`` owns the params, drawn from ``--seed``, and
the step.  Step i trains on ``mnist_like(batch, seed=i)``
with SGD and momentum (``Session.train_step``); then the accuracy on
``mnist_like(256, seed=10_000)`` is evaluated through the same backend
(``Session.evaluate``).  A step is done when its loss is on the host.
The reference's ``--snn`` path of ``repro.launch.train``.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Dict, Optional

import torch

from repro_torch import api
from repro_torch.config import SNNConfig, get_snn
from repro_torch.core.snn_model import SNN_BACKENDS
from repro_torch.core.surrogate import SURROGATE_KINDS
from repro_torch.data.synthetic import mnist_like
from repro_torch.dist.mesh import parse_mesh
from repro_torch.launch.serve import device_name, load_spec_file
from repro_torch.obs.log import LOG_LEVELS, configure_logging, get_logger

log = get_logger("train")

EVAL_BATCH, EVAL_SEED = 256, 10_000


def train(cfg: SNNConfig, spec: Optional[api.TrainSpec] = None, *,
          backend: str = "hopper", surrogate: str = "fast_sigmoid",
          lr: float = 1e-3, steps: int = 50, batch: int = 256, seed: int = 0,
          device=None) -> Dict:
    """Take ``steps`` SGD steps of ``batch`` frames, then evaluate; returns
    the loss of every step, the step times and the held-out accuracy.
    Without a ``spec``, one is built from ``backend``, ``surrogate`` and
    ``lr``."""
    if spec is None:
        spec = api.TrainSpec(backend=backend, lr=lr, surrogate_kind=surrogate)
    sess = api.Session(cfg, spec, seed=seed, device=device)

    def to_dev(x, y):
        return (torch.from_numpy(x).to(sess.device),
                torch.from_numpy(y).to(sess.device))

    losses, seconds = [], []
    for i in range(steps):
        x, y = to_dev(*mnist_like(batch, seed=i))
        t0 = time.perf_counter()
        losses.append(sess.train_step(x, y))
        seconds.append(time.perf_counter() - t0)
        if i % 10 == 0 or i == steps - 1:
            log.info("step %5d loss %.4f step_ms %.2f backend=%s", i,
                     losses[-1], seconds[-1] * 1e3, spec.backend)
    # the median step: the first one also builds and warms the kernels
    step_s = statistics.median(seconds) if seconds else 0.0
    acc = sess.evaluate(*to_dev(*mnist_like(EVAL_BATCH, seed=EVAL_SEED)))
    return {
        "losses": losses,
        "step_ms": [s * 1e3 for s in seconds],
        "median_step_ms": step_s * 1e3,
        "frames_per_s": batch / step_s if step_s > 0 else 0.0,
        "accuracy": acc,
        "backend": spec.backend,
        "surrogate": spec.surrogate_kind,
        "timesteps": sess.cfg.timesteps,
        "batch": batch,
        "device": device_name(sess),
    }


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--snn", default="snn-mnist")
    ap.add_argument("--backend", default="hopper", choices=SNN_BACKENDS)
    ap.add_argument("--surrogate", default="fast_sigmoid",
                    choices=SURROGATE_KINDS)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--timesteps", type=int, default=0,
                    help="override the config's timesteps (0 = keep)")
    ap.add_argument("--spec-file", default=None,
                    help="JSON TrainSpec (api.spec_from_dict; kind='train'), "
                         "in place of the per-flag spec")
    ap.add_argument("--mesh", default="",
                    help="repro_torch.dist mesh string, e.g. 'data=2' or "
                         "bare '2': data-sharded train step over the mesh's "
                         "entries (with --device cpu, N host entries)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-level", default="info", choices=LOG_LEVELS,
                    help="stderr log verbosity (repro_torch.obs.log)")
    args = ap.parse_args(argv)
    configure_logging(args.log_level)
    if args.spec_file:
        spec = load_spec_file(args.spec_file, api.TrainSpec)
    else:
        spec = api.TrainSpec(backend=args.backend,
                             surrogate_kind=args.surrogate, lr=args.lr,
                             timesteps=args.timesteps or None)
    if args.mesh:
        spec = dataclasses.replace(spec, mesh=parse_mesh(args.mesh))
    r = train(get_snn(args.snn), spec, steps=args.steps, batch=args.batch,
              seed=args.seed, device=args.device)
    log.info("trained %d steps of %d frames (backend=%s, surrogate=%s, "
             "T=%d): loss %.4f -> %.4f, median step %.2f ms, %.1f trained "
             "frames/s, held-out accuracy %.2f%%, device=%s", len(r["losses"]),
             r["batch"], r["backend"], r["surrogate"], r["timesteps"],
             r["losses"][0] if r["losses"] else float("nan"),
             r["losses"][-1] if r["losses"] else float("nan"),
             r["median_step_ms"], r["frames_per_s"], r["accuracy"] * 100,
             r["device"])
    return r


if __name__ == "__main__":
    main()
