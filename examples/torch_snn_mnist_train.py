"""Train the paper's classification SNN (28x28-16c-32c-8c-10) with surrogate
gradients on MNIST-like digits, then run the full Skydiver pipeline:
APRC magnitudes -> CBWS schedule -> cycle model -> Table-I-style row, on
the PyTorch port (the reference's ``examples/snn_mnist_train.py``).

    PYTHONPATH=src python examples/torch_snn_mnist_train.py --steps 300
    PYTHONPATH=src python examples/torch_snn_mnist_train.py --device cpu \
        --backend batched --steps 2

Training runs through the ``repro_torch.api`` facade: the flags build one
``TrainSpec`` (``--backend`` selects the execution order that is trained;
``hopper``, the default, runs the kernels on the card) and a ``Session``
owns the params the Skydiver pipeline then analyzes.  The balance, kfps,
uJ per image and GSOp/s are outputs of the performance model of the
paper's FPGA (``perfmodel.XC7Z045``) from the measured spike counts, not
speeds of the card.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np

from repro_torch import api
from repro_torch.config import SNNConfig, get_snn
from repro_torch.core import SNN_BACKENDS, SURROGATE_KINDS, aprc
from repro_torch.core.scheduler import build_schedule
from repro_torch.data.synthetic import mnist_like
from repro_torch.obs.log import configure_logging, get_logger
from repro_torch.perfmodel import XC7Z045, simulate_network

log = get_logger("examples")

ANALYSIS_FRAMES = 64


def skydiver_pipeline(sess: api.Session, frames: np.ndarray) -> Dict:
    """Table I's row under no schedule and under APRC+CBWS, from the spike
    counts of ``frames`` (per image), and Fig. 6's spike~magnitude
    Spearman correlation of every conv layer after the first."""
    cfg, params = sess.cfg, sess.params
    n, h, w, c = frames.shape
    out = sess.infer(frames)
    per_layer = [np.full((cfg.timesteps, c), float(h * w) / c)]
    for l in range(len(cfg.conv_channels) - 1):
        per_layer.append(np.asarray(out.timestep_counts[l]) / n)
    table1 = {}
    for mode in ("none", "aprc+cbws"):
        scheds = build_schedule(params, cfg, mode)
        perf = simulate_network(cfg, per_layer,
                                [s.in_partition for s in scheds],
                                [s.out_partition for s in scheds], XC7Z045)
        table1[mode] = {"balance": perf.balance,
                        "kfps": perf.fps(XC7Z045) / 1e3,
                        "uj_per_img": perf.energy_j(XC7Z045) * 1e6,
                        "gsops": perf.gsops(XC7Z045)}
    spearman = {}
    for l in range(1, len(cfg.conv_channels)):
        mags = np.maximum(aprc.filter_magnitudes(params["conv"][l]["w"]), 0)
        spearman[l] = aprc.proportionality(
            mags, np.asarray(out.spike_counts[l]))["spearman"]
    return {"table1": table1, "spearman": spearman}


def run(cfg: Optional[SNNConfig] = None, *, params: Optional[Dict] = None,
        steps: int = 200, batch: int = 32, timesteps: int = 8,
        lr: float = 1e-3, backend: str = "hopper",
        surrogate: str = "fast_sigmoid", device=None) -> Dict:
    """Train ``cfg`` (default: ``snn-mnist``) from ``params`` (default:
    fresh weights from seed 0) for ``steps`` steps, evaluate on 512
    held-out digits, then run ``skydiver_pipeline`` on 64 of them."""
    sess = api.Session(cfg if cfg is not None else "snn-mnist",
                       api.TrainSpec(backend=backend, surrogate_kind=surrogate,
                                     lr=lr, timesteps=timesteps),
                       params=params, device=device)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        losses.append(sess.train_step(*mnist_like(batch, seed=i)))
        if i % 25 == 0 or i == steps - 1:
            log.info("step %4d loss %.4f", i, losses[-1])
    train_s = time.perf_counter() - t0
    xte, yte = mnist_like(512, seed=10_000)
    acc = sess.evaluate(xte, yte)
    return {"losses": losses, "train_seconds": train_s, "accuracy": acc,
            **skydiver_pipeline(sess, xte[:ANALYSIS_FRAMES])}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--timesteps", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--backend", default="hopper", choices=SNN_BACKENDS,
                    help="execution order to train through (core.snn_model)")
    ap.add_argument("--surrogate", default="fast_sigmoid",
                    choices=SURROGATE_KINDS,
                    help="surrogate-gradient kind for the spike backward")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    configure_logging("info")
    r = run(get_snn("snn-mnist"), steps=args.steps, batch=args.batch,
            timesteps=args.timesteps, lr=args.lr, backend=args.backend,
            surrogate=args.surrogate, device=args.device)
    log.info("trained %d steps in %.1fs (backend=%s, surrogate=%s)",
             args.steps, r["train_seconds"], args.backend, args.surrogate)
    # the paper reports 98.5% on real MNIST at T=8
    log.info("accuracy on held-out synthetic digits: %.2f%% "
             "(paper: 98.5%% on MNIST)", r["accuracy"] * 100)
    for mode, row in r["table1"].items():
        log.info("%10s balance=%.4f kfps=%.2f uJ/img=%.1f gsops=%.2f "
                 "(XC7Z045 model)", mode, row["balance"], row["kfps"],
                 row["uj_per_img"], row["gsops"])
    for l, rho in r["spearman"].items():
        log.info("layer %d spike~magnitude spearman=%.3f", l, rho)
    return r


if __name__ == "__main__":
    main()
