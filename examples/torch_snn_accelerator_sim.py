"""Skydiver accelerator simulation on the segmentation network, the Fig. 7
ablation (none / CBWS alone / APRC+CBWS) end to end, on the PyTorch port
(the reference's ``examples/snn_accelerator_sim.py``):

  build both network variants (SAME pad and APRC full pad), measure real
  spike workloads on synthetic road frames through the selected backend
  (``hopper``: the kernels on the card), schedule with Algorithm 1, and
  run the cycle model -> balance ratios + throughput gain.

    PYTHONPATH=src python examples/torch_snn_accelerator_sim.py
    PYTHONPATH=src python examples/torch_snn_accelerator_sim.py \
        --device cpu --backend batched --frames 1 --timesteps 3

The balances, frames per second and mJ per frame are outputs of the
performance model of the paper's FPGA (``perfmodel.XC7Z045``), computed
from the measured spike counts: they are not speeds of the card.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.config import SNNConfig, get_snn
from repro_torch.core.scheduler import build_schedule
from repro_torch.core.snn_model import (SNN_BACKENDS, init_snn, skew_channels,
                                        snn_apply)
from repro_torch.data.synthetic import road_like
from repro_torch.device import resolve_device
from repro_torch.obs.log import configure_logging, get_logger
from repro_torch.perfmodel import XC7Z045, simulate_network

log = get_logger("examples")

MODES = ("none", "cbws", "aprc+cbws")
PAPER_BALANCE = {"none": 0.6919, "cbws": 0.5437, "aprc+cbws": 0.9569}
SIGMA, SKEW_SEED = 1.2, 1


def variant(cfg: SNNConfig, params: Dict, mode: str, timesteps: int):
    """One bar's network: its config ('aprc+cbws' runs the APRC full-pad
    net; 'none' and 'cbws' the unmodified SAME-pad net, where filter
    magnitudes are a poor workload predictor: the paper's point), the
    lognormally skewed weights and the schedule (Algorithm 1 for both CBWS
    bars, naive striping for 'none')."""
    vcfg = dataclasses.replace(cfg, aprc=(mode == "aprc+cbws"),
                               timesteps=timesteps)
    vparams = skew_channels(params, sigma=SIGMA, seed=SKEW_SEED)
    sched = build_schedule(vparams, vcfg,
                           "none" if mode == "none" else "aprc+cbws")
    return vcfg, vparams, sched


def measure(cfg: SNNConfig, params: Dict, frames: torch.Tensor,
            backend: str, schedule=None):
    """Per-layer input workloads, (T, Cin) spike counts summed over the
    batch (layer 0: the frame counted as dense events), and the outputs."""
    with torch.no_grad():
        out = snn_apply(params, frames, cfg, backend=backend,
                        schedule=schedule if backend == "hopper" else None)
    b, h, w, c = frames.shape
    per_layer = [np.full((cfg.timesteps, c), float(b * h * w) / c)]
    for l in range(len(cfg.conv_channels) - 1):
        per_layer.append(out.timestep_counts[l].cpu().numpy())
    return per_layer, out


def simulate(cfg: Optional[SNNConfig] = None, *, params: Optional[Dict] = None,
             frames: int = 4, timesteps: int = 12, backend: str = "hopper",
             seed: int = 0, device=None) -> Dict:
    """The three bars of Fig. 7 on ``cfg`` (default: ``snn-seg``) from the
    unskewed weights ``params`` (default: ``init_snn`` from ``seed``) and
    ``road_like(frames, seed=0)`` at the config's input size.  Returns per
    mode the model's balance (Spartus), barrier balance, frames per second
    and mJ per frame, with the measured ``timestep_counts``, and the
    throughput gain of APRC+CBWS over none."""
    cfg = cfg if cfg is not None else get_snn("snn-seg")
    dev = resolve_device(device)
    if params is None:
        params = init_snn(torch.Generator().manual_seed(seed), cfg,
                          device=dev)
    h, w = cfg.input_hw
    x = torch.from_numpy(road_like(frames, h=h, w=w, seed=0)[0]).to(dev)
    modes = {}
    for mode in MODES:
        vcfg, vparams, sched = variant(cfg, params, mode, timesteps)
        per_layer, out = measure(vcfg, vparams, x, backend, sched)
        perf = simulate_network(vcfg, per_layer,
                                [s.in_partition for s in sched],
                                [s.out_partition for s in sched], XC7Z045)
        modes[mode] = {
            "balance": perf.balance_spartus,
            "barrier_balance": perf.balance,
            "fps": perf.fps(XC7Z045),
            "mj_per_frame": perf.energy_j(XC7Z045) * 1e3,
            "paper_balance": PAPER_BALANCE[mode],
            "timestep_counts": per_layer[1:],
        }
    return {"modes": modes, "backend": backend, "timesteps": timesteps,
            "frames": frames, "hardware_model": "XC7Z045",
            "gain": modes["aprc+cbws"]["fps"] / modes["none"]["fps"]}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--timesteps", type=int, default=12)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--backend", default="hopper", choices=SNN_BACKENDS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    configure_logging("info")
    r = simulate(frames=args.frames, timesteps=args.timesteps,
                 backend=args.backend, seed=args.seed, device=args.device)
    for mode, m in r["modes"].items():
        log.info("%10s balance=%.4f (paper %.4f) barrier_balance=%.4f "
                 "fps=%.1f mJ/frame=%.2f (XC7Z045 model)", mode,
                 m["balance"], m["paper_balance"], m["barrier_balance"],
                 m["fps"], m["mj_per_frame"])
    log.info("throughput gain APRC+CBWS vs none: %.2fx (paper: 1.4x)",
             r["gain"])
    return r


if __name__ == "__main__":
    main()
