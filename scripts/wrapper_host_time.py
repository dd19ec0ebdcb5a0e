#!/usr/bin/env python3
"""Host time of one call of each kernel wrapper of ``repro_torch`` and of
the pieces a wrapper is made of, on one card.

    python3 scripts/wrapper_host_time.py [--src DIR]

``--src`` imports ``repro_torch`` from ``DIR`` (default: this checkout's
``src``), so the same script times another tree's wrappers.  Each number
is the wall time of 500 calls back to back divided by 500, after a warm-up
and before one synchronize: the inputs are batch 1 (device time a few
microseconds), so the card waits for the host and the wall time is the
host's.  Wrappers: kernel A's dV mode (``spiking_conv``, snn-mnist layer 0
at batch 1) and, where the tree has it, its hoisted mode with and without
SAVE_U (T=8); kernel B (``spiking_conv_lif``, layer 1, T=8); kernel D
(``lif_bwd``); kernel F (``lif_fused``).  Pieces: one PyTorch op on the
same tensor, ``torch.empty`` of the hoisted mode's spike train,
``torch.cuda.current_stream().cuda_stream`` and the raw stream handle
PyTorch's own generated kernels read (``_cuda_getCurrentRawStream``),
entering and leaving
``torch.cuda.device``, and the argument checks of four tensors.  Prints
one JSON line, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def host_us(fn, calls: int = 500) -> float:
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        print("wrapper_host_time: no card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, lif
    from repro_torch.kernels import spiking_conv as sc
    from repro_torch.kernels import spiking_conv_lif as scl
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator().manual_seed(0)
    frame = torch.rand((1, 28, 28, 1), generator=g).to(dev)
    w0 = (torch.randn((3, 3, 1, 16), generator=g) * 0.47).to(dev)
    b0 = torch.zeros(16, device=dev)
    v0 = torch.zeros((1, 30, 30, 16), device=dev)
    train = (torch.rand((8, 1, 30, 30, 16), generator=g) < 0.3).float().to(
        dev)
    w1 = (torch.randn((3, 3, 16, 32), generator=g) * 0.1).to(dev)
    b1 = torch.zeros(32, device=dev)
    v1 = torch.zeros((1, 32, 32, 32), device=dev)
    u = torch.randn((8, 1, 32, 32, 32), generator=g).to(dev)
    flat = torch.randn((1024, 32), generator=g).to(dev)

    def device_context():
        with torch.cuda.device(dev):
            pass

    rec = {"src": args.src,
           "spiking_conv": host_us(lambda: sc.spiking_conv(frame, w0, b0)),
           "spiking_conv_lif": host_us(lambda: scl.spiking_conv_lif(
               train, v1, w1, b1)),
           "lif_bwd": host_us(lambda: scl.lif_bwd(
               u, u, u[0], v_th=1.0, alpha=10.0, kind="fast_sigmoid")),
           "lif_fused": host_us(lambda: lif.lif_fused(flat, flat, 1.0)),
           "torch_op": host_us(lambda: frame + 1.0),
           "torch_empty_train": host_us(lambda: torch.empty(
               (8, 1, 30, 30, 16), device=dev)),
           "current_stream": host_us(
               lambda: torch.cuda.current_stream(dev).cuda_stream),
           "raw_stream": host_us(
               lambda: torch._C._cuda_getCurrentRawStream(dev.index)),
           "device_context": host_us(device_context),
           "check_cuda_args_4": host_us(lambda: _build.check_cuda_args(
               "probe", a=frame, b=v0, c=w0, d=b0))}
    if hasattr(sc, "spiking_conv_lif_hoisted"):
        for save_u in (False, True):
            rec["spiking_conv_lif_hoisted" + ("_save_u" if save_u else "")] \
                = host_us(lambda: sc.spiking_conv_lif_hoisted(
                    frame, v0, w0, b0, t=8, save_u=save_u))
    print(json.dumps(rec), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
