#!/usr/bin/env python3
"""Time kernel A (``src/repro_torch/kernels/csrc/spiking_conv.cu``) in its
three instances (dV mode, hoisted mode, hoisted mode with SAVE_U) at
snn-mnist's main-path shape, across store instructions and block heights,
on one card.

    python3 scripts/kernel_a_variants.py

Store instructions: the committed source as it is ("st": plain 16-byte
stores) and with its 16-byte stores made streaming stores ("st.cs":
``__stcs``, evict first: the 118 MB spike train does not fit the 50 MB
L2), each built into its own library under ``build/repro_torch/variants/``.
Block heights: ``block_rows`` 1, 2 and 4 (the plan's, 480 threads) output
rows of 30 pixels a block.  Frames (256, 28, 28, 1) uniform [0, 1) from
numpy seed 0, He-normal weights, T=8, the zero carry.  Each timing is the
device time of one launch: CUDA events around 20 launches back to back
(so the host's launch time hides behind the device's), median of 10, in
the order A, B, B, A for every pair compared.  Every variant's outputs
must equal the committed kernel's bit for bit.  Prints one JSON line per
timing, then the card's name and power limit.  Needs a card of compute
capability 9.0 and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

STORE = "*reinterpret_cast<float4*>(p) = make_float4(q[0], q[1], q[2], q[3]);"
VARIANTS = {
    "st": STORE,
    "st.cs": "__stcs(reinterpret_cast<float4*>(p), "
             "make_float4(q[0], q[1], q[2], q[3]));",
}
N, H, W, T = 256, 28, 28, 8


def build_variant(name: str, store: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    from repro_torch.kernels import spiking_conv as sc
    src = (_build.CSRC / "spiking_conv.cu").read_text()
    if src.count(STORE) != 1:
        raise RuntimeError("the store of store_quad is not where this "
                           "script expects it")
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"spiking_conv_{name.replace('.', '_')}.cu"
    cu.write_text(src.replace(STORE, store))
    so = cu.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(so), str(cu)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.spiking_conv_lif_hoisted_launch.argtypes = sc._HOISTED_ARGTYPES
    lib.spiking_conv_launch.argtypes = sc._ARGTYPES
    return lib


def main() -> int:
    import numpy as np
    import torch
    from repro_torch.kernels import spiking_conv as sc
    if not torch.cuda.is_available():
        print("kernel_a_variants: no card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    libs = {k: build_variant(k, v) for k, v in VARIANTS.items()}
    gen = torch.Generator().manual_seed(0)
    frames = torch.from_numpy(np.random.default_rng(0).random(
        (N, H, W, 1), dtype=np.float32)).cuda()
    w = (torch.randn((3, 3, 1, 16), generator=gen) * (2 / 9) ** 0.5).cuda()
    b = torch.zeros(16, device="cuda")
    v0 = torch.zeros((N, 30, 30, 16), device="cuda")
    plan_rows, ct = sc.plan_tiles(30, 3, 1, 16)
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(lib, mode, rows):
        """One launch of ``mode`` with ``rows`` output rows a block, into
        fresh outputs; returns (call, outputs)."""
        if mode == "dV":
            outs = (torch.empty((N, 30, 30, 16), device="cuda"),)

            def call():
                return lib.spiking_conv_launch(
                    frames.data_ptr(), w.data_ptr(), b.data_ptr(),
                    outs[0].data_ptr(), N, H, W, 1, 16, 3, 2, 30, 30, rows,
                    ct, stream)
        else:
            s = torch.empty((T, N, 30, 30, 16), device="cuda")
            outs = (s, torch.empty_like(v0)) + (
                (torch.empty_like(s),) if mode == "save_u" else ())

            def call():
                return lib.spiking_conv_lif_hoisted_launch(
                    frames.data_ptr(), v0.data_ptr(), w.data_ptr(),
                    b.data_ptr(), *(o.data_ptr() for o in outs),
                    *(() if mode == "save_u" else (None,)), T, N, H, W, 1,
                    16, 3, 2, 30, 30, rows, ct, 1.0, stream)
        return call, outs

    def device_ms(call, launches=20, reps=10):
        for _ in range(3):
            call()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(launches):
                if call():
                    raise RuntimeError("launch failed")
            e.record()
            e.synchronize()
            times.append(a.elapsed_time(e) / launches)
        return statistics.median(times)

    for mode in ("dV", "hoisted", "save_u"):
        if mode == "dV":
            want = (sc.spiking_conv(frames, w, b),)
        else:
            want = sc.spiking_conv_lif_hoisted(frames, v0, w, b, t=T,
                                               save_u=mode == "save_u")
        calls = {}
        for store, lib in libs.items():
            for rows in (1, 2, plan_rows):
                call, outs = launcher(lib, mode, rows)
                if call():
                    raise RuntimeError("launch failed")
                torch.cuda.synchronize()
                if not all(torch.equal(a, b_) for a, b_ in zip(outs, want)):
                    raise RuntimeError(f"{store} rows={rows} differs from "
                                       f"the kernel")
                calls[store, rows] = call
        base = ("st", plan_rows)
        for other in [k for k in calls if k != base]:
            for order, key in enumerate([base, other, other, base]):
                print(json.dumps({"mode": mode, "store": key[0],
                                  "block_rows": key[1], "against": list(
                                      other if key == base else base),
                                  "order": order,
                                  "device_ms": device_ms(calls[key])}),
                      flush=True)
        del want, calls
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
