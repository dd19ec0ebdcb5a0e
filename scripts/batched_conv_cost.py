#!/usr/bin/env python3
"""Time and device memory of the ``batched`` backend's conv of a spike
input, ``core.snn_layers.conv2d(..., binary=True)`` (one float64 GEMM per
tap on shifted views of the padded input), against the formula it replaced
(one float64 GEMM over the R*R*Cin im2col copy of the padded input), on one
card.

    python3 scripts/batched_conv_cost.py

Shapes: the conv layers that take a spike train at full width: snn-mnist
layers 1 and 2 at batch 256 (T=8 folded: 2048 images) and snn-seg layers
1-4 and its readout at batch 16 (T=16 folded: 256 images), on 0/1 inputs
of rate 0.2 and He-normal weights (torch seed 0).  For each, both
formulas' forward must give the same bits; then the forward's ms and the
forward-and-backward's ms between CUDA events (median of 5 after 2 warm-up
calls, in the order old, new, new, old, the two runs of each reported),
and the device memory the forward-and-backward took at its peak (GB above
what was allocated before it).  The forward is also timed, with its bits
checked, in a variant the library does not take: the output rows in
blocks of ``BLOCKS`` bytes (float64 accumulator plus input rows), each
block's taps run before the next block's, so that a block can stay in the
card's L2 cache (50 MB).  Prints one JSON line per shape, then the card's
name and power limit as nvidia-smi gives them.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

# name, images, H, W, Cin, Cout (3x3, APRC full padding)
SHAPES = [
    ("snn-mnist layer 1", 2048, 30, 30, 16, 32),
    ("snn-mnist layer 2", 2048, 32, 32, 32, 8),
    ("snn-seg layer 1", 256, 82, 162, 8, 16),
    ("snn-seg layer 2", 256, 84, 164, 16, 32),
    ("snn-seg layer 3", 256, 86, 166, 32, 32),
    ("snn-seg layer 4", 256, 88, 168, 32, 16),
    ("snn-seg readout", 256, 90, 170, 16, 1),
]
BLOCKS = [8 << 20, 24 << 20, 64 << 20]


def im2col_conv(x, w):
    """The replaced formula (APRC): the im2col copy of the padded input in
    float64 times the exact-grid weights, rounded once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.snn_layers import exact_grid
    r, _, cin, cout = w.shape
    n, h, wd = x.shape[:3]
    e_h, e_w = h + r - 1, wd + r - 1
    xp = F.pad(x.double(), (0, 0, r - 1, r - 1, r - 1, r - 1))
    taps = [xp[:, dy:dy + e_h, dx:dx + e_w, :]
            for dy in range(r) for dx in range(r)]
    patches = torch.cat(taps, dim=-1).reshape(n * e_h * e_w, r * r * cin)
    wq = exact_grid(w.reshape(r * r * cin, cout), dim=0)
    return (patches @ wq).to(x.dtype).reshape(n, e_h, e_w, cout)


def per_tap_conv(x, w):
    from repro_torch.core.snn_layers import conv2d
    return conv2d(x, w, aprc=True, binary=True)


def blocked_per_tap_conv(x, w, block_bytes):
    """The per-tap forward with its output rows in blocks of
    ``block_bytes``; R*R GEMM launches a block."""
    import torch
    from repro_torch.core.snn_layers import (_flat_rows, _tap_offsets,
                                             exact_grid)
    r, _, cin, cout = w.shape
    n, e_h, e_w = x.shape[0], x.shape[1] + r - 1, x.shape[2] + r - 1
    wq = exact_grid(w.reshape(r * r * cin, cout), dim=0)
    xr, hp, wp = _flat_rows(x.double(), r - 1, r - 1)
    rows = xr.shape[0] - (r - 1) * (wp + 1)
    z = xr.new_empty((xr.shape[0], cout))
    taps = [(off, wq[k * cin:(k + 1) * cin])
            for k, off in _tap_offsets(r, wp)]
    blk = max(1, block_bytes // (8 * (cin + cout)))
    for s0 in range(0, rows, blk):
        nb = min(blk, rows - s0)
        zb = z[s0:s0 + nb]
        torch.mm(xr[s0 + taps[0][0]:s0 + taps[0][0] + nb], taps[0][1],
                 out=zb)
        for off, wk in taps[1:]:
            zb.addmm_(xr[s0 + off:s0 + off + nb], wk)
    return z.reshape(n, hp, wp, cout)[:, :e_h, :e_w].to(x.dtype)


def event_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("batched_conv_cost: needs a CUDA card", file=sys.stderr)
        return 2
    gen = torch.Generator().manual_seed(0)
    formulas = {"im2col": im2col_conv, "per_tap": per_tap_conv}
    for name, n, h, wd, cin, cout in SHAPES:
        x = (torch.rand((n, h, wd, cin), generator=gen) < 0.2).float().cuda()
        w = (torch.randn((3, 3, cin, cout), generator=gen)
             * (2.0 / (9 * cin)) ** 0.5).cuda()
        g = torch.randn((n, h + 2, wd + 2, cout), generator=gen).cuda()
        with torch.no_grad():
            same = torch.equal(im2col_conv(x, w), per_tap_conv(x, w))
        xg = x.clone().requires_grad_(True)
        wg = w.clone().requires_grad_(True)

        def fwd(f):
            def run():
                with torch.no_grad():
                    return f(x, w)
            return run

        def fwd_bwd(f):
            return lambda: torch.autograd.grad((f(xg, wg) * g).sum(),
                                               (xg, wg))

        rec = {"shape": name, "input": [n, h, wd, cin], "cout": cout,
               "forward_bit_identical": same}
        with torch.no_grad():
            want = per_tap_conv(x, w)
            for bb in BLOCKS:
                got = blocked_per_tap_conv(x, w, bb)
                rec[f"blocked_{bb >> 20}mb_bit_identical"] = torch.equal(
                    got, want)
                runs = [event_ms(lambda: blocked_per_tap_conv(x, w, bb))
                        for _ in range(2)]
                rec[f"blocked_{bb >> 20}mb_forward_ms"] = runs
            del want, got
        for key, make in (("forward_ms", fwd), ("fwd_bwd_ms", fwd_bwd)):
            runs = {k: [] for k in formulas}
            for k in ("im2col", "per_tap", "per_tap", "im2col"):
                runs[k].append(event_ms(make(formulas[k])))
            rec[key] = runs
        for k, f in formulas.items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fwd_bwd(f)()
            torch.cuda.synchronize()
            rec[f"fwd_bwd_peak_gb_{k}"] = (torch.cuda.max_memory_allocated()
                                           - base) / 1e9
        print(json.dumps(rec), flush=True)
        del x, w, g, xg, wg
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
