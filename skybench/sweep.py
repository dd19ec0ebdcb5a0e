"""Find the open-loop cell's knee: the highest rate that the live engine
serves with no growing backlog, by one sweep of fixed rates in one
process:

    python3 skybench/sweep.py --workload seg-engine-poisson \
        --rates 400,800,1200 --seconds 6 --seed 1

For each rate it prints the p50 and p95 latency (ms, from the due time),
the completed rate, and the p95 of the first and the last third of the
requests: a backlog that grows shows as a last third far above the first.
The cell's rate is then written into its traffic file by hand, at about
four fifths of the knee.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from skybench import harness
    from skybench.trace import Trace

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_bench(ROOT)
    cell = harness.cell_entry(bench, args.workload)
    config = harness.load_config(cell["config"])
    cfg = harness.port_config(config)
    dev = torch.device("cuda")
    for rate in [float(r) for r in args.rates.split(",")]:
        traffic = {**harness.load_traffic(cell["traffic"]),
                   "rate_per_s": rate}
        ctx = harness.Context(cell=cell, config=config, traffic=traffic,
                              model=config["model"], cfg=cfg,
                              seed=args.seed, device=dev,
                              trace=Trace(False, dev))
        drv = harness.driver_class(config, traffic)(ctx)
        drv.setup()
        t = time.perf_counter()
        e2e = drv.window(args.seconds)
        wall = time.perf_counter() - t
        lat = drv.latency_ms
        third = len(lat) // 3
        print(json.dumps({
            "rate": rate, "requests": len(lat), "failed": drv.failed,
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": e2e["p95_ms"],
            "p95_first_third_ms": float(np.percentile(lat[:third], 95)),
            "p95_last_third_ms": float(np.percentile(lat[-third:], 95)),
            "completed_per_s": len(lat) / wall,
            "late_p95_ms": drv.readings["late_p95_ms"],
            "balance": drv.summary.get("request_balance")}), flush=True)
        drv.release()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
