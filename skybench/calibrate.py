"""Readings that the output check's limits are set from, for one cell at
its own size, many seeds in one process:

    python3 skybench/calibrate.py --workload mnist-infer-digits \
        --seeds 101-112 --control 3 --seconds 2 [--fault half_batch]

For each seed it runs the cell's set-up, a short window at the cell's own
load and the check, and prints one JSON line with the compared numbers of
the program (``sound``, or with ``--fault`` the planted fault's).  For the
first ``--control`` seeds it also prints the numbers of the control: the
reference computed in the precision below the configuration's (TF32 for
the float32 networks, float8 products for the bfloat16 language models)
in the program's place, against the float32 reference.  A limit lies
above every sound reading and below the control's (and a training cell's
faults') smallest: ``PERF.md`` gives them.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def seeds_of(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def read_seed(bench, workload: str, seed: int, seconds: float, *,
              control: bool, fault=None, device: str = "cuda", cfg=None,
              model_override=None, traffic_override=None) -> dict:
    """The compared numbers of one seed: the program's (``sound``, or
    ``faulty`` under ``fault``) and, with ``control``, the control's."""
    import torch
    from skybench import harness
    from skybench.faults import planted
    from skybench.trace import Trace

    cell = harness.cell_entry(bench, workload)
    config = harness.load_config(cell["config"])
    traffic = {**harness.load_traffic(cell["traffic"]),
               **(traffic_override or {})}
    dev = torch.device(device)
    ctx = harness.Context(
        cell=cell, config=config, traffic=traffic,
        model={**config["model"], **(model_override or {})},
        cfg=cfg if cfg is not None else harness.port_config(config),
        seed=seed, device=dev, trace=Trace(False, dev))
    drv = harness.driver_class(config, traffic)(ctx)
    t = time.perf_counter()
    with planted(fault) if fault else contextlib.nullcontext():
        drv.setup()
        setup_s = time.perf_counter() - t
        e2e = drv.window(seconds)
    drv.release()
    t_check = time.perf_counter()
    numbers = drv.check()
    rec = {"workload": workload, "seed": seed, "fault": fault,
           "setup_s": setup_s, "e2e": e2e,
           "check_s": time.perf_counter() - t_check,
           "sound" if fault is None else "faulty": numbers,
           **{k: drv.readings[k] for k in ("firing", "taps_per_frame",
                                           "occupied_experts")
              if k in drv.readings}}
    if hasattr(drv, "leaf_gaps"):
        rec["leaf_gaps"] = drv.leaf_gaps
    if control:
        rec["control"] = drv.controlled()
        if hasattr(drv, "leaf_gaps"):
            rec["control_leaf_gaps"] = drv.leaf_gaps
    rec["seconds"] = time.perf_counter() - t
    if dev.type == "cuda":
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 101-112,5000")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=0,
                    help="the control on this many of the seeds")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from skybench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_bench(ROOT)
    for n, seed in enumerate(seeds_of(args.seeds)):
        rec = read_seed(bench, args.workload, seed, args.seconds,
                        control=n < args.control, fault=args.fault)
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"total_s": time.perf_counter() - T0,
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
