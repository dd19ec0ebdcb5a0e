"""Run one cell of the benchmark once and print its result line.

    python3 skybench/run.py --workload mnist-infer-digits --seed 7 \
        --seconds 10 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, ``skybench/``
and the port (``src/repro_torch``).  It needs the cards the cell asks for
and exits with code 2 without them.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a profiled
stretch of the window.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
output check compared, beside its limit); the last lines of standard error
repeat the checks.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from skybench import harness

    bench = harness.load_bench(ROOT)
    cell = harness.cell_entry(bench, args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < int(cell["chips"]):
        print(f"skybench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has {cards}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START,
                              bench=bench)
    bad = harness.forbidden_modules()
    if bad:
        print(f"skybench: the run loaded {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
