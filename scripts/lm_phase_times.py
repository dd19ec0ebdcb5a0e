"""Phases ``lm`` and ``lm_train`` of a checkout's ``chip_smoke.py``, alone
and timed: to set the unsharded LM path of one tree against another's
in one call on one card.

    python3 scripts/lm_phase_times.py [CHECKOUT ...]

Each CHECKOUT (default: this one) runs in a process of its own, in the
order given, and prints the phases' own JSON lines, then one line
``{"tree": ..., "phase": ..., "seconds": ...}`` a phase.  The card's name
and power limit come first, as ``nvidia-smi`` gives them.  Exits nonzero
when a phase fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def child(tree: Path) -> int:
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import chip_smoke
    smi = chip_smoke.phase_env()
    for name, run in (("lm", chip_smoke.phase_lm),
                      ("lm_train", lambda: chip_smoke.phase_lm_train(smi))):
        t = time.perf_counter()
        run()
        print(json.dumps({"tree": str(tree), "phase": name,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        return child(Path(argv[1]).resolve())
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    rc = 0
    for tree in argv or [str(HERE)]:
        rc |= subprocess.run([sys.executable, __file__, "--child",
                              tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
