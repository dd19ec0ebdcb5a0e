"""One run of one cell, driven by data.

``BENCHMARK.json`` names the cell's configuration and traffic; the harness
finds everything else by those names, so a later cell is new files and new
entries, never an edit:

- ``skybench/configs/<config>.json``: the network (the port's config name
  and every width, which must match it), its weight law, how it runs, and
  its ``family`` (``snn`` where it names none);
- ``skybench/families/<family>.py``: the family's ``port_config(config)``,
  which builds the port's config and checks every width of the file
  against it, ``MODES``, its drivers by mode name (each with the
  ``SMALL_MIX`` of the CPU rehearsal), and ``narrow(name, config)``, the
  file cut for that rehearsal;
- ``skybench/traffic/<traffic>.json``: a traffic mix, the parameters of one
  of its family's modes;
- ``skybench/layer_metrics/<metric>.py``: one reader per per-layer metric,
  ``read(run) -> float | None`` (None: nothing to read in this cell);
- ``skybench/limits/<cell>.json``: each number the cell's output check
  compares, with its limit.

``run_cell`` makes the inputs and weights from the seed, builds and warms
the cell's shapes (set-up), measures for ``seconds``, frees the program,
checks its outputs against the plain reference, and returns the result
line's dict.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from skybench import work
from skybench.trace import Trace

__all__ = ["ROOT", "BENCH", "load_bench", "cell_entry", "load_config",
           "load_traffic", "load_limits", "load_reader", "load_family",
           "load_kind", "driver_class", "Context", "run_cell",
           "forbidden_modules", "port_config"]

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
_LOADED: Dict[str, object] = {}


def load_bench(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_entry(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def _json(kind: str, name: str, base: Path) -> Dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    return json.loads(path.read_text())


def load_config(name: str, base: Path = BENCH) -> Dict:
    return _json("configs", name, base)


def load_traffic(name: str, base: Path = BENCH) -> Dict:
    return _json("traffic", name, base)


def load_limits(cell: str, base: Path = BENCH) -> Dict[str, float]:
    return _json("limits", cell, base)["limits"]


def _module(kind: str, name: str, base: Path):
    path = base / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"skybench_{kind}_{name}".replace(".", "_").replace("/", "_"), path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str, base: Path = BENCH):
    """The ``read`` function of ``layer_metrics/<metric>.py``."""
    return _module("layer_metrics", metric, base).read


def _module_once(kind: str, name: str, base: Path):
    key = str(base / kind / f"{name}.py")
    if key not in _LOADED:
        _LOADED[key] = _module(kind, name, base)
    return _LOADED[key]


def load_family(config: Dict, base: Path = BENCH):
    """The module ``families/<family>.py`` of ``config`` (``snn`` where
    the file names no ``family``), loaded once a path."""
    return _module_once("families", config.get("family", "snn"), base)


def load_kind(name: str, base: Path = BENCH):
    """The module ``reference/kinds/<name>.py`` of a language model's
    mixer or FFN kind, loaded once a path."""
    return _module_once("reference/kinds", name, base)


def port_config(config: Dict, base: Path = BENCH):
    """The port's config of ``config``, checked by its family against
    every width of the file."""
    return load_family(config, base).port_config(config)


def driver_class(config: Dict, traffic: Dict, base: Path = BENCH):
    """The driver of ``traffic``'s mode in ``config``'s family."""
    modes = load_family(config, base).MODES
    if traffic["mode"] not in modes:
        raise KeyError(f"mode {traffic['mode']!r} is not one of family "
                       f"{config.get('family', 'snn')!r}'s: {sorted(modes)}")
    return modes[traffic["mode"]]


def forbidden_modules(names=None) -> list:
    """Top-level names among ``names`` (default: the loaded modules) that
    the port's run must not hold, compared whole: ``repro_torch`` is not
    ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a driver and a metric reader see of the run."""

    cell: Dict
    config: Dict
    traffic: Dict
    model: Dict
    cfg: object                        # the port's config
    seed: int
    device: torch.device
    trace: Trace


def _metrics_for(bench: Dict, kind: str, cell: str):
    return [m for m in bench[kind]
            if cell in m.get("workloads", [w["name"]
                                           for w in bench["workloads"]])]


def _device_info(device: torch.device, peak: int) -> Dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": 0}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda",
             bench: Optional[Dict] = None, base: Path = BENCH,
             cfg=None, model_override: Optional[Dict] = None,
             traffic_override: Optional[Dict] = None,
             limits: Optional[Dict[str, float]] = None,
             log=None) -> Dict:
    """One run; returns the result line's dict.  ``cfg``,
    ``model_override``, ``traffic_override`` and ``limits`` replace what
    the files say (the tests' narrowed networks)."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    bench = bench if bench is not None else load_bench(base.parent)
    cell = cell_entry(bench, workload)
    config = load_config(cell["config"], base)
    traffic = {**load_traffic(cell["traffic"], base),
               **(traffic_override or {})}
    model = {**config["model"], **(model_override or {})}
    dev = torch.device(device)
    ctx = Context(cell=cell, config=config, traffic=traffic, model=model,
                  cfg=cfg if cfg is not None else port_config(config, base),
                  seed=int(seed), device=dev, trace=Trace(trace, dev))
    limits = limits if limits is not None else load_limits(workload, base)
    drv = driver_class(config, traffic, base)(ctx)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    drv.setup()
    setup_s = time.perf_counter() - t_start
    ctx.trace.warm()
    e2e = drv.window(float(seconds))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    reading = ctx.trace.read()
    drv.release()

    numbers = drv.check()
    checks = {k: {"value": float(numbers[k]), "limit": float(v)}
              for k, v in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    attempted = int(drv.readings["attempted"])
    failed = int(getattr(drv, "failed", 0))

    e2e["setup_s"] = setup_s
    metrics: Dict[str, Dict] = {}
    if not trace:
        for m in _metrics_for(bench, "end_to_end", workload):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
    else:
        run = Run(ctx, drv, reading)
        for m in _metrics_for(bench, "per_layer", workload):
            v = load_reader(m["name"], base)(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": _device_info(dev, peak)}
    if trace and reading is not None:
        result["device"]["busy_s"] = reading.busy_s
        result["device"]["window_s"] = reading.window_s
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in reading.device_ops],
            "idle_gaps": [[k, v] for k, v in reading.idle_gaps]}
    result["checks"] = checks
    r = drv.readings
    if "firing" in r:
        log(f"firing per conv layer (spikes per neuron and step): "
            f"{[round(f, 6) for f in r['firing']]}")
    for key in ("late_p95_ms", "late_max_ms", "occupied_experts"):
        if key in r:
            log(f"{key}: {r[key]}")
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    return result


class Run:
    """What a per-layer metric reader reads: the trace, the driver's
    readings and the work of the window and of its traced part."""

    def __init__(self, ctx: Context, driver, reading):
        self.ctx = ctx
        self.driver = driver
        self.trace = reading
        self.readings = driver.readings
        self.mode = ctx.traffic["mode"]

    def roofline(self) -> Optional[float]:
        """Least time of the traced stretch's work over its device-busy
        time, in %; None where the device did nothing."""
        if self.trace is None or self.trace.busy_s <= 0:
            return None
        least = work.least_seconds(self.readings["work_traced"])
        return 100.0 * least / self.trace.busy_s

    def mfu(self) -> Optional[float]:
        """The window's operations over its seconds at the peak, in %."""
        if self.ctx.device.type != "cuda":
            return None
        flops = work.total(self.readings["work_window"]).flops
        return 100.0 * flops / (self.readings["window_s"] * work.PEAK_FLOPS)

    def mfu_batches(self) -> Optional[float]:
        """The operations of the engine's micro-batches after the warm-up
        over the seconds in which one was in flight on a lane (the union
        of their ``batch_done`` service intervals) at the peak, in %."""
        events = getattr(self.driver, "events", None)
        if self.ctx.device.type != "cuda" or not events:
            return None
        want = set(self.readings["rids"])
        t0 = min(e.ts for e in events if e.kind == "submit" and e.rid in want)
        done = [e for e in events if e.kind == "batch_done" and e.ts >= t0]
        if not done:
            return None
        frames = sum(e.get("n") for e in done)
        per_frame = work.total(work.infer_work(
            self.ctx.model, self.readings["taps_per_frame"], 1.0, 0.0)).flops
        from skybench.trace import union_gaps
        lo = min(e.ts - e.get("svc") for e in done)
        hi = max(e.ts for e in done)
        busy, _ = union_gaps([(e.ts - e.get("svc"), e.ts) for e in done],
                             lo, hi)
        return 100.0 * frames * per_frame / (busy * work.PEAK_FLOPS)

    def idle(self) -> Optional[float]:
        if self.trace is None or self.trace.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)
