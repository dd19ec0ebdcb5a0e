"""Every cell run end to end on the CPU at a narrowed size through the
port's plain paths (a rehearsal of the card's run), the output check
failing on a broken program and on the control, and a cell, a traffic mix
and a per-layer metric added as files alone."""
import json
import shutil

import numpy as np
import pytest
import torch

from skybench import harness
from skybench.data.weights import make_weights
from skybench.drivers import DRIVERS
from skybench.faults import planted
from skybench.inputs import draw_frames
from skybench.tests._tiny import run_tiny
from skybench.trace import Trace

# the open-loop engine cell is kept as files (its traffic mix, limits and
# readers) for a later benchmark change to declare: the tests run it too
BENCH = harness.load_bench()
BENCH["workloads"].append({"name": "seg-engine-poisson", "config": "snn-seg",
                           "traffic": "poisson_road", "chips": 1,
                           "why": "road cameras into the live engine"})
BENCH["end_to_end"].append({"name": "p95_ms", "unit": "ms", "better": "lower",
                            "bound": 0.25, "source": "host_clock",
                            "workloads": ["seg-engine-poisson"]})
for _name, _unit in (("queue_ms.engine", "ms"), ("balance.engine", "ratio"),
                     ("idle.engine", "%")):
    BENCH["per_layer"].append({"name": _name, "unit": _unit,
                               "better": "lower", "source": "program_span",
                               "layer": "serving engine", "moves": "p95_ms",
                               "workloads": ["seg-engine-poisson"]})
CELLS = [w["name"] for w in BENCH["workloads"]]


def _mode(cell):
    w = harness.cell_entry(BENCH, cell)
    return harness.load_traffic(w["traffic"])["mode"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell):
    res = run_tiny(cell, bench=BENCH)
    assert res["correct"], res["checks"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["checks"]) == set(harness.load_limits(cell))
    json.dumps(res)


def test_traced_engine_run_reads_the_engine_trace():
    res = run_tiny("seg-engine-poisson", bench=BENCH, trace=True,
                   seconds=0.6)
    assert res["correct"]
    assert res["metrics"]["queue_ms.engine"]["value"] >= 0
    assert "p95_ms" not in res["metrics"]


def test_traced_run_reports_per_layer_metrics_and_a_breakdown():
    res = run_tiny("mnist-infer-digits", trace=True, seconds=0.4)
    assert res["correct"]
    assert "launches.infer" in res["metrics"]
    assert "infer_fps" not in res["metrics"]
    dev = res["device"]
    assert dev["window_s"] > 0 and dev["busy_s"] >= 0
    gaps = res["breakdown"]["idle_gaps"]
    assert gaps and gaps[0][0] == "skybench.infer"


FAULTS = [(c, "altered_answer") for c in CELLS
          if _mode(c) in ("closed_infer", "open_loop")] + \
         [(c, f) for c in CELLS if _mode(c) == "closed_train"
          for f in ("unchanged_state", "half_batch")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_program_is_not_correct(cell, fault):
    with planted(fault):
        res = run_tiny(cell, bench=BENCH)
    assert not res["correct"], res["checks"]


def _driver(cell, seed=3, **mix):
    """A driver of ``cell`` at its published widths with its inputs and
    weights made, as its set-up makes them, and no program."""
    w = harness.cell_entry(BENCH, cell)
    config = harness.load_config(w["config"])
    traffic = {**harness.load_traffic(w["traffic"]), **mix}
    dev = torch.device("cpu")
    ctx = harness.Context(cell=w, config=config, traffic=traffic,
                          model=config["model"], cfg=None, seed=seed,
                          device=dev, trace=Trace(False, dev))
    drv = DRIVERS[traffic["mode"]](ctx)
    params = drv.weights()
    drv.ref_params = params
    model = config["model"]
    if traffic["mode"] == "closed_infer":
        drv.pool = [draw_frames(traffic["frames"], traffic["batch"], model,
                                seed)[0]]
    elif traffic["mode"] == "open_loop":
        drv.frames = draw_frames(traffic["frames"], traffic["pool_frames"],
                                 model, seed)[0]
    else:
        x, y = draw_frames(traffic["frames"], 3 * traffic["batch"], model,
                           seed)
        b = traffic["batch"]
        drv.pool = [(x[i * b:(i + 1) * b], y[i * b:(i + 1) * b])
                    for i in range(3)]
    return drv


CONTROL = {"mnist-infer-digits": dict(batch=64, ref_block=64),
           "mnist-infer-dense": dict(batch=64, ref_block=64),
           "seg-infer-road": dict(batch=4, ref_block=4),
           "seg-engine-poisson": dict(pool_frames=4, ref_block=4),
           "mnist-train-digits": dict(batch=32)}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The reference in TF32 in the program's place fails one of the
    cell's limits (at the published widths, a smaller batch)."""
    limits = harness.load_limits(cell)
    nums = _driver(cell, **CONTROL[cell]).controlled()
    assert any(nums[k] > v for k, v in limits.items() if k in nums), nums


def test_a_cell_added_as_files_alone(tmp_path):
    """A new traffic mix, cell, limits file and per-layer metric: files
    and entries, no edit to the harness."""
    base = tmp_path / "skybench"
    for part in ("configs", "traffic", "limits", "layer_metrics"):
        shutil.copytree(harness.BENCH / part, base / part)
    (base / "traffic" / "bulk_small.json").write_text(json.dumps(
        {"mode": "closed_infer", "frames": "digits", "batch": 2,
         "pool_batches": 3, "ref_block": 2}))
    (base / "limits" / "mnist-infer-small.json").write_text(json.dumps(
        {"limits": {"count_gap": 1e-4, "logit_p99": 0.04}}))
    (base / "layer_metrics" / "calls.small.py").write_text(
        "def read(run):\n    return float(run.readings['calls_window'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "mnist-infer-small",
                               "config": "snn-mnist", "traffic": "bulk_small",
                               "chips": 1, "why": "a cell made of data"})
    for m in bench["end_to_end"]:
        if m["name"] in ("infer_fps",):
            m["workloads"].append("mnist-infer-small")
    bench["per_layer"].append({"name": "calls.small", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "model", "moves": "infer_fps",
                               "workloads": ["mnist-infer-small"]})
    plain = run_tiny("mnist-infer-small", bench=bench, base=base)
    assert plain["correct"] and "infer_fps" in plain["metrics"]
    traced = run_tiny("mnist-infer-small", bench=bench, base=base,
                      trace=True, seconds=0.3)
    assert traced["metrics"]["calls.small"]["value"] > 0


def test_open_loop_arrivals_are_the_same_set_for_every_seed():
    a = _driver("seg-engine-poisson", seed=1)._arrivals(500, 320.0)
    b = _driver("seg-engine-poisson", seed=2**31 + 9)._arrivals(500, 320.0)
    gaps_a, gaps_b = np.diff(a, prepend=0.0), np.diff(b, prepend=0.0)
    assert np.sort(gaps_a) == pytest.approx(np.sort(gaps_b))
    assert not (a == b).all()
    # the mean gap is the rate's
    assert a[-1] == pytest.approx(b[-1])
    assert a[-1] / 500 == pytest.approx(1 / 320.0, rel=0.02)


def test_weights_are_made_on_the_run_device():
    model = harness.load_config("snn-seg")["model"]
    params = make_weights(model, 1.0, 4, torch.device("cpu"))
    assert [p["w"].shape[-1] for p in params["conv"]] == \
        model["conv_channels"]
    assert params["dense"] == []
