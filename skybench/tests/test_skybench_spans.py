"""The readers of the program's spans (``stage_ms``, ``launch_ms``,
``readback_ms``, ``counts_ms``, ``wgrad_ms``) on a traced run of every cell
that reports one, on the CPU: numbers where the spans time the host,
nothing where they time the device (there is none), and nothing from a
program without spans.  The traced run records from its window's start,
so a loaded machine cannot leave its one long call untraced."""
import sys
import types

import pytest

from repro_torch import obs

from skybench import drivers, harness
from skybench.tests._tiny import run_tiny

BENCH = harness.load_bench()
SPAN_METRICS = [m for m in BENCH["per_layer"]
                if m["source"] == "program_span"]
DEVICE_TIMED = {"counts_ms.infer", "wgrad_ms.train"}


def test_the_span_metrics_are_declared():
    assert {m["name"] for m in SPAN_METRICS} >= {
        "stage_ms.infer", "launch_ms.infer", "readback_ms.infer",
        "counts_ms.infer", "launch_ms.train", "wgrad_ms.train"}


SPAN_CELLS = [w["name"] for w in BENCH["workloads"]
              if any(w["name"] in m["workloads"] for m in SPAN_METRICS)]


@pytest.mark.parametrize("cell", SPAN_CELLS)
def test_traced_run_reads_the_programs_spans(cell, monkeypatch):
    obs.reset_spans()
    # the profiler starts before the window's first call, which it then
    # traces however long the call takes
    monkeypatch.setattr(drivers, "TRACE_AFTER_S", 0.0)
    res = run_tiny(cell, trace=True, seconds=2.0)
    assert res["correct"], res["checks"]
    want = {m["name"] for m in SPAN_METRICS if cell in m["workloads"]}
    assert want
    for name in want - DEVICE_TIMED:
        assert res["metrics"][name]["value"] > 0, name
        assert res["metrics"][name]["unit"] == "ms"
    for name in want & DEVICE_TIMED:
        assert name not in res["metrics"], name          # no device here
    calls = obs.read_spans().totals
    roots = [n for n in ("repro_torch.infer", "repro_torch.train_step")
             if n in calls]
    assert len(roots) == 1 and calls[roots[0]].count > 0


@pytest.mark.parametrize("metric", [m["name"] for m in SPAN_METRICS])
def test_a_reader_gives_nothing_without_spans(metric, monkeypatch):
    read = harness.load_reader(metric)
    run = types.SimpleNamespace(
        mode="closed_train" if metric.endswith(".infer") else
        "closed_infer", trace=object(), readings={})
    assert read(run) is None                             # another mode
    run.mode = "closed_infer" if metric.endswith(".infer") else \
        "closed_train"
    monkeypatch.setitem(sys.modules, "repro_torch.obs",
                        types.ModuleType("repro_torch.obs"))
    assert read(run) is None                             # no read_spans
