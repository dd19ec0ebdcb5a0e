"""Every cell run end to end on the CPU at a narrowed size through the
port's plain paths (a rehearsal of the card's run), the output check
failing on a broken program and on the control, and a cell, a traffic mix
and a per-layer metric, a whole family of configurations, a family of
event clips through ``ClosedInfer``'s methods, and a second ``snn`` file
cut by the family's rule, added as files alone."""
import json
import shutil
import time

import numpy as np
import pytest
import torch

from skybench import harness
from skybench.data.weights import make_weights
from skybench.faults import planted
from skybench.inputs import draw_frames
from skybench.tests._tiny import run_tiny, tiny, with_kept
from skybench.trace import Trace

# the open-loop engine cell and the decode cell are kept as files (their
# traffic mixes, limits and readers) for a later benchmark change to
# declare: the tests run them too
BENCH = with_kept(harness.load_bench())
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
          for f in ("unchanged_state", "half_batch")] + \
         [(c, f) for c in CELLS if _mode(c) == "closed_decode"
          for f in ("altered_answer", "unwritten_cache", "dropped_choice",
                    "no_shared")]


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
    drv = harness.driver_class(config, traffic)(ctx)
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


@pytest.mark.parametrize("cell", [c for c in CELLS if c in CONTROL])
def test_the_control_is_not_correct(cell):
    """The reference in TF32 in the program's place fails one of the
    cell's limits (at the published widths, a smaller batch)."""
    limits = harness.load_limits(cell)
    nums = _driver(cell, **CONTROL[cell]).controlled()
    assert any(nums[k] > v for k, v in limits.items() if k in nums), nums


def _tiny_decoder(cell, seed):
    """A narrowed decode cell's driver after its set-up, window and
    release on the CPU."""
    w = harness.cell_entry(BENCH, cell)
    config = harness.load_config(w["config"])
    cfg, over, mix = tiny(w["config"], "closed_decode")
    traffic = {**harness.load_traffic(w["traffic"]), **mix}
    dev = torch.device("cpu")
    ctx = harness.Context(cell=w, config=config, traffic=traffic,
                          model={**config["model"], **over}, cfg=cfg,
                          seed=seed, device=dev, trace=Trace(False, dev))
    drv = harness.driver_class(config, traffic)(ctx)
    drv.setup()
    drv.window(0.2)
    drv.release()
    return drv


@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if _mode(c) == "closed_decode"])
@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_the_decode_control_is_not_correct(cell, seed):
    """The reference in float8 products in the program's place fails one
    of the cell's limits (at the narrowed size: the published one needs
    the card)."""
    limits = harness.load_limits(cell)
    drv = _tiny_decoder(cell, seed)
    sound = drv.check()
    assert all(sound[k] <= v for k, v in limits.items()), sound
    nums = drv.controlled()
    assert any(nums[k] > v for k, v in limits.items()), nums


def _copy_of_the_files(tmp_path):
    base = tmp_path / "skybench"
    for part in ("configs", "traffic", "limits", "layer_metrics",
                 "families"):
        shutil.copytree(harness.BENCH / part, base / part)
    return base


def test_a_cell_added_as_files_alone(tmp_path):
    """A new traffic mix, cell, limits file and per-layer metric: files
    and entries, no edit to the harness."""
    base = _copy_of_the_files(tmp_path)
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


TOY_FAMILY = '''"""A toy family: one closed-loop caller of a matrix product,
checked against numpy."""
import time

import numpy as np
import torch

from skybench.drivers import Driver
from skybench.work import LayerWork


def port_config(config):
    return dict(config["model"])


class ClosedProduct(Driver):
    def setup(self):
        n = int(self.model["n"])
        gen = torch.Generator(device=self.device).manual_seed(self.ctx.seed)
        self.a = torch.randn(n, n, generator=gen, device=self.device,
                             dtype=torch.float64)

    def window(self, seconds):
        self.outs, t0 = [], time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.trace_due(t0, seconds)
            with self.span("product"):
                self.outs.append(float(torch.trace(self.a @ self.a)))
        t1 = time.perf_counter()
        self.trace.stop()
        k = len(self.outs)
        self.readings.update(window_s=t1 - t0, attempted=k, products=k)
        return {"products_per_s": k / (t1 - t0)}

    def check(self):
        a = self.a.cpu().numpy()
        want = float(np.trace(a @ a))
        n, k = a.shape[0], self.readings["products"]
        self.readings["work_window"] = [
            LayerWork("product", 2.0 * n ** 3 * k, 8.0 * n * n * k)]
        return {"trace_gap": max(abs(v - want) for v in self.outs)
                / abs(want)}


MODES = {"closed_product": ClosedProduct}
'''


def test_a_family_added_as_files_alone(tmp_path):
    """A configuration of a new family, with its family module, traffic
    mix, cell, limits and per-layer metric: files and entries, no edit to
    the harness."""
    base = _copy_of_the_files(tmp_path)
    (base / "families" / "toy.py").write_text(TOY_FAMILY)
    (base / "configs" / "toy-square.json").write_text(json.dumps(
        {"family": "toy", "model": {"n": 192}, "reduced": []}))
    (base / "traffic" / "products.json").write_text(json.dumps(
        {"mode": "closed_product"}))
    (base / "limits" / "toy-products.json").write_text(json.dumps(
        {"limits": {"trace_gap": 1e-12}}))
    (base / "layer_metrics" / "products.toy.py").write_text(
        "def read(run):\n"
        "    if run.mode != 'closed_product':\n"
        "        return None\n"
        "    return float(run.readings['products'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "toy-square", "source": "a test",
                             "file": "skybench/configs/toy-square.json",
                             "reduced": [], "why": "a family made of data"})
    bench["workloads"].append({"name": "toy-products",
                               "config": "toy-square", "traffic": "products",
                               "chips": 1, "why": "a cell of a new family"})
    bench["end_to_end"].append({"name": "products_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["toy-products"]})
    bench["per_layer"].append({"name": "products.toy", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "model", "moves": "products_per_s",
                               "workloads": ["toy-products"]})
    runs = [harness.run_cell("toy-products", 2**31 + 5, seconds, trace,
                             t_start=time.perf_counter(), device="cpu",
                             bench=bench, base=base, log=lambda s: None)
            for seconds, trace in ((0.3, False), (0.5, True))]
    plain, traced = runs
    assert plain["correct"] and plain["attempted"] > 0, plain
    assert set(plain["metrics"]) == {"products_per_s", "setup_s"}
    assert traced["correct"]
    assert set(traced["metrics"]) == {"products.toy"}
    assert traced["metrics"]["products.toy"]["value"] > 0


CLIP_FAMILY = '''"""A family of spiking networks on event clips (B, T, H, W, C): the
port's ``snn_apply`` on each clip as a spike train, against a plain
forward of this file's own, through ``ClosedInfer``'s window and check."""
import dataclasses
import math
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from skybench.drivers import ClosedInfer
from skybench.inputs import sub_seed
from skybench.work import LayerWork


def port_config(config):
    from repro_torch.config import get_snn
    m = config["model"]
    return dataclasses.replace(
        get_snn(config["snn_config"]), input_hw=tuple(m["input_hw"]),
        input_channels=m["input_channels"],
        conv_channels=tuple(m["conv_channels"]),
        dense_units=tuple(m["dense_units"]), timesteps=m["timesteps"])


def narrow(name, config):
    return port_config(config), {}


class Out(NamedTuple):
    logits: torch.Tensor
    counts: list
    taps: list


def _sides(model):
    h, w = model["input_hw"]
    r = model["kernel_size"]
    out = []
    for _ in model["conv_channels"]:
        h, w = h + r - 1, w + r - 1
        out.append((h, w))
    return out


def _cast(t, control):
    return t.to(torch.bfloat16).float() if control else t


def forward(model, params, clips, control):
    """Each conv layer's membrane over the clip's own steps, reset by
    subtraction; the dense readout's mean over T."""
    x = clips.transpose(0, 1)
    counts, taps = [], []
    for p in params["conv"]:
        r = p["w"].shape[0]
        wt = _cast(p["w"].permute(3, 2, 0, 1), control)
        taps.append(float((x != 0).sum()) * r * r)
        v, out = 0.0, []
        for x_t in x:
            xi = F.pad(x_t.permute(0, 3, 1, 2), (r - 1,) * 4)
            z = F.conv2d(_cast(xi, control), wt).permute(0, 2, 3, 1)
            v = v + z + p["b"]
            s = (v >= model["v_threshold"]).to(v.dtype)
            v = v - model["v_threshold"] * s
            out.append(s)
        x = torch.stack(out)
        counts.append(x.sum(dim=(1, 2, 3)))
    d = params["dense"][0]
    acc = sum(_cast(x_t.reshape(len(x_t), -1), control)
              @ _cast(d["w"], control) + d["b"] for x_t in x)
    return Out(acc / len(x), counts, taps)


class Clips:
    """The program: the port's forward on a clip given as a spike
    train."""

    def __init__(self, cfg, params):
        self.cfg, self.params = cfg, params

    def infer(self, clips):
        from repro_torch.core.snn_model import snn_apply
        x = torch.as_tensor(clips).transpose(0, 1).contiguous()
        with torch.no_grad():
            out = snn_apply(self.params, x, self.cfg, backend="batched")
        return SimpleNamespace(
            logits=out.logits.numpy(),
            timestep_counts=[c.numpy() for c in out.timestep_counts])


class ClosedClips(ClosedInfer):
    SMALL_MIX = dict(batch=3, pool_batches=2, ref_block=2)

    def draw_inputs(self, n):
        m = self.model
        rng = np.random.default_rng(sub_seed(self.ctx.seed, 1))
        shape = (n, m["timesteps"], *m["input_hw"], m["input_channels"])
        x = rng.random(shape) < float(self.mix["density"])
        self.readings["events_per_clip"] = float(x.sum()) / n
        return x.astype(np.float32)

    def weights(self):
        m, r = self.model, self.model["kernel_size"]
        gen = torch.Generator(device=self.device).manual_seed(self.ctx.seed)
        cin, conv = m["input_channels"], []
        for cout in m["conv_channels"]:
            w = torch.randn((r, r, cin, cout), generator=gen,
                            device=self.device)
            conv.append({"w": w * math.sqrt(2.0 / (r * r * cin)),
                         "b": torch.zeros(cout, device=self.device)})
            cin = cout
        h, w = _sides(m)[-1]
        din, dout = h * w * cin, m["dense_units"][0]
        wd = torch.randn((din, dout), generator=gen, device=self.device)
        return {"conv": conv,
                "dense": [{"w": wd * math.sqrt(2.0 / din),
                           "b": torch.zeros(dout, device=self.device)}]}

    def program(self, params):
        return Clips(self.ctx.cfg, params)

    def reference_blocks(self, x, control):
        b = int(self.mix["ref_block"])
        with torch.no_grad():
            outs = [forward(self.model, self.ref_params, x[i:i + b], control)
                    for i in range(0, len(x), b)]
        return Out(torch.cat([o.logits for o in outs]),
                   [sum(o.counts[k] for o in outs)
                    for k in range(len(outs[0].counts))],
                   [sum(o.taps[k] for o in outs)
                    for k in range(len(outs[0].taps))])

    def layer_work(self, taps, frames, calls):
        return [LayerWork(f"conv{i}", 2.0 * t * cout * frames, 0.0)
                for i, (t, cout) in enumerate(
                    zip(taps, self.model["conv_channels"]))]

    def firing(self, refs, n_frames):
        steps = self.model["timesteps"]
        return [sum(float(o.counts[i].sum()) for o in refs)
                / (n_frames * steps * h * w * cout)
                for i, ((h, w), cout) in enumerate(
                    zip(_sides(self.model), self.model["conv_channels"]))]


MODES = {"closed_infer": ClosedClips}
'''


def test_a_clip_family_added_as_files_alone(tmp_path):
    """A family whose driver subclasses ``ClosedInfer`` with its own
    inputs (event clips, B x T x H x W x C), weights, program, reference
    and work, with its configuration, traffic mix, cell, limits and a
    reader: files and entries, run through the rehearsal of the declared
    cells, untraced and traced, where the ``*.infer`` readers read it."""
    base = _copy_of_the_files(tmp_path)
    (base / "families" / "clips.py").write_text(CLIP_FAMILY)
    (base / "configs" / "clip-net.json").write_text(json.dumps(
        {"family": "clips", "snn_config": "snn-mnist", "reduced": [],
         "model": {"input_hw": [10, 10], "input_channels": 2,
                   "conv_channels": [4, 8, 4], "kernel_size": 3,
                   "dense_units": [10], "timesteps": 3,
                   "v_threshold": 1.0, "aprc": True}}))
    (base / "traffic" / "clips_sparse.json").write_text(json.dumps(
        {"mode": "closed_infer", "density": 0.2, "batch": 64,
         "pool_batches": 8, "ref_block": 16}))
    (base / "limits" / "clip-infer.json").write_text(json.dumps(
        {"limits": {"count_gap": 1e-4, "mean_gap": 1.5e-3}}))
    (base / "layer_metrics" / "events.clips.py").write_text(
        "def read(run):\n"
        "    return run.readings.get('events_per_clip')\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "clip-net", "source": "a test",
                             "file": "skybench/configs/clip-net.json",
                             "reduced": [], "why": "a family of clips"})
    bench["workloads"].append({"name": "clip-infer", "config": "clip-net",
                               "traffic": "clips_sparse", "chips": 1,
                               "why": "event clips scored in bulk"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("infer_fps", "launches.infer", "roofline.infer"):
            m["workloads"].append("clip-infer")
    bench["per_layer"].append({"name": "events.clips", "unit": "events",
                               "better": "lower", "source": "host_clock",
                               "layer": "model", "moves": "infer_fps",
                               "workloads": ["clip-infer"]})
    plain = run_tiny("clip-infer", bench=bench, base=base)
    assert plain["correct"] and plain["attempted"] > 0, plain["checks"]
    assert set(plain["metrics"]) == {"infer_fps", "setup_s"}
    assert set(plain["checks"]) == {"count_gap", "mean_gap"}
    traced = run_tiny("clip-infer", bench=bench, base=base, trace=True,
                      seconds=0.3)
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["events.clips"]["value"] > 0
    assert "launches.infer" in traced["metrics"]


@pytest.mark.parametrize("config,traffic,limits", [
    ("snn-mnist", "bulk_digits", "mnist-infer-digits"),
    ("snn-seg", "bulk_road", "seg-infer-road")])
def test_an_snn_file_with_no_narrowing_entry_runs_by_the_rule(
        tmp_path, config, traffic, limits):
    """A second file of a port config, under a name that ``NARROW`` does
    not hold, is cut by the family's rule (sides at most 12, widths at
    most 8, T 3) and runs through the rehearsal: files and entries."""
    base = _copy_of_the_files(tmp_path)
    name, cell = f"{config}-copy", f"{limits}-copy"
    shutil.copy(base / "configs" / f"{config}.json",
                base / "configs" / f"{name}.json")
    shutil.copy(base / "limits" / f"{limits}.json",
                base / "limits" / f"{cell}.json")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": name, "source": "a test",
                             "file": f"skybench/configs/{name}.json",
                             "reduced": [], "why": "a second file"})
    bench["workloads"].append({"name": cell, "config": name,
                               "traffic": traffic, "chips": 1,
                               "why": "a cell of the second file"})
    for m in bench["end_to_end"]:
        if m["name"] == "infer_fps":
            m["workloads"].append(cell)
    cfg, over, _ = tiny(name, "closed_infer", base)
    model = harness.load_config(config)["model"]
    assert over == dict(
        input_hw=[min(s, 12) for s in model["input_hw"]],
        conv_channels=[min(c, 8) for c in model["conv_channels"]],
        timesteps=3)
    assert (list(cfg.input_hw), list(cfg.conv_channels), cfg.timesteps) \
        == (over["input_hw"], over["conv_channels"], 3)
    res = run_tiny(cell, bench=bench, base=base)
    assert res["correct"] and res["attempted"] > 0, res["checks"]


# the narrowed shapes and small mixes that the CPU cases have run at since
# the harness began: the family's ``narrow`` and each mode's ``SMALL_MIX``
# give them again
PARENT_NARROW = {
    "snn-mnist": dict(input_hw=[12, 12], conv_channels=[4, 8, 4],
                      timesteps=3),
    "snn-seg": dict(input_hw=[12, 20], conv_channels=[4, 8, 8, 8, 4, 1],
                    timesteps=3),
}
PARENT_MIX = {
    "closed_infer": dict(batch=4, pool_batches=2, ref_block=4),
    "open_loop": dict(pool_frames=6, rate_per_s=40, warm_requests=4,
                      check_requests=20, max_batch=4),
    "closed_train": dict(batch=4, pool_batches=4),
    "closed_decode": dict(batch=2, prompt_len=8, cache_len=16,
                          warm_steps=1, check_steps=3),
}


@pytest.mark.parametrize("cell", CELLS)
def test_the_narrowed_cells_are_the_parents(cell):
    w = harness.cell_entry(BENCH, cell)
    cfg, over, mix = tiny(w["config"], _mode(cell))
    assert mix == PARENT_MIX[_mode(cell)]
    want = PARENT_NARROW.get(w["config"])
    if want is None:                    # an LM: ``tiny_lm``'s depth
        assert cfg.num_layers == 8 and over["num_hidden_layers"] == 8
        return
    assert over == want
    assert (list(cfg.input_hw), list(cfg.conv_channels), cfg.timesteps) \
        == (want["input_hw"], want["conv_channels"], want["timesteps"])


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
