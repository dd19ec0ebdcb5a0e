"""The port's entry points against the reference, on the CPU: the data
iterators and ``skew_channels`` bit for bit; the trace exporter's output
equal to the reference's on the same events, and byte-identical trace
files from two virtual-clock engine replays; ``obs.log``; both launchers on
the facade (``--spec-file`` kind errors in the reference's words, a spec
file giving the flag path's bits, ``--trace-out``); and the four examples
on the reference's weights (``from_jax_params``): the Fig. 7 ablation's and
Table I's spike counts exactly and their performance-model numbers to
1e-9 relative of the reference's own pipeline
(``repro.core.snn_model.skew_channels``, ``build_schedule``,
``repro.perfmodel.simulate_network``).
"""
import argparse
import dataclasses
import importlib.util
import io
import json
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jx_api
import repro.data.synthetic as jx_data
import repro.obs.export as jx_export
import repro.obs.log as jx_log
import repro.obs.trace as jx_trace
import repro_torch.api as api
import repro_torch.data.synthetic as data
import repro_torch.obs.export as export
import repro_torch.obs.log as obs_log
import repro_torch.obs.trace as trace
from repro.config import get_snn
from repro.core import aprc as jx_aprc
from repro.core import build_schedule as jx_build_schedule
from repro.core import init_snn as jx_init_snn
from repro.core import snn_apply as jx_snn_apply
from repro.core.snn_model import skew_channels as jx_skew_channels
from repro.perfmodel import XC7Z045 as JX_HW
from repro.perfmodel import simulate_network as jx_simulate
from repro_torch.core.snn_model import init_snn, skew_channels
from repro_torch.core.snn_train import make_train_step
from repro_torch.interop import from_jax_params, to_numpy_params
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.serving import EngineConfig, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-9          # performance-model numbers, relative


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jx_params(cfg, key=0):
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        jx_init_snn, static_argnums=1)(jax.random.PRNGKey(key), cfg))


def _tiny_cfg(**over):
    return dataclasses.replace(
        get_snn("snn-mnist"), input_hw=(8, 8), conv_channels=(8, 8),
        timesteps=2, num_spe_clusters=4, **over)


@pytest.fixture
def quiet_logging():
    """Restore the port's root logger after a test configures it."""
    root = logging.getLogger("repro_torch")
    state = (root.level, list(root.handlers), root.propagate)
    subs = {n: logging.getLogger(n).level
            for n in ("repro_torch.serve", "repro_torch.train")}
    yield
    root.setLevel(state[0])
    root.handlers[:] = state[1]
    root.propagate = state[2]
    for n, lvl in subs.items():
        logging.getLogger(n).setLevel(lvl)


# -- data ----------------------------------------------------------------------

ITERATORS = {
    "token": lambda mod, seed: mod.token_batches(50, 3, 7, seed=seed),
    "digit": lambda mod, seed: mod.digit_batches(4, seed=seed),
    "road": lambda mod, seed: mod.road_batches(2, seed=seed),
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(ITERATORS))
def test_iterators_match_the_reference(name, seed):
    got, want = (ITERATORS[name](mod, seed) for mod in (data, jx_data))
    for _ in range(3):
        a, b = next(got), next(want)
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("sigma, seed", [(1.2, 1), (0.5, 7)])
@pytest.mark.parametrize("model", ["snn-mnist", "snn-seg"])
def test_skew_channels_matches_the_reference(model, sigma, seed):
    cfg = get_snn(model)
    np_params = _jx_params(cfg)
    want = jax.tree_util.tree_map(
        np.asarray, jx_skew_channels(np_params, sigma=sigma, seed=seed))
    params = from_jax_params(np_params, device="cpu")
    got = skew_channels(params, sigma=sigma, seed=seed)
    assert all(p["w"].device.type == "cpu" for p in got["conv"])
    assert got["dense"] is params["dense"]
    got = to_numpy_params(got)
    for kind in ("conv", "dense"):
        for g, w in zip(got[kind], want[kind]):
            for k in ("w", "b"):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


# -- obs.export, obs.log ---------------------------------------------------------

def _emit_sequence(mod):
    """One engine-like event sequence on a recorder of ``mod``: two lanes'
    micro-batches, a dispatch with no end, a batch end with no dispatch,
    terminal events with and without a lane, and scheduler events."""
    rec = mod.TraceRecorder()
    for rid in range(4):
        rec.emit(mod.KIND_SUBMIT, t=0.001 * rid, rid=rid)
    rec.emit(mod.KIND_WINDOW, t=0.004, n=4)
    rec.emit(mod.KIND_ADMIT, t=0.004, n=3, balance=0.875)
    rec.emit(mod.KIND_DISPATCH, t=0.005, lane=0, n=2, rids=(0, 1),
             timesteps=3)
    rec.emit(mod.KIND_DISPATCH, t=0.005, lane=1, n=1, rids=(2,),
             timesteps=3)
    rec.emit(mod.KIND_REJECT, t=0.005, rid=3, reason="slo")
    rec.emit(mod.KIND_BATCH_DONE, t=0.0071, lane=0, wall=0.0021)
    rec.emit(mod.KIND_COMPLETE, t=0.0071, lane=0, rid=0)
    rec.emit(mod.KIND_COMPLETE, t=0.0071, lane=0, rid=1)
    rec.emit(mod.KIND_BATCH_DONE, t=0.008, lane=0, wall=0.001)
    rec.emit(mod.KIND_LANE_DEATH, t=0.009, lane=1, error="crash")
    rec.emit(mod.KIND_FAILED, t=0.009, rid=2)
    rec.emit(mod.KIND_ROUND, t=0.01, served=2)
    rec.emit(mod.KIND_DRAIN, t=0.011)
    return rec


@pytest.mark.parametrize("limit", [None, 3, 100])
def test_exporter_matches_the_reference(limit):
    got, want = _emit_sequence(trace), _emit_sequence(jx_trace)
    assert export.chrome_trace(got) == jx_export.chrome_trace(want)
    assert export.chrome_trace(got.events()) == jx_export.chrome_trace(want)
    assert (export.render_timeline(got, limit=limit)
            == jx_export.render_timeline(want, limit=limit))


def test_exporter_writes_the_reference_file(tmp_path):
    n = export.write_chrome_trace(_emit_sequence(trace), tmp_path / "a.json")
    m = jx_export.write_chrome_trace(_emit_sequence(jx_trace),
                                     tmp_path / "b.json")
    assert n == m
    assert ((tmp_path / "a.json").read_bytes()
            == (tmp_path / "b.json").read_bytes())


def _traced_replay(params, cfg, path, chunk):
    eng = ServingEngine(params, cfg, EngineConfig(
        backend="hopper", num_lanes=2, max_batch=4, device="cpu",
        trace=True, chunk_timesteps=chunk,
        service_time_fn=lambda lane, wall, t: 0.002 * (1 + lane) * t))
    frames = np.random.default_rng(2).random(
        (10, *cfg.input_hw, cfg.input_channels), dtype=np.float32)
    for i, f in enumerate(frames):
        eng.submit(f, arrival=0.0007 * i)
    eng.run()
    export.write_chrome_trace(eng.trace, path)
    return eng


@pytest.mark.parametrize("chunk", [None, 1])
def test_engine_replays_write_identical_trace_files(tmp_path, chunk):
    cfg = _tiny_cfg()
    params = init_snn(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = _traced_replay(params, cfg, tmp_path / "a.json", chunk)
    _traced_replay(params, cfg, tmp_path / "b.json", chunk)
    raw = (tmp_path / "a.json").read_bytes()
    assert raw == (tmp_path / "b.json").read_bytes()
    events = json.loads(raw)["traceEvents"]
    ph = [e["ph"] for e in events]
    assert ph.count("X") == len(eng.trace.events("dispatch"))
    assert ph.count("s") == ph.count("f") == 10


def test_log_levels_match_the_reference(quiet_logging):
    assert obs_log.LOG_LEVELS == jx_log.LOG_LEVELS
    assert obs_log.get_logger().name == "repro_torch"
    assert obs_log.get_logger("serve").name == "repro_torch.serve"
    with pytest.raises(ValueError) as got:
        obs_log.configure_logging("loud")
    with pytest.raises(ValueError) as want:
        jx_log.configure_logging("loud")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("level", obs_log.LOG_LEVELS)
def test_configure_logging_sets_levels(quiet_logging, level):
    root = logging.getLogger("repro_torch")
    root.handlers[:] = []
    buf = io.StringIO()
    assert obs_log.configure_logging(level, {"serve": "error"},
                                     stream=buf) is root
    obs_log.configure_logging(level, stream=io.StringIO())   # idempotent
    assert len(root.handlers) == 1 and not root.propagate
    assert root.level == getattr(logging, level.upper())
    assert obs_log.get_logger("serve").level == logging.ERROR
    obs_log.get_logger("train").info("step %d", 3)
    obs_log.get_logger("serve").warning("dropped")
    out = buf.getvalue()
    assert ("repro_torch.train I step 3" in out) == (level in ("debug",
                                                               "info"))
    assert "dropped" not in out


# -- the launchers ---------------------------------------------------------------

def _write(path, spec):
    path.write_text(json.dumps(spec.to_dict()))
    return str(path)


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_spec_file_kind_errors_use_the_reference_words(tmp_path, launcher,
                                                       quiet_logging):
    """A spec file of the other kind, written by the reference's specs,
    exits with the reference launcher's message."""
    from repro.launch import serve as jx_serve
    from repro.launch import train as jx_train
    wrong = (jx_api.TrainSpec() if launcher == "serve"
             else jx_api.ServeSpec())
    path = _write(tmp_path / "spec.json", wrong)
    ref_fn = jx_serve.serve_snn if launcher == "serve" else jx_train.train_snn
    with pytest.raises(SystemExit) as want:
        ref_fn(argparse.Namespace(spec_file=path))
    main = (serve_launcher if launcher == "serve" else train_launcher).main
    with pytest.raises(SystemExit) as got:
        main(["--spec-file", path, "--device", "cpu",
              "--log-level", "error"])
    assert str(got.value) == str(want.value)


def test_train_spec_file_gives_the_flag_path_losses(tmp_path, quiet_logging):
    path = _write(tmp_path / "train.json",
                  api.TrainSpec(backend="hopper", lr=1e-2, timesteps=2))
    common = ["--steps", "3", "--batch", "4", "--device", "cpu",
              "--log-level", "error"]
    by_file = train_launcher.main(["--spec-file", path] + common)
    by_flags = train_launcher.main(["--backend", "hopper", "--lr", "1e-2",
                                    "--timesteps", "2"] + common)
    cfg = dataclasses.replace(get_snn("snn-mnist"), timesteps=2)
    params = init_snn(torch.Generator().manual_seed(0), cfg, device="cpu")
    mom = jax.tree_util.tree_map(torch.zeros_like, params)
    step = make_train_step(cfg, spec=api.TrainSpec(backend="hopper",
                                                   lr=1e-2))
    raw = []
    for i in range(3):
        x, y = (torch.from_numpy(a) for a in data.mnist_like(4, seed=i))
        params, mom, loss = step(params, mom, x, y)
        raw.append(float(loss))
    assert by_file["losses"] == by_flags["losses"] == raw
    assert by_file["accuracy"] == by_flags["accuracy"]


def test_serve_spec_file_predictions_equal_session_infer(tmp_path,
                                                         quiet_logging):
    spec = api.ServeSpec(backend="hopper", schedule_mode="aprc+cbws")
    path = _write(tmp_path / "serve.json", spec)
    common = ["--batch", "3", "--steps", "2", "--device", "cpu",
              "--log-level", "error"]
    by_file = serve_launcher.main(["--spec-file", path] + common)
    by_flags = serve_launcher.main(["--schedule", "aprc+cbws"] + common)
    cfg = get_snn("snn-mnist")
    rng = np.random.default_rng(0)
    frames = [rng.random((3, 28, 28, 1), dtype=np.float32)
              for _ in range(3)][-1]
    want = api.Session(cfg, spec, device="cpu").infer(frames).logits
    for r in (by_file, by_flags):
        np.testing.assert_array_equal(r["logits"], want)
        np.testing.assert_array_equal(r["predictions"], want.argmax(-1))
        assert r["frames"] == 6 and r["schedule"] == "aprc+cbws"


def test_serve_launcher_writes_the_engine_trace(tmp_path, quiet_logging):
    path = _write(tmp_path / "serve.json",
                  api.ServeSpec(backend="hopper", schedule_mode="aprc+cbws",
                                max_batch=4))
    out = tmp_path / "trace.json"
    s = serve_launcher.main(["--spec-file", path, "--engine", "--steps", "3",
                             "--trace-out", str(out), "--device", "cpu",
                             "--log-level", "error"])
    events = json.loads(out.read_text())["traceEvents"]
    ph = [e["ph"] for e in events]
    assert s["served"] == 12 and s["trace_events"] == len(events)
    assert ph.count("X") == s["micro_batches"] > 0
    assert ph.count("s") == ph.count("f") == 12
    assert s["trace_write_ms"] >= 0.0


# -- the examples ------------------------------------------------------------------

SIM_HW, SIM_T, SIM_FRAMES = (20, 40), 3, 2


@pytest.fixture(scope="module")
def sim_reference():
    """The reference's Fig. 7 pipeline (its example's and
    ``tests/test_system.py``'s) at a reduced frame and T."""
    base = dataclasses.replace(get_snn("snn-seg"), input_hw=SIM_HW)
    np_params = _jx_params(base)
    frames, _ = jx_data.road_like(SIM_FRAMES, h=SIM_HW[0], w=SIM_HW[1],
                                  seed=0)
    modes = {}
    for mode in ("none", "cbws", "aprc+cbws"):
        cfg = dataclasses.replace(base, aprc=(mode == "aprc+cbws"),
                                  timesteps=SIM_T)
        params = jx_skew_channels(np_params, sigma=1.2, seed=1)
        out = jx_snn_apply(params, jnp.asarray(frames), cfg,
                           backend="batched")
        b, h, w, c = frames.shape
        per_layer = [np.full((SIM_T, c), float(b * h * w) / c)] + [
            np.asarray(out.timestep_counts[l])
            for l in range(len(cfg.conv_channels) - 1)]
        scheds = jx_build_schedule(params, cfg,
                                   "none" if mode == "none" else "aprc+cbws")
        perf = jx_simulate(cfg, per_layer, [s.in_partition for s in scheds],
                           [s.out_partition for s in scheds], JX_HW)
        modes[mode] = {"balance": perf.balance_spartus,
                       "barrier_balance": perf.balance,
                       "fps": perf.fps(JX_HW),
                       "mj_per_frame": perf.energy_j(JX_HW) * 1e3,
                       "timestep_counts": per_layer[1:]}
    return base, np_params, modes


@pytest.mark.parametrize("backend", ["batched", "hopper"])
def test_accelerator_sim_matches_the_reference(sim_reference, backend):
    base, np_params, want = sim_reference
    sim = _example("snn_accelerator_sim")
    got = sim.simulate(base, params=from_jax_params(np_params, device="cpu"),
                       frames=SIM_FRAMES, timesteps=SIM_T, backend=backend,
                       device="cpu")
    for mode, w in want.items():
        g = got["modes"][mode]
        for a, b in zip(g["timestep_counts"], w["timestep_counts"]):
            np.testing.assert_array_equal(a, b)
        for k in ("balance", "barrier_balance", "fps", "mj_per_frame"):
            assert g[k] == pytest.approx(w[k], rel=REL), (mode, k)
    # the reference's own ordering at this size: CBWS alone beats APRC+CBWS
    for r in (got["modes"], want):
        assert r["cbws"]["balance"] > r["aprc+cbws"]["balance"]
    assert got["gain"] == pytest.approx(
        want["aprc+cbws"]["fps"] / want["none"]["fps"], rel=REL)


@pytest.fixture(scope="module")
def mnist_reference():
    cfg = dataclasses.replace(get_snn("snn-mnist"), timesteps=3)
    np_params = _jx_params(cfg)
    frames = jx_data.mnist_like(512, seed=10_000)[0][:64]
    out = jx_snn_apply(np_params, jnp.asarray(frames), cfg, backend="batched")
    n, h, w, c = frames.shape
    per_layer = [np.full((3, c), float(h * w) / c)] + [
        np.asarray(out.timestep_counts[l]) / n
        for l in range(len(cfg.conv_channels) - 1)]
    table1 = {}
    for mode in ("none", "aprc+cbws"):
        scheds = jx_build_schedule(np_params, cfg, mode)
        perf = jx_simulate(cfg, per_layer, [s.in_partition for s in scheds],
                           [s.out_partition for s in scheds], JX_HW)
        table1[mode] = {"balance": perf.balance, "kfps": perf.fps(JX_HW) / 1e3,
                        "uj_per_img": perf.energy_j(JX_HW) * 1e6,
                        "gsops": perf.gsops(JX_HW)}
    spearman = {}
    for l in range(1, len(cfg.conv_channels)):
        mags = np.maximum(jx_aprc.filter_magnitudes(
            np_params["conv"][l]["w"]), 0)
        spearman[l] = jx_aprc.proportionality(
            mags, np.asarray(out.spike_counts[l]))["spearman"]
    return cfg, np_params, table1, spearman


@pytest.mark.parametrize("backend", ["batched", "hopper"])
def test_snn_mnist_pipeline_matches_the_reference(mnist_reference, backend):
    cfg, np_params, table1, spearman = mnist_reference
    got = _example("snn_mnist_train").run(
        cfg, params=from_jax_params(np_params, device="cpu"), steps=0,
        timesteps=3, backend=backend, device="cpu")
    assert got["losses"] == [] and 0.0 <= got["accuracy"] <= 1.0
    for mode, row in table1.items():
        for k, v in row.items():
            assert got["table1"][mode][k] == pytest.approx(v, rel=REL), \
                (mode, k)
    assert got["spearman"].keys() == spearman.keys()
    for l, v in spearman.items():
        assert got["spearman"][l] == pytest.approx(v, rel=REL)


def test_quickstart_trains_and_serves_bit_identically(quiet_logging):
    cfg = get_snn("snn-mnist")
    r = _example("quickstart").run(
        cfg, params=from_jax_params(_jx_params(cfg), device="cpu"),
        steps=40, batch=16, timesteps=2, device="cpu")
    assert r["losses"][-1] < r["losses"][0]
    assert r["live"]["served"] == 24
    assert 0.0 <= r["live_accuracy"] <= 1.0


@pytest.mark.parametrize("backend", ["batched", "hopper"])
def test_serve_batched_matches_the_reference(backend):
    cfg = _tiny_cfg()
    np_params = _jx_params(cfg)
    frames = np.random.default_rng(1).random((3, 8, 8, 1), dtype=np.float32)
    got = _example("serve_batched").serve_snn_batched(
        cfg, params=from_jax_params(np_params, device="cpu"), frames=frames,
        backend=backend, device="cpu")
    assert set(got["outputs"]) == {"ref", backend}
    for b, out in got["outputs"].items():
        want = jx_snn_apply(np_params, jnp.asarray(frames), cfg,
                            backend="ref" if b == "ref" else "batched")
        np.testing.assert_allclose(out.logits, np.asarray(want.logits),
                                   atol=1e-5, rtol=0)
        for a, w in zip(out.spike_counts, want.spike_counts):
            np.testing.assert_array_equal(a, np.asarray(w))


def test_serve_batched_threaded_serves_the_burst():
    cfg = _tiny_cfg()
    got = _example("serve_batched").serve_snn_threaded(
        cfg, params=from_jax_params(_jx_params(cfg), device="cpu"),
        batch=2, device="cpu")
    assert set(got["frames_per_s"]) == {"1-thread", "threaded"}
    assert all(0.0 < b <= 1.0 for b in got["request_balance"].values())
