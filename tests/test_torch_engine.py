"""The port's serving engine held to the reference's own contracts, torch
against torch (tests/test_chunk_parity.py, test_serving_slo.py,
test_serving_faults.py, test_serving_threaded.py, test_obs.py).

Chunk-scheduled serving gives every request the whole-T logits bits;
requests are evicted, degraded and joined at chunk boundaries; pad rows
leave the accumulated spike workload exact; every request resolves exactly
once under seeded chaos, lane restarts and hangs; a virtual-clock replay is
deterministic.  Everything runs on CPU tensors at a tiny width (the hopper
backend through its kernels' plain versions).
"""
import dataclasses
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.config import get_snn
from repro_torch.core import init_snn, snn_apply
from repro_torch.runtime.fault_tolerance import RetryPolicy
from repro_torch.runtime.faults import FaultPlan
from repro_torch.serving import EngineConfig, LaneSupervisor, ServingEngine

ROOT = Path(__file__).resolve().parents[1]


def _tiny_cfg(timesteps=5):
    return dataclasses.replace(
        get_snn("snn-mnist"), input_hw=(8, 8), conv_channels=(8, 8),
        timesteps=timesteps, num_spe_clusters=4)


@pytest.fixture(scope="module")
def tiny():
    cfg = _tiny_cfg()
    return cfg, init_snn(torch.Generator().manual_seed(0), cfg, device="cpu")


@pytest.fixture(scope="module")
def tiny3():
    cfg = _tiny_cfg(timesteps=3)
    return cfg, init_snn(torch.Generator().manual_seed(0), cfg, device="cpu")


def _frames(n, cfg, seed=0):
    return list(np.random.default_rng(seed).random(
        (n, *cfg.input_hw, cfg.input_channels), dtype=np.float32))


def _engine(params, cfg, **kw):
    kw = {"backend": "hopper", "keep_logits": True, "device": "cpu", **kw}
    return ServingEngine(params, cfg, EngineConfig(**kw))


def _whole(params, cfg, frames):
    with torch.no_grad():
        return snn_apply(params, torch.from_numpy(np.stack(frames)), cfg,
                         backend="hopper").logits.numpy()


def _assert_conserved(eng, rids, msg=""):
    """Every submitted rid resolved exactly once (completed / rejected /
    expired)."""
    out = ([r.rid for r in eng.completed] + [r.rid for r in eng.rejected]
           + [r.rid for r in eng.expired])
    assert len(out) == len(set(out)), f"a request resolved twice  {msg}"
    assert set(out) == set(rids), (
        f"lost={set(rids) - set(out)} phantom={set(out) - set(rids)}  {msg}")


# -- chunk-boundary rescheduling ---------------------------------------------

def _run(params, cfg, frames, ct, **kw):
    eng = _engine(params, cfg, num_lanes=2, max_batch=4, chunk_timesteps=ct,
                  **kw)
    for i, f in enumerate(frames):
        eng.submit(f, arrival=0.001 * i)
    return eng, eng.run()


@pytest.mark.parametrize("ct", [1, 2, 3, 5])
def test_engine_chunked_serving_bit_identical(tiny, ct):
    """Chunk-scheduled serving == whole-T dispatch per request: logits bits
    (and the single-shot forward's), accumulated spike totals, the traced
    chunk lifecycle, and conservation."""
    cfg, params = tiny
    frames = _frames(9, cfg, seed=5)
    e0, s0 = _run(params, cfg, frames, None)
    e1, s1 = _run(params, cfg, frames, ct, trace=True)
    assert s1["served"] == s0["served"] == len(frames)
    l0 = {r.rid: r.logits for r in e0.completed}
    l1 = {r.rid: r.logits for r in e1.completed}
    assert set(l0) == set(l1) == set(range(len(frames)))
    want = _whole(params, cfg, frames)
    for rid in l0:
        assert np.array_equal(l0[rid], l1[rid]), f"rid {rid} ct={ct}"
        assert np.array_equal(l0[rid], want[rid]), f"rid {rid} whole"
    for a, b in zip(e0.accumulated_timestep_counts(),
                    e1.accumulated_timestep_counts()):
        assert np.allclose(a.sum(), b.sum(), rtol=0, atol=1e-6)
    starts = e1.trace.events("chunk_start")
    dones = e1.trace.events("chunk_done")
    per_req = -(-cfg.timesteps // ct)
    assert len(starts) == len(dones) == per_req * len(frames)
    assert all(e.get("t_served") == cfg.timesteps
               for e in dones if e.get("done"))


def test_engine_mid_flight_deadline_eviction(tiny):
    """A request whose deadline passes while it is partly served is evicted
    at the next chunk boundary: deadline terminal, a mid_evict event, and
    conservation."""
    cfg, params = tiny
    frames = _frames(6, cfg, seed=6)
    svc = 0.004
    eng = _engine(params, cfg, num_lanes=1, max_batch=2, chunk_timesteps=2,
                  trace=True, slo_seconds_per_work=1e-6,
                  service_time_fn=lambda lane, wall, t: svc * t /
                  cfg.timesteps)
    rids = [eng.submit(f, arrival=0.0, deadline_s=0.009) for f in frames]
    s = eng.run()
    assert s["served"] + s["deadline_missed"] == len(frames)
    assert s["deadline_missed"] > 0 and eng.snapshot().mid_evicted > 0
    evicts = eng.trace.events("mid_evict")
    assert evicts and all(e.get("reason") == "expired" for e in evicts)
    assert all(0 < e.get("t_served") < cfg.timesteps for e in evicts)
    _assert_conserved(eng, rids)


def test_engine_mid_flight_degrade_truncates_remaining_chunks(tiny):
    """SLO degrade acts mid-flight: a request past its first chunk gets its
    target T truncated and finishes early from its carried state."""
    cfg, params = tiny
    frames = _frames(8, cfg, seed=7)
    svc = 0.004
    eng = _engine(params, cfg, num_lanes=1, max_batch=2, chunk_timesteps=1,
                  trace=True, latency_budget_s=0.010, slo_action="degrade",
                  slo_seconds_per_work=1e-6,
                  service_time_fn=lambda lane, wall, t: svc * t /
                  cfg.timesteps)
    for f in frames:
        eng.submit(f, arrival=0.0)
    s = eng.run()
    assert s["served"] == len(frames) and eng.snapshot().mid_degraded > 0
    mid = [e for e in eng.trace.events("degrade") if e.get("mid_flight")]
    assert mid
    last_served = {e.rid: e.get("t_served")
                   for e in eng.trace.events("chunk_done")}
    for e in mid:
        assert 0 < last_served[e.rid] < cfg.timesteps


def test_engine_new_arrivals_join_running_lanes_next_chunk(tiny):
    """A request arriving while a lane is mid-sequence rides that lane's
    next chunk batch, and still gets the whole-T bits."""
    cfg, params = tiny
    frames = _frames(3, cfg, seed=8)
    svc = 0.004
    eng = _engine(params, cfg, num_lanes=1, max_batch=4, chunk_timesteps=1,
                  trace=True, service_time_fn=lambda lane, wall, t:
                  svc * t / cfg.timesteps)
    r0 = eng.submit(frames[0], arrival=0.0)
    r1 = eng.submit(frames[1], arrival=1.7 * svc / cfg.timesteps)
    eng.run()
    shared = [e for e in eng.trace.events("dispatch")
              if set(e.get("rids", ())) >= {r0, r1}]
    assert shared, "late arrival never joined the running lane's chunk"
    got = {r.rid: r.logits for r in eng.completed}
    assert np.array_equal(got[r1], _whole(params, cfg, frames[1:2])[0])


def test_threaded_engine_chunked_parity_and_cancel(tiny):
    """Worker-thread lanes + chunk scheduling: live submissions complete
    with the whole-T bits; a cancelled request resolves exactly once."""
    cfg, params = tiny
    frames = _frames(6, cfg, seed=9)
    want = _whole(params, cfg, frames)
    eng = _engine(params, cfg, num_lanes=2, max_batch=2, threaded=True,
                  chunk_timesteps=2)
    eng.serve_forever()
    handles = [eng.submit_live(f) for f in frames]
    was_cancelled = handles[4].cancel()
    got = {i: h.result(timeout=60.0) for i, h in enumerate(handles)
           if not (i == 4 and was_cancelled)}
    s = eng.shutdown(timeout=60.0)
    assert s["served"] + s["cancelled"] == len(frames)
    assert s["cancelled"] == (1 if was_cancelled else 0)
    for i, logits in got.items():
        assert np.array_equal(logits, want[i]), f"live rid {i} drifted"


# -- pad rows ----------------------------------------------------------------

def _trained_like(params, bias=1.5):
    """Supra-threshold conv biases, as a trained net can have: all-zero pad
    rows now fire every timestep."""
    return {**params,
            "conv": [dict(p, b=p["b"] + bias) for p in params["conv"]]}


def _uniform(n, cfg, seed):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, *cfg.input_hw, cfg.input_channels)).astype(np.float32)


def test_pad_rows_fire_with_trained_params(tiny3):
    cfg, params = tiny3
    zero = torch.zeros((1, *cfg.input_hw, cfg.input_channels))
    with torch.no_grad():
        out = snn_apply(_trained_like(params), zero, cfg, backend="hopper")
    assert sum(float(t) for t in out.spike_totals) > 0


@pytest.mark.parametrize("ct", [None, 2])
def test_accumulated_spikes_match_unpadded_reference(tiny3, ct):
    """3 frames pad into bucket 4, and the trained-like pad row fires; the
    engine's accumulated spike workload still equals an unpadded forward of
    exactly those 3 frames."""
    cfg, params = tiny3
    params_b = _trained_like(params)
    frames = _uniform(3, cfg, seed=2)
    eng = _engine(params_b, cfg, num_lanes=1, max_batch=4,
                  chunk_timesteps=ct)
    for f in frames:
        eng.submit(f, arrival=0.0)
    eng.run()
    with torch.no_grad():
        ref = snn_apply(params_b, torch.from_numpy(frames), cfg,
                        backend="hopper")
    acc = eng.accumulated_timestep_counts()
    for masked, want in zip(acc, ref.timestep_counts):
        np.testing.assert_allclose(masked, want.double().numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_energy_metric_unaffected_by_padding(tiny3):
    cfg, params = tiny3
    params_b = _trained_like(params)
    frames = _uniform(3, cfg, seed=4)

    def run(buckets, max_batch):
        eng = _engine(params_b, cfg, num_lanes=1, max_batch=max_batch,
                      buckets=buckets)
        for f in frames:
            eng.submit(f, arrival=0.0)
        return eng.run()

    padded = run((1, 2, 4, 8, 16), 4)
    exact = run((1, 3), 3)
    assert padded["energy_j_per_image"] == pytest.approx(
        exact["energy_j_per_image"], rel=1e-6)


# -- faults, supervision, conservation ---------------------------------------

class _Gate:
    """Fault hook that blocks the first dispatched execution until
    released."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()
        self._armed = True
        self._lock = threading.Lock()

    def __call__(self, lane, attempt):
        with self._lock:
            arm, self._armed = self._armed, False
        if arm:
            self.entered.set()
            self.release.wait(timeout=30.0)


def _run_sampled_plan(tiny3, seed, chunk_timesteps=None):
    cfg, params = tiny3
    plan = FaultPlan.sample(seed, num_lanes=2)
    eng = _engine(params, cfg, num_lanes=2, max_batch=2, threaded=True,
                  max_retries=1, restart_budget=1, restart_backoff_s=0.001,
                  fault_plan=plan, chunk_timesteps=chunk_timesteps)
    frames = _frames(4, cfg, seed=1)
    arrivals = sorted([0.002 * i for i in range(10)]
                      + plan.storm_arrivals())
    rids = [eng.submit(frames[i % len(frames)], arrival=a)
            for i, a in enumerate(arrivals)]
    s = eng.run()
    msg = f"replay: FaultPlan.sample(seed={seed}, num_lanes=2)"
    assert s["served"] == len(rids), msg
    _assert_conserved(eng, rids, msg=msg)


@pytest.mark.parametrize("ct", [None, 1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sampled_plan_conservation(tiny3, seed, ct):
    _run_sampled_plan(tiny3, seed, chunk_timesteps=ct)


def test_threaded_crash_restart_acceptance(tiny3):
    """Kill every lane once mid-epoch (restart budget 1): every request
    resolves exactly once and both lanes serve after their restart."""
    cfg, params = tiny3
    eng = _engine(params, cfg, num_lanes=2, max_batch=2, threaded=True,
                  max_retries=0, restart_budget=1, restart_backoff_s=0.001,
                  fault_plan=FaultPlan(seed=42, crashes=((0, 0), (1, 1))))
    rids = [eng.submit(f, arrival=0.0) for f in _frames(24, cfg)]
    s = eng.run()
    assert s["served"] == 24 and s["restarts"] == 2.0
    _assert_conserved(eng, rids)
    assert s["mean_recovery_s"] >= 0.001
    assert {r.lane for r in eng.completed} == {0, 1}
    assert eng.supervisor.permanently_dead() == []


def test_threaded_budget_exhausted_goes_permanent(tiny3):
    cfg, params = tiny3
    eng = _engine(params, cfg, num_lanes=2, max_batch=2, threaded=True,
                  max_retries=0, restart_budget=1, restart_backoff_s=0.001,
                  fault_plan=FaultPlan(crashes=((0, 0), (0, 1))))
    rids = [eng.submit(f, arrival=0.0) for f in _frames(16, cfg)]
    s = eng.run()
    assert s["served"] == 16 and s["restarts"] == 1.0
    _assert_conserved(eng, rids)
    assert eng.supervisor.permanently_dead() == [0]


def test_threaded_hang_escalated_to_restart(tiny3):
    """A worker silent while busy is presumed hung: its batch is re-queued,
    the lane restarts, the zombie's late report is discarded."""
    cfg, params = tiny3
    gate = _Gate()
    eng = _engine(params, cfg, num_lanes=1, max_batch=1, threaded=True,
                  restart_budget=1, restart_backoff_s=0.001,
                  hang_timeout_s=0.25, fault_hook=gate)
    rids = [eng.submit(f, arrival=0.0) for f in _frames(3, cfg)]
    try:
        s = eng.run()
    finally:
        gate.release.set()
    assert s["served"] == 3 and s["restarts"] == 1.0
    _assert_conserved(eng, rids)


def test_supervisor_budget_backoff_and_permanent_death():
    sup = LaneSupervisor(2, restart_budget=2,
                         policy=RetryPolicy(backoff_s=0.1, max_backoff_s=1.0))
    at = sup.on_death(0, 10.0)
    assert at == pytest.approx(10.1)
    assert sup.on_death(0, 10.05) == at
    assert sup.due_restarts(10.05) == [] and sup.due_restarts(10.1) == [0]
    assert sup.on_restarted(0, 10.3) == pytest.approx(0.3)
    assert sup.on_death(0, 20.0) == pytest.approx(20.2)
    sup.on_restarted(0, 20.2)
    assert sup.on_death(0, 30.0) is None
    assert sup.permanently_dead() == [0] and sup.next_restart_at() is None
    assert sup.stats()["per_lane_restarts"] == [2, 0]


def test_supervisor_hang_detection_and_validation():
    sup = LaneSupervisor(2, restart_budget=1, hang_timeout_s=0.1)
    sup.beat(0, 0.0)
    sup.beat(1, 0.0)
    assert sup.stale(0.05) == [] and sup.stale(0.2) == [0, 1]
    assert sup.stale(0.2, busy=[1]) == [1]
    sup.on_death(1, 0.2)
    assert sup.stale(0.3, busy=[1]) == []
    for kw in ({"restart_budget": -1}, {"hang_timeout_s": 0.0}):
        with pytest.raises(ValueError):
            LaneSupervisor(1, **kw)


def test_virtual_replay_is_deterministic_under_chaos(tiny3):
    """The same chaos scenario on the VirtualClock twice: identical
    summaries, per-request (lane, window, start, finish) and trace lines."""
    cfg, params = tiny3

    def run_once():
        def kill_lane0(lane, attempt):
            if lane == 0:
                raise RuntimeError("chaos: lane 0 down")

        eng = _engine(params, cfg, num_lanes=2, max_batch=2, max_retries=1,
                      keep_logits=False, fault_hook=kill_lane0, trace=True,
                      service_time_fn=lambda lane, wall: 0.01 * (lane + 1))
        rids = [eng.submit(f, arrival=0.003 * i)
                for i, f in enumerate(_frames(10, cfg, seed=3))]
        s = eng.run()
        _assert_conserved(eng, rids)
        per_req = [(r.rid, r.lane, r.window, r.start, r.finish)
                   for r in sorted(eng.completed, key=lambda r: r.rid)]
        return s, per_req, eng.trace.lines()

    assert run_once() == run_once()


def test_exec_cache_holds_frozen_params(tiny):
    """The cache derives the dense layers' exact-grid weights once, when
    its params are set, and again on ``update_params``; the engine serves
    with the bits of an unfrozen forward."""
    from repro_torch.core.snn_layers import exact_grid
    cfg, params = tiny
    eng = _engine(params, cfg, max_batch=4)
    for p in (params, {**params, "dense": [
            {"w": d["w"] * 0.5, "b": d["b"]} for d in params["dense"]]}):
        if p is not params:
            eng.update_params(p)
        for d, dq in zip(p["dense"], eng.cache.params["dense"]):
            assert torch.equal(dq["wq"], exact_grid(d["w"], dim=0))
        frames = _frames(3, cfg, seed=9)
        rids = [eng.submit(f, arrival=0.0) for f in frames]
        eng.run()
        got = {r.rid: r.logits for r in eng.completed}
        want = _whole(p, cfg, frames)
        for i, rid in enumerate(rids):
            np.testing.assert_array_equal(got[rid], want[i])


def test_lane_devices_wait_for_the_mesh_runtime(tiny3):
    cfg, params = tiny3
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        _engine(params, cfg, lane_devices=("cpu", "cpu"))


def test_launcher_engine_path_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--engine",
         "--lanes", "2", "--device", "cpu", "--steps", "2",
         "--chunk-timesteps", "3"], env=env, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stderr
    assert "engine[virtual] served 16 frames" in r.stderr
