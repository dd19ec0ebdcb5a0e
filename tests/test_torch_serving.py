"""The port's serving engine against the reference's: one load trace, with
arrivals and frames made from numpy, replayed on the virtual clock through
JAX ``repro.serving.ServingEngine`` and the port's, on the same weights.

The service time is a deterministic function of (lane, timesteps), so both
engines take the same decisions: the same requests served, the same
terminal outcome per request, the same rounds and the same lane groups, in
whole-T and chunked dispatch and under an SLO budget with deadlines.  The
served logits agree to 1e-5.  The cycle model behind the engine's energy
metric (``perfmodel``) gives the reference's numbers.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import get_snn
from repro.core import build_schedule as jx_build_schedule
from repro.core import init_snn as jx_init_snn
from repro.perfmodel import XC7Z045 as JX_XC7Z045
from repro.perfmodel import simulate_network as jx_simulate_network
from repro.serving import EngineConfig as JxEngineConfig
from repro.serving import ServingEngine as JxServingEngine
from repro.serving import energy_per_image as jx_energy_per_image
from repro_torch.core import build_schedule
from repro_torch.interop import from_jax_params
from repro_torch.perfmodel import XC7Z045, simulate_network
from repro_torch.serving import EngineConfig, ServingEngine, energy_per_image

T = 5
MODES = {
    "whole": {},
    "chunked": {"chunk_timesteps": 2},
    # a budget that binds: requests degrade, some of them mid-flight
    "slo": {"chunk_timesteps": 2, "latency_budget_s": 0.006,
            "slo_action": "degrade", "slo_seconds_per_work": 2e-5},
    # an optimistic prior and a tight deadline: some requests expire,
    # some of them partly served
    "deadline": {"chunk_timesteps": 2, "slo_seconds_per_work": 1e-6,
                 "default_deadline_s": 0.002},
}


def _tiny_cfg():
    return dataclasses.replace(
        get_snn("snn-mnist"), input_hw=(8, 8), conv_channels=(8, 8),
        timesteps=T, num_spe_clusters=4)


@pytest.fixture(scope="module")
def tiny():
    cfg = _tiny_cfg()
    jparams = jax.tree_util.tree_map(np.asarray, jax.jit(
        jx_init_snn, static_argnums=1)(jax.random.PRNGKey(0), cfg))
    return cfg, jparams, from_jax_params(jparams, device="cpu")


def _trace(cfg, n=14, seed=3):
    rng = np.random.default_rng(seed)
    frames = rng.random((n, *cfg.input_hw, cfg.input_channels),
                        dtype=np.float32)
    # brighter and dimmer frames: the predicted workloads differ
    frames *= rng.uniform(0.2, 1.0, (n, 1, 1, 1)).astype(np.float32)
    arrivals = np.cumsum(rng.exponential(1e-3, n))
    return frames, arrivals


def _service(lane, wall, t):
    # lane 1 is slower; the price of a dispatch is its timestep count
    return 0.002 * (1.0 + 0.5 * lane) * t / T


def _replay(engine_cls, ecfg_cls, params, cfg, mode, **port_kw):
    eng = engine_cls(params, cfg, ecfg_cls(
        num_lanes=2, max_batch=4, keep_logits=True, trace=True,
        service_time_fn=_service, **MODES[mode], **port_kw))
    frames, arrivals = _trace(cfg)
    rids = [eng.submit(f, arrival=float(a)) for f, a in zip(frames, arrivals)]
    summary = eng.run()
    outcome = {}
    for name, reqs in (("served", eng.completed), ("rejected", eng.rejected),
                       ("expired", eng.expired)):
        for r in reqs:
            assert r.rid not in outcome, f"rid {r.rid} resolved twice"
            outcome[r.rid] = name
    assert set(outcome) == set(rids)
    groups = [(e.get("lane"), tuple(e.get("rids")), e.get("timesteps"))
              for e in eng.trace.events("dispatch")]
    logits = {r.rid: np.asarray(r.logits) for r in eng.completed}
    return summary, outcome, groups, logits


@pytest.fixture(scope="module")
def reference_runs(tiny):
    cfg, jparams, _ = tiny
    return {mode: _replay(JxServingEngine, JxEngineConfig, jparams, cfg,
                          mode, backend="batched") for mode in MODES}


SUMMARY_KEYS = ("served", "rounds", "rejected", "degraded",
                "deadline_missed", "chunks_dispatched", "mid_evicted",
                "mid_degraded", "p50_latency_s", "p99_latency_s",
                "request_balance", "predicted_balance", "wall_balance",
                "energy_j_per_image", "model_fps", "model_balance")


@pytest.mark.parametrize("backend", ["batched", "hopper"])
@pytest.mark.parametrize("mode", list(MODES))
def test_engine_replays_the_reference_trace(tiny, reference_runs, mode,
                                            backend):
    cfg, _, params = tiny
    s_j, out_j, groups_j, logits_j = reference_runs[mode]
    s_t, out_t, groups_t, logits_t = _replay(
        ServingEngine, EngineConfig, params, cfg, mode, backend=backend,
        device="cpu")
    assert out_t == out_j
    assert groups_t == groups_j
    for k in SUMMARY_KEYS:
        assert s_t[k] == pytest.approx(s_j[k], rel=1e-12, abs=1e-15), k
    assert set(logits_t) == set(logits_j)
    for rid, want in logits_j.items():
        np.testing.assert_allclose(logits_t[rid], want, atol=1e-5, rtol=0)
    if mode == "slo":
        assert s_t["mid_degraded"] > 0
    if mode == "deadline":
        assert s_t["mid_evicted"] > 0 and s_t["served"] < len(out_t)


def test_simulate_network_matches_the_reference(tiny):
    cfg, jparams, params = tiny
    rng = np.random.default_rng(8)
    counts = [rng.integers(0, 50, (T, c)).astype(np.float64)
              for c in (cfg.input_channels,) + cfg.conv_channels[:-1]]
    for mode in ("none", "cbws", "aprc+cbws"):
        s_j = jx_build_schedule(jparams, cfg, mode)
        s_t = build_schedule(params, cfg, mode)
        got = simulate_network(cfg, counts, [s.in_partition for s in s_t],
                               [s.out_partition for s in s_t], XC7Z045)
        want = jx_simulate_network(cfg, counts,
                                   [s.in_partition for s in s_j],
                                   [s.out_partition for s in s_j],
                                   JX_XC7Z045)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), mode
        assert got.energy_j(XC7Z045) == want.energy_j(JX_XC7Z045)
        assert got.fps(XC7Z045) == want.fps(JX_XC7Z045)


def test_energy_per_image_matches_the_reference(tiny):
    cfg, jparams, params = tiny
    rng = np.random.default_rng(9)
    counts = [rng.integers(0, 400, (T, c)).astype(np.float64)
              for c in cfg.conv_channels]
    assert energy_per_image(cfg, params, counts, 7) == \
        jx_energy_per_image(cfg, jparams, counts, 7)
    assert torch.is_tensor(params["conv"][0]["w"])
