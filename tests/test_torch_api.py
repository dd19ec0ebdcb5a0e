"""The port's facade, ``repro_torch.api``, against the reference's
``repro.api`` on the CPU.

Specs: every dict the reference's specs write loads in the port with equal
fields (its ``"pallas"`` backend read as ``"hopper"``), the port's specs
round-trip through JSON, and the reference's loud-validation cases raise
with the reference's words.  Sessions on the same weights
(``from_jax_params``) and frames: ``infer`` logits to 1e-5 and spike
counts exactly, two ``train_step`` losses to 1e-5, and equal ``evaluate``
accuracy, on the port's ``batched`` and ``hopper`` (its kernels' plain
versions on CPU tensors) against the reference's ``batched``.  Live
serving: ``serve_forever`` futures give ``infer``'s logits bit for bit.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import repro.api as jx_api
import repro_torch.api as api
from repro.config import get_snn
from repro.core import init_snn as jx_init_snn
from repro_torch.core.snn_model import snn_apply
from repro_torch.interop import from_jax_params


def _tiny_cfg():
    return dataclasses.replace(
        get_snn("snn-mnist"), input_hw=(8, 8), conv_channels=(8, 8),
        timesteps=2, num_spe_clusters=4)


@pytest.fixture(scope="module")
def tiny():
    cfg = _tiny_cfg()
    np_params = jax.tree_util.tree_map(np.asarray, jax.jit(
        jx_init_snn, static_argnums=1)(jax.random.PRNGKey(0), cfg))
    return cfg, np_params


def _frames(n, cfg, seed=0):
    rng = np.random.default_rng(seed)
    h, w = cfg.input_hw
    return np.clip(
        rng.uniform(0, 1, (n, h, w, cfg.input_channels))
        * rng.lognormal(-0.5, 1.2, (n, 1, 1, 1)), 0, 1).astype(np.float32)


def _session(cfg, np_params, spec):
    return api.Session(cfg, spec, params=from_jax_params(np_params,
                                                         device="cpu"),
                       device="cpu")


# -- specs ---------------------------------------------------------------------

REFERENCE_SPECS = [
    lambda: jx_api.ExecutionSpec(backend="pallas", schedule_mode="cbws",
                                 timesteps=5, surrogate_kind="arctan",
                                 surrogate_alpha=4.0),
    lambda: jx_api.ExecutionSpec(backend="batched", mesh={"data": 2},
                                 chunk_timesteps=2),
    lambda: jx_api.TrainSpec(backend="pallas", lr=3e-4, momentum=0.8),
    lambda: jx_api.TrainSpec(backend="ref", mesh=(("data", 4),)),
    lambda: jx_api.ServeSpec(
        backend="pallas", schedule_mode="aprc+cbws", num_lanes=3,
        max_batch=4, buckets=(1, 2, 4), admission="fifo", threaded=True,
        latency_budget_s=0.05, slo_action="degrade", degrade_timesteps=2,
        slo_batch_quantum_s=0.001, max_queue=64, default_deadline_s=0.5,
        restart_budget=2, hang_timeout_s=1.0, trace=True,
        fault_plan=jx_api.FaultPlan.sample(seed=3, num_lanes=3)),
    lambda: jx_api.ServeSpec(backend="batched", mesh={"data": 2},
                             chunk_timesteps=3),
]


@pytest.mark.parametrize("make", REFERENCE_SPECS)
def test_reference_spec_dicts_load_in_the_port(make):
    ref_spec = make()
    d = json.loads(json.dumps(ref_spec.to_dict()))
    spec = api.spec_from_dict(d)
    assert type(spec).__name__ == type(ref_spec).__name__
    for f in dataclasses.fields(ref_spec):
        want = getattr(ref_spec, f.name)
        got = getattr(spec, f.name)
        if f.name == "backend":
            assert got == ("hopper" if want == "pallas" else want)
        elif f.name == "fault_plan" and want is not None:
            assert got.to_dict() == want.to_dict()
        else:
            assert got == want, f.name
    # and the port writes what it read
    assert api.spec_from_dict(json.loads(json.dumps(spec.to_dict()))) == spec


PORT_SPECS = [
    lambda: api.ExecutionSpec(backend="hopper", schedule_mode="cbws",
                              timesteps=5, surrogate_kind="arctan",
                              surrogate_alpha=4.0),
    lambda: api.TrainSpec(backend="batched", lr=3e-4, momentum=0.8),
    lambda: api.ServeSpec(backend="batched", num_lanes=3, max_batch=4,
                          buckets=(1, 2, 4), admission="fifo", threaded=True,
                          latency_budget_s=0.05, slo_action="degrade",
                          degrade_timesteps=2, slo_batch_quantum_s=0.001,
                          fault_plan=api.FaultPlan.sample(seed=2,
                                                          num_lanes=3)),
    lambda: api.ServeSpec(backend="ref", mesh={"data": 2, "model": 2}),
]


@pytest.mark.parametrize("make", PORT_SPECS)
def test_port_specs_round_trip_through_json(make):
    spec = make()
    d = spec.to_dict()
    assert d["kind"] == type(spec).KIND
    assert api.spec_from_dict(d) == spec
    assert api.spec_from_dict(json.loads(json.dumps(d))) == spec


# (constructor, kwargs, the reference's match= words)
LOUD_CASES = [
    ("ExecutionSpec", dict(backend="tensorrt"), "backend"),
    ("ExecutionSpec", dict(surrogate_kind="step"), "fast_sigmoid"),
    ("ExecutionSpec", dict(backend="hopper", schedule_mode="greedy"),
     "aprc\\+cbws"),
    ("ExecutionSpec", dict(backend="batched", schedule_mode="aprc+cbws"),
     "pallas"),
    ("ExecutionSpec", dict(timesteps=0), "timesteps"),
    ("ExecutionSpec", dict(chunk_timesteps=0), "chunk_timesteps"),
    ("ExecutionSpec", dict(mesh={"data": 0}), "mesh"),
    ("ExecutionSpec", dict(backend="hopper", schedule_mode="cbws",
                           mesh={"data": 2}), "mutually exclusive"),
    ("TrainSpec", dict(lr=0.0), "lr"),
    ("TrainSpec", dict(momentum=1.0), "momentum"),
    ("TrainSpec", dict(backend="hopper", schedule_mode="aprc+cbws"),
     "schedule_mode"),
    ("ServeSpec", dict(num_lanes=0), "num_lanes"),
    ("ServeSpec", dict(max_batch=9, buckets=(2, 4)), "bucket"),
    ("ServeSpec", dict(admission="lifo"), "admission"),
    ("ServeSpec", dict(slo_action="drop"), "slo_action"),
]


@pytest.mark.parametrize("cls, kw, words", LOUD_CASES)
def test_loud_validation_uses_the_references_words(cls, kw, words):
    ref_kw = {k: ("pallas" if v == "hopper" else v) for k, v in kw.items()}
    with pytest.raises(ValueError, match=words):
        getattr(jx_api, cls)(**ref_kw)
    with pytest.raises(ValueError, match=words):
        getattr(api, cls)(**kw)


def test_from_dict_unknown_key_and_kind_are_loud():
    with pytest.raises(ValueError, match="lanes_count"):
        api.ServeSpec.from_dict({"lanes_count": 4})
    with pytest.raises(ValueError, match="kind"):
        api.TrainSpec.from_dict({"kind": "serve"})
    with pytest.raises(ValueError, match="spec kind"):
        api.spec_from_dict({"kind": "deploy"})


def test_resolve_schedule_auto():
    assert api.resolve_schedule("auto", "hopper") == "aprc+cbws"
    assert api.resolve_schedule("auto", "batched") is None
    assert api.resolve_schedule("cbws", "hopper") == "cbws"
    with pytest.raises(ValueError, match="hopper"):
        api.ServeSpec(backend="batched", schedule_mode=api.resolve_schedule(
            "aprc+cbws", "batched"))


def test_spec_fields_a_callee_cannot_apply_are_loud(tiny):
    cfg, np_params = tiny
    from repro_torch.core.snn_train import make_loss_fn, make_train_step
    params = from_jax_params(np_params, device="cpu")
    x = torch.from_numpy(_frames(2, cfg))
    with pytest.raises(ValueError, match="timesteps"):
        snn_apply(params, x, cfg,
                  spec=api.ExecutionSpec(backend="batched", timesteps=8))
    with pytest.raises(ValueError, match="timesteps"):
        make_train_step(cfg, spec=api.TrainSpec(timesteps=8))
    with pytest.raises(ValueError, match="timesteps"):
        make_loss_fn(cfg, spec=api.TrainSpec(timesteps=8))
    with pytest.raises(ValueError, match="schedule"):
        snn_apply(params, x, cfg, spec=api.ExecutionSpec(
            backend="hopper", schedule_mode="aprc+cbws"))
    out = snn_apply(params, x, cfg, spec=api.ExecutionSpec(
        backend="batched", timesteps=cfg.timesteps, chunk_timesteps=1))
    want = snn_apply(params, x, cfg, backend="batched")
    assert torch.equal(out.logits, want.logits)


def test_ops_spec_fields_the_kernel_cannot_apply_are_loud():
    from repro_torch.kernels import ops
    spikes, v0 = torch.zeros((3, 1, 4, 4, 2)), torch.zeros((1, 6, 6, 4))
    w, b = torch.zeros((3, 3, 2, 4)), torch.zeros((4,))
    with pytest.raises(ValueError, match="pallas kernel"):
        ops.spiking_conv_lif(spikes, v0, w, b,
                             spec=api.ExecutionSpec(backend="batched"))
    with pytest.raises(ValueError, match="timesteps"):
        ops.spiking_conv_lif(spikes, v0, w, b, spec=api.ExecutionSpec(
            backend="hopper", timesteps=8))
    with pytest.raises(ValueError, match="schedule"):
        ops.spiking_conv_lif(spikes, v0, w, b, spec=api.ExecutionSpec(
            backend="hopper", schedule_mode="aprc+cbws"))


# -- Session against the reference's -------------------------------------------

@pytest.mark.parametrize("backend", ["batched", "hopper"])
def test_session_infer_matches_the_reference(tiny, backend):
    cfg, np_params = tiny
    x = _frames(3, cfg, seed=3)
    want = jx_api.Session(cfg, jx_api.ExecutionSpec(backend="batched"),
                          params=np_params).infer(x)
    got = _session(cfg, np_params, api.ExecutionSpec(backend=backend)
                   ).infer(x)
    np.testing.assert_allclose(got.logits, np.asarray(want.logits),
                               atol=1e-5, rtol=1e-5)
    for a, b in zip(got.spike_counts, want.spike_counts):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("backend", ["batched", "hopper"])
def test_session_train_step_and_evaluate_match_the_reference(tiny, backend):
    cfg, np_params = tiny
    x = _frames(6, cfg, seed=5)
    y = np.arange(6) % 10
    ref = jx_api.Session(cfg, jx_api.TrainSpec(backend="batched", lr=1e-2),
                         params=np_params)
    sess = _session(cfg, np_params, api.TrainSpec(backend=backend, lr=1e-2))
    for _ in range(2):
        assert abs(sess.train_step(x, y) - ref.train_step(x, y)) < 1e-5
    assert sess.evaluate(x, y) == ref.evaluate(x, y)


def test_session_infer_is_the_raw_forward_and_follows_training(tiny):
    """``infer`` gives ``snn_apply``'s bits (the hopper backend with the
    session's schedule); after a train step the cached engine serves the
    new weights."""
    cfg, np_params = tiny
    from repro_torch.core.scheduler import build_schedule
    sess = _session(cfg, np_params, api.ServeSpec(
        backend="hopper", schedule_mode="aprc+cbws"))
    x = _frames(4, cfg, seed=7)

    def raw():
        with torch.no_grad():
            return snn_apply(sess.params, torch.from_numpy(x), cfg,
                             backend="hopper",
                             schedule=build_schedule(sess.params, cfg,
                                                     "aprc+cbws")).logits
    np.testing.assert_array_equal(sess.infer(x).logits, raw().numpy())
    sess.train_step(x, np.arange(4))
    np.testing.assert_array_equal(sess.infer(x).logits, raw().numpy())


def test_serve_forever_futures_equal_infer(tiny):
    cfg, np_params = tiny
    sess = _session(cfg, np_params, api.ServeSpec(
        backend="hopper", schedule_mode="aprc+cbws", num_lanes=2,
        max_batch=4))
    frames = _frames(10, cfg, seed=9)
    with sess.serve_forever() as live:
        assert live.running
        handles = [live.submit(f) for f in frames]
        logits = [h.result(timeout=60.0) for h in handles]
    assert live.summary()["served"] == len(frames)
    done = [r.rid for r in live.engine.completed]
    assert sorted(done) == sorted(h.rid for h in handles)
    for f, got in zip(frames, logits):
        np.testing.assert_array_equal(sess.infer(f[None]).logits[0], got)


def test_session_serve_and_engine(tiny):
    cfg, np_params = tiny
    sess = _session(cfg, np_params, api.ServeSpec(backend="batched",
                                                  num_lanes=2, max_batch=4))
    s = sess.serve(_frames(3, cfg), steps=2)
    assert s["frames"] == 6 and s["fps"] > 0
    eng = sess.engine()
    for f in _frames(8, cfg, seed=11):
        eng.submit(f, arrival=0.0)
    assert eng.run()["served"] == 8


def test_session_rejects_a_mesh_and_a_non_spec(tiny):
    """A mesh runs (the session's and an override ServeSpec's, on host
    entries when the session is on the CPU); what is rejected is a mesh
    the host cannot place, a mesh with a kernel schedule, and a non-spec."""
    cfg, np_params = tiny
    frames = _frames(3, cfg)
    mesh = _session(cfg, np_params, api.ExecutionSpec(mesh={"data": 2}))
    np.testing.assert_array_equal(
        mesh.infer(frames).logits,
        _session(cfg, np_params, api.ExecutionSpec()).infer(frames).logits)
    sess = _session(cfg, np_params, api.ServeSpec(backend="batched"))
    eng = sess.engine(api.ServeSpec(backend="batched", mesh={"data": 2}))
    assert eng.snapshot().lane_devices == ("cpu:0", "cpu:1")
    with pytest.raises(ValueError, match="CUDA devices are visible"):
        from repro_torch.dist import DeviceMesh
        DeviceMesh({"data": torch.cuda.device_count() + 1})
    with pytest.raises(ValueError, match="mutually exclusive"):
        api.ServeSpec(backend="hopper", schedule_mode="cbws",
                      mesh={"data": 2})
    with pytest.raises(TypeError, match="ExecutionSpec"):
        api.Session(cfg, {"backend": "batched"}, device="cpu")


def test_session_defaults_to_the_card(tiny):
    cfg, _ = tiny
    if torch.cuda.is_available():
        assert api.Session(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            api.Session(cfg)
    sess = api.Session(cfg, seed=1, device="cpu")
    assert sess.params["conv"][0]["w"].device.type == "cpu"
