"""The port's mesh runtime (``repro_torch.dist``, the SNN half of
``repro_torch.sharding``) against the reference's ``repro.dist`` and
``repro.sharding`` on the CPU.

  * helpers: ``DeviceMesh``'s round-robin lanes and axis sizes, its raise
    when a card mesh asks for more cards than are visible, the placement
    and ``cbws_sharding`` functions on seeded skewed loads, and
    ``ShardingCtx``'s entries for every rule profile over three meshes,
    each equal to the reference's;
  * bit parity across shard counts: logits and counts at ``data`` 1, 2
    and 4 equal the unsharded ``Session``'s, and the params after two mesh
    steps are bit-identical at 1, 2 and 4 (host entries ``cpu:i``);
  * against the reference's mesh path at ``data=1`` (in process, one JAX
    CPU device): logits within 1e-5, counts exact (the pad-row case
    against ``pad_to``), params after two steps within atol 5e-5 and rtol
    5e-4;
  * the threaded engine on pinned lanes through a lane crash, and both
    launchers' ``--mesh`` in a subprocess.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.utils._pytree import tree_leaves

from _rendezvous import AtOnce

import repro.api as jx_api
import repro.dist as jx_dist
import repro.sharding.cbws_sharding as jx_cbws
import repro.sharding.context as jx_ctx
import repro_torch.api as api
import repro_torch.dist as dist
import repro_torch.sharding as sharding
from repro.config import get_snn
from repro.core import init_snn as jx_init_snn
from repro_torch.dist import DeviceMesh, MeshRunner
from repro_torch.dist import runner as runner_mod
from repro_torch.interop import from_jax_params, to_numpy_params
from repro_torch.runtime.faults import FaultPlan

ROOT = Path(__file__).resolve().parents[1]
COUNT_FIELDS = ("spike_counts", "spike_totals", "timestep_counts",
                "skip_fractions")


def _tiny_cfg():
    # the reference's multi-device suite config (tests/test_dist.py)
    return dataclasses.replace(get_snn("snn-mnist"), input_hw=(8, 8),
                               conv_channels=(4, 4), timesteps=3,
                               dense_units=(16,))


@pytest.fixture(scope="module")
def tiny():
    cfg = _tiny_cfg()
    np_params = jax.tree_util.tree_map(np.asarray, jax.jit(
        jx_init_snn, static_argnums=1)(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    frames = rng.random((8, *cfg.input_hw, cfg.input_channels),
                        dtype=np.float32)
    labels = (np.arange(8) % 10).astype(np.int32)
    return cfg, np_params, frames, labels


def _session(cfg, np_params, spec):
    return api.Session(cfg, spec, params=from_jax_params(np_params,
                                                         device="cpu"),
                       device="cpu")


def _assert_counts_equal(got, want):
    for f in COUNT_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert len(a) == len(b), f
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f)


# -- DeviceMesh ----------------------------------------------------------------


@pytest.mark.parametrize("lanes", [1, 3, 5])
def test_device_mesh_round_robin_matches_the_reference(lanes):
    ref = jx_dist.DeviceMesh((("data", 1),))
    dm = DeviceMesh((("data", 1),), device="cpu")
    assert dm.axes == ref.axes and dm.num_devices == ref.num_devices
    assert dm.data_size == ref.data_size and dm.axis_names == ref.axis_names
    assert dm.axis_size("data") == ref.axis_size("data")
    idx = {d: i for i, d in enumerate(ref.devices)}
    assert [idx[d] for d in ref.lane_devices(lanes)] == \
        [dm.devices.index(d) for d in dm.lane_devices(lanes)]
    # four host entries: lane i on entry i % 4, all distinct
    dm4 = DeviceMesh(("data", 4), device="cpu")
    assert dm4.devices == tuple(torch.device("cpu", i) for i in range(4))
    assert dm4.lane_devices(6) == tuple(dm4.devices[i % 4] for i in range(6))
    assert repr(dm4) == "DeviceMesh(data=4, devices=4)"
    with pytest.raises(ValueError):
        dm.lane_devices(0)
    with pytest.raises(KeyError):
        dm.axis_size("model")
    assert DeviceMesh((("pod", 2), ("model", 2)), device="cpu").data_size == 1


def test_device_mesh_raises_for_cards_it_cannot_see():
    """A card mesh on a host with fewer cards raises, naming N, the count
    and devices=, and never falls back to the CPU; explicit entries may
    not repeat."""
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = visible + 1
    with pytest.raises(ValueError, match=rf"needs {n} devices but only "
                       rf"{visible} CUDA devices.*devices="):
        DeviceMesh((("data", n),))
    with pytest.raises(ValueError, match="repeats"):
        DeviceMesh(("data", 2), devices=["cpu:0", "cpu:0"])
    with pytest.raises(ValueError, match="names only 1"):
        DeviceMesh(("data", 2), devices=["cpu:0"])
    assert DeviceMesh(("data", 2), devices=["cpu:3", "cpu:1", "cpu:0"]
                      ).devices == (torch.device("cpu", 3),
                                    torch.device("cpu", 1))


# -- placement and cbws_sharding -----------------------------------------------


def _skewed_loads(seed, n=24):
    rng = np.random.default_rng(seed)
    return rng.lognormal(0.0, 1.2, n)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("devices", [2, 4])
def test_placement_helpers_match_the_reference(seed, devices):
    loads = _skewed_loads(seed)
    got = dist.device_placement(loads, devices)
    np.testing.assert_array_equal(got, jx_dist.device_placement(loads,
                                                                devices))
    fifo = dist.fifo_placement(len(loads), devices)
    np.testing.assert_array_equal(
        fifo, jx_dist.fifo_placement(len(loads), devices))
    cbws = dist.assignment_balance(loads, got, devices)
    assert cbws == jx_dist.assignment_balance(loads, got, devices)
    assert cbws >= dist.assignment_balance(loads, fifo, devices)


@pytest.mark.parametrize("case", [
    # heaviest -> lane 0 (d0), next -> d1, third -> d1 again (8+1 < 10),
    # last gets the only lane left (tests/test_dist.py)
    ([10.0, 8.0, 1.0, 1.0], [0, 1, 2, 3], ("d0", "d1", "d0", "d1")),
    ([1.0, 1.0], [2, 0, 1, 3], ("d0", "d1", "d0", "d1")),   # ties
    ([5.0, 4.0, 3.0], [1, 0], ("d0", "d1")),                 # truncation
    ([3.0, 3.0, 3.0], [0, 1, 2], (torch.device("cpu", 0),
                                  torch.device("cpu", 1),
                                  torch.device("cpu", 0))),
])
def test_assign_groups_to_devices_matches_the_reference(case):
    works, order, lane_devices = case
    load, jx_load = {"d1": 2.0}, {"d1": 2.0}
    got = dist.assign_groups_to_devices(works, order, lane_devices, load)
    want = jx_dist.assign_groups_to_devices(works, order, lane_devices,
                                            jx_load)
    assert got == want and load == jx_load
    assert len(got) == min(len(works), len(order))


@pytest.mark.parametrize("shards", [2, 4])
def test_cbws_sharding_matches_the_reference(shards):
    loads = _skewed_loads(7, n=16)
    perm = sharding.expert_placement(loads, shards)
    np.testing.assert_array_equal(perm, jx_cbws.expert_placement(loads,
                                                                 shards))
    mags = _skewed_loads(8, n=32) - 0.5
    np.testing.assert_array_equal(
        sharding.snn_channel_permutation(mags, shards),
        jx_cbws.snn_channel_permutation(mags, shards))
    bal = sharding.placement_balance(loads, perm, shards)
    assert bal == jx_cbws.placement_balance(loads, perm, shards)
    assert bal >= sharding.placement_balance(loads, np.arange(16), shards)
    rng = np.random.default_rng(shards)
    moe = {"router": rng.random((5, 16), dtype=np.float32),
           **{k: rng.random((16, 3, 4), dtype=np.float32)
              for k in ("w_gate", "w_up", "w_down")}}
    want = jx_cbws.apply_expert_permutation(moe, perm)
    got_np = sharding.apply_expert_permutation(moe, perm)
    got_t = sharding.apply_expert_permutation(
        {k: torch.from_numpy(v) for k, v in moe.items()}, perm)
    for k in moe:
        np.testing.assert_array_equal(got_np[k], want[k])
        np.testing.assert_array_equal(got_t[k].numpy(), want[k])


MESHES = [(("data", 4),), (("data", 2), ("model", 2)),
          (("pod", 2), ("data", 2), ("model", 4))]
LOGICAL = [(("batch", None, "heads"), (8, 3, 4)),
           (("batch", "ffn"), (6, 8)),
           (("fsdp", "experts", "vocab"), (16, 8, 3)),
           (("seq_data", "seq_model", "act_seq", "opt"), (4, 8, 2, 16)),
           (("kv_heads", "cache_seq", None), (2, 4, 4))]


@pytest.mark.parametrize("profile", sorted(jx_ctx.RULE_PROFILES))
def test_sharding_ctx_entries_match_the_reference(profile):
    assert sharding.RULE_PROFILES.keys() == jx_ctx.RULE_PROFILES.keys()
    assert sharding.make_rules(profile) == jx_ctx.make_rules(profile)
    assert sharding.DEFAULT_RULES == jx_ctx.DEFAULT_RULES
    for axes in MESHES:
        ref = jx_ctx.ShardingCtx(AbstractMesh(
            tuple(s for _, s in axes), tuple(n for n, _ in axes)),
            jx_ctx.make_rules(profile))
        for mesh in (axes, DeviceMesh(axes, device="cpu")):
            ctx = sharding.ShardingCtx(mesh, sharding.make_rules(profile))
            for logical, dims in LOGICAL:
                for name in logical:
                    assert ctx.axes_for(name) == ref.axes_for(name)
                for d in (None, dims):
                    assert ctx.pspec(logical, d) == tuple(
                        ref.pspec(logical, d)), (axes, logical, d)


def test_sharding_context_is_thread_local_and_nests():
    ctx = sharding.ShardingCtx((("data", 2),))
    assert sharding.current_ctx() is None
    with sharding.use_sharding(ctx):
        assert sharding.current_ctx() is ctx
        with sharding.use_sharding(None):
            assert sharding.current_ctx() is None
        assert sharding.current_ctx() is ctx
    assert sharding.current_ctx() is None


# -- bit parity across shard counts --------------------------------------------


@pytest.mark.parametrize("backend", ["batched", "hopper"])
def test_infer_bits_equal_at_every_shard_count(tiny, backend):
    cfg, np_params, frames, _ = tiny
    want = _session(cfg, np_params, api.ServeSpec(backend=backend)
                    ).infer(frames)
    for n in (1, 2, 4):
        got = _session(cfg, np_params, api.ServeSpec(
            backend=backend, mesh={"data": n})).infer(frames)
        np.testing.assert_array_equal(got.logits, want.logits)
        _assert_counts_equal(got, want)
    if backend == "hopper":
        assert want.skip_fractions     # the fused layer's table is held


@pytest.mark.parametrize("backend", ["batched", "ref", "hopper"])
def test_train_params_bit_identical_at_every_shard_count(tiny, backend):
    cfg, np_params, frames, labels = tiny
    params, losses = {}, {}
    for n in (1, 2, 4):
        s = _session(cfg, np_params, api.TrainSpec(
            backend=backend, lr=1e-2, mesh={"data": n}))
        losses[n] = [s.train_step(frames, labels) for _ in range(2)]
        params[n] = s.params
        assert all(t.device.type == "cpu" for t in tree_leaves(s.params))
    for n in (2, 4):
        assert losses[n] == losses[1]
        for a, b in zip(tree_leaves(params[n]), tree_leaves(params[1])):
            assert torch.equal(a, b)


def test_shards_are_in_flight_at_once(tiny, monkeypatch, tmp_path):
    """On a host mesh of 4, every shard's call waits at a barrier of four
    parties (``_rendezvous.AtOnce``): it passes only if the four shards
    run at the same time, each in a process of its own (one thread
    launching them in turn times out at the first), for the infer and for
    the train step, with the bits of data=1."""
    cfg, np_params, frames, labels = tiny
    want = _session(cfg, np_params, api.ServeSpec(
        backend="hopper", mesh={"data": 1})).infer(frames)
    trained = _session(cfg, np_params, api.TrainSpec(
        backend="hopper", lr=1e-2, mesh={"data": 1}))
    want_loss = trained.train_step(frames, labels)
    calls = {}
    for name in ("_infer_shard", "_rows_shard"):
        (tmp_path / name).mkdir()
        calls[name] = AtOnce(tmp_path / name, 4, runner_mod.__name__, name)
        monkeypatch.setattr(runner_mod, name, calls[name])
    got = _session(cfg, np_params, api.ServeSpec(
        backend="hopper", mesh={"data": 4})).infer(frames)
    np.testing.assert_array_equal(got.logits, want.logits)
    _assert_counts_equal(got, want)
    s = _session(cfg, np_params, api.TrainSpec(backend="hopper", lr=1e-2,
                                               mesh={"data": 4}))
    assert s.train_step(frames, labels) == want_loss
    for a, b in zip(tree_leaves(s.params), tree_leaves(trained.params)):
        assert torch.equal(a, b)
    for at_once in calls.values():
        pids = at_once.pids()
        assert len(pids) == 4 and os.getpid() not in pids


def test_workers_hold_recent_params_versions_and_raise_errors(tiny):
    """Two sessions on the same host entries alternate without re-sending
    their params (each worker holds the last ``VERSIONS``); a shard that
    raises in its worker raises in the caller, and the next call works."""
    from repro_torch.dist import workers
    cfg, np_params, frames, _ = tiny
    a, b = (_session(cfg, np_params, api.ServeSpec(
        backend="batched", mesh={"data": 2})) for _ in range(2))
    want = a.infer(frames)
    b.infer(frames)
    held = workers._POOL["cpu:0"].held
    versions = list(held)
    np.testing.assert_array_equal(a.infer(frames).logits, want.logits)
    assert list(held)[-2:] == versions[-2:][::-1]        # no new version
    assert len(held) <= workers.VERSIONS
    with pytest.raises(ValueError, match="0 channels"):
        a.infer(frames[..., :0])            # raised in the workers
    assert not held
    np.testing.assert_array_equal(a.infer(frames).logits, want.logits)


def test_packed_outputs_unpack_to_the_same_bits(tiny):
    """A worker's graph reads its outputs back as one byte buffer
    (``runner._pack``): unpacked, they equal the plain read-back, field by
    field and dtype by dtype."""
    from repro_torch.core.snn_model import snn_apply
    from repro_torch.serving.batcher import to_host
    cfg, np_params, frames, _ = tiny
    params = from_jax_params(np_params, device="cpu")
    with torch.inference_mode():
        out = snn_apply(params, torch.from_numpy(frames), cfg,
                        backend="hopper")
        packed, layout = runner_mod._pack(out)
    got, want = runner_mod._unpack(packed.numpy(), layout), to_host(out)
    assert type(got) is type(want) and packed.dtype == torch.uint8
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_mesh_pads_to_the_shard_divisor(tiny):
    """A batch of 5 over data=4 runs as 8 rows (pad rows count, as the
    reference's global outputs do), and equals data=1 pinned to 8."""
    cfg, np_params, frames, _ = tiny
    got = _session(cfg, np_params, api.ServeSpec(
        backend="hopper", mesh={"data": 4})).infer(frames[:5])
    want = _session(cfg, np_params, api.ServeSpec(
        backend="hopper", mesh={"data": 1})).infer(frames[:5], bucket=8)
    assert got.logits.shape[0] == 5
    np.testing.assert_array_equal(got.logits, want.logits)
    _assert_counts_equal(got, want)


def test_runner_shards_over_the_batch_axes_only():
    cfg = _tiny_cfg()
    dm = DeviceMesh((("pod", 2), ("data", 2), ("model", 2)), device="cpu")
    r = MeshRunner(dm, cfg, api.ServeSpec(backend="batched"))
    # batch -> (pod, data): entries with model index 0, in mesh order
    assert r.shard_devices == tuple(torch.device("cpu", i)
                                    for i in (0, 2, 4, 6))
    assert r.lane_devices(3) == dm.lane_devices(3)
    with pytest.raises(ValueError, match="schedule"):
        MeshRunner(dm, cfg, api.ServeSpec(backend="hopper",
                                          schedule_mode="cbws"))


# -- against the reference's mesh path -----------------------------------------


@pytest.fixture(scope="module")
def reference_mesh(tiny):
    cfg, np_params, frames, labels = tiny
    jx = jx_api.Session(cfg, jx_api.TrainSpec(backend="batched", lr=1e-2,
                                              mesh={"data": 1}),
                        params=np_params)
    out = jx.infer(frames)
    padded = jx.infer(frames[:5], bucket=6)
    losses = [jx.train_step(frames, labels) for _ in range(2)]
    return out, padded, losses, jax.tree_util.tree_map(np.asarray,
                                                       jx.params)


@pytest.mark.parametrize("backend", ["batched", "hopper"])
def test_infer_matches_the_reference_mesh_path(tiny, reference_mesh,
                                               backend):
    cfg, np_params, frames, _ = tiny
    out, padded, _, _ = reference_mesh
    got = _session(cfg, np_params, api.ServeSpec(
        backend=backend, mesh={"data": 1})).infer(frames)
    np.testing.assert_allclose(got.logits, np.asarray(out.logits), atol=1e-5)
    for f in ("spike_counts", "spike_totals", "timestep_counts"):
        for a, b in zip(getattr(got, f), getattr(out, f)):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    # pad rows: a batch of 5 over data=2 runs 6 rows, as pad_to=6 does
    got5 = _session(cfg, np_params, api.ServeSpec(
        backend=backend, mesh={"data": 2})).infer(frames[:5])
    np.testing.assert_allclose(got5.logits, np.asarray(padded.logits),
                               atol=1e-5)
    for f in ("spike_counts", "spike_totals", "timestep_counts"):
        for a, b in zip(getattr(got5, f), getattr(padded, f)):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)


@pytest.mark.parametrize("backend", ["batched", "hopper"])
def test_train_step_matches_the_reference_mesh_path(tiny, reference_mesh,
                                                    backend):
    cfg, np_params, frames, labels = tiny
    _, _, want_losses, want_params = reference_mesh
    s = _session(cfg, np_params, api.TrainSpec(backend=backend, lr=1e-2,
                                               mesh={"data": 1}))
    losses = [s.train_step(frames, labels) for _ in range(2)]
    np.testing.assert_allclose(losses, want_losses, atol=1e-5)
    got = to_numpy_params(s.params)
    for k in ("conv", "dense"):
        for g, w in zip(got[k], want_params[k]):
            for n in ("w", "b"):
                np.testing.assert_allclose(g[n], w[n], atol=5e-5,
                                           rtol=5e-4)
    acc = s.evaluate(frames, labels)
    assert acc == _session(cfg, to_numpy_params(s.params), api.TrainSpec(
        backend=backend)).evaluate(torch.from_numpy(frames),
                                   torch.from_numpy(labels))


# -- the engine's pinned lanes -------------------------------------------------


def test_threaded_engine_on_pinned_lanes_survives_a_lane_crash(tiny):
    cfg, np_params, frames, _ = tiny
    sess = _session(cfg, np_params, api.ServeSpec(backend="hopper"))
    lanes = DeviceMesh(("data", 2), device="cpu").lane_devices(4)
    eng = sess.engine(api.ServeSpec(backend="hopper", num_lanes=4,
                                    threaded=True, max_batch=4),
                      lane_devices=lanes,
                      fault_plan=FaultPlan(crashes=((0, 0),)))
    n_req = 12
    rids = [eng.submit(frames[i % 8], arrival=0.0) for i in range(n_req)]
    eng.run()
    snap = eng.snapshot()
    assert snap.served + snap.rejected + snap.deadline_missed \
        + snap.cancelled == n_req
    assert snap.served > 0
    assert snap.lane_devices == ("cpu:0", "cpu:1", "cpu:0", "cpu:1")
    assert len(set(snap.lane_devices)) == 2
    got = {r.rid: np.asarray(r.logits) for r in eng.completed}
    want = _session(cfg, np_params, api.ServeSpec(
        backend="hopper", mesh={"data": 2})).infer(frames).logits
    for i, rid in enumerate(rids):
        if rid in got:
            np.testing.assert_array_equal(got[rid], want[i % 8])


def test_session_engine_pins_lanes_from_its_mesh(tiny):
    cfg, np_params, frames, _ = tiny
    sess = _session(cfg, np_params, api.ServeSpec(
        backend="batched", mesh={"data": 2}, num_lanes=3, threaded=True,
        max_batch=2))
    eng = sess.engine()
    assert eng.ecfg.lane_devices == (torch.device("cpu", 0),
                                     torch.device("cpu", 1),
                                     torch.device("cpu", 0))
    with sess.serve_forever() as live:
        handles = [live.submit(f) for f in frames[:4]]
        logits = [h.result(timeout=60) for h in handles]
    assert live.summary()["served"] == 4
    want = sess.infer(frames[:4]).logits
    for i, got in enumerate(logits):
        np.testing.assert_array_equal(got, want[i])


# -- the launchers ---------------------------------------------------------------


def _launch(module, args):
    code = (f"import json; from repro_torch.launch import {module} as m; "
            f"r = m.main({args!r}); "
            f"print(json.dumps({{k: (v.tolist() if hasattr(v, 'tolist') "
            f"else v) for k, v in r.items()}}))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_serve_launcher_mesh_matches_session():
    """The default backend (hopper) with --mesh: --schedule auto picks no
    schedule, since a mesh serves canonical weights."""
    from repro_torch.config import get_snn as pt_get_snn
    out = _launch("serve", ["--mesh", "2", "--device", "cpu", "--batch",
                            "3", "--steps", "1", "--log-level", "warning"])
    assert out["schedule"] == "none" and out["backend"] == "hopper"
    cfg = pt_get_snn("snn-mnist")
    rng = np.random.default_rng(0)
    last = [rng.random((3, *cfg.input_hw, cfg.input_channels),
                       dtype=np.float32) for _ in range(2)][-1]
    want = api.Session(cfg, api.ServeSpec(backend="hopper",
                                          mesh={"data": 2}),
                       seed=0, device="cpu").infer(last)
    np.testing.assert_array_equal(np.asarray(out["logits"], np.float32),
                                  want.logits)
    assert out["predictions"] == want.logits.argmax(-1).tolist()


def test_train_launcher_mesh_matches_session():
    from repro_torch.config import get_snn as pt_get_snn
    from repro_torch.data.synthetic import mnist_like
    out = _launch("train", ["--mesh", "data=2", "--device", "cpu",
                            "--backend", "batched", "--steps", "2",
                            "--batch", "3", "--lr", "1e-2",
                            "--log-level", "warning"])
    sess = api.Session(pt_get_snn("snn-mnist"), api.TrainSpec(
        backend="batched", lr=1e-2, mesh={"data": 2}), seed=0, device="cpu")
    want = [sess.train_step(*mnist_like(3, seed=i)) for i in range(2)]
    assert out["losses"] == want
    assert out["accuracy"] == sess.evaluate(*mnist_like(256, seed=10_000))
