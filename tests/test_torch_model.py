"""The port's model forward against the reference: the same weights (the
reference's ``init_snn`` through ``from_jax_params``) and the same numpy
inputs through JAX ``snn_apply(backend="ref"|"batched")`` and the port's
``ref``, ``batched`` and ``hopper`` backends (on CPU tensors the hopper
kernels' wrappers run their plain versions).  Logits agree to 1e-5, spike
counts exactly, as the reference holds its own backends
(tests/test_snn_backends.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_snn
from repro.core import encoding as jx_encoding
from repro.core import init_snn as jx_init_snn
from repro.core import snn_apply as jx_snn_apply
from repro.core import snn_model as jx_snn_model
from repro.core.neuron import lif_over_time as jx_lif_over_time
from repro.core.snn_layers import spiking_conv_step as jx_spiking_conv_step
from repro.core.surrogate import SURROGATE_KINDS
from repro.core.surrogate import surrogate_grad as jx_surrogate_grad
from repro.kernels import ref as jx_ref
from repro.kernels.spiking_conv import \
    skip_table_fraction as jx_skip_table_fraction
from repro_torch.core import (SNN, build_schedule, direct_encode,
                              lif_over_time, poisson_encode, snn_apply)
from repro_torch.core.neuron import lif_init
from repro_torch.core.snn_layers import spiking_conv_step
from repro_torch.core.surrogate import (NonDifferentiableSpikeError,
                                        heaviside, spike_fn)
from repro_torch.interop import from_jax_params

PORT_BACKENDS = ("ref", "batched", "hopper")


def _tiny_mnist_cfg():
    return dataclasses.replace(
        get_snn("snn-mnist"), input_hw=(8, 8), conv_channels=(8, 8),
        timesteps=3, num_spe_clusters=4)


def _tiny_seg_cfg():
    return dataclasses.replace(
        get_snn("snn-seg"), input_hw=(6, 8), conv_channels=(4, 1),
        timesteps=2, num_spe_clusters=2)


def _jax_params(cfg, seed):
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        jx_init_snn, static_argnums=1)(jax.random.PRNGKey(seed), cfg))


def _frames(seed, shape, rate=None):
    x = np.random.default_rng(seed).random(shape, dtype=np.float32)
    return x if rate is None else (x < rate).astype(np.float32)


# name -> (cfg, params seed, input made from a numpy seed)
CASES = {
    "mnist-direct": (_tiny_mnist_cfg, 0, lambda c: _frames(1, (2, 8, 8, 1))),
    "mnist-train": (_tiny_mnist_cfg, 4,
                    lambda c: _frames(5, (c.timesteps, 2, 8, 8, 1), 0.4)),
    "mnist-sparse-train": (_tiny_mnist_cfg, 6,
                           lambda c: _frames(7, (c.timesteps, 2, 8, 8, 1),
                                             0.01)),
    "seg-direct": (_tiny_seg_cfg, 2, lambda c: _frames(3, (1, 6, 8, 3))),
    "seg-train": (_tiny_seg_cfg, 8,
                  lambda c: _frames(9, (c.timesteps, 2, 6, 8, 3), 0.3)),
}


@pytest.fixture(scope="module")
def reference():
    """Each case's weights, input and the reference's ref/batched outputs,
    computed once for the module (jitted: one compile per case and
    backend instead of one per op)."""
    apply = jax.jit(jx_snn_apply, static_argnames=("cfg", "backend"))
    out = {}
    for name, (make_cfg, seed, make_x) in CASES.items():
        cfg = make_cfg()
        np_params, x = _jax_params(cfg, seed), make_x(cfg)
        want = {b: apply(np_params, jnp.asarray(x), cfg=cfg, backend=b)
                for b in ("ref", "batched")}
        out[name] = (cfg, np_params, x, want)
    return out


def _assert_outputs_match(got, want, logits_tol=1e-5):
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=logits_tol, rtol=logits_tol)
    assert len(got.spike_counts) == len(want.spike_counts)
    for a, b in zip(got.spike_counts, want.spike_counts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got.timestep_counts, want.timestep_counts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got.spike_totals, want.spike_totals):
        assert float(a) == float(b)


@pytest.mark.parametrize("schedule", [None, "aprc+cbws"])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("case", list(CASES))
def test_backends_match_reference(reference, case, backend, schedule):
    cfg, np_params, x, want = reference[case]
    params = from_jax_params(np_params, device="cpu")
    sched = build_schedule(params, cfg, schedule) if schedule else None
    got = snn_apply(params, torch.from_numpy(x), cfg, backend=backend,
                    schedule=sched)
    for ref_backend in ("ref", "batched"):
        _assert_outputs_match(got, want[ref_backend])
    if backend != "hopper":
        assert got.skip_fractions == ()


@jax.jit(static_argnums=0)
def _reference_fused_trains(cfg, np_params, x):
    """The input train of every fused (time-batched, kernel-B) layer, as
    the reference computes them: layer-0 output through the hoisted conv
    and LIF scan for direct-coded frames, the given train otherwise."""
    n_fused = len(cfg.conv_channels) - (0 if cfg.dense_units else 1)
    trains, v_th = [], cfg.v_threshold
    conv = np_params["conv"]
    if x.ndim == 4:
        z = jx_ref.spiking_conv_ref(x, conv[0]["w"], conv[0]["b"],
                                    aprc=cfg.aprc)
        s, _, _ = jx_snn_model._lif_scan_const(z, cfg.timesteps, v_th, 10.0)
        first = 1
    else:
        s, first = jnp.asarray(x), 0
    for i in range(first, len(conv)):
        trains.append(s)
        if i < n_fused:
            b, e = s.shape[1], jx_snn_model.layer_shapes(cfg)[i]
            s, _ = jx_ref.spiking_conv_lif_ref(
                s, jnp.zeros((b,) + e), conv[i]["w"], conv[i]["b"],
                v_th=v_th, aprc=cfg.aprc)
    return trains


@pytest.mark.parametrize("case", ["mnist-direct", "mnist-sparse-train",
                                  "seg-train"])
def test_hopper_skip_fractions_match_reference(reference, case):
    """The hopper backend reports one skip fraction per layer whose input
    is a spike train, equal to the reference's skip_table_fraction of the
    same train."""
    cfg, np_params, x, _ = reference[case]
    params = from_jax_params(np_params, device="cpu")
    got = snn_apply(params, torch.from_numpy(x), cfg, backend="hopper",
                    schedule=build_schedule(params, cfg))
    trains = _reference_fused_trains(cfg, np_params, jnp.asarray(x))
    want = [float(jx_skip_table_fraction(t, cfg.kernel_size, aprc=cfg.aprc))
            for t in trains]
    assert [float(f) for f in got.skip_fractions] == want
    if case == "mnist-sparse-train":
        assert want[0] > 0      # the sparse train really skips cells


@pytest.mark.parametrize("chunk", [None, 2])
@pytest.mark.parametrize("case", ["mnist-direct", "mnist-sparse-train",
                                  "seg-direct", "seg-train"])
def test_hopper_counts_on_the_cpu_take_the_fallback(reference, case, chunk):
    """On the CPU no launch counts its train: the hopper backend reduces
    each train with torch ops and calls ``skip_table_fraction`` once a
    fused layer (chunked: once a layer and chunk), with the reference's
    timestep counts and skip fractions, bit for bit."""
    from repro_torch.core import snn_apply_chunked
    from repro_torch.kernels.spiking_conv import skip_table_fraction
    cfg, np_params, x, want = reference[case]
    params = from_jax_params(np_params, device="cpu")
    sched = build_schedule(params, cfg)
    calls = skip_table_fraction.calls
    if chunk is None:
        got = snn_apply(params, torch.from_numpy(x), cfg, backend="hopper",
                        schedule=sched)
    else:
        got = snn_apply_chunked(params, torch.from_numpy(x), cfg,
                                chunk_timesteps=chunk, backend="hopper",
                                schedule=sched)
    n_chunks = 1 if chunk is None else -(-cfg.timesteps // chunk)
    assert skip_table_fraction.calls == \
        calls + n_chunks * len(got.skip_fractions)
    for a, b in zip(got.timestep_counts, want["batched"].timestep_counts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    trains = _reference_fused_trains(cfg, np_params, jnp.asarray(x))
    assert [float(f) for f in got.skip_fractions] == [
        float(jx_skip_table_fraction(t, cfg.kernel_size, aprc=cfg.aprc))
        for t in trains]


def test_snn_module_forward_is_snn_apply(reference):
    cfg, np_params, x, want = reference["mnist-direct"]
    params = from_jax_params(np_params, device="cpu")
    model = SNN(cfg, params, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x), backend="hopper",
                    schedule=build_schedule(model.param_dict(), cfg))
    _assert_outputs_match(got, want["ref"])


def test_channel_mismatch_and_unknown_backend_raise():
    cfg = _tiny_mnist_cfg()
    params = from_jax_params(_jax_params(cfg, 0), device="cpu")
    x = torch.from_numpy(_frames(2, (2, 8, 8, 2)))
    for backend in PORT_BACKENDS:
        with pytest.raises(ValueError, match="input_channels"):
            snn_apply(params, x, cfg, backend=backend)
    with pytest.raises(ValueError, match="backend"):
        snn_apply(params, x[..., :1], cfg, backend="pallas")
    state = lif_init((1, 10, 10, 8))
    with pytest.raises(ValueError, match=r"(?s)ref.*batched.*hopper"):
        spiking_conv_step(params["conv"][0], state, x[:1, ..., :1],
                          aprc=True, v_th=1.0, backend="fpga")


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_spiking_conv_step_matches_reference(backend):
    cfg = _tiny_mnist_cfg()
    np_params = _jax_params(cfg, 0)["conv"][0]
    spikes = _frames(6, (2, 8, 8, 1), 0.3)
    v0 = np.zeros((2, 10, 10, 8), np.float32)
    st_w, s_w = jx_spiking_conv_step(
        np_params, jx_snn_model.LIFState(v=jnp.asarray(v0)),
        jnp.asarray(spikes), aprc=True, v_th=1.0)
    p = {k: torch.from_numpy(v.copy()) for k, v in np_params.items()}
    st, s = spiking_conv_step(p, lif_init(v0.shape), torch.from_numpy(spikes),
                              aprc=True, v_th=1.0, backend=backend)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_w))
    np.testing.assert_allclose(st.v.numpy(), np.asarray(st_w.v), atol=1e-5)


def test_heaviside_backward_raises_not_silent_zeros():
    x = torch.linspace(-1.0, 1.0, 8, requires_grad=True)
    assert float(heaviside(x).detach().sum()) == 4.0   # forward still works
    with pytest.raises(NonDifferentiableSpikeError,
                       match=r"(?s)spike_fn.*ref.*batched"):
        heaviside(x).sum().backward()


@pytest.mark.parametrize("kind", SURROGATE_KINDS)
def test_spike_fn_surrogate_matches_reference(kind):
    v = np.linspace(-1.5, 1.5, 41).astype(np.float32)
    x = torch.from_numpy(v).requires_grad_(True)
    s = spike_fn(x, 4.0, kind)
    s.sum().backward()
    np.testing.assert_array_equal(s.detach().numpy(), (v >= 0).astype(
        np.float32))
    np.testing.assert_allclose(
        x.grad.numpy(), np.asarray(jx_surrogate_grad(v, 4.0, kind)),
        rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="surrogate"):
        spike_fn(x, 4.0, "sigmoid").sum().backward()


def test_lif_over_time_and_encoders_match_reference():
    z = np.random.default_rng(0).standard_normal((5, 3, 7)).astype(
        np.float32)
    s, st = lif_over_time(torch.from_numpy(z), v_th=0.8)
    s_w, st_w = jx_lif_over_time(jnp.asarray(z), v_th=0.8)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_w))
    np.testing.assert_allclose(st.v.numpy(), np.asarray(st_w.v), atol=1e-6)
    x = _frames(1, (2, 4, 4, 1))
    np.testing.assert_array_equal(
        direct_encode(torch.from_numpy(x), 3).numpy(),
        np.asarray(jx_encoding.direct_encode(jnp.asarray(x), 3)))
    trains = [poisson_encode(torch.Generator().manual_seed(5),
                             torch.from_numpy(x), 4) for _ in range(2)]
    assert trains[0].shape == (4, 2, 4, 4, 1)
    assert torch.equal(trains[0], trains[1])
    assert set(trains[0].unique().tolist()) <= {0.0, 1.0}
