"""Timestep-chunked execution in the port: against the reference's chunked
run, and against the port's own whole-T run (the reference's
chunk-parity contract, tests/test_chunk_parity.py, torch against torch).

Against JAX: the same weights (the reference's ``init_snn`` through
``from_jax_params``) and numpy frames; logits to 1e-5, spike counts
exactly.  Against itself: every chunking of T gives the whole-T run's bits
on every backend (on CPU tensors ``hopper`` runs its kernels' plain
versions; ``chip_smoke.py`` checks the kernels on the card), and a row's
logits do not depend on the batch it ran in.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import get_snn
from repro.core import chunk_lengths as jx_chunk_lengths
from repro.core import init_snn as jx_init_snn
from repro.core import snn_apply_chunked as jx_snn_apply_chunked
from repro_torch.core import (build_schedule, chunk_lengths,
                              init_chunk_carry, snn_apply, snn_apply_chunk,
                              snn_apply_chunked)
from repro_torch.core import snn_layers as L
from repro_torch.core.snn_model import freeze_params
from repro_torch.interop import from_jax_params
from repro_torch.kernels import ops

BACKENDS = ("ref", "batched", "hopper")


def _tiny_cfg(timesteps=5):
    return dataclasses.replace(
        get_snn("snn-mnist"), input_hw=(8, 8), conv_channels=(8, 8),
        timesteps=timesteps, num_spe_clusters=4)


@pytest.fixture(scope="module")
def tiny():
    cfg = _tiny_cfg()
    jparams = jax.tree_util.tree_map(np.asarray, jax.jit(
        jx_init_snn, static_argnums=1)(jax.random.PRNGKey(0), cfg))
    return cfg, jparams, from_jax_params(jparams, device="cpu")


def _frames(n, cfg, seed=0):
    return np.random.default_rng(seed).random(
        (n, *cfg.input_hw, cfg.input_channels), dtype=np.float32)


def _apply(params, x, cfg, backend, ct=None):
    with torch.no_grad():
        x = torch.from_numpy(x)
        if ct is None:
            return snn_apply(params, x, cfg, backend=backend)
        return snn_apply_chunked(params, x, cfg, chunk_timesteps=ct,
                                 backend=backend)


def _leaves(carry):
    return list(carry.conv_v) + list(carry.dense_v) + [carry.readout_v]


# -- against the reference ---------------------------------------------------

@pytest.mark.parametrize("t_total", [1, 5, 8, 9])
def test_chunk_lengths_match_the_reference(t_total):
    for ct in range(1, 11):
        assert chunk_lengths(t_total, ct) == jx_chunk_lengths(t_total, ct)
    for bad in ((5, 0), (0, 2)):
        with pytest.raises(ValueError):
            chunk_lengths(*bad)


@pytest.fixture(scope="module")
def jax_chunked(tiny):
    """The reference's chunked outputs, batched backend, per chunk length."""
    cfg, jparams, _ = tiny
    x = _frames(3, cfg, seed=1)
    run = jax.jit(jx_snn_apply_chunked,
                  static_argnames=("cfg", "chunk_timesteps", "backend"))
    return x, {ct: jax.tree_util.tree_map(np.asarray, run(
        jparams, x, cfg=cfg, chunk_timesteps=ct, backend="batched"))
        for ct in (1, 2, 3, 5, 7)}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("ct", [1, 2, 3, 5, 7])
def test_chunked_forward_matches_the_reference(tiny, jax_chunked, backend,
                                               ct):
    cfg, _, params = tiny
    x, want = jax_chunked[0], jax_chunked[1][ct]
    got = _apply(params, x, cfg, backend, ct)
    np.testing.assert_allclose(got.logits.numpy(), want.logits, atol=1e-5,
                               rtol=0)
    for a, b in zip(got.timestep_counts, want.timestep_counts):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(got.spike_totals, want.spike_totals):
        assert float(a) == float(b)


# -- against itself: bit-exact chunk parity ----------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("ct", [1, 2, 3, 5, 7])
def test_chunked_forward_bit_identical(tiny, backend, ct):
    """snn_apply_chunked == snn_apply for every uniform chunking, every
    backend: logits, per-timestep counts, totals and skip fractions."""
    cfg, _, params = tiny
    x = _frames(3, cfg, seed=1)
    want = _apply(params, x, cfg, backend)
    got = _apply(params, x, cfg, backend, ct)
    assert torch.equal(got.logits, want.logits)
    for a, b in zip(got.timestep_counts + got.spike_totals,
                    want.timestep_counts + want.spike_totals):
        assert torch.equal(a, b)
    assert len(got.skip_fractions) == len(want.skip_fractions)
    for a, b in zip(got.skip_fractions, want.skip_fractions):
        assert abs(float(a) - float(b)) < 1e-6


def _check_partition(tiny, partition, backend):
    """Chaining snn_apply_chunk over ``partition`` of T reproduces the
    whole-T carry and counts bit for bit."""
    cfg, _, params = tiny
    assert sum(partition) == cfg.timesteps
    x = torch.from_numpy(_frames(2, cfg, seed=2))
    with torch.no_grad():
        want_out, want_carry = snn_apply_chunk(
            params, x, init_chunk_carry(cfg, 2, device="cpu"), cfg,
            t_chunk=cfg.timesteps, backend=backend)
        carry, counts = init_chunk_carry(cfg, 2, device="cpu"), []
        for c in partition:
            out, carry = snn_apply_chunk(params, x, carry, cfg, t_chunk=c,
                                         backend=backend)
            counts.append(out.timestep_counts)
    for a, b in zip(_leaves(want_carry), _leaves(carry)):
        assert torch.equal(a, b), f"carry diverged for {partition}"
    for i, want in enumerate(want_out.timestep_counts):
        got = torch.cat([c[i] for c in counts])
        assert torch.equal(got, want), f"counts diverged for {partition}"


@pytest.mark.parametrize("partition", [(1, 3, 1), (2, 1, 2), (4, 1),
                                       (1, 1, 1, 1, 1), (5,)])
@pytest.mark.parametrize("backend", BACKENDS)
def test_mixed_partition_carry_chain(tiny, partition, backend):
    _check_partition(tiny, list(partition), backend)


@pytest.mark.parametrize("ct", [1, 2, 3, 5])
def test_chunked_fused_layer_gradients_bit_identical(tiny, ct):
    """BPTT through ``ops.spiking_conv_lif_chunked`` (membrane carried
    across segments) == whole-T BPTT, bit for bit, for the reference's
    loss ``s.sum() + v.sum()``.  With v_th = 1 that loss makes every
    membrane cotangent exactly 1, so the weight gradient is a count of
    spikes and the same in any summation order; the membrane and input
    gradients chain across segments exactly for any loss."""
    cfg, _, params = tiny
    T, B = cfg.timesteps, 2
    rng = np.random.default_rng(3)
    w, bias = params["conv"][1]["w"], params["conv"][1]["b"]
    spikes = torch.from_numpy((rng.random((T, B, 10, 10, 8)) < 0.3)
                              .astype(np.float32))
    v0 = torch.zeros((B, 12, 12, w.shape[-1]))
    g_s = torch.from_numpy(rng.standard_normal((T, B, 12, 12, 8))
                           .astype(np.float32))

    def grads(chunked, weight_loss):
        ws, bs = w.clone().requires_grad_(True), bias.clone().requires_grad_(
            True)
        xs, vs = spikes.clone().requires_grad_(True), \
            v0.clone().requires_grad_(True)
        if chunked:
            s, v = ops.spiking_conv_lif_chunked(xs, vs, ws, bs,
                                                chunk_timesteps=ct)
        else:
            s, v = ops.spiking_conv_lif(xs, vs, ws, bs)
        loss = s.sum() + v.sum() if weight_loss else (s * g_s).sum()
        loss.backward()
        return ws.grad, bs.grad, xs.grad, vs.grad

    for a, b in zip(grads(False, True), grads(True, True)):
        assert torch.equal(a, b), f"ct={ct}"
    for a, b in zip(grads(False, False)[2:], grads(True, False)[2:]):
        assert torch.equal(a, b), f"ct={ct}: dx/dv0"


@pytest.mark.parametrize("backend", BACKENDS)
def test_cross_batch_row_bits_stable(tiny, backend):
    """A row's logits do not depend on the batch it ran in, nor on the
    chunking: the property that lets the engine regroup a request's chunks
    into whatever micro-batch is running when its turn comes."""
    cfg, _, params = tiny
    x = _frames(16, cfg, seed=4)
    ref = _apply(params, x, cfg, backend).logits
    for n in (1, 2, 3, 4, 8):
        got = _apply(params, x[:n], cfg, backend).logits
        assert torch.equal(got, ref[:n]), f"batch {n} rows drifted"
    for ct in (1, 2):
        got = _apply(params, x[:1], cfg, backend, ct).logits
        assert torch.equal(got, ref[:1]), f"chunked b1 ct={ct} drifted"
    # a row's bits do not depend on its position in the batch either
    perm = np.random.default_rng(5).permutation(16)
    got = _apply(params, x[perm], cfg, backend).logits
    assert torch.equal(got, ref[perm])


@pytest.mark.parametrize("backend", BACKENDS)
def test_frozen_params_give_the_same_bits(tiny, backend):
    """``freeze_params`` (the serving cache's params: the dense layers'
    exact-grid weights computed once) changes no bit of a forward, whole T
    or chunked, with or without the CBWS schedule (which permutes the
    first dense layer's rounded weights with its weights)."""
    cfg, _, params = tiny
    frozen = freeze_params(params)
    assert all("wq" in dp and "wq" not in p
               for dp, p in zip(frozen["dense"], params["dense"]))
    x = torch.from_numpy(_frames(6, cfg, seed=8))
    sched = build_schedule(params, cfg, "aprc+cbws") \
        if backend == "hopper" else None
    with torch.no_grad():
        for ct in (None, 2):
            run = (lambda p: snn_apply(p, x, cfg, backend=backend,
                                       schedule=sched)) if ct is None else (
                lambda p: snn_apply_chunked(p, x, cfg, chunk_timesteps=ct,
                                            backend=backend, schedule=sched))
            assert torch.equal(run(frozen).logits, run(params).logits), ct


@pytest.mark.parametrize("cin, binary", [(1, False), (8, False), (8, True)])
def test_conv2d_rows_stable_for_analog_and_spike_inputs(cin, binary):
    """The plain conv routes by the input's values, not its width: an
    analog input of any width takes the fixed-order taps, a 0/1 input the
    exact float64 GEMM.  Either way a row's bits do not depend on the
    batch, and the result is the convolution's (float64 ``F.conv2d`` of
    the same tensors, to float32 rounding)."""
    rng = np.random.default_rng(cin + 10 * binary)
    x = rng.random((9, 6, 7, cin)).astype(np.float32)
    if binary:
        x = (x < 0.3).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, 5)) * 0.3).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    full = L.conv2d(xt, wt, aprc=True)
    for n in (1, 2, 3):
        assert torch.equal(L.conv2d(xt[:n], wt, aprc=True), full[:n]), n
    want = torch.nn.functional.conv2d(
        xt.double().permute(0, 3, 1, 2), wt.double().permute(3, 2, 0, 1),
        padding=2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(full.numpy(), want.numpy(), rtol=0,
                               atol=1e-5)


def test_chunk_entry_points_default_to_the_card(tiny):
    cfg, _, params = tiny
    if torch.cuda.is_available():
        carry = init_chunk_carry(cfg, 1)
        assert carry.readout_v.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_chunk_carry(cfg, 1)
    carry = init_chunk_carry(cfg, 2, device="cpu")
    assert all(a.device.type == "cpu" and not bool(a.any())
               for a in _leaves(carry))
