"""``snn-seg`` in the port against the reference, on the CPU: all six layers
(a three-channel hoisted first layer, four fused layers, the non-firing
Cout=1 readout conv and its center crop), at narrowed widths, a reduced
frame and T=3, on ``road_like`` frames.

The port's ``hopper`` (its kernels' plain versions on CPU tensors, with
and without the CBWS schedule) and ``batched`` against the reference's
``batched``, on the reference's weights (``from_jax_params``): logits to
1e-5, spike counts exactly; the gradient of the reference's segmentation
test loss ``sum(logits ** 2)`` (``tests/test_snn_backends.py``) to atol
5e-5 / rtol 5e-4, the reference's bounds for its own backends.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_snn
from repro.core import init_snn as jx_init_snn
from repro.core import snn_apply as jx_snn_apply
from repro_torch.core.scheduler import build_schedule
from repro_torch.core.snn_model import snn_apply
from repro_torch.data.synthetic import road_like
from repro_torch.interop import from_jax_params

GRAD_TOL = dict(atol=5e-5, rtol=5e-4)


def _cfg():
    return dataclasses.replace(
        get_snn("snn-seg"), input_hw=(12, 20),
        conv_channels=(4, 8, 8, 8, 4, 1), timesteps=3, num_spe_clusters=4)


@pytest.fixture(scope="module")
def seg():
    cfg = _cfg()
    np_params = jax.tree_util.tree_map(np.asarray, jax.jit(
        jx_init_snn, static_argnums=1)(jax.random.PRNGKey(3), cfg))
    frames, _ = road_like(2, h=12, w=20, seed=0)
    want = jx_snn_apply(np_params, jnp.asarray(frames), cfg,
                        backend="batched")
    return cfg, np_params, frames, want


def _leaves(tree):
    return [tree[kind][i][k] for kind in ("conv", "dense")
            for i in range(len(tree[kind])) for k in ("w", "b")]


@pytest.mark.parametrize("backend, scheduled", [("batched", False),
                                                ("hopper", False),
                                                ("hopper", True)])
def test_seg_forward_matches_the_reference(seg, backend, scheduled):
    cfg, np_params, frames, want = seg
    params = from_jax_params(np_params, device="cpu")
    sched = build_schedule(params, cfg, "aprc+cbws") if scheduled else None
    with torch.no_grad():
        got = snn_apply(params, torch.from_numpy(frames), cfg,
                        backend=backend, schedule=sched)
    assert got.logits.shape == (2, 12, 20, 1)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=1e-5, rtol=1e-5)
    assert len(got.spike_counts) == len(cfg.conv_channels)
    for a, b in zip(got.spike_counts, want.spike_counts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got.timestep_counts, want.timestep_counts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the first five layers fire; the readout's mask is observability only
    assert all(float(t) > 0 for t in got.spike_totals[:5])


@pytest.mark.parametrize("backend", ["batched", "hopper"])
def test_seg_gradients_match_the_reference(seg, backend):
    cfg, np_params, frames, _ = seg

    def jx_loss(p):
        return jnp.sum(jx_snn_apply(p, jnp.asarray(frames), cfg,
                                    backend="batched").logits ** 2)

    want = _leaves(jax.jit(jax.grad(jx_loss))(np_params))
    params = from_jax_params(np_params, device="cpu")
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    out = snn_apply(params, torch.from_numpy(frames), cfg, backend=backend,
                    logits_only=True)
    (out.logits ** 2).sum().backward()
    for t, w in zip(leaves, want):
        assert t.grad is not None
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL)
    assert all(float(t.grad.abs().max()) > 0 for t in leaves[::2])
