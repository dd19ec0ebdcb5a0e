"""The port's training path against the reference.

The backward pieces (``lif_bwd_ref``, ``conv_grad_input_ref``,
``conv_grad_weights``) against the reference's XLA ones, the hopper
backend's gradients (its autograd Functions on CPU tensors, which run the
kernels' plain versions) against ``jax.grad`` of the reference's loss with
``backend="batched"``, a finite-difference check of the fused op's
backward, a short training run, per-example gradient rows, the synthetic
data and the training launcher.  Gradients agree to atol 5e-5 / rtol 5e-4,
the reference's bounds for its own backends (tests/test_snn_backends.py).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_snn
from repro.core import init_snn as jx_init_snn
from repro.core import snn_apply as jx_snn_apply
from repro.core.snn_train import make_grad_rows_fn as jx_make_grad_rows_fn
from repro.core.snn_train import make_loss_fn as jx_make_loss_fn
from repro.core.snn_train import make_train_step as jx_make_train_step
from repro.core.surrogate import SURROGATE_KINDS
from repro.data import synthetic as jx_synthetic
from repro.kernels import spiking_conv as jx_spiking_conv
from repro.kernels.spiking_conv_lif import lif_bwd_xla
from repro_torch.core import snn_apply
from repro_torch.core.snn_train import (make_grad_rows_fn, make_loss_fn,
                                        make_train_step)
from repro_torch.data import synthetic
from repro_torch.interop import from_jax_params
from repro_torch.kernels import ref
from repro_torch.kernels.spiking_conv import (SpikingConvFn, conv_grad_input,
                                              conv_grad_weights)
from repro_torch.kernels.spiking_conv_lif import (SpikingConvLIFFn, lif_bwd,
                                                  spiking_conv_lif)

SRC = Path(__file__).resolve().parents[1] / "src"
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)

jx_conv_grad_input = jax.jit(jx_spiking_conv.conv_grad_input_xla,
                             static_argnames="aprc")
jx_conv_grad_weights = jax.jit(jx_spiking_conv.conv_grad_weights_xla,
                               static_argnames=("aprc", "r"))
jx_lif_bwd = jax.jit(lif_bwd_xla, static_argnames=("v_th", "alpha", "kind"))

# B, H, W, Cin, Cout, R, aprc: odd heights and widths throughout
CONV_CASES = [
    (2, 7, 9, 3, 8, 3, True),
    (2, 7, 9, 3, 8, 3, False),
    (1, 9, 7, 2, 5, 5, True),
    (1, 9, 7, 2, 5, 5, False),
]


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


def _leaves(tree):
    """Every parameter leaf, in one order for both packages' dicts."""
    return [tree[kind][i][k] for kind in ("conv", "dense")
            for i in range(len(tree[kind])) for k in ("w", "b")]


def _port_grads(np_params, loss_fn):
    """The gradient of ``loss_fn(params)`` at the reference's weights,
    by ``loss.backward()``: one ``.grad`` per leaf, None where no
    gradient arrived."""
    params = from_jax_params(np_params, device="cpu")
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss_fn(params).backward()
    return [t.grad for t in leaves]


def _assert_grads_close(got, want, **tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g is not None
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   **(tol or GRAD_TOL))


def _frames(seed, shape, rate=None):
    x = np.random.default_rng(seed).random(shape, dtype=np.float32)
    return x if rate is None else (x < rate).astype(np.float32)


# -- the backward pieces -----------------------------------------------------

@pytest.mark.parametrize("kind", SURROGATE_KINDS)
@pytest.mark.parametrize("fn", [ref.lif_bwd_ref, lif_bwd],
                         ids=["oracle", "wrapper"])
def test_lif_bwd_matches_reference(fn, kind):
    rng = np.random.default_rng(len(kind))
    u = (rng.standard_normal((4, 2, 5, 7, 3)) * 0.6 + 0.9).astype(np.float32)
    g_s = rng.standard_normal(u.shape).astype(np.float32)
    g_v = rng.standard_normal(u.shape[1:]).astype(np.float32)
    launches = lif_bwd.launches
    lam, dv0 = fn(*map(torch.from_numpy, (u, g_s, g_v)), v_th=1.0,
                  alpha=4.0, kind=kind)
    lam_w, dv0_w = jx_lif_bwd(u, g_s, g_v, v_th=1.0, alpha=4.0, kind=kind)
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_w), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(dv0.numpy(), np.asarray(dv0_w), atol=1e-6,
                               rtol=1e-6)
    assert lif_bwd.launches == launches


@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("fn", [ref.conv_grad_input_ref, conv_grad_input],
                         ids=["oracle", "wrapper"])
def test_conv_grad_input_matches_reference(fn, case):
    b, h, w_, cin, cout, r, aprc = case
    rng = np.random.default_rng(sum(case))
    e_h, e_w = (h + r - 1, w_ + r - 1) if aprc else (h, w_)
    dz = rng.standard_normal((b, e_h, e_w, cout)).astype(np.float32)
    w = (rng.standard_normal((r, r, cin, cout)) * 0.3).astype(np.float32)
    launches = conv_grad_input.launches
    got = fn(torch.from_numpy(dz), torch.from_numpy(w), aprc=aprc).numpy()
    want = np.asarray(jx_conv_grad_input(dz, w, aprc=aprc))
    assert got.shape == want.shape == (b, h, w_, cin)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert conv_grad_input.launches == launches


@pytest.mark.parametrize("case", CONV_CASES)
def test_conv_grad_weights_matches_reference(case):
    b, h, w_, cin, cout, r, aprc = case
    rng = np.random.default_rng(sum(case) + 1)
    e_h, e_w = (h + r - 1, w_ + r - 1) if aprc else (h, w_)
    x = (rng.random((b, h, w_, cin)) < 0.3).astype(np.float32)
    dz = rng.standard_normal((b, e_h, e_w, cout)).astype(np.float32)
    dw, db = conv_grad_weights(torch.from_numpy(x), torch.from_numpy(dz),
                               aprc=aprc, r=r)
    dw_w, db_w = jx_conv_grad_weights(x, dz, aprc=aprc, r=r)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_w), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_w), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("aprc", [True, False])
def test_spiking_conv_fn_matches_autograd_of_the_plain_conv(aprc):
    """SpikingConvFn's (dx, dw, db) are the gradient of conv plus bias."""
    rng = np.random.default_rng(int(aprc))
    x = torch.from_numpy((rng.random((2, 7, 9, 3)) < 0.4).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, 3, 5)) * 0.3)
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    proj = torch.from_numpy(rng.standard_normal(
        ref.spiking_conv_ref(x, w, b, aprc=aprc).shape).astype(np.float32))
    grads = []
    for fn in (lambda *a: SpikingConvFn.apply(*a, aprc),
               lambda *a: ref.spiking_conv_ref(*a, aprc=aprc)):
        args = [t.clone().requires_grad_(True) for t in (x, w, b)]
        (fn(*args) * proj).sum().backward()
        grads.append([a.grad for a in args])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# -- model gradients against jax.grad ----------------------------------------

def _reference_grads(cfg, np_params, x, y, **kw):
    loss = jx_make_loss_fn(cfg, backend="batched", **kw)
    return _leaves(jax.jit(jax.grad(loss))(np_params, jnp.asarray(x),
                                           jnp.asarray(y)))


def _hopper_grads(cfg, np_params, x, y, backend="hopper", **kw):
    loss = make_loss_fn(cfg, backend=backend, **kw)
    return _port_grads(np_params, lambda p: loss(p, torch.from_numpy(x),
                                                 torch.from_numpy(y)))


@pytest.mark.parametrize("kind", SURROGATE_KINDS)
def test_hopper_gradients_match_reference(kind):
    cfg = _tiny_mnist_cfg()
    np_params = _jax_params(cfg, 0)
    x, y = _frames(1, (2, 8, 8, 1)), np.array([3, 7], np.int32)
    kw = dict(surrogate_alpha=4.0, surrogate_kind=kind)
    _assert_grads_close(_hopper_grads(cfg, np_params, x, y, **kw),
                        _reference_grads(cfg, np_params, x, y, **kw))


def test_hopper_spike_train_gradients_match_reference():
    """5-D input: every conv layer is a fused layer (no hoist), and the
    first one's input train needs no gradient."""
    cfg = _tiny_mnist_cfg()
    np_params = _jax_params(cfg, 4)
    x = _frames(5, (cfg.timesteps, 2, 8, 8, 1), 0.4)
    y = np.array([0, 9], np.int32)
    kw = dict(surrogate_alpha=4.0, surrogate_kind="fast_sigmoid")
    _assert_grads_close(_hopper_grads(cfg, np_params, x, y, **kw),
                        _reference_grads(cfg, np_params, x, y, **kw))


def test_hopper_segmentation_gradients_match_reference():
    """The non-firing readout conv differentiates through SpikingConvFn,
    with dx into the fused layer below it."""
    cfg = _tiny_seg_cfg()
    np_params = _jax_params(cfg, 2)
    x = _frames(3, (1, 6, 8, 3))

    def jx_loss(p):
        return jnp.sum(jx_snn_apply(p, jnp.asarray(x), cfg,
                                    backend="batched").logits ** 2)

    want = _leaves(jax.jit(jax.grad(jx_loss))(np_params))
    got = _port_grads(np_params, lambda p: (snn_apply(
        p, torch.from_numpy(x), cfg, backend="hopper").logits ** 2).sum())
    _assert_grads_close(got, want)


def test_hopper_cpu_gradients_reach_every_conv_weight():
    """On CPU tensors the hopper backend differentiates through its
    autograd Functions: every conv weight gets the batched backend's
    gradient, and both get the reference's.  (Its CPU route used to
    drop the surrogate: ``.grad`` stayed None on every conv weight.)"""
    cfg = _tiny_mnist_cfg()
    np_params = _jax_params(cfg, 0)
    x, y = _frames(1, (2, 8, 8, 1)), np.array([3, 7], np.int32)
    hopper = _hopper_grads(cfg, np_params, x, y)
    batched = _hopper_grads(cfg, np_params, x, y, backend="batched")
    n_conv = 2 * len(cfg.conv_channels)
    assert all(g is not None and float(g.abs().max()) > 0
               for g in hopper[:n_conv])
    _assert_grads_close(hopper, [g.numpy() for g in batched])
    _assert_grads_close(batched, _reference_grads(cfg, np_params, x, y))


def test_spiking_conv_lif_fn_finite_difference():
    """The reference's finite-difference check of the fused op's VJP, in
    its no-spike regime (v_th far above every membrane, alpha large): the
    layer is linear there, so the transposed-tap dx, the tap-matmul
    (dw, db) and the dv0 carry must match central differences."""
    t, b, h, w_, cin, cout = 3, 2, 5, 6, 2, 4
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.random((t, b, h, w_, cin)),
        rng.standard_normal((b, h + 2, w_ + 2, cout)) * 0.1,
        rng.standard_normal((3, 3, cin, cout)) * 0.2,
        np.linspace(-0.1, 0.1, cout))]
    proj = torch.from_numpy(rng.standard_normal((b, h + 2, w_ + 2, cout)))

    def f(a):
        s, vf = SpikingConvLIFFn.apply(*a, 30.0, True, 100.0,
                                       "fast_sigmoid")
        return (vf.double() * proj).sum(), s.sum()

    grad_args = [a.clone().requires_grad_(True) for a in args]
    loss, n_spikes = f(grad_args)
    assert float(n_spikes.detach()) == 0.0
    loss.backward()
    eps = 1e-3
    for i, (a, g) in enumerate(zip(args, grad_args)):
        d = torch.from_numpy(rng.standard_normal(a.shape).astype(np.float32))
        plus, minus = list(args), list(args)
        plus[i], minus[i] = a + eps * d, a - eps * d
        fd = (float(f(plus)[0]) - float(f(minus)[0])) / (2 * eps)
        analytic = float((g.grad.double() * d.double()).sum())
        np.testing.assert_allclose(analytic, fd, rtol=2e-3, atol=2e-3)


def test_spiking_conv_lif_without_grad_builds_no_graph():
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.random((2, 1, 5, 5, 2)) < 0.5)
                         .astype(np.float32))
    w = torch.full((3, 3, 2, 4), 0.3, requires_grad=True)
    b, v0 = torch.zeros(4), torch.zeros((1, 7, 7, 4))
    s, v = spiking_conv_lif(x, v0, w, b)
    assert s.grad_fn is not None
    with torch.no_grad():
        s2, v2 = spiking_conv_lif(x, v0, w, b)
    assert s2.grad_fn is None and torch.equal(s, s2) and torch.equal(v, v2)


# -- training ----------------------------------------------------------------

def test_train_step_trajectory_matches_reference():
    """10 SGD steps of full-width snn-mnist (T=3, batch 16, one fixed
    batch) through the hopper backend track the reference's batched
    backend, and the loss falls: the reference's own criteria
    (tests/test_snn_backends.py)."""
    cfg = dataclasses.replace(get_snn("snn-mnist"), timesteps=3)
    x, y = jx_synthetic.mnist_like(16, seed=0)
    np_params = _jax_params(cfg, 0)

    jx_step = jax.jit(jx_make_train_step(cfg, backend="batched", lr=1e-2))
    p, mom = np_params, jax.tree_util.tree_map(jnp.zeros_like, np_params)
    want = []
    for _ in range(10):
        p, mom, loss = jx_step(p, mom, jnp.asarray(x), jnp.asarray(y))
        want.append(float(loss))

    step = make_train_step(cfg, backend="hopper", lr=1e-2)
    params = from_jax_params(np_params, device="cpu")
    mom = jax.tree_util.tree_map(np.zeros_like, np_params)
    mom = from_jax_params(mom, device="cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = []
    for _ in range(10):
        params, mom, loss = step(params, mom, xt, yt)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    assert got[-1] < got[0] - 0.05, got


def test_grad_rows_match_reference():
    cfg = _tiny_mnist_cfg()
    np_params = _jax_params(cfg, 0)
    x, y = _frames(2, (3, 8, 8, 1)), np.array([1, 5, 8], np.int32)
    loss_w, rows_w = jx_make_grad_rows_fn(cfg, backend="batched",
                                          sequential=True)(
        np_params, jnp.asarray(x), jnp.asarray(y))
    params = from_jax_params(np_params, device="cpu")
    loss, rows = make_grad_rows_fn(cfg, backend="hopper", sequential=True)(
        params, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_w), atol=1e-5,
                               rtol=1e-5)
    for got, want in zip(_leaves(rows), _leaves(rows_w)):
        assert got.shape[0] == 3
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_data_is_bit_identical(seed):
    for got, want in [(synthetic.mnist_like(9, seed=seed),
                       jx_synthetic.mnist_like(9, seed=seed)),
                      (synthetic.road_like(2, h=20, w=40, seed=seed),
                       jx_synthetic.road_like(2, h=20, w=40, seed=seed))]:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_train_launcher_runs_on_the_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "2", "--batch", "4"], env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "trained 2 steps of 4 frames (backend=hopper" in r.stderr
    assert "held-out accuracy" in r.stderr
