"""The hoisted first layer (kernel A's hoisted mode) on the CPU.

``spiking_conv_lif_hoisted`` computes dV of the direct-coded frames once
and runs T steps of LIF on it.  Its plain version, which the wrapper runs
on CPU tensors and the kernel is held to on the card, must give the bits
of the route it replaces (``spiking_conv_plain`` then
``_lif_scan(const_t=T)``): trains, counts and final membranes are compared
with ``torch.equal``.  Against the JAX reference (``spiking_conv_ref`` then
``_lif_scan_const``, whose lax conv sums in its own order) spike trains
and counts are exact and the final membrane agrees to 1e-5 (abs and rel).
The autograd Function ``HoistedConvLIFFn`` (kernel D's plain version, the
sum of lam over T, the weight gradient) is held to autograd of the
replaced route at atol 5e-5 / rtol 5e-4, the reference's gradient bounds,
and to central differences.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import snn_model as jx_snn_model
from repro.kernels import ref as jx_ref
from repro_torch.config import get_snn
from repro_torch.core import init_snn, snn_apply, snn_apply_chunked
from repro_torch.core.snn_model import _lif_scan
from repro_torch.core.surrogate import SURROGATE_KINDS
from repro_torch.kernels import spiking_conv as sc
from repro_torch.kernels.spiking_conv import (plan_tiles,
                                              spiking_conv_lif_hoisted,
                                              spiking_conv_lif_hoisted_plain,
                                              spiking_conv_plain)
from repro_torch.kernels.spiking_conv_lif import HoistedConvLIFFn

GRAD_TOL = dict(atol=5e-5, rtol=5e-4)

# T, B, H, W, Cin, Cout, R, aprc
CASES = [
    (1, 2, 7, 9, 1, 8, 3, True),
    (3, 2, 7, 9, 1, 8, 3, False),       # SAME
    (8, 2, 9, 7, 2, 5, 5, True),        # 5x5 taps, Cout not a multiple of 4
    (8, 1, 8, 8, 2, 6, 5, False),
    (3, 3, 12, 12, 1, 16, 3, True),     # snn-mnist layer 0's channels
]


def _inputs(case, *, zero_frame=False, v0_scale=0.4):
    """Analog frames in [0, 1) (image 0 all zero when asked), weights and
    bias that make the first layer fire at every rate, a nonzero v0 (the
    chunk carry): numpy, from a seed."""
    t, b, h, w_, cin, cout, r, aprc = case
    rng = np.random.default_rng(sum(case))
    e_h, e_w = (h + r - 1, w_ + r - 1) if aprc else (h, w_)
    x = rng.random((b, h, w_, cin), dtype=np.float32)
    if zero_frame:
        x[0] = 0.0
    w = (rng.standard_normal((r, r, cin, cout)) * 0.4).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1 + 0.2).astype(np.float32)
    v0 = (rng.standard_normal((b, e_h, e_w, cout)) * v0_scale
          ).astype(np.float32)
    return x, w, bias, v0


def _replaced_route(x, w, bias, v0, t, aprc, alpha=10.0,
                    kind="fast_sigmoid"):
    """The route the hoisted op replaces: the conv, then the LIF scan on its
    constant output (differentiable)."""
    z = spiking_conv_plain(x, w, bias, aprc=aprc)
    return _lif_scan(z, 1.0, alpha, kind, v0, const_t=t)


@pytest.mark.parametrize("zero_frame", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_gives_the_replaced_routes_bits(case, zero_frame):
    t, *_, aprc = case
    x, w, bias, v0 = map(torch.from_numpy,
                         _inputs(case, zero_frame=zero_frame))
    s_want, cnt_want, v_want = _replaced_route(x, w, bias, v0, t, aprc)
    s, v, u = spiking_conv_lif_hoisted_plain(x, v0, w, bias, t=t, v_th=1.0,
                                             aprc=aprc, save_u=True)
    assert torch.equal(s, s_want) and torch.equal(v, v_want)
    assert torch.equal(s.sum(dim=(1, 2, 3)), cnt_want)
    assert torch.equal(s, (u >= 1.0).float())
    # u_t = v_{t-1} + dV: v_final is u's last step after its reset
    assert torch.equal(v, u[-1] - 1.0 * s[-1])
    assert float(s.sum()) > 0
    # the wrapper takes the plain version on CPU tensors
    got = spiking_conv_lif_hoisted(x, v0, w, bias, t=t, aprc=aprc)
    assert len(got) == 2 and torch.equal(got[0], s) and torch.equal(got[1],
                                                                      v)


@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_the_jax_reference(case):
    t, *_, aprc = case
    x, w, bias, v0 = _inputs(case)
    z = jx_ref.spiking_conv_ref(x, w, bias, aprc=aprc)
    s_want, cnt_want, v_want = jax.jit(
        jx_snn_model._lif_scan_const, static_argnums=(1, 2, 3, 4))(
            z, t, 1.0, 10.0, "fast_sigmoid", v0)
    s, v = spiking_conv_lif_hoisted_plain(*map(torch.from_numpy,
                                               (x, v0, w, bias)), t=t,
                                          aprc=aprc)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_want))
    np.testing.assert_array_equal(s.sum(dim=(1, 2, 3)).numpy(),
                                  np.asarray(cnt_want))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_want), atol=1e-5,
                               rtol=1e-5)


def test_split_of_t_gives_the_bits_of_one_call():
    """v_final of one call is v0 of the next (the chunk carry)."""
    case = CASES[2]
    x, w, bias, v0 = map(torch.from_numpy, _inputs(case))
    s, v = spiking_conv_lif_hoisted(x, v0, w, bias, t=8)
    s_a, v_a = spiking_conv_lif_hoisted(x, v0, w, bias, t=3)
    s_b, v_b = spiking_conv_lif_hoisted(x, v_a, w, bias, t=5)
    assert torch.equal(torch.cat([s_a, s_b]), s) and torch.equal(v_b, v)
    s0, v_0 = spiking_conv_lif_hoisted(x, v0, w, bias, t=0)
    assert s0.shape == (0,) + s.shape[1:] and torch.equal(v_0, v0)


@pytest.mark.parametrize("kind", SURROGATE_KINDS)
def test_function_gradients_match_the_replaced_route(kind):
    """(dframes, dv0, dw, db) of HoistedConvLIFFn against autograd through
    the conv and the LIF scan it replaces, on one loss of the train and the
    final membrane."""
    case = (4, 2, 7, 9, 2, 8, 3, True)
    t = case[0]
    args0 = list(map(torch.from_numpy, _inputs(case)))   # x, w, bias, v0
    rng = np.random.default_rng(len(kind))
    proj = torch.from_numpy(rng.standard_normal(
        (t,) + tuple(args0[3].shape)).astype(np.float32))
    grads, trains = [], []
    for route in ("function", "replaced"):
        x, w, bias, v0 = [a.clone().requires_grad_(True) for a in args0]
        if route == "function":
            s, v = HoistedConvLIFFn.apply(x, v0, w, bias, t, 1.0, True, 4.0,
                                          kind)
        else:
            s, _, v = _replaced_route(x, w, bias, v0, t, True, 4.0, kind)
        ((s * proj).sum() + (v ** 2).sum()).backward()
        grads.append([a.grad for a in (x, w, bias, v0)])
        trains.append(s.detach())
    assert torch.equal(trains[0], trains[1])
    assert float(trains[0].sum()) > 0
    for got, want in zip(*grads):
        assert got is not None and float(want.abs().max()) > 0
        torch.testing.assert_close(got, want, **GRAD_TOL)


def test_function_finite_difference():
    """In the no-spike regime (v_th far above every membrane, alpha large)
    the layer is linear, v_final = v0 + T * dV, so (dframes, dv0, dw, db)
    must match central differences."""
    t, b, h, w_, cin, cout = 3, 2, 5, 6, 2, 4
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.random((b, h, w_, cin)),
        rng.standard_normal((b, h + 2, w_ + 2, cout)) * 0.1,
        rng.standard_normal((3, 3, cin, cout)) * 0.2,
        np.linspace(-0.1, 0.1, cout))]
    proj = torch.from_numpy(rng.standard_normal((b, h + 2, w_ + 2, cout)))

    def f(a):
        s, vf = HoistedConvLIFFn.apply(*a, t, 30.0, True, 100.0,
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


def test_function_refuses_an_unknown_surrogate():
    x, w, bias, v0 = [torch.from_numpy(a).requires_grad_(True)
                      for a in _inputs(CASES[0])]
    s, v = HoistedConvLIFFn.apply(x, v0, w, bias, 1, 1.0, True, 4.0,
                                  "sigmoid")
    with pytest.raises(ValueError, match="surrogate"):
        (s.sum() + v.sum()).backward()


def _tiny_cfg():
    return dataclasses.replace(get_snn("snn-mnist"), input_hw=(8, 8),
                               conv_channels=(8, 8), timesteps=3,
                               num_spe_clusters=4)


def test_hopper_first_layer_goes_through_the_hoisted_op(monkeypatch):
    """The hopper backend's first layer calls the hoisted op once per chunk
    (no LIF loop of plain ops), the autograd Function when a gradient is
    needed; its outputs equal the batched backend's bit for bit on the CPU,
    whole T and in chunks."""
    cfg = _tiny_cfg()
    params = init_snn(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.rand((3, 8, 8, 1), generator=torch.Generator().manual_seed(1))
    calls = []

    def counted(*a, **kw):
        calls.append(kw["t"])
        return spiking_conv_lif_hoisted(*a, **kw)

    monkeypatch.setattr(sc, "spiking_conv_lif_hoisted", counted)
    with torch.no_grad():
        got = snn_apply(params, x, cfg, backend="hopper")
        want = snn_apply(params, x, cfg, backend="batched")
        chunked = snn_apply_chunked(params, x, cfg, chunk_timesteps=2,
                                    backend="hopper")
    assert calls == [3, 2, 1]
    assert torch.equal(got.logits, want.logits)
    assert torch.equal(chunked.logits, got.logits)
    for a, b, c in zip(got.timestep_counts, want.timestep_counts,
                       chunked.timestep_counts):
        assert torch.equal(a, b) and torch.equal(a, c)

    w0 = params["conv"][0]["w"].clone().requires_grad_(True)
    grad_params = {**params, "conv": [{**params["conv"][0], "w": w0},
                                      *params["conv"][1:]]}
    out = snn_apply(grad_params, x, cfg, backend="hopper")
    out.logits.sum().backward()
    assert calls == [3, 2, 1]            # the Function took this forward
    assert w0.grad is not None and float(w0.grad.abs().max()) > 0


def test_plan_is_cached_and_fits_one_block():
    plan_tiles.cache_clear()
    for shape in [(30, 3, 1, 16), (162, 3, 3, 8), (12, 5, 2, 6),
                  (34, 3, 32, 8)]:
        br, ct = plan_tiles(*shape)
        e_w, r, cin, cout = shape
        assert ct % 4 == 0 and ct >= min(4, cout)
        assert br * e_w * ct // 4 <= 512
        groups = -(-cout // ct)
        # the groups split the quads evenly: less than a quad of padding
        # a group
        assert groups * ct - -(-cout // 4) * 4 < 4 * groups
        assert plan_tiles(*shape) == (br, ct)
    assert plan_tiles.cache_info().hits == 4


def test_wrapper_checks_shapes_and_devices():
    x = torch.zeros((2, 6, 6, 1))
    w, b = torch.zeros((3, 3, 1, 4)), torch.zeros(4)
    v0 = torch.zeros((2, 8, 8, 4))
    with pytest.raises(ValueError, match="v0"):
        spiking_conv_lif_hoisted(x, v0[:, :7], w, b, t=2)
    with pytest.raises(ValueError, match=r"\(B, H, W, Cin\)"):
        spiking_conv_lif_hoisted(x[None], v0, w, b, t=2)
    with pytest.raises(ValueError, match="do not fit"):
        spiking_conv_lif_hoisted(x, v0, w, b[:3], t=2)
    with pytest.raises(ValueError, match="t must be"):
        spiking_conv_lif_hoisted(x, v0, w, b, t=-1)
    meta = [a.to("meta") for a in (x, v0, w, b)]
    with pytest.raises(ValueError, match="CUDA"):
        spiking_conv_lif_hoisted(*meta, t=2)
    with pytest.raises(ValueError, match="CUDA"):
        spiking_conv_lif_hoisted(*meta, t=2, save_u=True)
