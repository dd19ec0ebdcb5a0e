"""The hand-written kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips unless there is an NVIDIA card
of compute capability 9.0 or newer.  The file imports neither JAX nor the
JAX package, so it runs on a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Spike trains follow ``chip_smoke.py``'s rule: a site may differ only by a
threshold flip (the plain pre-reset membrane within 1e-4 of v_th at the
first differing step), and final membranes of agreeing sites agree to 1e-4.
The saved pre-reset membrane is held to the final membrane's 1e-4 where
the trains agree (a membrane that grows to tens differs from cuDNN's by a
few ulps), the LIF backward to 1e-6 (rel and abs; it repeats the plain
version's float operations), the input gradient to 1e-5 of its largest
value.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.snn_model import _lif_scan
from repro_torch.core.surrogate import SURROGATE_KINDS
from repro_torch.kernels import ref
from repro_torch.kernels.spiking_conv import conv_grad_input, spiking_conv
from repro_torch.kernels.spiking_conv_lif import (lif_bwd, spiking_conv_lif,
                                                  spiking_conv_lif_fwd)

CONV_CASES = [
    # B, H, W, Cin, Cout, R, aprc
    (2, 8, 8, 3, 8, 3, True),
    (1, 12, 12, 1, 16, 3, True),
    (2, 6, 10, 4, 12, 5, True),         # 5x5 taps
    (2, 8, 8, 3, 8, 3, False),          # SAME
    (1, 7, 9, 2, 6, 3, True),           # ragged rows
    (2, 10, 10, 6, 9, 3, False),        # Cout not a multiple of 4
    (3, 30, 30, 16, 32, 3, True),       # snn-mnist layer 1 widths
    (2, 2, 60, 3, 2, 4, False),         # even R: SAME pads (1, 2)
]
FUSED_CASES = [
    # T, B, H, W, Cin, Cout, R, aprc
    (3, 2, 8, 8, 3, 8, 3, True),
    (2, 1, 7, 9, 2, 6, 3, True),        # ragged rows
    (2, 2, 6, 6, 4, 6, 3, False),       # SAME
    (8, 2, 32, 32, 32, 8, 3, True),     # snn-mnist layer 2 widths
]


@pytest.fixture
def card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the sm_90a kernels need an NVIDIA card of compute "
                    "capability 9.0 or newer")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


def _flips_near_threshold(s, s_plain, u_plain, v_th, band=1e-4):
    diff = s != s_plain
    sites = diff.any(dim=0)
    if not bool(sites.any()):
        return True
    first = diff.float().argmax(dim=0)
    u_first = u_plain.gather(0, first.unsqueeze(0))[0]
    return bool(((u_first - v_th).abs()[sites] <= band).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES)
def test_spiking_conv_kernel_matches_plain(card, case):
    b, h, w_, cin, cout, r, aprc = case
    rng = np.random.default_rng(sum(case))
    x = (rng.random((b, h, w_, cin)) < 0.15).astype(np.float32)
    w = (rng.standard_normal((r, r, cin, cout)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.01).astype(np.float32)
    x, w, bias = _on(card, x, w, bias)
    n = spiking_conv.launches
    got = spiking_conv(x, w, bias, aprc=aprc)
    torch.cuda.synchronize()
    assert spiking_conv.launches == n + 1
    torch.testing.assert_close(got, ref.spiking_conv_ref(x, w, bias,
                                                         aprc=aprc),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.02, 0.5])
@pytest.mark.parametrize("case", FUSED_CASES)
def test_spiking_conv_lif_kernel_matches_plain(card, case, rate):
    t, b, h, w_, cin, cout, r, aprc = case
    rng = np.random.default_rng(sum(case) + int(rate * 100))
    e_h, e_w = (h + r - 1, w_ + r - 1) if aprc else (h, w_)
    x = (rng.random((t, b, h, w_, cin)) < rate).astype(np.float32)
    w = (rng.standard_normal((r, r, cin, cout)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.05 + 0.1).astype(np.float32)
    v0 = (rng.standard_normal((b, e_h, e_w, cout)) * 0.3).astype(np.float32)
    x, w, bias, v0 = _on(card, x, w, bias, v0)
    n = spiking_conv_lif.launches
    s, v = spiking_conv_lif(x, v0, w, bias, v_th=1.0, aprc=aprc)
    torch.cuda.synchronize()
    assert spiking_conv_lif.launches == n + 1
    sp, vp, up = ref.spiking_conv_lif_ref(x, v0, w, bias, v_th=1.0,
                                          aprc=aprc, save_u=True)
    assert _flips_near_threshold(s, sp, up, 1.0)
    agree = (s == sp).all(dim=0)
    torch.testing.assert_close(v[agree], vp[agree], atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_chunked_membrane_carry_is_bit_exact(card):
    """v_final of one call is v0 of the next: a split of T gives the bits
    of the whole-T call."""
    rng = np.random.default_rng(0)
    x = (rng.random((6, 2, 12, 12, 4)) < 0.2).astype(np.float32)
    w = (rng.standard_normal((3, 3, 4, 8)) * 0.3).astype(np.float32)
    bias = np.full(8, 0.05, np.float32)
    x, w, bias = _on(card, x, w, bias)
    v0 = torch.zeros((2, 14, 14, 8), device=card)
    s, v = spiking_conv_lif(x, v0, w, bias)
    s_a, v_a = spiking_conv_lif(x[:2].contiguous(), v0, w, bias)
    s_b, v_b = spiking_conv_lif(x[2:].contiguous(), v_a, w, bias)
    assert torch.equal(torch.cat([s_a, s_b]), s) and torch.equal(v_b, v)


@pytest.mark.cuda
def test_faint_analog_frame_is_not_skipped(card):
    x = torch.zeros((1, 8, 8, 1), device=card)
    x[0, 2, 3, 0] = 0.2
    w = torch.ones((3, 3, 1, 4), device=card)
    b = torch.zeros(4, device=card)
    out = spiking_conv(x, w, b)
    torch.testing.assert_close(out, ref.spiking_conv_ref(x, w, b),
                               atol=1e-6, rtol=0)
    assert float(out.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", FUSED_CASES)
def test_training_forward_saves_the_pre_reset_membrane(card, case):
    """Kernel C: kernel B's trains plus u = v_{t-1} + dV_t."""
    t, b, h, w_, cin, cout, r, aprc = case
    rng = np.random.default_rng(sum(case) + 11)
    e_h, e_w = (h + r - 1, w_ + r - 1) if aprc else (h, w_)
    x = (rng.random((t, b, h, w_, cin)) < 0.3).astype(np.float32)
    w = (rng.standard_normal((r, r, cin, cout)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.05 + 0.1).astype(np.float32)
    v0 = (rng.standard_normal((b, e_h, e_w, cout)) * 0.3).astype(np.float32)
    x, w, bias, v0 = _on(card, x, w, bias, v0)
    n = spiking_conv_lif_fwd.launches
    s, v, u = spiking_conv_lif_fwd(x, v0, w, bias, v_th=1.0, aprc=aprc)
    torch.cuda.synchronize()
    assert spiking_conv_lif_fwd.launches == n + 1
    sb, vb = spiking_conv_lif(x, v0, w, bias, v_th=1.0, aprc=aprc)
    assert torch.equal(s, sb) and torch.equal(v, vb)
    assert torch.equal(s, (u >= 1.0).float())
    sp, vp, up = ref.spiking_conv_lif_ref(x, v0, w, bias, v_th=1.0,
                                          aprc=aprc, save_u=True)
    assert _flips_near_threshold(s, sp, up, 1.0)
    agree = (s == sp).all(dim=0)
    torch.testing.assert_close(u[:, agree], up[:, agree], atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SURROGATE_KINDS)
@pytest.mark.parametrize("shape", [(3, 2, 10, 10, 8), (8, 1, 7, 9, 5),
                                   (1, 3, 4, 4, 3)])
def test_lif_bwd_kernel_matches_plain(card, shape, kind):
    rng = np.random.default_rng(sum(shape) + len(kind))
    u = (rng.standard_normal(shape) * 0.6 + 0.9).astype(np.float32)
    g_s = rng.standard_normal(shape).astype(np.float32)
    g_v = rng.standard_normal(shape[1:]).astype(np.float32)
    u, g_s, g_v = _on(card, u, g_s, g_v)
    n = lif_bwd.launches
    lam, dv0 = lif_bwd(u, g_s, g_v, v_th=1.0, alpha=4.0, kind=kind)
    torch.cuda.synchronize()
    assert lif_bwd.launches == n + 1
    lam_p, dv0_p = ref.lif_bwd_ref(u, g_s, g_v, v_th=1.0, alpha=4.0,
                                   kind=kind)
    torch.testing.assert_close(lam, lam_p, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(dv0, dv0_p, atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("density", [1.0, 0.05])
def test_conv_grad_input_kernel_matches_plain(card, case, density):
    """Kernel E on a dense cotangent and on one whose row-blocks are mostly
    zero (the blocks it skips)."""
    b, h, w_, cin, cout, r, aprc = case
    rng = np.random.default_rng(sum(case) + 3)
    e_h, e_w = (h + r - 1, w_ + r - 1) if aprc else (h, w_)
    dz = rng.standard_normal((b, e_h, e_w, cout)).astype(np.float32)
    dz *= (rng.random((b, e_h, 1, 1)) < density)
    w = (rng.standard_normal((r, r, cin, cout)) * 0.2).astype(np.float32)
    dz, w = _on(card, dz, w)
    n = conv_grad_input.launches
    got = conv_grad_input(dz, w, aprc=aprc)
    torch.cuda.synchronize()
    assert conv_grad_input.launches == n + 1
    want = ref.conv_grad_input_ref(dz, w, aprc=aprc)
    assert got.shape == want.shape == (b, h, w_, cin)
    scale = max(float(want.abs().max()), 1e-30)
    torch.testing.assert_close(got, want, atol=1e-5 * scale, rtol=0)


def _batched_layer(x, v0, w, b, aprc, alpha, kind):
    """The batched backend's layer: conv over the folded (T*B) batch, then
    the LIF scan with the surrogate spike function, all autograd ops."""
    t, n = x.shape[:2]
    z = ref.spiking_conv_ref(x.reshape((t * n,) + x.shape[2:]), w, b,
                             aprc=aprc)
    s, _, v = _lif_scan(z.reshape((t, n) + z.shape[1:]), 1.0, alpha, kind,
                        v0)
    return s, v


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SURROGATE_KINDS)
def test_fused_layer_backward_matches_the_batched_path(card, kind):
    """SpikingConvLIFFn (kernels C, D, E, and conv_grad_weights) against
    autograd through the batched backend's layer, on the same inputs."""
    rng = np.random.default_rng(len(kind))
    t, b, h, w_, cin, cout = 4, 2, 9, 11, 4, 8
    x = (rng.random((t, b, h, w_, cin)) < 0.3).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.05 + 0.1).astype(np.float32)
    v0 = (rng.standard_normal((b, h + 2, w_ + 2, cout)) * 0.3
          ).astype(np.float32)
    proj = rng.standard_normal((t, b, h + 2, w_ + 2, cout)).astype(np.float32)
    args0 = _on(card, x, v0, w, bias)
    proj, = _on(card, proj)
    counts = (spiking_conv_lif_fwd.launches, lif_bwd.launches,
              conv_grad_input.launches)
    grads, trains = [], []
    for layer in (lambda *a: spiking_conv_lif(*a, aprc=True,
                                              surrogate_alpha=4.0,
                                              surrogate_kind=kind),
                  lambda *a: _batched_layer(*a, True, 4.0, kind)):
        args = [a.clone().requires_grad_(True) for a in args0]
        s, v = layer(*args)
        ((s * proj).sum() + (v ** 2).sum()).backward()
        grads.append([a.grad for a in args])
        trains.append(s.detach())
    torch.cuda.synchronize()
    assert (spiking_conv_lif_fwd.launches, lif_bwd.launches,
            conv_grad_input.launches) == tuple(c + 1 for c in counts)
    assert torch.equal(trains[0], trains[1])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_wrappers_check_their_arguments(card):
    x = torch.zeros((1, 8, 8, 2), device=card)
    w = torch.zeros((3, 3, 2, 4), device=card)
    b = torch.zeros(4, device=card)
    with pytest.raises(TypeError, match="float32"):
        spiking_conv(x.double(), w.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        spiking_conv(x.permute(0, 2, 1, 3), w, b)
    with pytest.raises(ValueError, match="CUDA device"):
        spiking_conv(x, w.cpu(), b)
    with pytest.raises(ValueError, match="v0"):
        spiking_conv_lif(x[None], torch.zeros((1, 9, 9, 4), device=card),
                         w, b)
    with pytest.raises(ValueError, match="surrogate"):
        lif_bwd(x[None], x[None], x, v_th=1.0, alpha=4.0, kind="sigmoid")
    # the public wrappers differentiate; the raw launchers refuse to
    wg = w.clone().requires_grad_(True)
    spiking_conv(x, wg, b).sum().backward()
    assert wg.grad is not None and wg.grad.shape == w.shape
    v0 = torch.zeros((1, 10, 10, 4), device=card)
    with pytest.raises(NotImplementedError, match="backward"):
        spiking_conv_lif_fwd(x[None], v0, wg, b)
    with pytest.raises(NotImplementedError, match="backward"):
        conv_grad_input(v0.requires_grad_(True), w)


# -- kernel F and the chunked hopper path --------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 128), (17, 300), (1, 1),
                                   (4096, 512), (3, 5, 7)])
def test_lif_fused_kernel_matches_plain(card, shape, dtype):
    """Kernel F gives the plain version's bits (max error 0), in float32
    and bfloat16, with membranes exactly at the threshold included."""
    from repro_torch.kernels.lif import lif_fused
    g = torch.Generator().manual_seed(len(shape) * 1000 + shape[0])
    v = torch.randn(shape, generator=g).to(dtype)
    z = torch.randn(shape, generator=g).to(dtype)
    for start, value in ((0, 1.0), (3, 0.7)):   # v + z == v_th
        v.view(-1)[start::7] = value
        z.view(-1)[start::7] = 0.0
    for v_th in (1.0, 0.7):
        want = ref.lif_fused_ref(v, z, v_th)
        before = lif_fused.launches
        got = lif_fused(v.to(card), z.to(card), v_th)
        torch.cuda.synchronize()
        assert lif_fused.launches == before + 1
        for a, b in zip(got, want):
            assert a.dtype == dtype and torch.equal(a.cpu(), b)


def _tiny_model(card, timesteps=5):
    import dataclasses
    from repro_torch.config import get_snn
    from repro_torch.core import init_snn
    cfg = dataclasses.replace(get_snn("snn-mnist"), input_hw=(12, 12),
                              conv_channels=(8, 16), timesteps=timesteps,
                              num_spe_clusters=4)
    return cfg, init_snn(torch.Generator().manual_seed(0), cfg, device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("ct", [1, 2, 3, 5])
def test_chunked_hopper_forward_bit_identical(card, ct):
    """snn_apply_chunked on the kernels == whole T, bit for bit: logits,
    per-timestep counts and skip fractions."""
    from repro_torch.core import (build_schedule, snn_apply,
                                  snn_apply_chunked)
    cfg, params = _tiny_model(card)
    x = torch.rand((6, 12, 12, 1), generator=torch.Generator()
                   .manual_seed(1)).to(card)
    sched = build_schedule(params, cfg, "aprc+cbws")
    with torch.inference_mode():
        want = snn_apply(params, x, cfg, backend="hopper", schedule=sched)
        got = snn_apply_chunked(params, x, cfg, chunk_timesteps=ct,
                                backend="hopper", schedule=sched)
    assert torch.equal(got.logits, want.logits)
    for a, b in zip(got.timestep_counts, want.timestep_counts):
        assert torch.equal(a, b)
    for a, b in zip(got.skip_fractions, want.skip_fractions):
        assert abs(float(a) - float(b)) < 1e-6


@pytest.mark.cuda
def test_hopper_rows_do_not_depend_on_the_batch(card):
    from repro_torch.core import snn_apply
    cfg, params = _tiny_model(card)
    x = torch.rand((16, 12, 12, 1), generator=torch.Generator()
                   .manual_seed(2)).to(card)
    with torch.inference_mode():
        full = snn_apply(params, x, cfg, backend="hopper").logits
        for n in (1, 2, 3, 4, 8):
            got = snn_apply(params, x[:n], cfg, backend="hopper").logits
            assert torch.equal(got, full[:n]), f"batch {n}"


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["ref", "batched"])
def test_plain_rows_do_not_depend_on_the_batch(card, backend):
    """The plain backends' rows on the card (float64 exact-grid GEMMs for
    spike inputs, fixed-order taps for the analog frame)."""
    from repro_torch.core import snn_apply
    cfg, params = _tiny_model(card)
    x = torch.rand((16, 12, 12, 1), generator=torch.Generator()
                   .manual_seed(2)).to(card)
    with torch.inference_mode():
        full = snn_apply(params, x, cfg, backend=backend).logits
        for n in (1, 2, 3, 4, 8):
            got = snn_apply(params, x[:n], cfg, backend=backend).logits
            assert torch.equal(got, full[:n]), f"batch {n}"
