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
value.  Kernel A sums its taps in the plain path's order and rounding, so
on analog frames its dV, and its hoisted mode's trains and membranes, equal
the plain version's bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.snn_model import _lif_scan
from repro_torch.core.surrogate import SURROGATE_KINDS
from repro_torch.kernels import ref
from repro_torch.kernels.spiking_conv import (conv_grad_input, spiking_conv,
                                              spiking_conv_lif_hoisted)
from repro_torch.kernels.spiking_conv_lif import (HoistedConvLIFFn,
                                                  SpikingConvLIFFn, lif_bwd,
                                                  spiking_conv_lif,
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
# the tensor-core kernels pad K (Cin) and N (Cout) to their MMA tiles: Cin
# and Cout that are not multiples of 8 or 16, a Cout past 32 (a second
# channel group on the grid), 5x5 taps with two k16 steps a tap
MMA_FUSED_CASES = [
    # T, B, H, W, Cin, Cout, R, aprc
    (3, 2, 9, 11, 5, 12, 3, True),
    (2, 2, 8, 8, 3, 40, 3, False),
    (2, 1, 6, 7, 20, 9, 5, True),
]
MMA_GRAD_CASES = [
    # the forward's B, H, W, Cin, Cout, R, aprc: kernel E sums over Cout
    # and writes Cin
    (2, 9, 11, 5, 12, 3, True),
    (1, 8, 8, 20, 40, 3, False),
    (2, 6, 6, 33, 7, 3, True),
    (1, 7, 9, 3, 3, 5, True),
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


def _fused_input(rng, shape, kind):
    """A spike train (rate 0.3), or the same sites holding faint analog
    values in (0, 0.5) at every step ("analog") or every other step
    ("mixed")."""
    spikes = (rng.random(shape) < 0.3).astype(np.float32)
    if kind == "spikes":
        return spikes
    faint = spikes * (rng.random(shape) * 0.5).astype(np.float32)
    if kind == "analog":
        return faint
    spikes[::2] = faint[::2]
    return spikes


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["spikes", "analog", "mixed"])
@pytest.mark.parametrize("case", MMA_FUSED_CASES + FUSED_CASES[:1])
def test_fused_kernels_on_spike_and_analog_inputs(card, case, kind):
    """Kernels B and C on 0/1 trains (their tensor-core path) and on inputs
    that are not (their float32 path, at every step or every other one),
    against the plain version: the same trains up to threshold flips, the
    same membranes and pre-reset membranes where the trains agree."""
    t, b, h, w_, cin, cout, r, aprc = case
    rng = np.random.default_rng(sum(case) + len(kind))
    e_h, e_w = (h + r - 1, w_ + r - 1) if aprc else (h, w_)
    x = _fused_input(rng, (t, b, h, w_, cin), kind)
    w = (rng.standard_normal((r, r, cin, cout)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.05 + 0.1).astype(np.float32)
    v0 = (rng.standard_normal((b, e_h, e_w, cout)) * 0.3).astype(np.float32)
    x, w, bias, v0 = _on(card, x, w, bias, v0)
    n = (spiking_conv_lif.launches, spiking_conv_lif_fwd.launches)
    s, v = spiking_conv_lif(x, v0, w, bias, v_th=1.0, aprc=aprc)
    s_c, v_c, u = spiking_conv_lif_fwd(x, v0, w, bias, v_th=1.0, aprc=aprc)
    torch.cuda.synchronize()
    assert (spiking_conv_lif.launches, spiking_conv_lif_fwd.launches) == \
        (n[0] + 1, n[1] + 1)
    assert torch.equal(s, s_c) and torch.equal(v, v_c)
    sp, vp, up = ref.spiking_conv_lif_ref(x, v0, w, bias, v_th=1.0,
                                          aprc=aprc, save_u=True)
    assert _flips_near_threshold(s, sp, up, 1.0)
    agree = (s == sp).all(dim=0)
    torch.testing.assert_close(v[agree], vp[agree], atol=1e-4, rtol=0)
    torch.testing.assert_close(u[:, agree], up[:, agree], atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", MMA_GRAD_CASES)
def test_conv_grad_input_kernel_pads_its_mma_tiles(card, case):
    """Kernel E where its K (the forward's Cout) and N (the forward's Cin)
    are not multiples of its MMA tiles, or N spans two channel groups."""
    b, h, w_, cin, cout, r, aprc = case
    rng = np.random.default_rng(sum(case) + 5)
    e_h, e_w = (h + r - 1, w_ + r - 1) if aprc else (h, w_)
    dz = rng.standard_normal((b, e_h, e_w, cout)).astype(np.float32)
    w = (rng.standard_normal((r, r, cin, cout)) * 0.2).astype(np.float32)
    dz, w = _on(card, dz, w)
    n = conv_grad_input.launches
    got = conv_grad_input(dz, w, aprc=aprc)
    torch.cuda.synchronize()
    assert conv_grad_input.launches == n + 1
    want = ref.conv_grad_input_ref(dz, w, aprc=aprc)
    assert got.shape == want.shape == (b, h, w_, cin)
    torch.testing.assert_close(got, want,
                               atol=1e-5 * float(want.abs().max()), rtol=0)


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


# -- kernel A on analog frames: the dV mode and the hoisted mode -------------

HOISTED_CASES = [
    # T, B, H, W, Cin, Cout, R, aprc
    (8, 4, 28, 28, 1, 16, 3, True),     # snn-mnist layer 0
    (3, 2, 28, 28, 1, 16, 3, False),    # SAME
    (3, 2, 12, 12, 2, 8, 5, True),      # 5x5 taps
    (1, 3, 13, 11, 1, 16, 3, True),     # ragged rows
    (3, 2, 9, 9, 3, 6, 3, True),        # Cout not a multiple of 4
    (2, 2, 6, 60, 1, 48, 3, False),     # two channel groups
]


def _analog(case, zero_frame=False):
    t, b, h, w_, cin, cout, r, aprc = case
    rng = np.random.default_rng(sum(case) + 17)
    e_h, e_w = (h + r - 1, w_ + r - 1) if aprc else (h, w_)
    x = rng.random((b, h, w_, cin), dtype=np.float32)
    if zero_frame:
        x[0] = 0.0
    w = (rng.standard_normal((r, r, cin, cout)) * 0.4).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1 + 0.2).astype(np.float32)
    v0 = (rng.standard_normal((b, e_h, e_w, cout)) * 0.4).astype(np.float32)
    return x, w, bias, v0


@pytest.mark.cuda
@pytest.mark.parametrize("zero_frame", [False, True])
@pytest.mark.parametrize("case", HOISTED_CASES)
def test_spiking_conv_is_bit_exact_on_analog_frames(card, case, zero_frame):
    """Kernel A's dV mode sums in the plain path's order: equal bits."""
    *_, aprc = case
    x, w, bias, _ = _on(card, *_analog(case, zero_frame))
    n = spiking_conv.launches
    got = spiking_conv(x, w, bias, aprc=aprc)
    torch.cuda.synchronize()
    assert spiking_conv.launches == n + 1
    assert torch.equal(got, ref.spiking_conv_ref(x, w, bias, aprc=aprc))


@pytest.mark.cuda
@pytest.mark.parametrize("save_u", [False, True])
@pytest.mark.parametrize("zero_frame", [False, True])
@pytest.mark.parametrize("case", HOISTED_CASES)
def test_hoisted_kernel_is_bit_exact(card, case, zero_frame, save_u):
    """Kernel A's hoisted mode, with and without SAVE_U, from a nonzero v0:
    the plain version's trains, final membranes and pre-reset membranes."""
    from repro_torch.kernels.spiking_conv import \
        spiking_conv_lif_hoisted_plain
    t, *_, aprc = case
    x, w, bias, v0 = _on(card, *_analog(case, zero_frame))
    counter = "launches_save_u" if save_u else "launches"
    n = getattr(spiking_conv_lif_hoisted, counter)
    got = spiking_conv_lif_hoisted(x, v0, w, bias, t=t, v_th=1.0, aprc=aprc,
                                   save_u=save_u)
    torch.cuda.synchronize()
    assert getattr(spiking_conv_lif_hoisted, counter) == n + 1
    want = spiking_conv_lif_hoisted_plain(x, v0, w, bias, t=t, v_th=1.0,
                                          aprc=aprc, save_u=save_u)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float(got[0].sum()) > 0


@pytest.mark.cuda
def test_hoisted_kernel_chunks_are_bit_exact(card):
    x, w, bias, v0 = _on(card, *_analog(HOISTED_CASES[2]))
    s, v = spiking_conv_lif_hoisted(x, v0, w, bias, t=5)
    s_a, v_a = spiking_conv_lif_hoisted(x, v0, w, bias, t=2)
    s_b, v_b = spiking_conv_lif_hoisted(x, v_a, w, bias, t=3)
    assert torch.equal(torch.cat([s_a, s_b]), s) and torch.equal(v_b, v)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SURROGATE_KINDS)
def test_hoisted_backward_matches_the_batched_path(card, kind):
    """HoistedConvLIFFn (kernel A's hoisted mode with SAVE_U, D, E for the
    frames, conv_grad_weights) against autograd through the conv and the
    LIF scan it replaces, on the same inputs."""
    t = 4
    x, w, bias, v0 = _on(card, *_analog((t, 2, 9, 11, 2, 8, 3, True)))
    proj = torch.randn((t,) + tuple(v0.shape),
                       generator=torch.Generator().manual_seed(3)).to(card)
    counts = (spiking_conv_lif_hoisted.launches_save_u, lif_bwd.launches,
              conv_grad_input.launches)
    grads, trains = [], []
    for route in ("function", "replaced"):
        args = [a.clone().requires_grad_(True) for a in (x, v0, w, bias)]
        if route == "function":
            s, v = HoistedConvLIFFn.apply(*args, t, 1.0, True, 4.0, kind)
        else:
            z = ref.spiking_conv_ref(args[0], args[2], args[3])
            s, _, v = _lif_scan(z, 1.0, 4.0, kind, args[1], const_t=t)
        ((s * proj).sum() + (v ** 2).sum()).backward()
        grads.append([a.grad for a in args])
        trains.append(s.detach())
    torch.cuda.synchronize()
    assert (spiking_conv_lif_hoisted.launches_save_u, lif_bwd.launches,
            conv_grad_input.launches) == tuple(c + 1 for c in counts)
    assert torch.equal(trains[0], trains[1])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_hoisted_wrapper_checks_its_arguments(card):
    x = torch.rand((1, 8, 8, 1), device=card)
    w = torch.rand((3, 3, 1, 4), device=card)
    b = torch.zeros(4, device=card)
    v0 = torch.zeros((1, 10, 10, 4), device=card)
    with pytest.raises(TypeError, match="float32"):
        spiking_conv_lif_hoisted(x.double(), v0.double(), w.double(),
                                 b.double(), t=2)
    with pytest.raises(ValueError, match="contiguous"):
        spiking_conv_lif_hoisted(x, v0.permute(0, 2, 1, 3), w, b, t=2)
    with pytest.raises(ValueError, match="CUDA device"):
        spiking_conv_lif_hoisted(x, v0, w.cpu(), b, t=2)
    with pytest.raises(NotImplementedError, match="backward"):
        spiking_conv_lif_hoisted(x, v0, w.clone().requires_grad_(True), b,
                                 t=2)
    s, v = spiking_conv_lif_hoisted(x, v0, w, b, t=0)
    assert s.shape == (0, 1, 10, 10, 4) and torch.equal(v, v0)


# -- snn-seg's shapes, the batched conv, the facade ----------------------------

def _seg(card, batch=2):
    from repro_torch.api import ServeSpec, Session
    from repro_torch.config import get_snn
    from repro_torch.data.synthetic import road_like
    cfg = get_snn("snn-seg")
    sess = Session(cfg, ServeSpec(backend="hopper", schedule_mode="aprc+cbws"),
                   seed=0, device=card)
    frames, _ = road_like(batch, seed=0)
    return cfg, sess, frames


@pytest.mark.cuda
@pytest.mark.parametrize("save_u", [False, True])
def test_hoisted_kernel_at_seg_widths(card, save_u):
    """Three-channel frames at E_w = 162, T = 16: bit for bit."""
    from repro_torch.kernels.spiking_conv import \
        spiking_conv_lif_hoisted_plain
    x, w, bias, v0 = _on(card, *_analog((16, 2, 80, 160, 3, 8, 3, True)))
    got = spiking_conv_lif_hoisted(x, v0, w, bias, t=16, save_u=save_u)
    want = spiking_conv_lif_hoisted_plain(x, v0, w, bias, t=16,
                                          save_u=save_u)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [1, 2, 3, 4])
def test_fused_kernels_at_seg_widths(card, layer):
    """B and C at snn-seg's layers (E_w 164-170; layer 3 takes a plan of
    208 KB of shared memory)."""
    from repro_torch.core.snn_model import layer_shapes
    from repro_torch.config import get_snn
    from repro_torch.kernels.spiking_conv import plan_mma_tiles
    cfg = get_snn("snn-seg")
    (h, w_, cin), (e_h, e_w, cout) = (layer_shapes(cfg)[layer - 1],
                                      layer_shapes(cfg)[layer])
    if layer == 3:
        assert plan_mma_tiles(e_w, 3, cin, cout).smem_bytes > 200 * 1024
    rng = np.random.default_rng(layer)
    x = (rng.random((4, 2, h, w_, cin)) < 0.2).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.3).astype(np.float32)
    bias = np.full(cout, 0.05, np.float32)
    v0 = np.zeros((2, e_h, e_w, cout), np.float32)
    x, w, bias, v0 = _on(card, x, w, bias, v0)
    s, v, u = spiking_conv_lif_fwd(x, v0, w, bias)
    sb, vb = spiking_conv_lif(x, v0, w, bias)
    assert torch.equal(s, sb) and torch.equal(v, vb)
    sp, vp, up = ref.spiking_conv_lif_ref(x, v0, w, bias, save_u=True)
    assert _flips_near_threshold(s, sp, up, 1.0)
    agree = (s == sp).all(dim=0)
    torch.testing.assert_close(v[agree], vp[agree], atol=1e-4, rtol=0)
    torch.testing.assert_close(u[:, agree], up[:, agree], atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_readout_conv_and_its_input_gradient_at_cout_1(card):
    """snn-seg's readout: A's dV mode with one output channel (its masked
    store), and E whose cotangent has one channel."""
    rng = np.random.default_rng(5)
    x = (rng.random((8, 90, 170, 16)) < 0.3).astype(np.float32)
    w = (rng.standard_normal((3, 3, 16, 1)) * 0.1).astype(np.float32)
    bias = np.full(1, -0.02, np.float32)
    dz = rng.standard_normal((8, 92, 172, 1)).astype(np.float32)
    x, w, bias, dz = _on(card, x, w, bias, dz)
    torch.testing.assert_close(spiking_conv(x, w, bias),
                               ref.spiking_conv_ref(x, w, bias),
                               atol=1e-5, rtol=1e-5)
    want = ref.conv_grad_input_ref(dz, w)
    got = conv_grad_input(dz, w)
    assert got.shape == (8, 90, 170, 16)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
def test_seg_session_forward_goes_through_the_kernels(card):
    """Session.infer on snn-seg: snn_apply's bits, one launch of the hoisted
    mode, four of B and one of A's dV mode a forward, finite logits of the
    frame's shape."""
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.core.snn_model import snn_apply
    cfg, sess, frames = _seg(card)
    sess.infer(frames)
    counts = (spiking_conv_lif_hoisted.launches, spiking_conv_lif.launches,
              spiking_conv.launches)
    out = sess.infer(frames)
    assert (spiking_conv_lif_hoisted.launches, spiking_conv_lif.launches,
            spiking_conv.launches) == (counts[0] + 1, counts[1] + 4,
                                       counts[2] + 1)
    assert out.logits.shape == (2, 80, 160, 1)
    assert np.isfinite(out.logits).all()
    with torch.inference_mode():
        raw = snn_apply(sess.params, torch.from_numpy(frames).to(card), cfg,
                        backend="hopper",
                        schedule=build_schedule(sess.params, cfg,
                                                "aprc+cbws")).logits
    assert np.array_equal(raw.cpu().numpy(), out.logits)


@pytest.mark.cuda
def test_seg_gradient_matches_the_batched_path(card):
    """One gradient of sum(logits ** 2) at batch 1, hopper against batched:
    every leaf agrees to 1e-2 of its norm (``chip_smoke.py``'s bound when
    the forward may hold a threshold flip; the seg phase applies 1e-4 when
    it holds none)."""
    from repro_torch.core.snn_model import snn_apply
    cfg, sess, frames = _seg(card, batch=1)
    x = torch.from_numpy(frames).to(card)
    grads = {}
    for backend in ("hopper", "batched"):
        leaves = [p.detach().clone().requires_grad_(True)
                  for p in (t for layer in sess.params["conv"]
                            for t in (layer["w"], layer["b"]))]
        params = {"conv": [{"w": leaves[2 * i], "b": leaves[2 * i + 1]}
                           for i in range(len(leaves) // 2)], "dense": []}
        out = snn_apply(params, x, cfg, backend=backend, logits_only=True)
        grads[backend] = torch.autograd.grad((out.logits ** 2).sum(), leaves)
    for g_h, g_b in zip(grads["hopper"], grads["batched"]):
        assert float(g_h.abs().max()) > 0
        assert float((g_h - g_b).norm() / g_b.norm()) < 1e-2


@pytest.mark.cuda
def test_batched_spike_conv_does_not_sync_the_host(card):
    """The batched conv told its input is a spike train runs forward and
    backward without a host sync (sync debug mode raises on one)."""
    from repro_torch.core import snn_layers as L
    rng = np.random.default_rng(7)
    x = (rng.random((32, 30, 30, 16)) < 0.2).astype(np.float32)
    w = (rng.standard_normal((3, 3, 16, 32)) * 0.2).astype(np.float32)
    x, w = _on(card, x, w)
    x.requires_grad_(True)
    w.requires_grad_(True)
    want = L.conv2d(x, w, aprc=True)
    g = torch.randn(want.shape, generator=torch.Generator().manual_seed(0)
                    ).to(card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = L.conv2d(x, w, aprc=True, binary=True)
        dx, dw = torch.autograd.grad((got * g).sum(), (x, w))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)
    assert dx.shape == x.shape and dw.shape == w.shape
    with pytest.raises(RuntimeError):
        torch.cuda.set_sync_debug_mode("error")
        try:
            L.conv2d(x.detach(), w.detach(), aprc=True)   # looks: syncs
        finally:
            torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_logits_only_forward_on_the_card(card):
    """The logits-only hopper forward gives the full forward's logits bits
    and launches the same kernels."""
    from repro_torch.core.snn_model import snn_apply
    cfg, params = _tiny_model(card)
    x = torch.rand((4, 12, 12, 1), generator=torch.Generator()
                   .manual_seed(3)).to(card)
    with torch.inference_mode():
        full = snn_apply(params, x, cfg, backend="hopper")
        n = (spiking_conv_lif_hoisted.launches, spiking_conv_lif.launches)
        only = snn_apply(params, x, cfg, backend="hopper", logits_only=True)
    assert (spiking_conv_lif_hoisted.launches,
            spiking_conv_lif.launches) == (n[0] + 1, n[1] + 1)
    assert torch.equal(full.logits, only.logits) and not only.spike_counts


@pytest.mark.cuda
def test_session_on_the_card_matches_snn_apply_and_serve_forever(card):
    import dataclasses

    from repro_torch.api import ServeSpec, Session
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.core.snn_model import snn_apply
    cfg, params = _tiny_model(card)
    sess = Session(cfg, ServeSpec(backend="hopper", schedule_mode="aprc+cbws",
                                  num_lanes=2, max_batch=4),
                   params=params, device=card)
    x = np.random.default_rng(4).random((6, 12, 12, 1), dtype=np.float32)
    out = sess.infer(x)
    with torch.inference_mode():
        raw = snn_apply(params, torch.from_numpy(x).to(card), cfg,
                        backend="hopper",
                        schedule=build_schedule(params, cfg, "aprc+cbws"))
    assert np.array_equal(out.logits, raw.logits.cpu().numpy())
    with sess.serve_forever() as live:
        handles = [live.submit(f) for f in x]
        got = [h.result(timeout=60.0) for h in handles]
    for i, row in enumerate(got):
        assert np.array_equal(row, out.logits[i])
    assert dataclasses.is_dataclass(sess.spec)


# -- the entry points: SAME-pad snn-seg, the Fig. 7 ablation, the launcher -----

def _seg_trains(cfg, params, x, hopper):
    """snn-seg's five spike trains, each layer computed from its own
    backend's previous train: by the kernels (``hopper``) or plain ops."""
    from repro_torch.core.snn_model import (_conv_folded, _conv_plain,
                                            layer_shapes)
    conv, t = params["conv"], cfg.timesteps
    shapes = layer_shapes(cfg)
    with torch.inference_mode():
        v0 = x.new_zeros((x.shape[0],) + shapes[0])
        if hopper:
            s, _ = spiking_conv_lif_hoisted(x, v0, conv[0]["w"],
                                            conv[0]["b"], t=t, aprc=cfg.aprc)
        else:
            s, _, _ = _lif_scan(_conv_plain(x, conv[0], cfg.aprc), 1.0, 10.0,
                                "fast_sigmoid", v0, const_t=t)
        trains = [s]
        for i in range(1, len(conv) - 1):
            v0 = x.new_zeros((x.shape[0],) + shapes[i])
            if hopper:
                s, _ = spiking_conv_lif(s.contiguous(), v0, conv[i]["w"],
                                        conv[i]["b"], aprc=cfg.aprc)
            else:
                s, _, _ = _lif_scan(_conv_folded(s, conv[i], cfg, False),
                                    1.0, 10.0, "fast_sigmoid", v0)
            trains.append(s)
    return trains


def _within_the_flip_bound(cfg, params, x, counts_h, counts_b):
    """Per layer: at most 1e-5 of the sites differ between the hopper and
    plain trains (``chip_smoke.py``'s MAX_FLIP_FRACTION), the trains give
    the forwards' counts, and the counts differ by at most T x the
    differing sites."""
    t = cfg.timesteps
    for l, (s_h, s_b) in enumerate(zip(_seg_trains(cfg, params, x, True),
                                       _seg_trains(cfg, params, x, False))):
        sites = (s_h != s_b).any(dim=0)
        assert int(sites.sum()) <= 1e-5 * sites.numel(), l
        assert torch.equal(s_h.sum(dim=(1, 2, 3)).cpu(),
                           torch.as_tensor(counts_h[l]).float().cpu())
        assert torch.equal(s_b.sum(dim=(1, 2, 3)).cpu(),
                           torch.as_tensor(counts_b[l]).float().cpu())
        diff = (torch.as_tensor(counts_h[l]).double()
                - torch.as_tensor(counts_b[l]).double()).abs().sum()
        assert float(diff) <= t * int(sites.sum()), l


def _example(name):
    import importlib.util
    from pathlib import Path
    path = (Path(__file__).resolve().parents[1] / "examples"
            / f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_same_pad_skewed_seg_stays_within_the_flip_bound(card):
    """Fig. 7's 'cbws' bar: snn-seg with SAME pad (no APRC crop) on
    lognormally skewed weights, through the kernels with a CBWS schedule,
    against the plain path."""
    import dataclasses
    from repro_torch.config import get_snn
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.core.snn_model import (init_snn, skew_channels,
                                            snn_apply)
    from repro_torch.data.synthetic import road_like
    cfg = dataclasses.replace(get_snn("snn-seg"), aprc=False, timesteps=6)
    params = skew_channels(init_snn(torch.Generator().manual_seed(0), cfg,
                                    device=card), sigma=1.2, seed=1)
    x = torch.from_numpy(road_like(1, seed=0)[0]).to(card)
    n = spiking_conv.launches
    with torch.inference_mode():
        out_h = snn_apply(params, x, cfg, backend="hopper",
                          schedule=build_schedule(params, cfg, "aprc+cbws"))
        out_b = snn_apply(params, x, cfg, backend="batched")
    assert spiking_conv.launches == n + 1            # the SAME-pad readout
    assert out_h.logits.shape == out_b.logits.shape == (1, 80, 160, 1)
    assert bool(torch.isfinite(out_h.logits).all())
    _within_the_flip_bound(cfg, params, x, out_h.timestep_counts,
                           out_b.timestep_counts)


@pytest.mark.cuda
def test_accelerator_sim_on_the_card(card):
    """The Fig. 7 ablation's function at one frame and T=6: three hopper
    forwards (hoisted 1, B 4, A's dV 1 each), and each mode's counts
    within the flip bound of batched's."""
    from repro_torch.config import get_snn
    from repro_torch.core.snn_model import init_snn
    from repro_torch.data.synthetic import road_like
    sim = _example("snn_accelerator_sim")
    cfg = get_snn("snn-seg")
    n = (spiking_conv_lif_hoisted.launches, spiking_conv_lif.launches,
         spiking_conv.launches)
    got = sim.simulate(cfg, frames=1, timesteps=6, backend="hopper",
                       device=card)
    assert (spiking_conv_lif_hoisted.launches, spiking_conv_lif.launches,
            spiking_conv.launches) == (n[0] + 3, n[1] + 12, n[2] + 3)
    want = sim.simulate(cfg, frames=1, timesteps=6, backend="batched",
                        device=card)
    params = init_snn(torch.Generator().manual_seed(0), cfg, device=card)
    x = torch.from_numpy(road_like(1, seed=0)[0]).to(card)
    for mode in sim.MODES:
        g, w = got["modes"][mode], want["modes"][mode]
        vcfg, vparams, _ = sim.variant(cfg, params, mode, 6)
        _within_the_flip_bound(vcfg, vparams, x, g["timestep_counts"],
                               w["timestep_counts"])
        assert 0.0 < g["balance"] <= 1.0 and g["fps"] > 0.0


@pytest.mark.cuda
def test_serve_launcher_spec_file_equals_session_infer(card, tmp_path):
    import json
    from repro_torch.api import ServeSpec, Session
    from repro_torch.config import get_snn
    from repro_torch.launch.serve import main
    spec = ServeSpec(backend="hopper", schedule_mode="aprc+cbws")
    path = tmp_path / "serve.json"
    path.write_text(json.dumps(spec.to_dict()))
    got = main(["--spec-file", str(path), "--batch", "4", "--steps", "1",
                "--device", "cuda", "--log-level", "error"])
    rng = np.random.default_rng(0)
    frames = [rng.random((4, 28, 28, 1), dtype=np.float32)
              for _ in range(2)][-1]
    want = Session(get_snn("snn-mnist"), spec, device=card).infer(frames)
    assert np.array_equal(got["logits"], want.logits)
    assert np.array_equal(got["predictions"], want.logits.argmax(-1))


# -- the mesh runtime on the card ----------------------------------------------

@pytest.mark.cuda
def test_shard_split_through_the_kernels(card):
    """The property the mesh runtime's bit parity rests on, through the
    kernels: two contiguous halves of a batch give the whole batch's
    logits, and the gradient rows of the halves are the whole batch's
    rows, bit for bit; a data=1 mesh session gives the unsharded bits."""
    from repro_torch.api import ServeSpec, Session, TrainSpec
    from repro_torch.core.snn_model import snn_apply
    from repro_torch.core.snn_train import make_grad_rows_fn
    cfg, params = _tiny_model(card)
    x = torch.rand((6, 12, 12, 1), generator=torch.Generator()
                   .manual_seed(5)).to(card)
    y = torch.arange(6, device=card) % 10
    with torch.inference_mode():
        whole = snn_apply(params, x, cfg, backend="hopper").logits
        halves = torch.cat([snn_apply(params, h, cfg, backend="hopper")
                            .logits for h in (x[:3], x[3:])])
    assert torch.equal(whole, halves)
    rows_fn = make_grad_rows_fn(cfg, spec=TrainSpec(backend="hopper"))
    n = (spiking_conv_lif_fwd.launches, lif_bwd.launches)
    loss, grads = rows_fn(params, x, y)
    assert spiking_conv_lif_fwd.launches > n[0] and lif_bwd.launches > n[1]
    parts = [rows_fn(params, x[s], y[s]) for s in (slice(0, 3), slice(3, 6))]
    assert torch.equal(loss, torch.cat([p[0] for p in parts]))
    from torch.utils._pytree import tree_leaves
    for g, *hs in zip(tree_leaves(grads), *(tree_leaves(p[1])
                                            for p in parts)):
        assert torch.equal(g, torch.cat(hs))
    xs = x.cpu().numpy()
    mesh = Session(cfg, ServeSpec(backend="hopper", mesh={"data": 1}),
                   params=params, device=card).infer(xs)
    flat = Session(cfg, ServeSpec(backend="hopper"), params=params,
                   device=card).infer(xs)
    assert np.array_equal(mesh.logits, flat.logits)
    for a, b in zip(mesh.spike_counts, flat.spike_counts):
        assert np.array_equal(a, b)


@pytest.mark.cuda
def test_device_mesh_takes_only_visible_cards(card):
    from repro_torch.dist import DeviceMesh
    count = torch.cuda.device_count()
    assert DeviceMesh(("data", count)).devices == tuple(
        torch.device("cuda", i) for i in range(count))
    with pytest.raises(ValueError, match=rf"needs {count + 1} devices but "
                       rf"only {count} CUDA devices"):
        DeviceMesh(("data", count + 1))


# -- the LM serving path on the card -------------------------------------------

def _lm(card, arch, window=0):
    import dataclasses

    from repro_torch.config import get_arch, reduced
    from repro_torch.models import transformer
    cfg = reduced(get_arch(arch))
    if window:
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, window=window))
    return cfg, transformer.init_params(
        torch.Generator(device=card).manual_seed(0), cfg, device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,window", [("qwen2.5-3b", 0),
                                         ("gemma3-4b", 8)])
def test_lm_decode_matches_forward_on_the_card(card, arch, window):
    """A reduced dense and a reduced sliding config (window 8, so the ring
    wraps): prefill and 12 teacher-forced decode steps against the forward,
    float32 caches, within tests/test_decode.py's 1e-3 and 2e-3 of
    max(1, max|logit|)."""
    from repro_torch.models import transformer
    cfg, params = _lm(card, arch, window)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 44), dtype=np.int32)).to(card)
    with torch.inference_mode():
        full = transformer.forward(params, cfg, tokens=toks, remat=False)[0]
        logits, caches = transformer.prefill(
            params, cfg, tokens=toks[:, :32], remat=False, max_len=44,
            cache_dtype=torch.float32)
        scale = max(1.0, float(full[:, 31].abs().max()))
        assert float((logits[:, 0] - full[:, 31]).abs().max()) < 1e-3 * scale
        for pos in range(32, 44):
            logits, caches = transformer.decode_step(
                params, caches, cfg, token=toks[:, pos:pos + 1], pos=pos)
            scale = max(1.0, float(full[:, pos].abs().max()))
            assert float((logits[:, 0] - full[:, pos]).abs().max()) \
                < 2e-3 * scale, pos
    assert all(c["mixer"]["k"].device.type == "cuda" for c in caches)


@pytest.mark.cuda
def test_lm_weights_are_made_on_the_card(card, monkeypatch):
    """Every weight is drawn on the card by a generator there: no host
    tensor is made and none is copied, and the card's allocated bytes grow
    by at least the parameters' bytes (measured after a collection, so no
    tensor of an earlier test is freed in between)."""
    import gc

    from repro_torch.models.layers import leaves
    drawn, copies = [], []
    randn = torch.randn

    def recording_randn(*args, **kw):
        out = randn(*args, **kw)
        drawn.append((out.device.type, kw["generator"].device.type))
        return out

    monkeypatch.setattr(leaves.torch, "randn", recording_randn)
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: copies.append(self))
    gc.collect()
    torch.cuda.synchronize(card)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(card)
    cfg, params = _lm(card, "gemma3-4b")
    torch.cuda.synchronize(card)
    grown = torch.cuda.memory_allocated(card) - before
    want = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"memory_allocated grew by {grown} bytes; the parameters hold "
          f"{want} bytes")
    assert grown >= want, (grown, want)
    assert drawn, "no weight was drawn"
    assert set(drawn) == {("cuda", "cuda")}, set(drawn)
    assert not copies, f"{len(copies)} host copies"
    assert {p.device.type for p in params.parameters()} == {"cuda"}
    from repro_torch.models import transformer
    with pytest.raises(ValueError, match="generator lives on"):
        transformer.init_params(torch.Generator(), cfg, device=card)


@pytest.mark.cuda
def test_lm_keeps_tf32_off(card):
    """The LM's float32 products stay float32: TF32 is off after a forward
    on the card, and a product of the model's widths agrees with float64
    to far better than TF32's 10-bit mantissa would give."""
    from repro_torch.models import transformer
    cfg, params = _lm(card, "qwen2.5-3b")
    with torch.inference_mode():
        transformer.forward(params, cfg, tokens=torch.zeros(
            (1, 8), dtype=torch.int32, device=card))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    gen = torch.Generator(device=card).manual_seed(1)
    a = torch.randn((64, 4096), generator=gen, device=card)
    b = torch.randn((4096, 64), generator=gen, device=card)
    exact = a.double() @ b.double()
    err = float(((a @ b).double() - exact).abs().max())
    assert err < 1e-4 * float(exact.abs().max())


@pytest.mark.cuda
def test_deepseek_v3_on_the_card_matches_the_cpu(card):
    """A reduced deepseek-v3-671b (MLA, a dense layer and MoE layers with a
    shared expert, capacity factor 1.25) on the card against the same
    weights on the CPU: forward logits and aux, prefill and 6 absorbed
    decode steps within 1e-5 of max(1, max|logit|), and every MoE call
    routed identically (experts, positions, drops; the smallest k-th gate
    margin is printed)."""
    import copy

    from repro_torch.models import transformer
    from repro_torch.models.layers.moe import recorded_routes
    cfg, params = _lm(card, "deepseek-v3-671b")
    host = copy.deepcopy(params).to("cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 46), dtype=np.int32))

    def run(p, dev):
        t = toks.to(dev)
        with torch.inference_mode(), recorded_routes(p) as routes:
            logits, aux = transformer.forward(p, cfg, tokens=t, remat=False)
            outs = [logits, aux.reshape(1)]
            last, caches = transformer.prefill(
                p, cfg, tokens=t[:, :40], remat=False, max_len=46,
                cache_dtype=torch.float32)
            outs.append(last)
            for pos in range(40, 46):
                last, caches = transformer.decode_step(
                    p, caches, cfg, token=t[:, pos:pos + 1], pos=pos)
                outs.append(last)
        return [o.cpu() for o in outs], routes

    got, card_routes = run(params, card)
    want, host_routes = run(host, torch.device("cpu"))
    margin = min(r["margin"] for r in host_routes)
    print(f"{len(host_routes)} MoE calls; smallest k-th gate margin "
          f"{margin:.3e}; dropped choices "
          f"{[int((~r['keep']).sum()) for r in host_routes]}")
    assert len(card_routes) == len(host_routes) == 2 * (1 + 1 + 6)
    for a, b in zip(card_routes, host_routes):
        for key in ("top_idx", "pos", "keep"):
            assert torch.equal(a[key].cpu(), b[key]), (a["layer"], key,
                                                       margin)
    for g, w in zip(got, want):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-5 * scale


def _state_lm(card, arch):
    """A reduced Mamba or RWKV6 config on the card; jamba's MoE at
    capacity factor 2E/k, so no token drops and decode equals forward."""
    import dataclasses
    cfg, params = _lm(card, arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=2 * cfg.moe.num_experts
            / cfg.moe.top_k))
    return cfg, params


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-7b"])
def test_state_lm_decode_matches_forward_on_the_card(card, arch):
    """Reduced jamba (Mamba, attention, MoE) and rwkv6 (the time-mix, the
    channel-mix): a prompt of 32 (two chunks of 16) and 16 teacher-forced
    decode steps against the forward over 48, float32 caches, within
    tests/test_decode.py's 1e-3 and 2e-3 of max(1, max|logit|); the
    states stay float32 on the card."""
    from repro_torch.models import transformer
    cfg, params = _state_lm(card, arch)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 48), dtype=np.int32)).to(card)
    with torch.inference_mode():
        full = transformer.forward(params, cfg, tokens=toks, remat=False)[0]
        logits, caches = transformer.prefill(
            params, cfg, tokens=toks[:, :32], remat=False, max_len=48,
            cache_dtype=torch.float32)
        scale = max(1.0, float(full[:, 31].abs().max()))
        assert float((logits[:, 0] - full[:, 31]).abs().max()) < 1e-3 * scale
        for pos in range(32, 48):
            logits, caches = transformer.decode_step(
                params, caches, cfg, token=toks[:, pos:pos + 1], pos=pos)
            scale = max(1.0, float(full[:, pos].abs().max()))
            assert float((logits[:, 0] - full[:, pos]).abs().max()) \
                < 2e-3 * scale, pos
    state = caches[0]["mixer"]["ssm" if cfg.mamba else "state"]
    assert state.device.type == "cuda" and state.dtype == torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-7b"])
def test_state_lm_on_the_card_matches_the_cpu_in_float64(card, arch):
    """The card's float32 forward, prefill of 32 and 4 decode steps
    against the same weights in float64 on the CPU, within 1e-5 of
    max(1, max|logit|)."""
    import copy

    from repro_torch.models import transformer
    cfg, params = _state_lm(card, arch)
    host = copy.deepcopy(params).to(device="cpu", dtype=torch.float64)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 48), dtype=np.int32))

    def run(p, dev, dt):
        t = toks.to(dev)
        with torch.inference_mode():
            outs = [transformer.forward(p, cfg, tokens=t, remat=False)[0]]
            last, caches = transformer.prefill(
                p, cfg, tokens=t[:, :32], remat=False, max_len=36,
                cache_dtype=dt)
            outs.append(last)
            for pos in range(32, 36):
                last, caches = transformer.decode_step(
                    p, caches, cfg, token=t[:, pos:pos + 1], pos=pos)
                outs.append(last)
        return [o.double().cpu() for o in outs]

    got = run(params, card, torch.float32)
    want = run(host, torch.device("cpu"), torch.float64)
    for g, w in zip(got, want):
        scale = max(1.0, float(w.abs().max()))
        err = float((g - w).abs().max())
        print(f"{arch}: {err / scale:.3e} of max(1, max|logit|)")
        assert err <= 1e-5 * scale


# -- LM training on the card -------------------------------------------------------

def _named(state):
    return ([(n, p) for n, p in state.params.named_parameters()]
            + [(".step", state.opt.step)]
            + [(f".m/{n}", t) for n, t in state.opt.m.items()]
            + [(f".v/{n}", t) for n, t in state.opt.v.items()])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-moe-16b"])
def test_lm_train_step_on_the_card_matches_the_cpu(card, arch):
    """A reduced config's train steps on the card against the same steps
    on the CPU from the same state (TF32 off): the metrics, m and v within
    1e-5 x max(1, max|cpu|), and the params within that plus 2 x lr_s for
    each step s at which the element's CPU gradient lies within 1e-5 x
    max(1, max|g|) of zero (Adam's first steps move an element near lr
    whatever its grad's size, so a grad near zero of the other sign is
    2 x lr apart); every other element has no lr term.  The MoE at
    2 x E / k."""
    import dataclasses

    from repro_torch.config import get_arch, reduced
    from repro_torch.data.synthetic import token_batches
    from repro_torch.models import lm
    cfg = reduced(get_arch(arch))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=2 * cfg.moe.num_experts
            / cfg.moe.top_k))
    cpu = lm.init_train_state(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    gpu = lm.init_train_state(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    gpu.params.to(card)
    gpu = lm.TrainState(gpu.params, type(gpu.opt)(
        gpu.opt.step.to(card), {n: t.to(card) for n, t in gpu.opt.m.items()},
        {n: t.to(card) for n, t in gpu.opt.v.items()}))
    step = lm.make_train_step(cfg)
    extra = {n: 0.0 for n, _ in cpu.params.named_parameters()}
    for b, _ in zip(token_batches(cfg.vocab_size, 2, 32, seed=0), range(2)):
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        names, leaves = zip(*cpu.params.named_parameters())
        loss, _ = lm.loss_fn(cpu.params, cfg, tb)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        _, mc = step(cpu, tb)
        _, mg = step(gpu, {k: v.to(card) for k, v in tb.items()})
        for k in mc:
            want = float(mc[k])
            assert abs(float(mg[k]) - want) <= 1e-5 * max(1.0, abs(want)), k
        lr = float(mc["lr"])
        for n, g in zip(names, grads):
            if g is None:
                extra[n] = extra[n] + 2 * lr
                continue
            g = g.detach().double().abs()
            near = g <= 1e-5 * max(1.0, float(g.max()))
            extra[n] = extra[n] + 2 * lr * near.double()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    for (name, g), (_, c) in zip(_named(gpu), _named(cpu)):
        assert g.device.type == "cuda"
        g, c = g.detach().cpu().double(), c.detach().double()
        err = float(((g - c).abs() - extra.get(name, 0.0)).max())
        bound = 1e-5 * max(1.0, float(c.abs().max()))
        assert err <= bound, (name, err, bound)


@pytest.mark.cuda
def test_checkpointer_round_trips_card_tensors_in_place(card, tmp_path):
    """Card tensors, bfloat16 among them, saved and restored into the
    target's own storage (the same ``data_ptr``) with their bits."""
    from repro_torch.checkpoint import Checkpointer
    gen = torch.Generator(device=card).manual_seed(0)
    tree = {"a": torch.randn((64, 33), generator=gen, device=card),
            "b": [torch.randn((7,), generator=gen, device=card)
                  .to(torch.bfloat16),
                  torch.arange(5, dtype=torch.int32, device=card)]}
    ck = Checkpointer(str(tmp_path), keep=2)
    ck.save(1, tree)
    want = [t.clone() for t in (tree["a"], *tree["b"])]
    for t in (tree["a"], *tree["b"]):
        t.zero_()                      # written after save returned
    ck.wait()
    ptrs = [t.data_ptr() for t in (tree["a"], *tree["b"])]
    out = ck.restore(1, tree)
    assert out is tree
    got = [tree["a"], *tree["b"]]
    assert [t.data_ptr() for t in got] == ptrs
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_prefetcher_puts_batches_on_the_card(card):
    """``Prefetcher(device="cuda")``: the batches come in order, on the
    card, equal to their host batches once the consumer has waited."""
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.data.synthetic import token_batches
    host = [b for b, _ in zip(token_batches(1000, 4, 64, seed=3), range(6))]
    pf = Prefetcher(iter(host), device=card, depth=2)
    got = list(pf)
    assert len(got) == len(host)
    for g, h in zip(got, host):
        assert set(g) == set(h)
        for k in h:
            assert g[k].device.type == "cuda"
            assert torch.equal(g[k].cpu(), torch.from_numpy(h[k]))


@pytest.mark.cuda
def test_lm_on_a_mesh_of_one_card_equals_one_device(card):
    """Phase ``lm_mesh`` (a) of ``chip_smoke.py`` in small form: reduced
    qwen2.5-3b on a data=1 x model=1 mesh over a real NCCL group of one
    (a spawned process), under ``serve`` and ``tp_fsdp``, against the
    same weights unsharded: the leaf-by-leaf init, a prefill and 4 decode
    steps' logits and 3 train steps' losses, bit for bit."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent))
    from _rendezvous import group_of_one
    from repro_torch.dist import spmd
    got = spmd.run(group_of_one, 1, "qwen2.5-3b", "cuda", device="cuda",
                   timeout=300)
    assert got and all(got.values()), got


# -- the counting launches: counts written where the spikes are fired --------

# (name, T, B, H, W, Cin, Cout, hoisted): snn-mnist's layers (kernel A's
# hoisted mode at 4 rows a block, B at 8), snn-seg's (1-row plans), and a
# hoisted and a fused layer of two channel groups, whose row counts go by
# atomics
COUNT_CASES = [
    ("mnist-layer0", 8, 3, 28, 28, 1, 16, True),
    ("mnist-layer1", 8, 3, 30, 30, 16, 32, False),
    ("mnist-layer2", 8, 3, 32, 32, 32, 8, False),
    ("seg-layer0", 8, 2, 80, 160, 3, 8, True),
    ("seg-layer1", 8, 2, 82, 162, 8, 16, False),
    ("seg-layer3", 8, 1, 86, 166, 32, 32, False),
    ("hoisted-two-groups", 8, 2, 8, 170, 1, 16, True),
    ("fused-two-groups", 8, 2, 8, 8, 3, 40, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", COUNT_CASES, ids=[c[0] for c in COUNT_CASES])
def test_counting_launches_count_the_trains_they_fire(card, case):
    """A counting launch of the hoisted mode or of B: the train and final
    membrane of the launch without counts (and of the training instance)
    bit for bit; counts by step and channel and by output row equal to
    torch's reductions of the train, on output channels permuted as a CBWS
    schedule permutes them; T whole and as 4 + 4 chunks, whose counts
    concatenate to the whole's; the finisher's skip fraction equal to
    ``skip_table_fraction``'s bits."""
    from repro_torch.kernels.spiking_conv import (skip_fraction_from_rows,
                                                  skip_table_fraction)
    name, t, b, h, w_, cin, cout, hoisted = case
    rng = np.random.default_rng(len(name) + h)
    perm = rng.permutation(cout)
    w = np.ascontiguousarray((rng.standard_normal((3, 3, cin, cout))
                              * (1.0 if hoisted else 0.5)
                              ).astype(np.float32)[..., perm])
    bias = np.full(cout, 0.1, np.float32)
    v0 = np.zeros((b, h + 2, w_ + 2, cout), np.float32)
    if hoisted:
        x = rng.random((b, h, w_, cin)).astype(np.float32)
    else:
        rows = rng.random((t, b, h, 1, 1)) < 0.7
        x = ((rng.random((t, b, h, w_, cin)) < 0.15) & rows
             ).astype(np.float32)
    x, w, bias, v0 = _on(card, x, w, bias, v0)

    def run(steps, v, count=False, xs=x):
        if hoisted:
            return spiking_conv_lif_hoisted(xs, v, w, bias, t=steps,
                                            count=count)
        return spiking_conv_lif(xs, v, w, bias, count=count)

    fn = spiking_conv_lif_hoisted if hoisted else spiking_conv_lif
    before = (fn.launches, fn.launches_counted)
    s, v, c = run(t, v0, count=True)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_counted) == (before[0] + 1,
                                                  before[1] + 1)
    plain = run(t, v0)
    assert torch.equal(s, plain[0]) and torch.equal(v, plain[1])
    if hoisted:
        fwd = spiking_conv_lif_hoisted(x, v0, w, bias, t=t, save_u=True)
    else:
        fwd = spiking_conv_lif_fwd(x, v0, w, bias)
    assert torch.equal(s, fwd[0]) and torch.equal(v, fwd[1])
    assert torch.equal(c.t, s.sum(dim=(1, 2, 3)).int())
    assert torch.equal(c.rows, s.sum(dim=(3, 4)).int())
    assert 0 < int(c.t.sum()) < s.numel()

    half = t // 2
    if hoisted:
        s1, v1, c1 = run(half, v0, count=True)
        s2, v2, c2 = run(t - half, v1, count=True)
    else:
        s1, v1, c1 = run(half, v0, count=True, xs=x[:half].contiguous())
        s2, v2, c2 = run(t - half, v1, count=True, xs=x[half:].contiguous())
    assert torch.equal(torch.cat([s1, s2]), s) and torch.equal(v2, v)
    assert torch.equal(torch.cat([c1.t, c2.t]), c.t)
    assert torch.equal(torch.cat([c1.rows, c2.rows]), c.rows)

    calls = skip_table_fraction.calls
    for counts, train in ((c, s), (c1, s1), (c2, s2)):
        want = skip_table_fraction(train, 3)
        for _ in range(2):      # the finisher zeroes its scratch again
            assert torch.equal(skip_fraction_from_rows(counts, 3), want)
    assert skip_table_fraction.calls == calls + 3


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["snn-mnist", "snn-seg"])
def test_hopper_forward_counts_through_the_kernels(card, net):
    """One hopper forward with a CBWS schedule: every spiking layer's
    counts are the counting launches', equal to torch's reductions of its
    train (made here by the kernels without counts, in canonical channel
    order), the skip fractions ``skip_table_fraction``'s bits of those
    trains, and ``skip_table_fraction`` is never called; run as two
    chunks, the counts and logits bit for bit; logits-only, the logits'
    bits with no counting launch."""
    from repro_torch.config import get_snn
    from repro_torch.core import (build_schedule, init_snn, layer_shapes,
                                  snn_apply, snn_apply_chunked)
    from repro_torch.core.scheduler import permute_conv_params
    from repro_torch.data.synthetic import mnist_like, road_like
    from repro_torch.kernels.spiking_conv import skip_table_fraction
    cfg = get_snn(net)
    params = init_snn(torch.Generator().manual_seed(0), cfg, device=card)
    frames = (mnist_like(32, seed=0) if net == "snn-mnist"
              else road_like(2, seed=0))[0]
    x = torch.from_numpy(frames).to(card)
    sched = build_schedule(params, cfg, "aprc+cbws")

    conv = permute_conv_params(params, list(sched))["conv"]
    shapes = layer_shapes(cfg)
    n_spiking = len(conv) - (0 if cfg.dense_units else 1)
    trains, s = [], x
    with torch.inference_mode():
        for i in range(n_spiking):
            w, b = conv[i]["w"].contiguous(), conv[i]["b"].contiguous()
            v0 = torch.zeros((x.shape[0],) + shapes[i], device=card)
            if i == 0:
                s, _ = spiking_conv_lif_hoisted(s, v0, w, b, t=cfg.timesteps,
                                                v_th=cfg.v_threshold,
                                                aprc=cfg.aprc)
            else:
                s, _ = spiking_conv_lif(s, v0, w, b, v_th=cfg.v_threshold,
                                        aprc=cfg.aprc)
            trains.append(s)
        counted = (spiking_conv_lif_hoisted.launches_counted,
                   spiking_conv_lif.launches_counted)
        calls = skip_table_fraction.calls
        got = snn_apply(params, x, cfg, backend="hopper", schedule=sched)
        assert skip_table_fraction.calls == calls
        assert (spiking_conv_lif_hoisted.launches_counted,
                spiking_conv_lif.launches_counted) == (
                    counted[0] + 1, counted[1] + n_spiking - 1)
        for i, s in enumerate(trains):
            inv = torch.as_tensor(sched[i].out_perm, device=card).argsort()
            assert torch.equal(got.timestep_counts[i],
                               s.sum(dim=(1, 2, 3))[:, inv].float())
        assert len(got.skip_fractions) == len(cfg.conv_channels) - 1
        for frac, s in zip(got.skip_fractions, trains):
            assert torch.equal(frac, skip_table_fraction(
                s, cfg.kernel_size, aprc=cfg.aprc))

        chunked = snn_apply_chunked(params, x, cfg,
                                    chunk_timesteps=cfg.timesteps // 2,
                                    backend="hopper", schedule=sched)
        counted = spiking_conv_lif.launches_counted
        only = snn_apply(params, x, cfg, backend="hopper", schedule=sched,
                         logits_only=True)
    assert torch.equal(chunked.logits, got.logits)
    for a, b in zip(chunked.timestep_counts, got.timestep_counts):
        assert torch.equal(a, b)
    for a, b in zip(chunked.skip_fractions, got.skip_fractions):
        assert abs(float(a) - float(b)) < 1e-6
    assert spiking_conv_lif.launches_counted == counted
    assert torch.equal(only.logits, got.logits) and not only.spike_counts


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["snn-mnist", "snn-seg"])
def test_scheduled_call_issues_the_unscheduled_device_ops(card, net):
    """A scheduled hopper session's full call runs on the layout its cache
    derived when the params were set: under the profiler it issues the
    device ops of an unscheduled session's call, as many and of the same
    names, and gives its bits."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import ServeSpec, Session
    from repro_torch.config import get_snn
    from repro_torch.data.synthetic import mnist_like, road_like
    cfg = get_snn(net)
    frames = (mnist_like(32, seed=0) if net == "snn-mnist"
              else road_like(2, seed=0))[0]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):      # CUPTI's start-up, untimed
        torch.ones(1, device=card).add_(1)
        torch.cuda.synchronize()
    outs, ops = [], []
    for mode in ("aprc+cbws", None):
        sess = Session(cfg, ServeSpec(backend="hopper", schedule_mode=mode),
                       seed=0, device=card)
        sess.infer(frames)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            outs.append(sess.infer(frames))
            torch.cuda.synchronize()
        ops.append(sorted(e.name for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA))
    assert ops[0], "the profiler saw no device op"
    assert len(ops[0]) == len(ops[1]) and ops[0] == ops[1]
    for a, b in zip(outs[0], outs[1]):
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert np.array_equal(u, v)


@pytest.mark.cuda
def test_counting_forward_replays_from_a_cuda_graph(card):
    """A mesh worker's CUDA graph of a full-output hopper forward
    (``dist.runner._infer_shard``): its replays, on new frames and on the
    first frames again, give the eager forward's logits, counts and skip
    fractions bit for bit, so the count buffers and the finisher's scratch
    are zeroed inside the captured region."""
    from repro_torch.config import get_snn
    from repro_torch.core import init_snn, snn_apply
    from repro_torch.dist.runner import _infer_shard
    cfg = get_snn("snn-mnist")
    params = init_snn(torch.Generator().manual_seed(0), cfg, device=card)
    rng = np.random.default_rng(3)
    first = rng.random((4, 28, 28, 1)).astype(np.float32)
    second = (rng.random((4, 28, 28, 1)) < 0.2).astype(np.float32)
    graphs = {}
    for frames in (first, second, first):
        got = _infer_shard(card, params, graphs, cfg, {"backend": "hopper"},
                           False, frames)
        with torch.inference_mode():
            want = snn_apply(params, torch.from_numpy(frames).to(card), cfg,
                             backend="hopper")
        assert np.array_equal(got.logits, want.logits.cpu().numpy())
        for a, b in zip(got.timestep_counts + got.skip_fractions,
                        want.timestep_counts + want.skip_fractions):
            assert np.array_equal(a, b.cpu().numpy())
    assert len(graphs) == 1


@pytest.mark.cuda
def test_forward_under_grad_counts_with_torch(card):
    """A full-output hopper forward that builds a gradient runs C, which
    counts nothing: its counts are the reductions of its trains and its
    skip fractions ``skip_table_fraction``'s, the bits of the counting
    forward without a gradient; no launch counts, and the empty table's
    finisher gives NaN without a launch."""
    from repro_torch.config import get_snn
    from repro_torch.core import init_snn, snn_apply
    from torch.utils._pytree import tree_map
    from repro_torch.data.synthetic import mnist_like
    from repro_torch.kernels.spiking_conv import (TrainCounts,
                                                  skip_fraction_from_rows,
                                                  skip_table_fraction)
    cfg = get_snn("snn-mnist")
    params = init_snn(torch.Generator().manual_seed(0), cfg, device=card)
    x = torch.from_numpy(mnist_like(8, seed=1)[0]).to(card)
    with torch.no_grad():
        want = snn_apply(params, x, cfg, backend="hopper")
    grad = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                    params)
    counted = (spiking_conv_lif_hoisted.launches_counted,
               spiking_conv_lif.launches_counted)
    calls = skip_table_fraction.calls
    got = snn_apply(grad, x, cfg, backend="hopper")
    assert got.logits.requires_grad
    assert (spiking_conv_lif_hoisted.launches_counted,
            spiking_conv_lif.launches_counted) == counted
    assert skip_table_fraction.calls == calls + len(cfg.conv_channels) - 1
    assert torch.equal(got.logits.detach(), want.logits)
    for a, b in zip(got.timestep_counts + got.skip_fractions,
                    want.timestep_counts + want.skip_fractions):
        assert torch.equal(a.detach(), b)

    rows = torch.zeros((0, 2, 30), dtype=torch.int32, device=card)
    launches = skip_fraction_from_rows.launches
    frac = skip_fraction_from_rows(TrainCounts(rows.new_zeros((0, 4)), rows),
                                   3)
    assert frac.device.type == "cuda" and bool(torch.isnan(frac))
    assert skip_fraction_from_rows.launches == launches


# -- the weight gradient ------------------------------------------------------

# N (T x batch folded), H, W, Cin, Cout, R, aprc of the forward conv, and
# whether its input is a spike train (else analog frames)
WGRAD_CASES = [
    (2048, 30, 30, 16, 32, 3, True, True),    # snn-mnist layer 1
    (2048, 32, 32, 32, 8, 3, True, True),     # layer 2
    (256, 28, 28, 1, 16, 3, True, False),     # layer 0: the frames
    (256, 82, 162, 8, 16, 3, True, True),     # snn-seg layers 1 to 5
    (256, 84, 164, 16, 32, 3, True, True),
    (256, 86, 166, 32, 32, 3, True, True),
    (256, 88, 168, 32, 16, 3, True, True),
    (256, 90, 170, 16, 1, 3, True, True),     # the Cout = 1 readout
    (16, 80, 160, 3, 8, 3, True, False),      # seg layer 0: the frames
    (7, 9, 11, 5, 12, 3, False, True),        # SAME, ragged M
    (6, 12, 13, 16, 32, 5, True, True),       # 5x5 taps
    (5, 10, 10, 6, 9, 5, False, True),        # 5x5 taps, SAME
    (3, 7, 9, 40, 36, 3, True, True),         # two channel groups each way
    (2, 6, 8, 32, 32, 5, True, True),         # taps split over the grid
    (3, 2, 60, 3, 2, 4, False, False),        # even R: SAME pads (1, 2)
]


def _wgrad_inputs(case, density=0.2, seed=0):
    """A spike train (or frames) and a cotangent scaled as a batch-mean
    loss's: dz ~ N(0, 1) / sqrt(M), so that dw is about unit size."""
    n, h, w_, cin, cout, r, aprc, spikes = case
    rng = np.random.default_rng(seed + sum(case))
    e_h, e_w = (h + r - 1, w_ + r - 1) if aprc else (h, w_)
    x = (rng.random((n, h, w_, cin), dtype=np.float32) < density
         ).astype(np.float32) if spikes else \
        rng.random((n, h, w_, cin), dtype=np.float32)
    dz = (rng.standard_normal((n, e_h, e_w, cout), dtype=np.float32)
          / np.float32(np.sqrt(n * e_h * e_w)))
    return x, dz


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGRAD_CASES)
def test_conv_grad_weights_kernel_matches_plain(card, case):
    """The kernel (the spike instance on spike trains, the analog instance
    on frames) against the plain torch-op GEMMs, at every main-path shape
    of snn-mnist and snn-seg and the odd ones, one launch a call."""
    from repro_torch.kernels.spiking_conv import conv_grad_weights
    *_, r, aprc, spikes = case
    x, dz = _on(card, *_wgrad_inputs(case))
    launches = (conv_grad_weights.launches, conv_grad_weights.launches_analog)
    dw, db = conv_grad_weights(x, dz, aprc=aprc, r=r, binary=spikes)
    dw_p, db_p = ref.conv_grad_weights_ref(x, dz, aprc=aprc, r=r)
    torch.cuda.synchronize()
    assert (conv_grad_weights.launches, conv_grad_weights.launches_analog) \
        == (launches[0] + 1, launches[1] + (not spikes))
    torch.testing.assert_close(dw, dw_p, atol=5e-5, rtol=5e-4)
    torch.testing.assert_close(db, db_p, atol=5e-5, rtol=5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["zero train", "frames as spikes",
                                  "faint frames", "spikes as frames"])
def test_conv_grad_weights_on_what_the_caller_did_not_say(card, kind):
    """An all-zero train gives dw zero and db dz's sums; the spike instance
    takes the analog route for tiles that are not 0 and 1 (frames, faint
    frames) and stays right; the analog instance is right on spikes."""
    from repro_torch.kernels.spiking_conv import conv_grad_weights
    case = (64, 30, 30, 16, 32, 3, True, kind != "frames as spikes"
            and kind != "faint frames")
    x, dz = _on(card, *_wgrad_inputs(case, seed=5))
    if kind == "zero train":
        x.zero_()
    if kind == "faint frames":
        x.mul_(1e-3)
    binary = kind != "spikes as frames"
    dw, db = conv_grad_weights(x, dz, aprc=True, r=3, binary=binary)
    dw_p, db_p = ref.conv_grad_weights_ref(x, dz, aprc=True, r=3)
    if kind == "zero train":
        assert not bool(dw.any())
    torch.testing.assert_close(dw, dw_p, atol=5e-5, rtol=5e-4)
    torch.testing.assert_close(db, db_p, atol=5e-5, rtol=5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("spikes", [True, False])
def test_conv_grad_weights_bits_do_not_depend_on_the_blocks(card, spikes):
    """The chains fix the bits: as many persistent blocks as fit, 7, or
    one, give the same dw and db bit for bit, and so does a second call."""
    from repro_torch.kernels.spiking_conv import _launch_wgrad
    case = (512, 30, 30, 16, 32, 3, True, spikes)
    x, dz = _on(card, *_wgrad_inputs(case, seed=2))
    runs = [_launch_wgrad(x, dz, True, 3, spikes, max_blocks=m)
            for m in (0, 7, 1, 0)]
    for dw, db in runs[1:]:
        assert torch.equal(dw, runs[0][0]) and torch.equal(db, runs[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4])
def test_autograd_weight_gradients_take_the_kernel(card, t):
    """Through SpikingConvLIFFn (spike instance; T = 1 and 4) and
    HoistedConvLIFFn (analog instance), autograd's dw and db are the plain
    version's on the same lam, and each backward launches the kernel
    once."""
    from repro_torch.kernels.spiking_conv import conv_grad_weights
    rng = np.random.default_rng(t)
    b, h, w_, cin, cout = 3, 10, 12, 8, 16
    x = (rng.random((t, b, h, w_, cin)) < 0.3).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.05 + 0.1).astype(np.float32)
    v0 = (rng.standard_normal((b, h + 2, w_ + 2, cout)) * 0.3
          ).astype(np.float32)
    g_s = rng.standard_normal((t, b, h + 2, w_ + 2, cout)).astype(np.float32)
    x, w, bias, v0, g_s = _on(card, x, w, bias, v0, g_s)
    frames = x[0]
    for layer in ("fused", "hoisted"):
        wg, bg = (a.clone().requires_grad_(True) for a in (w, bias))
        launches = (conv_grad_weights.launches,
                    conv_grad_weights.launches_analog)
        if layer == "fused":
            s, v = SpikingConvLIFFn.apply(x, v0, wg, bg, 1.0, True, 4.0,
                                          "fast_sigmoid")
            _, _, u = spiking_conv_lif_fwd(x, v0, w, bias)
            inp = x.reshape((t * b,) + x.shape[2:])
        else:
            s, v = HoistedConvLIFFn.apply(frames, v0, wg, bg, t, 1.0, True,
                                          4.0, "fast_sigmoid")
            _, _, u = spiking_conv_lif_hoisted(frames, v0, w, bias, t=t,
                                               save_u=True)
            inp = frames
        torch.autograd.backward((s, v), (g_s, torch.zeros_like(v)))
        torch.cuda.synchronize()
        assert (conv_grad_weights.launches,
                conv_grad_weights.launches_analog) == \
            (launches[0] + 1, launches[1] + (layer == "hoisted"))
        lam, _ = lif_bwd(u, g_s, torch.zeros_like(v0), v_th=1.0, alpha=4.0,
                         kind="fast_sigmoid")
        dz = (lam.reshape((t * b,) + lam.shape[2:]) if layer == "fused"
              else sum(lam[1:], lam[0]))
        dw_p, db_p = ref.conv_grad_weights_ref(inp, dz.contiguous(),
                                               aprc=True, r=3)
        torch.testing.assert_close(wg.grad, dw_p, atol=5e-5, rtol=5e-4)
        torch.testing.assert_close(bg.grad, db_p, atol=5e-5, rtol=5e-4)


@pytest.mark.cuda
def test_train_step_launches_the_weight_gradient_once_a_layer(card,
                                                              monkeypatch):
    """One snn-mnist train step on the hopper backend: the kernel once a
    conv layer (three), the analog instance once (the hoisted first
    layer), and never the plain torch-op GEMMs."""
    from repro_torch.api import TrainSpec
    from repro_torch.config import get_snn
    from repro_torch.core import init_snn
    from repro_torch.core.snn_train import make_train_step
    from repro_torch.data.synthetic import mnist_like
    from repro_torch.kernels import spiking_conv as a
    from torch.utils._pytree import tree_map

    def refuse(*args, **kw):
        raise AssertionError("the plain weight gradient ran on the card")

    monkeypatch.setattr(a, "conv_grad_weights_plain", refuse)
    cfg = get_snn("snn-mnist")
    params = init_snn(torch.Generator().manual_seed(0), cfg, device=card)
    mom = tree_map(torch.zeros_like, params)
    x, y = (torch.from_numpy(v).to(card) for v in mnist_like(16, seed=4))
    step = make_train_step(cfg, spec=TrainSpec(backend="hopper", lr=1e-2))
    launches = (a.conv_grad_weights.launches,
                a.conv_grad_weights.launches_analog)
    step(params, mom, x, y)
    torch.cuda.synchronize()
    assert (a.conv_grad_weights.launches,
            a.conv_grad_weights.launches_analog) == \
        (launches[0] + 3, launches[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("spikes", [True, False])
def test_conv_grad_weights_replays_from_a_cuda_graph(card, spikes):
    """The call captures in a CUDA graph (it allocates nothing inside its
    launches and never synchronizes): replays on new inputs copied into
    the captured ones give the eager call's bits."""
    from repro_torch.kernels.spiking_conv import conv_grad_weights
    case = (64, 30, 30, 16, 32, 3, True, spikes)
    inputs = [_on(card, *_wgrad_inputs(case, seed=s)) for s in (7, 8)]
    x, dz = (a.clone() for a in inputs[0])
    conv_grad_weights(x, dz, aprc=True, r=3, binary=spikes)   # build, load
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dw, db = conv_grad_weights(x, dz, aprc=True, r=3, binary=spikes)
    for xi, dzi in inputs + inputs[:1]:
        x.copy_(xi)
        dz.copy_(dzi)
        graph.replay()
        torch.cuda.synchronize()
        want = conv_grad_weights(xi, dzi, aprc=True, r=3, binary=spikes)
        assert torch.equal(dw, want[0]) and torch.equal(db, want[1])


@pytest.mark.cuda
def test_conv_grad_weights_checks_its_arguments(card):
    from repro_torch.kernels.spiking_conv import conv_grad_weights
    x = torch.zeros((2, 8, 8, 4), device=card)
    dz = torch.zeros((2, 10, 10, 8), device=card)
    with pytest.raises(TypeError, match="float32"):
        conv_grad_weights(x.double(), dz.double(), aprc=True, r=3)
    with pytest.raises(ValueError, match="contiguous"):
        conv_grad_weights(x.permute(0, 2, 1, 3), dz, aprc=True, r=3)
    with pytest.raises(ValueError, match="CUDA device"):
        conv_grad_weights(x.cpu(), dz, aprc=True, r=3)
    with pytest.raises(ValueError, match="do not fit"):
        conv_grad_weights(x, dz, aprc=False, r=3)
