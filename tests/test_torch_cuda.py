"""The hand-written kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips unless there is an NVIDIA card
of compute capability 9.0 or newer.  The file imports neither JAX nor the
JAX package, so it runs on a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Spike trains follow ``chip_smoke.py``'s rule: a site may differ only by a
threshold flip (the plain pre-reset membrane within 1e-4 of v_th at the
first differing step), and final membranes of agreeing sites agree to 1e-4.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.spiking_conv import spiking_conv
from repro_torch.kernels.spiking_conv_lif import spiking_conv_lif

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
    with pytest.raises(NotImplementedError, match="backward"):
        spiking_conv(x, w.requires_grad_(True), b)
