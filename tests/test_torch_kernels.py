"""The port's kernel modules against the reference: the oracles, the plain
versions the wrappers run on CPU tensors, the skip table and the tiling
plan.  The kernels themselves run only on the card
(tests/test_torch_cuda.py, and ``chip_smoke.py`` at the main path's
shapes)."""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import ref as jx_ref
from repro.kernels import spiking_conv as jx_spiking_conv
from repro_torch.kernels import ref
from repro_torch.kernels.spiking_conv import (plan_tiles, row_block_counts,
                                              skip_fraction_from_rows,
                                              skip_table_fraction,
                                              spiking_conv,
                                              spiking_conv_lif_hoisted,
                                              train_counts_plain)
from repro_torch.kernels.spiking_conv_lif import spiking_conv_lif

# the reference's functions, jitted: one compile per shape instead of one
# per op
jx_spiking_conv_ref = jax.jit(jx_ref.spiking_conv_ref, static_argnames="aprc")
jx_spiking_conv_lif_ref = jax.jit(jx_ref.spiking_conv_lif_ref,
                                  static_argnames=("v_th", "aprc"))
jx_row_block_counts = jax.jit(jx_spiking_conv.row_block_counts,
                              static_argnums=(1, 2, 3))
jx_skip_table_fraction = jax.jit(jx_spiking_conv.skip_table_fraction,
                                 static_argnums=1,
                                 static_argnames=("aprc", "block_rows"))

# the reference's CONV_CASES (tests/test_kernels.py); its block_rows and
# groups shape the TPU grid and are not read here
CONV_CASES = [
    # B, H, W, Cin, Cout, R, aprc, block_rows, groups
    (2, 8, 8, 3, 8, 3, True, 4, 2),
    (1, 12, 12, 1, 16, 3, True, 8, 4),
    (2, 6, 10, 4, 12, 5, True, 4, 3),   # 5x5 taps
    (2, 8, 8, 3, 8, 3, False, 4, 2),
    (1, 7, 9, 2, 6, 3, True, 4, 3),     # ragged rows
    (2, 10, 10, 6, 9, 3, False, 4, 9),  # group = single channel (SPE-like)
]
FUSED_CASES = [
    # T, B, H, W, Cin, Cout, R, aprc
    (3, 2, 8, 8, 3, 8, 3, True),
    (2, 1, 7, 9, 2, 6, 3, True),        # non-block-divisible rows
    (2, 2, 6, 6, 4, 6, 3, False),       # same-pad (APRC off)
]
LIF_CASES = [(8, 128), (10, 200), (1, 1), (17, 300)]


def _conv_inputs(case, seed=0, rate=0.15):
    b, h, w_, cin, cout, r, aprc, _, _ = case
    rng = np.random.default_rng(seed)
    spikes = (rng.random((b, h, w_, cin)) < rate).astype(np.float32)
    w = (rng.standard_normal((r, r, cin, cout)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.01).astype(np.float32)
    return spikes, w, bias, aprc


def _fused_inputs(case, rate, seed=0):
    t, b, h, w_, cin, cout, r, aprc = case
    rng = np.random.default_rng(seed + int(rate * 1000))
    spikes = (rng.random((t, b, h, w_, cin)) < rate).astype(np.float32)
    w = (rng.standard_normal((r, r, cin, cout)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.05).astype(np.float32)
    e_h, e_w = (h + r - 1, w_ + r - 1) if aprc else (h, w_)
    v0 = (rng.standard_normal((b, e_h, e_w, cout)) * 0.3).astype(np.float32)
    return spikes, v0, w, bias, aprc


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("fn", [ref.spiking_conv_ref, spiking_conv],
                         ids=["oracle", "wrapper"])
def test_spiking_conv_matches_reference(fn, case):
    """The oracle, and the wrapper on CPU tensors (its plain version),
    against the reference's oracle; the CPU path launches nothing."""
    spikes, w, bias, aprc = _conv_inputs(case)
    launches = spiking_conv.launches
    got = fn(*_t(spikes, w, bias), aprc=aprc).numpy()
    want = np.asarray(jx_spiking_conv_ref(spikes, w, bias, aprc=aprc))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert spiking_conv.launches == launches


@pytest.mark.parametrize("shape", LIF_CASES)
def test_lif_fused_ref_matches_reference(shape):
    rng = np.random.default_rng(shape[0])
    v = rng.standard_normal(shape).astype(np.float32)
    z = rng.standard_normal(shape).astype(np.float32)
    for v_th in (0.5, 1.0):
        vg, sg = ref.lif_fused_ref(*_t(v, z), v_th)
        vw, sw = jx_ref.lif_fused_ref(v, z, v_th)
        np.testing.assert_array_equal(sg.numpy(), np.asarray(sw))
        np.testing.assert_array_equal(vg.numpy(), np.asarray(vw))


@pytest.mark.parametrize("rate", [0.02, 0.18, 0.5])
@pytest.mark.parametrize("case", FUSED_CASES)
@pytest.mark.parametrize("fn", [ref.spiking_conv_lif_ref, spiking_conv_lif],
                         ids=["oracle", "wrapper"])
def test_spiking_conv_lif_matches_reference(fn, case, rate):
    """Conv+LIF over T against the reference's composed oracle, across
    spike rates spanning the paper's Fig. 2 regime."""
    spikes, v0, w, bias, aprc = _fused_inputs(case, rate)
    launches = spiking_conv_lif.launches
    s, v = fn(*_t(spikes, v0, w, bias), v_th=1.0, aprc=aprc)
    sr, vr = jx_spiking_conv_lif_ref(spikes, v0, w, bias, v_th=1.0,
                                         aprc=aprc)
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    np.testing.assert_allclose(v.numpy(), np.asarray(vr), atol=1e-4)
    assert spiking_conv_lif.launches == launches


def test_saved_pre_reset_membrane_is_v_plus_dv():
    spikes, v0, w, bias, aprc = _fused_inputs(FUSED_CASES[0], 0.18)
    s, v, u = ref.spiking_conv_lif_ref(*_t(spikes, v0, w, bias), v_th=1.0,
                                       aprc=aprc, save_u=True)
    s2, v2 = ref.spiking_conv_lif_ref(*_t(spikes, v0, w, bias), v_th=1.0,
                                      aprc=aprc)
    assert torch.equal(s, s2) and torch.equal(v, v2)
    assert torch.equal(s, (u >= 1.0).float())
    z0 = ref.spiking_conv_ref(*_t(spikes[0], w, bias), aprc=aprc)
    assert torch.equal(u[0], torch.from_numpy(v0) + z0)


def test_zero_input_emits_bias_and_zero_train_still_integrates():
    """All-zero input is the skip path: dV is the bias alone, and the LIF
    recurrence still advances on it."""
    w = torch.ones((3, 3, 3, 4))
    bias = torch.arange(4, dtype=torch.float32)
    out = spiking_conv(torch.zeros((2, 8, 8, 3)), w, bias, aprc=True)
    assert torch.equal(out, bias.expand(out.shape))
    s, v = spiking_conv_lif(torch.zeros((3, 2, 8, 8, 3)),
                            torch.zeros((2, 10, 10, 4)), w,
                            torch.full((4,), 0.4), v_th=1.0, aprc=True)
    # bias 0.4, threshold 1.0: the first spike lands exactly at step 3
    assert float(s[:2].sum()) == 0.0 and float(s[2].sum()) == 2 * 100 * 4
    torch.testing.assert_close(v, torch.full_like(v, 0.2))


def test_faint_analog_input_not_skipped():
    """A block whose value sum is < 1 must still convolve: the skip table
    counts nonzero entries, it does not sum values."""
    x = np.zeros((1, 8, 8, 1), np.float32)
    x[0, 2, 3, 0] = 0.2
    w, bias = np.ones((3, 3, 1, 4), np.float32), np.zeros(4, np.float32)
    out = spiking_conv(*_t(x, w, bias), aprc=True).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jx_spiking_conv_ref(x, w, bias, aprc=True)),
        atol=1e-6)
    assert out.max() > 0
    assert int(row_block_counts(torch.from_numpy(x), 3, 4, 2).sum()) > 0


@pytest.mark.parametrize("shape,r,br,nb", [((2, 13, 9, 3), 3, 4, 3),
                                           ((3, 20, 6, 2), 5, 8, 2),
                                           ((1, 8, 8, 1), 3, 8, 1)])
def test_row_block_counts_match_reference(shape, r, br, nb):
    rng = np.random.default_rng(sum(shape))
    x = np.where(rng.random(shape) < 0.3, rng.random(shape), 0.0
                 ).astype(np.float32)
    got = row_block_counts(torch.from_numpy(x), r, br, nb).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jx_row_block_counts(x, r, br, nb)))


@pytest.mark.parametrize("rate", [0.0, 0.003, 0.05, 0.4])
@pytest.mark.parametrize("shape,r,aprc", [((3, 2, 30, 30, 4), 3, True),
                                          ((2, 3, 17, 9, 2), 3, False),
                                          ((2, 2, 12, 12, 1), 5, True)])
def test_skip_table_fraction_matches_reference(shape, r, aprc, rate):
    rng = np.random.default_rng(int(rate * 1000) + len(shape))
    spikes = (rng.random(shape) < rate).astype(np.float32)
    got = float(skip_table_fraction(torch.from_numpy(spikes), r, aprc=aprc))
    want = float(jx_skip_table_fraction(spikes, r, aprc=aprc))
    assert got == want


def _fused_layer_inputs():
    """(name, H, W, Cin) of the input train of every fused layer of
    snn-mnist and snn-seg (the layers after the hoisted first, snn-seg's
    readout included), with APRC on and off."""
    import dataclasses

    from repro_torch.config import get_snn
    from repro_torch.core.snn_model import layer_shapes
    out = []
    for name in ("snn-mnist", "snn-seg"):
        for aprc in (True, False):
            shapes = layer_shapes(dataclasses.replace(get_snn(name),
                                                      aprc=aprc))
            pad = "aprc" if aprc else "same"
            out += [(f"{name}-layer{i}-{pad}", aprc) + shapes[i - 1]
                    for i in range(1, len(shapes))]
    return out


FUSED_LAYER_INPUTS = _fused_layer_inputs()


@pytest.mark.parametrize("train", ["silent", "firing", "random"])
@pytest.mark.parametrize("layer", FUSED_LAYER_INPUTS,
                         ids=[c[0] for c in FUSED_LAYER_INPUTS])
def test_skip_fraction_from_rows_equals_skip_table_fraction(layer, train):
    """The finisher's plain version, fed the row counts of a train, gives
    ``skip_table_fraction``'s bits for that train, at every fused layer's
    input shape of both nets (T=2, batch 2): silent, every site firing,
    and rows that are empty or sparse at random."""
    _, aprc, h, w_, cin = layer
    rng = np.random.default_rng(h * w_ + cin + len(train))
    shape = (2, 2, h, w_, cin)
    if train == "silent":
        x = np.zeros(shape, np.float32)
    elif train == "firing":
        x = np.ones(shape, np.float32)
    else:
        rows = rng.random((2, 2, h, 1, 1)) < 0.3
        x = ((rng.random(shape) < 0.02) & rows).astype(np.float32)
    x = torch.from_numpy(x)
    counts = train_counts_plain(x)
    calls = skip_table_fraction.calls
    want = skip_table_fraction(x, 3, aprc=aprc)
    assert skip_table_fraction.calls == calls + 1
    got = skip_fraction_from_rows(counts, 3, aprc=aprc)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)
    if train != "random":
        assert float(got) == (1.0 if train == "silent" else 0.0)


@pytest.mark.parametrize("hoisted", [True, False])
def test_count_outputs_on_the_cpu_are_the_trains_reductions(hoisted):
    """``count=True`` on CPU tensors: the plain version's outputs, then the
    train's counts by step and channel and by output row, as int32; no
    launch is counted."""
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((3, 3, 2, 6)) * 0.6).astype(np.float32)
    bias = np.full(6, 0.3, np.float32)
    v0 = np.zeros((2, 9, 11, 6), np.float32)
    if hoisted:
        x = rng.random((2, 7, 9, 2)).astype(np.float32)
        before = spiking_conv_lif_hoisted.launches_counted
        s, v, c = spiking_conv_lif_hoisted(*_t(x, v0, w, bias), t=3,
                                           count=True)
        plain = spiking_conv_lif_hoisted(*_t(x, v0, w, bias), t=3)
        assert spiking_conv_lif_hoisted.launches_counted == before
    else:
        x = (rng.random((3, 2, 7, 9, 2)) < 0.4).astype(np.float32)
        xt, v0t, wt, bt = _t(x, v0, w, bias)
        before = spiking_conv_lif.launches_counted
        s, v, c = spiking_conv_lif(xt, v0t, wt, bt, count=True)
        plain = spiking_conv_lif(xt, v0t, wt, bt)
        assert spiking_conv_lif.launches_counted == before
    assert torch.equal(s, plain[0]) and torch.equal(v, plain[1])
    assert c.t.dtype == c.rows.dtype == torch.int32
    assert torch.equal(c.t, s.sum(dim=(1, 2, 3)).int())
    assert torch.equal(c.rows, s.sum(dim=(3, 4)).int())
    assert 0 < int(c.t.sum()) < s.numel()


@pytest.mark.parametrize("case", ["grad", "save_u"])
def test_count_is_refused_where_no_launch_counts(case):
    """``count`` asks for kernel B's or the hoisted mode's counting
    instance: a forward that builds a gradient (kernel C) or keeps the
    membrane (``save_u``) counts nothing, and asking it to raises."""
    rng = np.random.default_rng(12)
    w = (rng.standard_normal((3, 3, 2, 4)) * 0.6).astype(np.float32)
    bias = np.full(4, 0.3, np.float32)
    v0 = np.zeros((2, 9, 11, 4), np.float32)
    if case == "grad":
        x = (rng.random((3, 2, 7, 9, 2)) < 0.4).astype(np.float32)
        xt, v0t, wt, bt = _t(x, v0, w, bias)
        with pytest.raises(ValueError, match="count"):
            spiking_conv_lif(xt, v0t, wt.requires_grad_(True), bt,
                             count=True)
    else:
        x = rng.random((2, 7, 9, 2)).astype(np.float32)
        with pytest.raises(ValueError, match="count"):
            spiking_conv_lif_hoisted(*_t(x, v0, w, bias), t=3, save_u=True,
                                     count=True)


@pytest.mark.parametrize("planes", [(0, 2), (2, 0)],
                         ids=["no-steps", "no-images"])
def test_empty_skip_table_is_nan(planes):
    """A table of no cells (no steps or no images) has the reference's mean
    of nothing, NaN, from the train and from its row counts alike."""
    x = torch.zeros(planes + (5, 4, 3))
    want = skip_table_fraction(x, 3)
    got = skip_fraction_from_rows(train_counts_plain(x), 3)
    assert want.dtype == got.dtype == torch.float32
    assert bool(torch.isnan(want)) and bool(torch.isnan(got))


def test_tile_plan_at_the_main_path_shapes():
    """One thread per pixel and channel quad, at most 512 a block: snn-mnist
    layer 0's 30-wide rows of 16 channels take 4 rows a block (the ragged
    30-row output masks half its last block), layer 1's 32 channels 2 rows,
    layer 2's 8 channels 7; wide snn-seg rows split their channels into
    even groups of one row; a narrow layer keeps 8 rows; a row no block
    can hold raises."""
    assert plan_tiles(30, 3, 1, 16) == (4, 16)
    assert plan_tiles(32, 3, 16, 32) == (2, 32)
    assert plan_tiles(34, 3, 32, 8) == (7, 8)
    assert plan_tiles(170, 3, 32, 16) == (1, 8)
    assert plan_tiles(10, 3, 3, 1) == (8, 4)
    with pytest.raises(ValueError, match="no tiling"):
        plan_tiles(2000, 3, 8, 8)


def test_wrappers_refuse_tensors_they_cannot_launch_on():
    """Only CPU tensors take the plain version; anything else launches the
    kernel or raises — there is no silent fallback."""
    x = torch.zeros((1, 4, 4, 1), device="meta")
    w = torch.zeros((3, 3, 1, 4), device="meta")
    b = torch.zeros((4,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        spiking_conv(x, w, b)
    with pytest.raises(ValueError, match="CUDA"):
        spiking_conv_lif(x[None], torch.zeros((1, 6, 6, 4), device="meta"),
                         w, b)
