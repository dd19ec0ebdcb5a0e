"""The arithmetic and the tiling of the tensor-core kernels B, C and E and
of the weight gradient, on the CPU: the operand splits they make (their
plain-torch mirrors in ``kernels/ref.py``), the tile plans they launch with
(``kernels/spiking_conv.py:plan_mma_tiles``, ``plan_wgrad``) and the
weight gradient's wrapper.  The kernels themselves run only on the card
(tests/test_torch_cuda.py, ``chip_smoke.py``); nothing here touches
CUDA."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.config import get_snn
from repro_torch.core.snn_layers import conv2d, exact_grid
from repro_torch.core.snn_model import init_snn
from repro_torch.kernels import ref
from repro_torch.kernels.ref import (split_bf16x3, split_tf32x2, tf32_round,
                                     tf32x3_product)
from repro_torch.kernels.spiking_conv import (MMA_TILES, MMA_WARPS,
                                              WGRAD_ACC_TILES, WGRAD_CHAINS,
                                              WGRAD_MAX_COLS, WGRAD_MAX_POS,
                                              _launch_wgrad,
                                              conv_grad_weights,
                                              plan_mma_tiles, plan_wgrad)

_MAX_SMEM = 227 * 1024


def _snn_mnist_weights(seed):
    cfg = get_snn("snn-mnist")
    params = init_snn(torch.Generator().manual_seed(seed), cfg, device="cpu")
    return [layer["w"] for layer in params["conv"]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16x3_split_is_exact_on_he_normal_weights(seed):
    """hi + mid + lo == w bit for bit, over snn-mnist's three conv layers
    at their published widths; hi is w rounded to bf16."""
    for w in _snn_mnist_weights(seed):
        hi, mid, lo = split_bf16x3(w)
        assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
        assert torch.equal(hi.double() + mid.double() + lo.double(),
                           w.double())
        assert torch.equal(hi, w.to(torch.bfloat16))


@pytest.mark.parametrize("exponent", list(range(-30, 4, 3)))
def test_bf16x3_split_is_exact_across_magnitudes(exponent):
    """The same at magnitudes from 1e-30 to 1e3, both signs, random
    mantissas (every float32 bit pattern's low bits occur)."""
    rng = np.random.default_rng(exponent + 100)
    w = (rng.uniform(1.0, 10.0, 4096) * 10.0 ** exponent
         * rng.choice([-1.0, 1.0], 4096)).astype(np.float32)
    w = torch.from_numpy(w)
    hi, mid, lo = split_bf16x3(w)
    assert torch.equal(hi.double() + mid.double() + lo.double(), w.double())
    # each part holds the remainder of the one before it
    assert bool((mid.double().abs() <= hi.double().abs() * 2.0 ** -8).all())
    assert bool((lo.double().abs() <= mid.double().abs() * 2.0 ** -8).all())


def _patches64(x, r, aprc):
    """The plain conv's float64 im2col rows of an NHWC input (the layout of
    ``core.snn_layers.conv2d``)."""
    lo, hi = (r - 1, r - 1) if aprc else ((r - 1) // 2, r - 1 - (r - 1) // 2)
    b, h, w, cin = x.shape
    e_h, e_w = h + lo + hi - r + 1, w + lo + hi - r + 1
    xp = F.pad(x.double(), (0, 0, lo, hi, lo, hi))
    taps = [xp[:, dy:dy + e_h, dx:dx + e_w, :]
            for dy in range(r) for dx in range(r)]
    return torch.cat(taps, dim=-1).reshape(b * e_h * e_w, r * r * cin), \
        (b, e_h, e_w)


@pytest.mark.parametrize("aprc", [True, False])
@pytest.mark.parametrize("layer", [1, 2])
def test_spike_products_of_the_split_sum_to_the_plain_conv(layer, aprc):
    """The spike x part products of the three planes, summed in float64,
    give the float64 conv of the plain path exactly (its weights are
    already on the exact grid), and rounded to float32 its output bit for
    bit: the sum kernels B and C approximate in the tensor cores."""
    w = _snn_mnist_weights(layer)[layer]
    r, _, cin, cout = w.shape
    h = 30 if layer == 1 else 32
    rng = np.random.default_rng(layer + 10 * aprc)
    x = torch.from_numpy((rng.random((2, h, h, cin)) < 0.3)
                         .astype(np.float32))
    patches, shape = _patches64(x, r, aprc)
    wq = exact_grid(w.reshape(r * r * cin, cout), dim=0)
    assert torch.equal(wq, w.reshape(r * r * cin, cout).double())
    split = sum(patches @ part.double().reshape(r * r * cin, cout)
                for part in split_bf16x3(w))
    assert torch.equal(split, patches @ wq)
    assert torch.equal(split.float().reshape(*shape, cout),
                       conv2d(x, w, aprc=aprc))


def _tf32_rna_reference(x: np.ndarray) -> np.ndarray:
    """Round to 11 significant bits, ties away from zero, by float64
    arithmetic on the value (not on its bits)."""
    out = np.zeros_like(x, dtype=np.float64)
    nz = x != 0
    mant, exp = np.frexp(np.abs(x[nz].astype(np.float64)))   # in [0.5, 1)
    scaled = mant * 2.0 ** 11
    rounded = np.floor(scaled + 0.5)                          # ties away
    out[nz] = np.sign(x[nz]) * np.ldexp(rounded, exp - 11)
    return out.astype(np.float32)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(20000) * 10.0 ** rng.integers(-20, 20, 20000)
         ).astype(np.float32)
    # exact ties: the 13 dropped bits are 1 followed by zeros
    ties = (rng.integers(0x00800000, 0x7F000000, 2000, dtype=np.int64)
            & ~0x1FFF | 0x1000).astype(np.int32).view(np.float32)
    x = np.concatenate([x, ties, -ties, np.zeros(3, np.float32)])
    got = tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _tf32_rna_reference(x))
    assert not (got.view(np.int32) & 0x1FFF).any()


def test_tf32_split_parts_are_tf32_and_hold_22_bits():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal(10000).astype(np.float32))
    hi, lo = split_tf32x2(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    resid = (x.double() - hi.double() - lo.double()).abs()
    assert bool((resid <= x.double().abs() * 2.0 ** -21).all())


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_tf32x3_product_relative_error_below_1e_6(scale):
    """Kernel E's product of two float32 values from their TF32 parts
    (three of the four cross products) against the exact product."""
    rng = np.random.default_rng(int(scale * 1000) % 97)
    a = (rng.standard_normal(100000) * scale).astype(np.float32)
    b = (rng.standard_normal(100000)).astype(np.float32)
    exact = a.astype(np.float64) * b.astype(np.float64)
    got = tf32x3_product(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    rel = np.abs(got - exact) / np.abs(exact)
    assert rel.max() < 1e-6


# -- the tile plan -----------------------------------------------------------

# (E_w, R, Cin, Cout) of every tensor-core launch: snn-mnist's main path,
# chip_smoke.py's cases and tests/test_torch_cuda.py's, and snn-seg's
# widest rows (80x160 frames, APRC full pad)
BC_SHAPES = [
    (32, 3, 16, 32), (34, 3, 32, 8),                   # layers 1 and 2
    (32, 3, 16, 32), (32, 5, 8, 16),                   # SAME 3x3, 5x5
    (10, 3, 3, 8), (11, 3, 2, 6), (6, 3, 4, 6),        # test cases
    (13, 3, 5, 12), (8, 3, 3, 40), (11, 5, 20, 9),
    (164, 3, 32, 32), (166, 3, 32, 16), (168, 3, 16, 1),   # snn-seg
]
E_SHAPES = [
    # E's own terms: E_w = the forward input's W, Cin = the forward's Cout
    # (summed), Cout = the forward's Cin (written)
    (32, 3, 8, 32), (30, 3, 32, 16),                   # layers 2 and 1
    (32, 3, 32, 16), (28, 5, 16, 8), (27, 3, 8, 16),   # SAME, 5x5, ragged
    (11, 3, 12, 5), (8, 3, 40, 20), (6, 3, 7, 33), (9, 5, 3, 3),
    (162, 3, 32, 32), (164, 3, 16, 32),                # snn-seg
]


def _check_plan(plan, e_w, r, cin, cout, split):
    bf16 = split == "bf16x3"
    depth = 16 if bf16 else 8
    # K and N padded to the MMA tiles
    assert plan.k_pad % depth == 0 and cin <= plan.k_pad < cin + depth
    # one channel group for a layer of up to 32 channels, padded by less
    # than an n8 tile; wider layers in groups of 32
    assert plan.cout_tile == 8 * plan.n_tiles == min(32, -(-cout // 8) * 8)
    # the m-tiles fit the warps, the accumulators the registers
    assert plan.m_tiles == -(-plan.block_rows * e_w // 16)
    assert plan.m_tiles <= MMA_WARPS * MMA_TILES
    assert MMA_TILES * plan.n_tiles * 4 <= 32
    # the shared memory fits one block, by the kernel's formula
    cs = plan.k_pad + (8 if bf16 else 4)
    halo = (plan.block_rows + r - 1) * (e_w + r - 1)
    if bf16:
        want = 2 * (3 * r * r * plan.cout_tile * cs + halo * cs) + 4 * (
            halo * (-(-cin // 4) * 4) + 32 * MMA_WARPS * MMA_TILES * 4
            * plan.n_tiles)
    else:
        want = 4 * (2 * r * r * plan.cout_tile * cs + halo * cs)
    assert plan.smem_bytes == want <= _MAX_SMEM


@pytest.mark.parametrize("shape", BC_SHAPES)
def test_mma_plan_fits_kernels_b_and_c(shape):
    _check_plan(plan_mma_tiles(*shape), *shape, "bf16x3")


@pytest.mark.parametrize("shape", E_SHAPES)
def test_mma_plan_fits_kernel_e(shape):
    _check_plan(plan_mma_tiles(*shape, split="tf32x3"), *shape, "tf32x3")


def test_mma_plan_at_the_main_path_shapes():
    """snn-mnist's launches: one channel group a layer, so each step's halo
    is staged once; layer 1's 32 channels and 8 rows fill the 16 m-tiles,
    layer 2's 34-wide rows take 7 (15 m-tiles); shared memory leaves room
    for two blocks an SM."""
    def key(p):
        return (p.block_rows, p.cout_tile, p.k_pad, p.m_tiles, p.smem_bytes)
    assert key(plan_mma_tiles(32, 3, 16, 32)) == (8, 32, 16, 16, 112320)
    assert key(plan_mma_tiles(34, 3, 32, 8)) == (7, 8, 32, 15, 92864)
    assert key(plan_mma_tiles(32, 3, 8, 32, split="tf32x3")) == \
        (8, 32, 8, 16, 43968)
    assert key(plan_mma_tiles(30, 3, 32, 16, split="tf32x3")) == \
        (8, 16, 32, 15, 87552)


def test_mma_plan_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="no tiling"):
        plan_mma_tiles(300, 3, 8, 8)        # one row is over 16 m-tiles
    with pytest.raises(ValueError, match="split"):
        plan_mma_tiles(32, 3, 16, 32, split="fp8")


def test_main_path_shapes_match_the_config():
    """The shapes above are snn-mnist's: E_w, Cin and Cout of layers 1, 2."""
    cfg = get_snn("snn-mnist")
    c0, c1, c2 = cfg.conv_channels
    h = cfg.input_hw[1] + 2                     # layer 0's APRC output
    assert (h + 2, c0, c1) == BC_SHAPES[0][0:1] + BC_SHAPES[0][2:]
    assert (h + 4, c1, c2) == BC_SHAPES[1][0:1] + BC_SHAPES[1][2:]
    assert cfg.kernel_size == 3


# -- the weight gradient (csrc/conv_grad_weights.cu) --------------------------

@pytest.mark.parametrize("exponent", list(range(-14, 3, 4)))
def test_bf16x3_split_of_a_cotangent_is_exact_on_spikes(exponent):
    """The weight gradient's split of dz: on a 0/1 spike, x * (hi + mid +
    lo), summed in float32 from the parts, is x * dz bit for bit, at the
    small magnitudes of a batch-mean loss's cotangent and up to 100."""
    rng = np.random.default_rng(exponent + 300)
    dz = torch.from_numpy((rng.standard_normal(8192) * 10.0 ** exponent)
                          .astype(np.float32))
    x = torch.from_numpy((rng.random(8192) < 0.3).astype(np.float32))
    hi, mid, lo = split_bf16x3(dz)
    parts = hi.float() + mid.float() + lo.float()
    assert torch.equal(x * parts, x * dz)
    assert torch.equal(parts, dz)


# (N, E_h, E_w, R, Cin, Cout, analog): the weight gradient's calls
WGRAD_SHAPES = [
    (2048, 32, 32, 3, 16, 32, False),      # snn-mnist layers 1, 2 and 0
    (2048, 34, 34, 3, 32, 8, False),
    (256, 30, 30, 3, 1, 16, True),
    (8, 32, 32, 3, 16, 32, False),         # make_grad_rows_fn's batch-1 rows
    (256, 84, 164, 3, 8, 16, False),       # snn-seg layers 1 to 5, and 0
    (256, 86, 166, 3, 16, 32, False),
    (256, 88, 168, 3, 32, 32, False),
    (256, 90, 170, 3, 32, 16, False),
    (256, 92, 172, 3, 16, 1, False),
    (16, 82, 162, 3, 3, 8, True),
    (7, 9, 11, 3, 5, 12, False),           # ragged
    (6, 16, 17, 5, 16, 32, False),         # 5x5 taps
    (2, 10, 12, 5, 32, 32, False),         # 5x5 at 32 x 32: taps on the grid
    (3, 9, 11, 3, 40, 36, False),          # two channel groups each way
]


@pytest.mark.parametrize("shape", WGRAD_SHAPES)
def test_wgrad_plan_fits_its_kernel(shape):
    """Each warp's tap slots fit its accumulators, a tile fits one block's
    shared memory (the kernel's layout), whole rows up to 64 columns and
    at most 256 positions, and the chains are the tiles up to 264."""
    n, e_h, e_w, r, cin, cout, analog = shape
    p = plan_wgrad(n, e_h, e_w, r, cin, cout, analog=analog)
    assert p.m_tiles == (1 if cin <= 16 else 2)
    assert p.n_tiles == (1 if cout <= 8 else 2 if cout <= 16 else 4)
    slots = WGRAD_ACC_TILES // (p.m_tiles * p.n_tiles)
    assert -(-(r * r + 1) // p.tap_groups) <= slots
    assert p.tap_groups in (1, 2, 4) or p.tap_groups % MMA_WARPS == 0
    # the fewest groups that fit
    assert p.tap_groups == 1 or -(-(r * r + 1) // (p.tap_groups // 2)) > \
        slots
    assert p.block_cols == e_w if e_w <= WGRAD_MAX_COLS else \
        p.block_cols <= WGRAD_MAX_COLS < e_w
    assert p.block_rows * p.block_cols <= max(WGRAD_MAX_POS, p.block_cols)
    assert 1 <= p.block_rows <= e_h
    assert p.smem_bytes <= _MAX_SMEM
    assert p.tiles == n * -(-e_h // p.block_rows) * -(-e_w // p.block_cols)
    assert p.chains == min(p.tiles, WGRAD_CHAINS)


def test_wgrad_plan_at_the_main_path_shapes():
    """snn-mnist's three calls a train step: layer 1 in two tap groups of
    four warps, 8 whole rows a tile; layer 2 in one group of eight, 7 rows;
    layer 0's frames (the analog instance) 8 rows; 264 chains each.  The
    batch-1 rows of ``make_grad_rows_fn`` (T = 8 images) plan 32 chains,
    one a tile, not 264 blocks of nothing."""
    def key(p):
        return (p.block_rows, p.block_cols, p.tap_groups, p.chains,
                p.smem_bytes)
    assert key(plan_wgrad(2048, 32, 32, 3, 16, 32)) == \
        (8, 32, 2, 264, 178704)
    assert key(plan_wgrad(2048, 34, 34, 3, 32, 8)) == (7, 34, 1, 264, 135696)
    assert key(plan_wgrad(256, 30, 30, 3, 1, 16, analog=True)) == \
        (8, 30, 1, 264, 51280)
    assert key(plan_wgrad(8, 32, 32, 3, 16, 32)) == (8, 32, 2, 32, 178704)


def test_wgrad_plan_refuses_an_empty_layer():
    with pytest.raises(ValueError, match="no weight-gradient plan"):
        plan_wgrad(2, 8, 8, 3, 0, 4)


def test_wgrad_wrapper_refuses_what_the_kernel_does_not_take():
    """The launcher's checks, before any pointer reaches the card: the
    shapes of a conv, float32, contiguous, one CUDA device."""
    x = torch.zeros((2, 8, 8, 4))
    dz = torch.zeros((2, 10, 10, 8))
    with pytest.raises(ValueError, match="do not fit"):
        _launch_wgrad(x, dz, False, 3, True)       # SAME: dz is 8 x 8
    with pytest.raises(ValueError, match="do not fit"):
        _launch_wgrad(x[..., :0], dz, True, 3, True)
    with pytest.raises(ValueError, match=r"\(N, H, W, Cin\)"):
        _launch_wgrad(x[0], dz, True, 3, True)
    with pytest.raises(TypeError, match="float32"):
        _launch_wgrad(x.double(), dz.double(), True, 3, True)
    with pytest.raises(ValueError, match="contiguous"):
        _launch_wgrad(x.transpose(1, 2), dz, True, 3, True)
    with pytest.raises(ValueError, match="CUDA device"):
        _launch_wgrad(x, dz, True, 3, True)


@pytest.mark.parametrize("binary", [False, True])
def test_wgrad_on_cpu_tensors_takes_the_plain_loop(binary):
    """CPU tensors take the torch-op GEMMs, with their bits, whichever
    instance the caller names, and launch nothing."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.random((3, 9, 11, 5)) < 0.3)
                         .astype(np.float32))
    dz = torch.from_numpy(rng.standard_normal((3, 11, 13, 12))
                          .astype(np.float32))
    launches = (conv_grad_weights.launches,
                conv_grad_weights.launches_analog)
    dw, db = conv_grad_weights(x, dz, aprc=True, r=3, binary=binary)
    want = ref.conv_grad_weights_ref(x, dz, aprc=True, r=3)
    assert torch.equal(dw, want[0]) and torch.equal(db, want[1])
    assert (conv_grad_weights.launches,
            conv_grad_weights.launches_analog) == launches
