"""The port's kernel-ops layer (``repro_torch.kernels.ops``) against the
reference's (``repro.kernels.ops``): the same numpy inputs through both.

On CPU tensors every op computes through its kernel's plain version; the
kernels themselves are held against those plain versions on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).  ``lif_fused`` is held
against the reference's Pallas kernel run in interpret mode: spikes equal,
membranes to 1e-6 in float32 and 1e-2 in bfloat16 (the reference's own
rule, tests/test_kernels.py).  The chunked fused layer is held against the
reference's whole-T oracle ``ref.spiking_conv_lif_ref`` (the reference's
own fused op reaches its halo kernel, which does not run on this JAX):
spikes exactly, membranes to 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jx_ops
from repro.kernels import ref as jx_ref
from repro_torch.kernels import ops
from repro_torch.kernels.lif import lif_fused as lif_fused_wrapper

LIF_CASES = [(8, 128), (10, 200), (1, 1), (17, 300), (32, 256)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _both(x, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", LIF_CASES)
def test_lif_fused_matches_the_reference_kernel(shape, dtype):
    rng = np.random.default_rng(shape[0])
    v = rng.standard_normal(shape).astype(np.float32)
    z = rng.standard_normal(shape).astype(np.float32)
    (vj, vt), (zj, zt) = _both(v, dtype), _both(z, dtype)
    v2j, s2j = jx_ops.lif_fused(vj, zj, 1.0, interpret=True)
    v2t, s2t = ops.lif_fused(vt, zt, 1.0)
    assert v2t.dtype == s2t.dtype == DTYPES[dtype][1]
    assert v2t.shape == s2t.shape == shape
    np.testing.assert_array_equal(_np(s2t), _np(s2j))
    np.testing.assert_allclose(_np(v2t), _np(v2j), atol=DTYPES[dtype][2],
                               rtol=0)


@pytest.mark.parametrize("v_th", [0.5, 0.7, 1.0, 2.0])
def test_lif_fused_threshold_sweep(v_th):
    """Membranes on both sides of each threshold, including values equal
    to it (0.7 is not a float32: the comparison is made in float32)."""
    v = np.linspace(-2, 2, 64, dtype=np.float32).reshape(8, 8)
    v[0, :4] = np.float32(v_th)
    z = np.zeros((8, 8), np.float32)
    v2j, s2j = jx_ops.lif_fused(jnp.asarray(v), jnp.asarray(z), v_th,
                                interpret=True)
    v2t, s2t = ops.lif_fused(torch.from_numpy(v), torch.from_numpy(z), v_th)
    np.testing.assert_array_equal(_np(s2t), _np(s2j))
    np.testing.assert_allclose(_np(v2t), _np(v2j), atol=1e-6, rtol=0)
    assert float(s2t[0, :4].sum()) == 4.0


def test_lif_fused_pads_and_slices_back():
    """The op takes a shape that is no multiple of the reference's (8, 128)
    block as it is (the kernel needs no padding) and returns the caller's
    shape, equal to the wrapper's result."""
    v = torch.randn(17, 300, generator=torch.Generator().manual_seed(0))
    z = torch.randn(17, 300, generator=torch.Generator().manual_seed(1))
    got = ops.lif_fused(v, z, 1.0)
    want = lif_fused_wrapper(v, z, 1.0)
    for a, b in zip(got, want):
        assert a.shape == (17, 300) and torch.equal(a, b)


def _fused_inputs(seed, t, b, h, w, cin, cout, r, aprc, rate):
    rng = np.random.default_rng(seed)
    spikes = (rng.random((t, b, h, w, cin)) < rate).astype(np.float32)
    wt = (rng.standard_normal((r, r, cin, cout)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.05).astype(np.float32)
    e_h, e_w = (h + r - 1, w + r - 1) if aprc else (h, w)
    v0 = (rng.standard_normal((b, e_h, e_w, cout)) * 0.2).astype(np.float32)
    return spikes, v0, wt, bias


# T, B, H, W, Cin, Cout, R, aprc, rate
FUSED_CASES = [
    (5, 2, 8, 8, 3, 8, 3, True, 0.2),
    (4, 1, 7, 9, 2, 6, 3, True, 0.4),      # ragged rows
    (6, 2, 6, 6, 4, 6, 3, False, 0.3),     # SAME
    (3, 2, 6, 10, 4, 5, 5, True, 0.1),     # 5x5 taps
]


@pytest.mark.parametrize("ct", [1, 2, 3])
@pytest.mark.parametrize("case", FUSED_CASES)
def test_chunked_fused_layer_matches_the_whole_T_oracle(case, ct):
    *shape, aprc, rate = case
    spikes, v0, w, b = _fused_inputs(7, *shape, aprc, rate)
    s_j, v_j = jx_ref.spiking_conv_lif_ref(
        jnp.asarray(spikes), jnp.asarray(v0), jnp.asarray(w),
        jnp.asarray(b), v_th=1.0, aprc=aprc)
    s_t, v_t = ops.spiking_conv_lif_chunked(
        *map(torch.from_numpy, (spikes, v0, w, b)), chunk_timesteps=ct,
        v_th=1.0, aprc=aprc)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-4,
                               rtol=0)


def test_single_step_is_the_two_kernel_path():
    """T=1: the fused op equals ``spiking_conv`` followed by ``lif_fused``
    (the reference's drop-in contract, tests/test_kernels.py), here on the
    port's plain versions, bit for bit."""
    spikes, v0, w, b = map(torch.from_numpy, _fused_inputs(
        3, 1, 2, 8, 8, 3, 8, 3, True, 0.18))
    s, v = ops.spiking_conv_lif(spikes, v0, w, b, v_th=1.0, aprc=True)
    z = ops.spiking_conv(spikes[0], w, b, aprc=True)
    v2, s2 = ops.lif_fused(v0.reshape(-1, v0.shape[-1]),
                           z.reshape(-1, z.shape[-1]), 1.0)
    assert torch.equal(s[0], s2.reshape(s[0].shape))
    assert torch.equal(v, v2.reshape(v.shape))


class _Spec:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("spec, match", [
    (_Spec(backend="batched"), "backend"),
    (_Spec(timesteps=9), "timesteps"),
    (_Spec(resolved_schedule=lambda: "cbws"), "schedule"),
    (_Spec(chunk_timesteps=2), "chunk"),
])
def test_spec_fields_the_op_cannot_apply_are_loud(spec, match):
    spikes, v0, w, b = map(torch.from_numpy, _fused_inputs(
        1, 2, 1, 6, 6, 2, 4, 3, True, 0.3))
    with pytest.raises(ValueError, match=match):
        ops.spiking_conv_lif(spikes, v0, w, b, spec=spec)


def test_spec_surrogate_reaches_the_backward():
    """A spec's surrogate overrides the kwargs: the gradient equals the one
    taken with the same surrogate passed directly."""
    spikes, v0, w, b = map(torch.from_numpy, _fused_inputs(
        2, 3, 2, 6, 6, 2, 4, 3, True, 0.4))
    grads = []
    for kw in ({"spec": _Spec(backend="hopper", surrogate_kind="arctan",
                              surrogate_alpha=4.0)},
               {"surrogate_kind": "arctan", "surrogate_alpha": 4.0}):
        wg = w.clone().requires_grad_(True)
        s, v = ops.spiking_conv_lif(spikes, v0, wg, b, **kw)
        (s.sum() + v.sum() * 0.5).backward()
        grads.append(wg.grad)
    assert torch.equal(grads[0], grads[1])
