"""Two repairs of the port, held on the CPU.

Logits-only forwards.  ``snn_apply(..., logits_only=True)`` (and the chunked
entries) compute the logits alone: no spike counts, no skip table, nothing
that feeds them.  The serving cache's ``"logits"`` entries and the training
loss use it.  The logits keep the full forward's bits on every backend,
whole T and chunked, and so do the gradients (the loss never read the
counts).  A counting test shows the work is gone: a logits entry and the
loss call ``skip_table_fraction`` never, and reduce no spike train.

The ``batched`` conv.  ``snn_layers.conv2d`` on a 0/1 input multiplies one
float64 GEMM per tap on the exact-grid weights instead of one GEMM over an
im2col copy of the padded input: every partial sum is exact, so the bits
are the old formula's (kept here as ``_im2col_conv``).  A caller that knows
its input is a spike train says so (``binary=True``) and skips the value
check, the host sync on the card; the model's layers after the first do.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

import repro_torch.kernels.spiking_conv as sc
from repro_torch.api import TrainSpec
from repro_torch.config import get_snn
from repro_torch.core import snn_layers as L
from repro_torch.core.scheduler import build_schedule
from repro_torch.core.snn_model import init_snn, snn_apply, snn_apply_chunked
from repro_torch.core.snn_train import make_loss_fn
from repro_torch.serving.batcher import ExecCache

BACKENDS = ("ref", "batched", "hopper")


def _mnist_cfg():
    return dataclasses.replace(
        get_snn("snn-mnist"), input_hw=(8, 8), conv_channels=(8, 8),
        timesteps=5, num_spe_clusters=4)


def _seg_cfg():
    return dataclasses.replace(
        get_snn("snn-seg"), input_hw=(6, 8), conv_channels=(4, 8, 1),
        timesteps=4, num_spe_clusters=2)


CFGS = {"snn-mnist": _mnist_cfg, "snn-seg": _seg_cfg}


def _setup(name, n=3, seed=0):
    cfg = CFGS[name]()
    params = init_snn(torch.Generator().manual_seed(seed), cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(seed).random(
        (n, *cfg.input_hw, cfg.input_channels), dtype=np.float32))
    return cfg, params, x


def _sched(params, cfg, backend):
    return build_schedule(params, cfg, "aprc+cbws") \
        if backend == "hopper" else None


# -- logits-only forwards ------------------------------------------------------

@pytest.mark.parametrize("ct", [None, 2])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(CFGS))
def test_logits_only_gives_the_full_forwards_bits(name, backend, ct):
    cfg, params, x = _setup(name)
    sched = _sched(params, cfg, backend)

    def run(logits_only):
        with torch.no_grad():
            if ct is None:
                return snn_apply(params, x, cfg, backend=backend,
                                 schedule=sched, logits_only=logits_only)
            return snn_apply_chunked(params, x, cfg, chunk_timesteps=ct,
                                     backend=backend, schedule=sched,
                                     logits_only=logits_only)

    full, only = run(False), run(True)
    assert torch.equal(full.logits, only.logits)
    assert full.spike_counts and full.timestep_counts
    assert (only.spike_counts, only.spike_totals, only.timestep_counts,
            only.skip_fractions) == ((), (), (), ())


@pytest.mark.parametrize("backend", BACKENDS)
def test_logits_only_loss_gradients_are_bit_identical(backend):
    """``make_loss_fn`` now runs the logits-only forward; its gradients are
    those of the same loss on the full forward, bit for bit."""
    cfg, params, x = _setup("snn-mnist", n=2)
    y = torch.tensor([3, 7])

    def grads(loss_fn):
        leaves = [p.detach().clone().requires_grad_(True)
                  for kind in ("conv", "dense") for p in
                  (t for layer in params[kind] for t in layer.values())]
        it = iter(leaves)
        tree = {kind: [{k: next(it) for k in layer} for layer in params[kind]]
                for kind in ("conv", "dense")}
        loss = loss_fn(tree)
        return [loss] + list(torch.autograd.grad(loss, leaves))

    def full_loss(p):
        logits = snn_apply(p, x, cfg, backend=backend).logits
        return -torch.log_softmax(logits, -1)[torch.arange(2), y].mean()

    ours = make_loss_fn(cfg, spec=TrainSpec(backend=backend))
    for a, b in zip(grads(lambda p: ours(p, x, y)), grads(full_loss)):
        assert torch.equal(a, b)


class _Census(TorchFunctionMode):
    """Counts the reductions of spike trains and membranes (a ``sum`` or
    ``count_nonzero`` of a tensor of three or more dimensions) and the
    value checks (``all``) run inside the mode."""

    def __init__(self):
        super().__init__()
        self.reductions = 0
        self.value_checks = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        first = args[0] if args else None
        if isinstance(first, torch.Tensor):
            if name in ("sum", "count_nonzero") and first.dim() >= 3:
                self.reductions += 1
            if name == "all":
                self.value_checks += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def skip_table_calls():
    """The calls of ``skip_table_fraction`` since the test began, read
    from its own counter."""
    start = sc.skip_table_fraction.calls
    return lambda: sc.skip_table_fraction.calls - start


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_logits_entry_does_no_counting_work(backend, chunked,
                                            skip_table_calls):
    """The serving cache's logits entry (the engine's throughput mode) and
    the training loss compute neither skip fractions nor spike counts; the
    full entry, for contrast, does."""
    cfg, params, x = _setup("snn-mnist", n=4)
    cache = ExecCache(params, cfg, schedule_mode="aprc+cbws"
                      if backend == "hopper" else None,
                      chunk_timesteps=2 if chunked else None, device="cpu")
    loss = make_loss_fn(cfg, spec=TrainSpec(backend=backend))
    census = _Census()
    with census:
        logits = cache.get(4, backend, outputs="logits")(cache.params, x)
        with torch.no_grad():
            loss(params, x, torch.tensor([0, 1, 2, 3]))
    assert logits.shape == (4, 10)
    assert skip_table_calls() == 0 and census.reductions == 0
    full = _Census()
    with full:
        cache.get(4, backend, outputs="full")(cache.params, x)
    assert full.reductions > 0
    assert (skip_table_calls() > 0) == (backend == "hopper")


# -- the batched conv ----------------------------------------------------------

def _im2col_conv(x, w, aprc):
    """The formula ``snn_layers.conv2d`` used for a 0/1 input before: one
    float64 GEMM over the r*r*Cin im2col copy of the padded input, on the
    exact-grid weights."""
    r, _, cin, cout = w.shape
    lo, hi = (r - 1, r - 1) if aprc else ((r - 1) // 2, r - 1 - (r - 1) // 2)
    b_, h, wd = x.shape[0], x.shape[1], x.shape[2]
    e_h, e_w = h + lo + hi - r + 1, wd + lo + hi - r + 1
    xp = F.pad(x.double(), (0, 0, lo, hi, lo, hi))
    taps = [xp[:, dy:dy + e_h, dx:dx + e_w, :]
            for dy in range(r) for dx in range(r)]
    patches = torch.cat(taps, dim=-1).reshape(b_ * e_h * e_w, r * r * cin)
    wq = L.exact_grid(w.reshape(r * r * cin, cout), dim=0)
    return (patches @ wq).to(x.dtype).reshape(b_, e_h, e_w, cout)


# Cin, Cout, R, aprc
CONV_SHAPES = [(1, 8, 3, True), (3, 8, 3, False), (16, 32, 3, True),
               (32, 16, 5, False), (8, 1, 5, True), (32, 32, 3, False),
               (5, 7, 5, True)]


@pytest.mark.parametrize("binary", [None, True])
@pytest.mark.parametrize("cin, cout, r, aprc", CONV_SHAPES)
def test_spike_conv_matches_the_im2col_formula(cin, cout, r, aprc, binary):
    """Bit for bit in the forward; the gradients (dx, dw) to float64
    rounding of the same products, cast to float32."""
    rng = np.random.default_rng(cin * 100 + cout + r)
    x = torch.from_numpy((rng.random((3, 9, 11, cin)) < 0.3)
                         .astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy((rng.standard_normal((r, r, cin, cout)) * 0.3)
                         .astype(np.float32)).requires_grad_(True)
    want = _im2col_conv(x, w, aprc)
    got = L.conv2d(x, w, aprc=aprc, binary=binary)
    assert torch.equal(got, want)
    g = torch.from_numpy(rng.standard_normal(want.shape).astype(np.float32))
    for a, b in zip(torch.autograd.grad((got * g).sum(), (x, w)),
                    torch.autograd.grad((want * g).sum(), (x, w))):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_spike_conv_told_binary_checks_no_values():
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.random((2, 6, 6, 4)) < 0.5).astype(np.float32))
    w = torch.randn((3, 3, 4, 8), generator=torch.Generator().manual_seed(0))
    told, looked = _Census(), _Census()
    with told:
        a = L.conv2d(x, w, aprc=True, binary=True)
    with looked:
        b = L.conv2d(x, w, aprc=True)
    assert told.value_checks == 0 and looked.value_checks == 1
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_batched_forward_checks_values_only_at_the_first_layer(name):
    """The time-batched layers after the first are fed a spike train and
    say so; only the first layer, fed the frames, looks at its input."""
    cfg, params, x = _setup(name, n=2)
    census = _Census()
    with census, torch.no_grad():
        snn_apply(params, x, cfg, backend="batched")
    assert census.value_checks == 1
