"""The port's scheduling copies (APRC prediction, CBWS, balance, the
channel schedule) against the reference: identical partitions,
permutations and permuted weights on the same inputs."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.config import get_snn
from repro.core import aprc as jx_aprc
from repro.core import balance as jx_balance
from repro.core import cbws as jx_cbws
from repro.core import scheduler as jx_sched
from repro_torch.core import aprc, balance, cbws, scheduler
from repro_torch.interop import from_jax_params, to_numpy_params


def _workloads(seed, k):
    return np.random.default_rng(seed).lognormal(0.0, 1.5, k)


PARTITION_CASES = [(0, 8, 1), (1, 16, 4), (2, 64, 8), (3, 10, 3), (4, 3, 5)]


@pytest.mark.parametrize("seed,k,n", PARTITION_CASES)
@pytest.mark.parametrize("fn", ["cbws_partition", "greedy_lpt_partition"])
def test_partitions_match_reference(fn, seed, k, n):
    w = _workloads(seed, k)
    got = getattr(cbws, fn)(w, n)
    want = getattr(jx_cbws, fn)(w, n)
    assert got.groups == want.groups
    np.testing.assert_array_equal(got.permutation(), want.permutation())
    np.testing.assert_array_equal(cbws.partition_sums(got, w),
                                  jx_cbws.partition_sums(want, w))


@pytest.mark.parametrize("k,n", [(8, 4), (32, 8), (12, 3)])
def test_equal_and_naive_partitions_match_reference(k, n):
    w = _workloads(k, k)
    assert (cbws.cbws_partition_equal(w, n).groups
            == jx_cbws.cbws_partition_equal(w, n).groups)
    assert cbws.naive_partition(k, n).groups == \
        jx_cbws.naive_partition(k, n).groups


def test_balance_metrics_match_reference():
    w = _workloads(7, 32)
    p = cbws.cbws_partition(w, 4)
    assert balance.measure_balance(p, w) == jx_balance.measure_balance(
        jx_cbws.cbws_partition(w, 4), w)
    assert balance.balance_ratio(w) == jx_balance.balance_ratio(w)
    assert balance.throughput_gain(0.9, 0.6) == \
        jx_balance.throughput_gain(0.9, 0.6)


def _tiny_mnist_cfg():
    return dataclasses.replace(
        get_snn("snn-mnist"), input_hw=(8, 8), conv_channels=(8, 8),
        timesteps=3, num_spe_clusters=4)


@pytest.fixture(scope="module")
def mnist_params():
    """Weights of the tiny config in the reference's layout, skewed per
    channel like a trained net's so CBWS has an imbalance to fix."""
    cfg = _tiny_mnist_cfg()
    rng = np.random.default_rng(0)
    conv, cin = [], cfg.input_channels
    for cout in cfg.conv_channels:
        scale = rng.lognormal(0.0, 1.0, cout).astype(np.float32)
        w = rng.standard_normal((3, 3, cin, cout)).astype(np.float32) * scale
        conv.append({"w": w, "b": np.zeros(cout, np.float32)})
        cin = cout
    din = 10 * 10 * cin
    dense = [{"w": rng.standard_normal((din, 10)).astype(np.float32),
              "b": np.zeros(10, np.float32)}]
    np_params = {"conv": conv, "dense": dense}
    return cfg, np_params, from_jax_params(np_params, device="cpu")


def test_magnitudes_match_reference(mnist_params):
    _, np_params, params = mnist_params
    for mode in ("sum", "abs"):
        for a, b in zip(aprc.layer_magnitudes(params, mode),
                        jx_aprc.layer_magnitudes(np_params, mode)):
            np.testing.assert_array_equal(a, b)
    for layer in range(len(params["conv"])):
        np.testing.assert_array_equal(
            aprc.predicted_input_workloads(params, layer),
            jx_aprc.predicted_input_workloads(np_params, layer))
    m, s = _workloads(1, 16), _workloads(2, 16)
    assert aprc.proportionality(m, s) == jx_aprc.proportionality(m, s)


@pytest.mark.parametrize("mode", ["none", "cbws", "aprc+cbws"])
def test_build_schedule_and_permutation_match_reference(mnist_params, mode):
    cfg, np_params, params = mnist_params
    got = scheduler.build_schedule(params, cfg, mode)
    want = jx_sched.build_schedule(np_params, cfg, mode)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.out_partition.groups == w.out_partition.groups
        assert g.in_partition.groups == w.in_partition.groups
        np.testing.assert_array_equal(g.out_perm, w.out_perm)
        np.testing.assert_array_equal(g.in_perm, w.in_perm)
    permuted = to_numpy_params(scheduler.permute_conv_params(params, got))
    ref = jx_sched.permute_conv_params(np_params, want)
    for kind in ("conv", "dense"):
        for a, b in zip(permuted[kind], ref[kind]):
            np.testing.assert_array_equal(a["w"], b["w"])
            np.testing.assert_array_equal(a["b"], b["b"])


def test_unknown_schedule_mode_raises(mnist_params):
    cfg, _, params = mnist_params
    with pytest.raises(ValueError, match="aprc\\+cbws"):
        scheduler.build_schedule(params, cfg, "fpga")


def test_permutation_leaves_tensors_on_their_device(mnist_params):
    cfg, _, params = mnist_params
    permuted = scheduler.permute_conv_params(
        params, scheduler.build_schedule(params, cfg))
    assert all(isinstance(p["w"], torch.Tensor) and p["w"].device.type == "cpu"
               for p in permuted["conv"] + permuted["dense"])
