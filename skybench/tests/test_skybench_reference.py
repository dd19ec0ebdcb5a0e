"""The frozen reference computes the port's network: at batch 2 on the CPU
against ``snn_apply(backend="batched")`` and the port's train step, on the
same weights.  The reference never imports the port; this test holds the
two side by side."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import TrainSpec
from repro_torch.config import get_snn
from repro_torch.core.snn_model import snn_apply
from repro_torch.core.snn_train import make_train_step

from skybench import harness
from skybench.data.weights import make_weights
from skybench.inputs import draw_frames
from skybench.reference import snn as ref

SEG_NARROW = dict(input_hw=[16, 24], conv_channels=[8, 16, 32, 32, 16, 1],
                  timesteps=4)


def _setup(name, narrow=None):
    conf = harness.load_config(name)
    model = {**conf["model"], **(narrow or {})}
    cfg = get_snn(conf["snn_config"])
    if narrow:
        cfg = dataclasses.replace(
            cfg, input_hw=tuple(model["input_hw"]),
            conv_channels=tuple(model["conv_channels"]),
            timesteps=model["timesteps"])
    params = make_weights(model, 1.0, 11, torch.device("cpu"))
    return model, cfg, params


# frames on which no membrane lands within rounding of the threshold: a
# first-layer neuron there can fire on one side alone (the port sums its
# analog taps in another order than cuDNN), and its flip spreads; the seg
# frames of seed 5 hold one such neuron
@pytest.mark.parametrize("name,narrow,kind,seed", [
    ("snn-mnist", None, "digits", 5), ("snn-mnist", None, "uniform", 5),
    ("snn-seg", SEG_NARROW, "road", 6)])
def test_forward_matches_the_port(name, narrow, kind, seed):
    model, cfg, params = _setup(name, narrow)
    x, _ = draw_frames(kind, 2, model, seed=seed)
    x = torch.as_tensor(x)
    with torch.no_grad():
        port = snn_apply(params, x, cfg, backend="batched")
        mine = ref.forward(model, params, x)
    np.testing.assert_allclose(mine.logits.numpy(), port.logits.numpy(),
                               rtol=1e-5, atol=1e-5)
    for c, pc in zip(mine.counts, port.timestep_counts):
        np.testing.assert_array_equal(c.numpy(), pc.numpy())


def test_blocks_sum_to_the_whole():
    model, _, params = _setup("snn-mnist")
    x = torch.as_tensor(draw_frames("digits", 5, model, seed=2)[0])
    whole = ref.forward_blocks(model, params, x, block=5)
    parts = ref.forward_blocks(model, params, x, block=2)
    np.testing.assert_allclose(parts.logits, whole.logits, rtol=1e-6,
                               atol=1e-6)
    for a, b in zip(parts.counts, whole.counts):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert parts.taps == whole.taps


def test_train_steps_match_the_port():
    model, cfg, params = _setup("snn-mnist")
    x, y = draw_frames("digits", 6, model, seed=9)
    batches = [(torch.as_tensor(x[i:i + 2]), torch.as_tensor(y[i:i + 2]))
               for i in range(0, 6, 2)]
    rec = ref.train_steps(model, params, batches, lr=1e-2, momentum=0.9)
    step = make_train_step(cfg, spec=TrainSpec(backend="batched", lr=1e-2,
                                               momentum=0.9))
    p = params
    mom = {g: [{k: torch.zeros_like(t) for k, t in q.items()}
               for q in params[g]] for g in ("conv", "dense")}
    losses = []
    for i, (xb, yb) in enumerate(batches):
        p, mom, loss = step(p, mom, xb, yb)
        losses.append(float(loss))
        if i == 0:
            first = mom
    np.testing.assert_allclose(rec.losses, losses, rtol=1e-5)
    for g in ("conv", "dense"):
        for a, b in zip(rec.first_grad[g], first[g]):
            for k in ("w", "b"):
                np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                           rtol=1e-4, atol=1e-6)
        for a, b in zip(rec.params[g], p[g]):
            for k in ("w", "b"):
                np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                           rtol=1e-5, atol=1e-7)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -12), 0.0])
    got = ref.round_tf32(x)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -9, -1.0, 0.0])
    assert torch.equal(got, want)


def test_weights_follow_the_seed():
    model = harness.load_config("snn-mnist")["model"]
    a = make_weights(model, 1.0, 2**31 + 5, torch.device("cpu"))
    b = make_weights(model, 1.0, 2**31 + 5, torch.device("cpu"))
    c = make_weights(model, 1.0, 2**31 + 6, torch.device("cpu"))
    assert torch.equal(a["conv"][1]["w"], b["conv"][1]["w"])
    assert not torch.equal(a["conv"][1]["w"], c["conv"][1]["w"])
    # the per-channel skew spreads the channels' filter norms
    norms = a["conv"][1]["w"].flatten(0, 2).norm(dim=0)
    assert float(norms.max() / norms.min()) > 3.0
