"""``skybench/work.py`` on hand-made trains whose work is known."""
import pytest
import torch

from skybench import work
from skybench.reference import snn as ref

MODEL = dict(input_hw=[2, 2], input_channels=1, conv_channels=[2],
             kernel_size=3, dense_units=[3], timesteps=2, v_threshold=1.0,
             aprc=True)


def test_taps_of_one_spike():
    x = torch.zeros(1, 2, 2, 1)
    x[0, 0, 0, 0] = 1.0
    assert ref._taps(x, 3, aprc=True) == 9.0       # full pads: every tap
    assert ref._taps(x, 3, aprc=False) == 4.0      # SAME: a corner's four


def test_taps_count_nonzeros_not_values():
    x = torch.zeros(2, 5, 4, 3)
    x[0, 1, 1, 0] = 0.25                           # faint analog input
    x[1, 4, 3, 2] = 1.0
    x[1, 4, 3, 1] = 1.0
    assert ref._taps(x, 3, aprc=True) == 27.0


@pytest.mark.parametrize("aprc", [True, False])
def test_taps_against_brute_force(aprc):
    gen = torch.Generator().manual_seed(3)
    x = (torch.rand(3, 6, 7, 2, generator=gen) < 0.3).float()
    r = 3
    lo, hi = (2, 2) if aprc else (1, 1)
    e_h, e_w = 6 + lo + hi - r + 1, 7 + lo + hi - r + 1
    want = 0
    for n in range(3):
        for y in range(6):
            for xx in range(7):
                for c in range(2):
                    if x[n, y, xx, c] == 0:
                        continue
                    for dy in range(r):
                        for dx in range(r):
                            oy, ox = y + lo - dy, xx + lo - dx
                            want += 0 <= oy < e_h and 0 <= ox < e_w
    assert ref._taps(x, r, aprc) == want


def test_infer_work_of_one_frame():
    layers = work.infer_work(MODEL, taps=[9.0], frames=1, calls=1)
    conv, dense, counts = layers
    # 2 per landed tap per output channel, 4 per membrane update
    assert conv.flops == 2 * 9 * 2 + 4 * (2 * 4 * 4 * 2)
    # the frame in float32, the train out at a bit a spike, the weights
    assert conv.bytes == 4 * 4 + (2 * 4 * 4 * 2) / 8 + 4 * (9 * 2 + 2)
    assert dense.flops == 2 * 2 * 32 * 3
    assert dense.bytes == 2 * 32 / 8 + 4 * 3 + 4 * 33 * 3
    assert counts.flops == 0 and counts.bytes == 4 * 2 * 2


def test_work_scales_with_frames_and_calls():
    one = work.total(work.infer_work(MODEL, [9.0], 1, 1))
    many = work.total(work.infer_work(MODEL, [9.0], 10, 1))
    assert many.flops == 10 * one.flops
    per_call = 4 * (9 * 2 + 2) + 4 * 33 * 3 + 4 * 2 * 2
    assert many.bytes == 10 * (one.bytes - per_call) + per_call


def test_train_work_adds_the_backward_and_the_update():
    fwd = work.total(work.infer_work(MODEL, [9.0], 4, 1))
    train = work.train_work(MODEL, [9.0], frames=4, steps=1)
    n_params = 9 * 2 + 2 + 33 * 3
    assert train[-1].name == "sgd" and train[-1].flops == 4 * n_params
    # the first layer has no input gradient: dW (as its forward conv) and
    # the LIF backward only
    assert train[0].flops - work.infer_work(MODEL, [9.0], 4, 1)[0].flops \
        == 4 * (2 * 9 * 2 + 8 * 2 * 16 * 2)
    assert work.total(train).flops > fwd.flops


def test_least_seconds_takes_the_slower_bound_layer_by_layer():
    layers = [work.LayerWork("a", work.PEAK_FLOPS, 0.0),
              work.LayerWork("b", 0.0, 2 * work.PEAK_BYTES)]
    assert work.least_seconds(layers) == pytest.approx(3.0)
