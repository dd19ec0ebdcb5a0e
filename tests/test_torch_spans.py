"""The program's stage spans (``repro_torch.obs.spans``): off unless a
``torch.profiler`` session records, and then every stage of
``Session.infer`` and ``Session.train_step`` recorded with its parent, as a
range in the profile and in the totals that ``read_spans`` reads.

The CPU tests run the narrowed networks through the kernels' plain
versions; the one test marked ``cuda`` runs them on the card, where the
counting work and the weight gradient are also timed on the device:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_spans.py
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.api import ServeSpec, Session, TrainSpec
from repro_torch.config import get_snn
from repro_torch.obs import spans

P = obs.spans.PREFIX
NARROW = {
    "snn-mnist": dict(input_hw=(12, 12), conv_channels=(4, 8, 4),
                      timesteps=3),
    "snn-seg": dict(input_hw=(12, 20), conv_channels=(4, 8, 8, 8, 4, 1),
                    timesteps=3),
}
INFER_STAGES = ("infer.stage", "infer.forward", "infer.wait",
                "infer.readback")
TRAIN_STAGES = ("train.stage", "train.forward", "train.backward",
                "train.update", "train.wait")


def _cfg(name):
    return dataclasses.replace(get_snn(name), **NARROW[name])


def _frames(cfg, n=4, seed=0):
    h, w = cfg.input_hw
    return np.random.default_rng(seed).random(
        (n, h, w, cfg.input_channels), dtype=np.float32)


def _serve(name, device="cpu"):
    return Session(_cfg(name), ServeSpec(backend="hopper",
                                         schedule_mode="aprc+cbws"),
                   device=device)


def _train(device="cpu"):
    return Session(_cfg("snn-mnist"), TrainSpec(backend="hopper", lr=1e-2),
                   device=device)


def _traced(fn, *, calls=1, cuda=False):
    """``fn`` called ``calls`` times under a profiler; the profiler's own
    ``repro_torch.*`` range names, the reading, and the last result."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    obs.reset_spans()
    with profile(activities=acts) as prof:
        for _ in range(calls):
            out = fn()
    names = {e.name for e in prof.events() if e.name.startswith(P)}
    return names, obs.read_spans(), out


def _expected_parents(cfg, kind):
    n = len(cfg.conv_channels)
    if kind == "infer":
        want = {s: "infer" for s in INFER_STAGES}
        want.update({f"model.conv{i}": "infer.forward" for i in range(n)})
        want.update({"model.counts": "infer.forward",
                     "model.skip_table": "infer.forward"})
    else:
        want = {s: "train_step" for s in TRAIN_STAGES}
        want.update({f"model.conv{i}": "train.forward" for i in range(n)})
        want["train.wgrad"] = "train.backward"
    want[kind if kind == "infer" else "train_step"] = None
    return {P + k: (P + v if v else None) for k, v in want.items()}


def _check_tree(reading, names, want):
    by_name = {}
    for e in reading.events:
        by_name.setdefault(e.get("name"), set()).add(e.get("parent"))
    assert set(by_name) == set(want), set(by_name) ^ set(want)
    for name, parents in by_name.items():
        assert parents == {want[name]}, (name, parents)
    assert names == set(want)                     # ranges in the profile
    roots = {e.rid for e in reading.events if e.get("parent") is None}
    assert {e.rid for e in reading.events} == roots
    assert reading.dropped == 0


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    entered = []

    def counting(real):
        def enter(name, *a, **kw):
            entered.append(name)
            return real(name, *a, **kw)
        return enter

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting(torch.autograd.profiler.record_function))
    monkeypatch.setattr(spans, "RANGE", counting(spans.RANGE))
    assert not obs.tracing()
    assert obs.span("a") is obs.span("b", root=True)    # one shared null
    obs.reset_spans()
    sess = _serve("snn-mnist")
    x = _frames(sess.cfg)
    untraced = sess.infer(x)
    _train().train_step(x, np.arange(4))
    got = obs.read_spans()
    assert got.totals == {} and got.events == [] and entered == []
    _, _, traced = _traced(lambda: sess.infer(x))
    assert entered                                       # on, it does enter
    for a, b in zip(untraced, traced):
        for u, t in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(u, t)


@pytest.mark.parametrize("name", ["snn-mnist", "snn-seg"])
def test_traced_infer_records_every_span_with_its_parent(name):
    sess = _serve(name)
    x = _frames(sess.cfg)
    sess.infer(x)                            # builds the engine: untraced
    names, reading, _ = _traced(lambda: sess.infer(x), calls=3)
    _check_tree(reading, names, _expected_parents(sess.cfg, "infer"))
    tot = reading.totals
    assert tot[P + "infer"].count == 3
    staged = sum(tot[P + s].host_ms for s in INFER_STAGES)
    assert staged >= 0.9 * tot[P + "infer"].host_ms
    assert all(t.device_ms is None for t in tot.values())
    assert reading.per_call(P + "infer", P + "model.counts",
                            device=True) is None
    assert reading.per_call(P + "infer", P + "infer.stage") > 0


@pytest.mark.parametrize("name", ["snn-mnist", "snn-seg"])
def test_schedule_is_laid_out_once_a_params_version(name):
    """A scheduled session lays its kernel schedule out
    (``model.schedule``) once when its engine takes the params, once when
    an engine's params are updated, and in no call."""
    sess = _serve(name)
    x = _frames(sess.cfg)
    _, reading, _ = _traced(lambda: sess.infer(x))     # builds the engine
    assert reading.totals[P + "model.schedule"].count == 1
    _, reading, _ = _traced(lambda: sess.infer(x), calls=3)
    assert reading.totals[P + "infer"].count == 3
    assert P + "model.schedule" not in reading.totals
    eng = sess.engine()
    half = {k: [{n: t * 0.5 for n, t in layer.items()} for layer in v]
            for k, v in sess.params.items()}
    _, reading, _ = _traced(lambda: eng.update_params(half))
    assert reading.totals[P + "model.schedule"].count == 1


def test_traced_train_step_records_every_span_with_its_parent():
    sess = _train()
    x, y = _frames(sess.cfg), np.arange(4)
    sess.train_step(x, y)                    # builds the step: untraced
    names, reading, loss = _traced(lambda: sess.train_step(x, y), calls=3)
    assert np.isfinite(loss)
    _check_tree(reading, names, _expected_parents(sess.cfg, "train"))
    tot = reading.totals
    assert tot[P + "train_step"].count == 3
    assert tot[P + "train.wgrad"].count == 3 * len(sess.cfg.conv_channels)
    staged = sum(tot[P + s].host_ms for s in TRAIN_STAGES)
    assert staged >= 0.9 * tot[P + "train_step"].host_ms
    # the weight gradient runs inside the backward: its host time is part
    # of the backward's, not of its self time
    back = tot[P + "train.backward"]
    assert back.self_ms == pytest.approx(
        back.host_ms - tot[P + "train.wgrad"].host_ms, abs=1e-6)
    assert all(t.device_ms is None for t in tot.values())


def test_a_span_on_another_thread_takes_the_roots_innermost_span():
    seen = []

    def other():
        with obs.span("other"):
            seen.append(threading.get_ident())

    def call():
        with obs.span("outer", root=True):
            with obs.span("inner"):
                t = threading.Thread(target=other)
                t.start()
                t.join(timeout=10)
                assert not t.is_alive()

    _, reading, _ = _traced(call)
    ev = {e.get("name"): e for e in reading.events}
    assert ev[P + "other"].get("parent") == P + "inner"
    assert ev[P + "other"].get("thread") == seen[0]
    assert ev[P + "other"].rid == ev[P + "outer"].rid
    assert ev[P + "outer"].get("parent") is None
    tot = reading.totals
    assert tot[P + "inner"].self_ms <= tot[P + "inner"].host_ms
    _, reading, _ = _traced(other)           # no root open: no parent
    (e,) = reading.events
    assert e.get("parent") is None and e.rid is None


def test_totals_do_not_depend_on_the_ring():
    book = spans.SpanBook(capacity=4)
    for i in range(10):
        with book.span(P + "step", root=True):
            pass
    got = book.read()
    assert got.totals[P + "step"].count == 10
    assert len(got.events) == 4 and got.dropped == 6
    assert [e.rid for e in got.events] == [7, 8, 9, 10]
    book.reset()
    assert book.read().totals == {}


def test_per_call_divides_by_the_root_and_wants_every_device_time():
    tot = {P + "r": spans.SpanTotal(4, 40.0, 1.0, None),
           P + "a": spans.SpanTotal(8, 8.0, 8.0, 2.0),
           P + "b": spans.SpanTotal(4, 4.0, 4.0, None)}
    r = spans.SpanReading(tot, [], 0)
    assert r.per_call(P + "r", P + "a", P + "b") == pytest.approx(3.0)
    assert r.per_call(P + "r", P + "a", device=True) == pytest.approx(0.5)
    assert r.per_call(P + "r", P + "a", P + "b", device=True) is None
    assert r.per_call(P + "r", P + "missing") is None
    assert r.per_call(P + "missing", P + "a") is None


@pytest.mark.cuda
def test_on_the_card_counts_and_wgrad_are_device_timed():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the sm_90a kernels need an NVIDIA card of compute "
                    "capability 9.0 or newer")
    dev = torch.device("cuda")
    sess = _serve("snn-mnist", dev)
    x = _frames(sess.cfg, n=8)
    untraced = sess.infer(x)
    names, reading, traced = _traced(lambda: sess.infer(x), calls=3,
                                     cuda=True)
    np.testing.assert_array_equal(untraced.logits, traced.logits)
    _check_tree(reading, names, _expected_parents(sess.cfg, "infer"))
    assert reading.per_call(P + "infer", P + "model.counts",
                            P + "model.skip_table", device=True) > 0
    tr = _train(dev)
    y = np.arange(8) % 10
    tr.train_step(x, y)
    names, reading, _ = _traced(lambda: tr.train_step(x, y), calls=3,
                                cuda=True)
    # autograd runs the backward on a thread of its own on the card: the
    # weight gradient still names the backward as its parent
    _check_tree(reading, names, _expected_parents(tr.cfg, "train"))
    assert reading.per_call(P + "train_step", P + "train.wgrad",
                            device=True) > 0
