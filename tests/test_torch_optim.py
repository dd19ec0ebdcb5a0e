"""The port's optimizer (``repro_torch.optim``) against the JAX reference,
on the CPU.

Inputs come from a numpy seed and go through both packages.  The
schedules equal the reference's bits at every step where XLA's float32
cosine and torch's round alike; where those differ (by 1 ulp, at a few
steps of the decay), the schedule agrees within 2 ulp beyond that
difference carried through (peak_lr x (1 - floor) / 2 x |dcos|): near the
end of the decay 1 + cos cancels, so one ulp of the cosine is several
of the result (measured: up to 1.72 ulp beyond it).
``adam.update`` (in place in the port) equals the reference's eager
``update`` bit for bit: params, m, v and the step.  ``global_norm``
agrees within 2 float32 ulp (the two packages sum each leaf's squares in
another order; measured: 1 ulp here), and so does
``clip_by_global_norm``'s scale; its grads are the grads times that
scale bit for bit, so within 3 ulp of the reference's (the scale's 2 and
the product's rounding; measured: 3).  Compression is exact: ``torch.round``
rounds half to even as ``jnp.round`` does.  The reference's own cases of
``tests/test_optim.py`` follow, on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
# shim: skips only the @given tests when hypothesis is absent
from _hypothesis_compat import given, settings, st

from repro.optim import adam as jx_adam
from repro.optim import compression as jx_comp
from repro.optim import schedules as jx_sched
from repro_torch.optim import adam, schedules
from repro_torch.optim.compression import (EFState, compress,
                                           compress_with_error_feedback,
                                           decompress, ef_init)

SHAPES = {"a": (300, 70), "b": (1000,), "c": (5, 7, 11), "d": ()}


def ulps(got, want) -> int:
    """The largest distance in float32 ulps between two arrays."""
    g = np.asarray(got, np.float32).reshape(-1).view(np.int32)
    w = np.asarray(want, np.float32).reshape(-1).view(np.int32)
    return int(np.abs(g.astype(np.int64) - w.astype(np.int64)).max())


def tree(seed, scale=1.0, positive=False):
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in SHAPES.items():
        a = rng.random(s) if positive else rng.standard_normal(s)
        # magnitudes over seven decades, as a model's grads have
        out[k] = np.asarray(a * scale * 10.0 ** rng.uniform(-6, 1, s),
                            np.float32)
    return out


def to_t(t):
    return {k: torch.from_numpy(np.array(v)) for k, v in t.items()}


def to_j(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


@pytest.mark.parametrize("kw", [dict(peak_lr=3e-4, warmup=100, total=1000),
                                dict(peak_lr=1e-3, warmup=10, total=100),
                                dict(peak_lr=3e-4, warmup=0, total=50,
                                     floor=0.0)])
def test_linear_warmup_cosine_at_every_step(kw):
    steps = np.arange(kw["total"] + 1, dtype=np.int32)
    got = schedules.linear_warmup_cosine(torch.from_numpy(steps), **kw)
    want = jx_sched.linear_warmup_cosine(jnp.asarray(steps), **kw)
    assert got.dtype == torch.float32 and got.shape == steps.shape
    # the cosine's argument, as both compute it, and the two cosines
    warmup, total = kw["warmup"], kw["total"]
    frac = np.clip((steps.astype(np.float32) - np.float32(warmup))
                   / np.float32(max(1, total - warmup)), 0, 1)
    arg = (np.float32(np.pi) * frac.astype(np.float32)).astype(np.float32)
    dcos = np.abs(np.asarray(jnp.cos(jnp.asarray(arg)), np.float64)
                  - torch.cos(torch.from_numpy(arg)).double().numpy())
    got, want = got.numpy(), np.asarray(want)
    same = dcos == 0
    assert np.array_equal(got[same], want[same])
    err = np.abs(got.astype(np.float64) - want)
    carried = kw["peak_lr"] * (1 - kw.get("floor", 0.1)) / 2 * dcos
    ulp = np.spacing(np.abs(want)).astype(np.float64)
    assert (err <= carried + 2 * ulp).all()
    one = schedules.linear_warmup_cosine(torch.tensor(7), **kw)
    assert one.shape == () and one.dtype == torch.float32


def test_constant_schedule():
    got = schedules.constant(torch.tensor(5), peak_lr=3e-4, warmup=9)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == float(jx_sched.constant(jnp.asarray(5),
                                                 peak_lr=3e-4))


@pytest.mark.parametrize("step", [0, 1, 9, 123])
@pytest.mark.parametrize("lr_kind", ["float", "tensor"])
def test_adam_update_bit_for_bit_and_in_place(step, lr_kind):
    p, g = tree(0), tree(1)
    m, v = tree(2, 0.01), tree(3, 0.001, positive=True)
    lr = 3e-4 * (step + 1) / 100
    jlr = jnp.float32(lr) if lr_kind == "tensor" else lr
    tlr = torch.tensor(lr, dtype=torch.float32) if lr_kind == "tensor" \
        else lr
    jp, jo = jx_adam.update(to_j(g), jx_adam.AdamState(
        jnp.asarray(step, jnp.int32), to_j(m), to_j(v)), to_j(p), lr=jlr)
    tp = to_t(p)
    st = adam.AdamState(torch.tensor(step, dtype=torch.int32), to_t(m),
                        to_t(v))
    ids = {k: t.data_ptr() for k, t in tp.items()}
    outp, outs = adam.update(to_t(g), st, tp, lr=tlr)
    # in place: the same objects and storage come back
    assert outp is tp and outs is st
    assert {k: t.data_ptr() for k, t in tp.items()} == ids
    assert int(st.step) == int(jo.step) == step + 1
    for k in SHAPES:
        for got, want in ((tp[k], jp[k]), (st.m[k], jo.m[k]),
                          (st.v[k], jo.v[k])):
            assert np.array_equal(got.numpy(), np.asarray(want)), k


@pytest.mark.parametrize("lr_kind", ["float", "tensor"])
def test_adam_update_bfloat16_params_float32_moments(lr_kind):
    """Params in bfloat16, moments in float32: the reference's casts (a
    Python lr is rounded to bfloat16, a float32 one promotes the update
    to float32)."""
    p, g = tree(4), tree(5)
    jp0 = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    jst = jx_adam.init(jp0)
    lr = 1e-2 if lr_kind == "float" else jnp.float32(1e-2)
    jp, jo = jx_adam.update({k: jnp.asarray(v, jnp.bfloat16)
                             for k, v in g.items()}, jst, jp0, lr=lr)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    st = adam.init(tp)
    assert all(t.dtype == torch.float32 for t in st.m.values())
    adam.update({k: torch.from_numpy(v).to(torch.bfloat16)
                 for k, v in g.items()}, st, tp,
                lr=1e-2 if lr_kind == "float" else torch.tensor(1e-2))
    for k in SHAPES:
        assert np.array_equal(tp[k].float().numpy(),
                              np.asarray(jp[k], np.float32)), k
        assert np.array_equal(st.m[k].numpy(), np.asarray(jo.m[k])), k
        assert np.array_equal(st.v[k].numpy(), np.asarray(jo.v[k])), k


def test_adam_update_in_groups_equals_one_group(monkeypatch):
    """The grouping of leaves (``GROUP_NUMEL``) changes no bit."""
    outs = []
    for numel in (adam.GROUP_NUMEL, 1000):
        monkeypatch.setattr(adam, "GROUP_NUMEL", numel)
        tp = to_t(tree(6))
        st = adam.init(tp)
        for i in range(3):
            adam.update(to_t(tree(7 + i)), st, tp, lr=1e-3)
        outs.append((tp, st))
    (p1, s1), (p2, s2) = outs
    for k in SHAPES:
        assert torch.equal(p1[k], p2[k]) and torch.equal(s1.m[k], s2.m[k])
        assert torch.equal(s1.v[k], s2.v[k])


def test_adam_init_on_a_module_keys_by_parameter_name():
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    st = adam.init(model, torch.float32)
    assert list(st.m) == [n for n, _ in model.named_parameters()]
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    assert all(float(t.abs().sum()) == 0 for t in st.v.values())
    with pytest.raises(ValueError, match="differ in their leaves"):
        adam.update({"0.weight": torch.zeros(4, 3)}, st, model, lr=1e-3)


def test_global_norm_and_clip_within_two_ulp():
    g = tree(8)
    want = jx_adam.global_norm(to_j(g))
    got = adam.global_norm(to_t(g))
    assert got.shape == () and got.dtype == torch.float32
    assert ulps(got.numpy(), want) <= 2
    for max_norm in (1.0, 1e6):
        jc, jn = jx_adam.clip_by_global_norm(to_j(g), max_norm)
        tg = to_t(g)
        out, tn = adam.clip_by_global_norm(tg, max_norm)
        assert out is tg
        assert ulps(tn.numpy(), jn) <= 2
        scale = np.minimum(np.float32(1.0), np.float32(max_norm)
                           / (tn.numpy() + np.float32(1e-9)))
        jscale = np.minimum(np.float32(1.0), np.float32(max_norm)
                            / (np.asarray(jn) + np.float32(1e-9)))
        assert ulps(scale, jscale) <= 2
        for k in SHAPES:
            assert np.array_equal(tg[k].numpy(), g[k] * scale), k
            assert ulps(tg[k].numpy(), jc[k]) <= 3, k
            if max_norm > float(jn):
                assert np.array_equal(tg[k].numpy(), g[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_exact(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((257,)) * 10.0).astype(np.float32)
    # values on the half-way points of the grid: round half to even
    x[:8] = np.float32(np.abs(x).max()) / 127.0 * np.array(
        [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5], np.float32)
    q, s = compress(torch.from_numpy(x))
    jq, js = jx_comp.compress(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    assert np.array_equal(decompress(q, s).numpy(),
                          np.asarray(jx_comp.decompress(jq, js)))
    assert decompress(q, s, torch.bfloat16).dtype == torch.bfloat16
    zq, zs = compress(torch.zeros(4))
    assert float(zs) == float(jx_comp.compress(jnp.zeros(4))[1])
    assert int(zq.abs().sum()) == 0


def test_compress_with_error_feedback_exact():
    rng = np.random.default_rng(3)
    grads = [{"g": rng.standard_normal((32,)).astype(np.float32),
              "h": [rng.standard_normal((3, 5)).astype(np.float32)]}
             for _ in range(4)]
    jef = jx_comp.ef_init(jax.tree.map(jnp.asarray, grads[0]))
    tef = ef_init({"g": torch.zeros(32), "h": [torch.zeros(3, 5)]})
    assert isinstance(tef, EFState)
    for g in grads:
        jq, jef = jx_comp.compress_with_error_feedback(
            jax.tree.map(jnp.asarray, g), jef)
        tq, tef = compress_with_error_feedback(
            {"g": torch.from_numpy(g["g"]),
             "h": [torch.from_numpy(g["h"][0])]}, tef)
        for (q, s), (jqq, js) in ((tq["g"], jq["g"]),
                                  (tq["h"][0], jq["h"][0])):
            assert np.array_equal(q.numpy(), np.asarray(jqq))
            assert float(s) == float(js)
        assert np.array_equal(tef.residual["g"].numpy(),
                              np.asarray(jef.residual["g"]))
        assert np.array_equal(tef.residual["h"][0].numpy(),
                              np.asarray(jef.residual["h"][0]))


# -- the reference's own cases (tests/test_optim.py), on the port --------------

def test_adam_minimizes_quadratic():
    params = {"w": torch.tensor([3.0, -2.0], requires_grad=True)}
    state = adam.init(params)
    target = torch.tensor([1.0, 1.0])
    for _ in range(200):
        loss = torch.sum((params["w"] - target) ** 2)
        grads = {"w": torch.autograd.grad(loss, params["w"])[0]}
        params, state = adam.update(grads, state, params, lr=0.05,
                                    weight_decay=0.0)
    np.testing.assert_allclose(params["w"].detach().numpy(), [1.0, 1.0],
                               atol=1e-2)


def test_clip_by_global_norm():
    grads = {"a": torch.full((10,), 10.0)}
    clipped, norm = adam.clip_by_global_norm(grads, 1.0)
    assert float(norm) > 1.0
    np.testing.assert_allclose(float(adam.global_norm(clipped)), 1.0,
                               rtol=1e-5)


def test_schedule_warmup_then_decay():
    lrs = [float(schedules.linear_warmup_cosine(
        torch.tensor(s), peak_lr=1e-3, warmup=10, total=100))
        for s in range(100)]
    assert lrs[0] < lrs[9] <= 1e-3 + 1e-9
    assert lrs[99] < lrs[50] < lrs[12]


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=50, deadline=None)
def test_compression_error_bounded(seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (64,)).astype(np.float32) * 10.0)
    q, s = compress(x)
    err = (decompress(q, s) - x).abs().numpy()
    assert err.max() <= float(s) * 0.5 + 1e-6   # round-to-nearest bound


@pytest.mark.parametrize("seed", [0, 7])
def test_compression_error_bounded_seeded(seed):
    """``test_compression_error_bounded`` on fixed seeds, which run where
    hypothesis is absent."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (64,)).astype(np.float32) * 10.0)
    q, s = compress(x)
    assert (decompress(q, s) - x).abs().max() <= float(s) * 0.5 + 1e-6


def test_error_feedback_unbiased_over_time():
    """With EF, the accumulated transmitted signal tracks the true sum."""
    rng = np.random.default_rng(0)
    grads_true = [torch.from_numpy(rng.normal(0, 1, 32).astype(np.float32))
                  for _ in range(50)]
    ef = ef_init({"g": grads_true[0]})
    sent_total = np.zeros(32)
    for g in grads_true:
        qtree, ef = compress_with_error_feedback({"g": g}, ef)
        q, s = qtree["g"]
        sent_total += decompress(q, s).numpy()
    true_total = np.sum([g.numpy() for g in grads_true], axis=0)
    resid = ef.residual["g"].numpy()
    np.testing.assert_allclose(sent_total + resid, true_total, atol=1e-3)
