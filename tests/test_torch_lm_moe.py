"""The port's routed MoE (``repro_torch.models.layers.moe``) against the
reference's local path, on the CPU.

Reduced deepseek-moe-16b widths (8 experts, top-2, experts 32 wide, one
shared expert, capacity factor 1.25), weights from the reference's
``moe.init``, inputs from numpy seeds.  Routing is discrete, so it is
compared exactly: ``top_idx``, each choice's position in its expert and the
``keep`` mask; every such assert prints the smallest margin between the
k-th and (k+1)-th gate, where a near-tie would show.  Outputs agree to
``TOL`` x max(1, max|ref|), the aux loss to 1e-6 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (AUX_RTOL, TOL, aux_sums_match, cfgs, close,
                        load_leaves, quiet_logging, t)
from _rendezvous import moe_route_check, run_ranks
from repro.config import get_arch as jx_get_arch
from repro.models.layers import moe as jx_moe
from repro_torch.config import get_arch, reduced
from repro_torch.launch import serve as serve_launcher
from repro_torch.models.layers import moe
from repro_torch.sharding import ShardingCtx, use_sharding


def _cfgs(num_shared=1):
    jcfg, cfg = cfgs("deepseek-moe-16b")
    return tuple(dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, num_shared=num_shared)) for c in (jcfg, cfg))


def _layer(jcfg, cfg, seed=0):
    jp = jax.tree.map(np.asarray, jx_moe.init(jax.random.PRNGKey(seed),
                                              jcfg))
    return jp, load_leaves(moe.MoE(cfg, device="meta").to_empty(
        device="cpu"), jp)


def _tokens(d, shape, seed, skew):
    """Hidden states with a shared direction of size ``skew``, which tilts
    the router towards some experts, as real activations do."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (d,)).astype(np.float32)
    return x + np.float32(skew) * rng.standard_normal(d).astype(np.float32)


def _margin(jp, x2d, k):
    """The smallest gap between the k-th and (k+1)-th gate of any token
    (float64 gates)."""
    logits = x2d.astype(np.float64) @ jp["router"].astype(np.float64)
    gates = np.exp(logits - logits.max(-1, keepdims=True))
    top = -np.sort(-gates / gates.sum(-1, keepdims=True), axis=-1)
    return float((top[:, k - 1] - top[:, k]).min())


def _routes_equal(jp, tp, x2d, m, capacity):
    """Exact routing against the reference; returns the port's keep."""
    margin = _margin(jp, x2d, m.top_k)
    jv, ji, jaux = jx_moe._route(jnp.asarray(jp["router"]), jnp.asarray(x2d),
                                 m)
    jpos = np.asarray(jx_moe._positions_in_expert(ji, m.num_experts))
    with torch.no_grad():
        tv, ti, pos, keep, aux = moe.route(tp, t(x2d), m, capacity)
    assert np.array_equal(ti.numpy(), np.asarray(ji)), \
        f"top_idx differs; smallest k-th gate margin {margin:.3e}"
    assert np.array_equal(pos.numpy(), jpos), \
        f"positions differ; smallest k-th gate margin {margin:.3e}"
    assert np.array_equal(keep.numpy(), jpos < capacity), \
        f"keep differs; smallest k-th gate margin {margin:.3e}"
    close(tv, jv)
    assert abs(float(aux) - float(jaux)) <= AUX_RTOL * abs(float(jaux))
    return keep


@pytest.mark.parametrize("tokens,skew", [(8, 0.0), (80, 0.0), (80, 3.0),
                                         (600, 3.0)])
def test_routing_is_exact(tokens, skew):
    jcfg, cfg = _cfgs()
    jp, tp = _layer(jcfg, cfg)
    x2d = _tokens(cfg.d_model, (tokens,), 1, skew)
    cap = moe.capacity_for(cfg.moe, tokens)
    assert cap == jx_moe.capacity_for(jcfg.moe, tokens)
    keep = _routes_equal(jp, tp, x2d, cfg.moe, cap)
    if skew:
        assert not keep.all(), "a tilted router at capacity 1.25 drops"


def test_positions_in_expert_are_exact():
    """Any (T, k) choice table, repeats across tokens included."""
    rng = np.random.default_rng(2)
    for shape, E in (((1, 1), 4), ((37, 2), 8), ((300, 6), 64),
                     ((64, 8), 256)):
        idx = rng.integers(0, E, shape, dtype=np.int32)
        want = np.asarray(jx_moe._positions_in_expert(jnp.asarray(idx), E))
        got = moe._positions_in_expert(t(idx).long())
        assert np.array_equal(got.numpy(), want)


def test_capacity_rounding_is_exact():
    """The reference's int() and round-up to 8, for the reduced and the
    published expert counts, across token counts and capacity factors."""
    for arch in ("deepseek-moe-16b", "deepseek-v3-671b"):
        for jcfg, cfg in (cfgs(arch), (jx_get_arch(arch), get_arch(arch))):
            m = cfg.moe
            for cf in (1.0, 1.25, 2 * m.num_experts / m.top_k, 1000.0):
                jm = dataclasses.replace(jcfg.moe, capacity_factor=cf)
                tm = dataclasses.replace(m, capacity_factor=cf)
                for n in list(range(1, 300)) + [2048, 8192, 65536]:
                    assert moe.capacity_for(tm, n) == \
                        jx_moe.capacity_for(jm, n), (arch, cf, n)


@pytest.mark.parametrize("num_shared,shape,skew", [
    (1, (2, 40), 0.0),
    (0, (2, 40), 0.0),
    (1, (2, 150), 3.0),       # drops tokens
    (0, (3, 1), 0.0),         # a decode step's batch
])
def test_apply_local_matches_reference(num_shared, shape, skew):
    jcfg, cfg = _cfgs(num_shared)
    jp, tp = _layer(jcfg, cfg, seed=num_shared)
    assert ("shared" in tp) == bool(num_shared)
    x = _tokens(cfg.d_model, shape, 3, skew)
    x2d = x.reshape(-1, cfg.d_model)
    keep = _routes_equal(jp, tp, x2d, cfg.moe,
                         moe.capacity_for(cfg.moe, x2d.shape[0]))
    if skew:
        assert not keep.all(), "this case is to drop tokens"
    want, jaux = jx_moe.apply_local(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got, aux = moe.apply(tp, t(x), cfg)
        got2, _ = tp(t(x))
    assert got.shape == x.shape
    close(got, want, TOL)
    assert abs(float(aux) - float(jaux)) <= AUX_RTOL * abs(float(jaux))
    assert torch.equal(got, got2)


def test_apply_local_in_bfloat16():
    """bfloat16 activations: the router stays float32, the experts run in
    bfloat16, as in the reference; within two bfloat16 ulps."""
    jcfg, cfg = _cfgs()
    jp, tp = _layer(jcfg, cfg)
    x = _tokens(cfg.d_model, (2, 16), 4, 0.0)
    want, _ = jx_moe.apply_local(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    got, _ = moe.apply(tp, t(x).to(torch.bfloat16), cfg)
    assert got.dtype == torch.bfloat16
    close(got.float(), np.asarray(want, np.float32), 2 * 2 ** -8)


def test_forward_sums_the_aux_losses():
    aux_sums_match("deepseek-moe-16b")


def test_apply_raises_under_a_sharding_context():
    """Under a ``ShardingCtx`` on a torch mesh (two gloo processes, data 1
    x model 2, ``tp_fsdp``) ``apply`` takes the sharded route
    (``_apply_sharded``; ``test_torch_sharded.py`` holds both routes to
    the reference's) and, at a capacity where nothing drops, computes
    ``apply_local``'s function; on a mesh description it has no
    placements and raises."""
    jcfg, cfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=8.0))
    jp = jax.tree.map(np.asarray, jx_moe.init(jax.random.PRNGKey(1), jcfg))
    x = _tokens(cfg.d_model, (2, 8), 2, 0.0)
    calls, got = run_ranks(moe_route_check, _flat(jp), x, n=2)
    assert calls == ["_apply_sharded"]
    want, _ = jx_moe.apply_local(jax.tree.map(jnp.asarray, jp),
                                 jnp.asarray(x), jcfg)
    close(got, np.asarray(want))
    _, tp = _layer(*_cfgs())
    with use_sharding(ShardingCtx((("data", 1), ("model", 1)))):
        with pytest.raises(TypeError, match="DTensors"):
            moe.apply(tp, t(x), cfg)
    moe.apply(tp, t(x), cfg)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_recorded_routes_give_each_calls_routing():
    """``recorded_routes``: the routing of every MoE call in the block, the
    reference's, with its drops and the k-th gate margin; no hook after."""
    jcfg, cfg = _cfgs()
    jp, tp = _layer(jcfg, cfg)
    x = _tokens(cfg.d_model, (2, 150), 3, 3.0)
    x2d = x.reshape(-1, cfg.d_model)
    _, ji, _ = jx_moe._route(jnp.asarray(jp["router"]), jnp.asarray(x2d),
                             jcfg.moe)
    jpos = np.asarray(jx_moe._positions_in_expert(ji, cfg.moe.num_experts))
    cap = moe.capacity_for(cfg.moe, x2d.shape[0])
    with torch.no_grad(), moe.recorded_routes(tp) as routes:
        tp(t(x))
        tp(t(x[:, :1]))
    assert [r["capacity"] for r in routes] == [cap, 8]
    r = routes[0]
    assert np.array_equal(r["top_idx"].numpy(), np.asarray(ji))
    assert np.array_equal(r["pos"].numpy(), jpos)
    assert np.array_equal(r["keep"].numpy(), jpos < cap)
    assert not r["keep"].all() and routes[1]["keep"].all()
    assert abs(r["margin"] - _margin(jp, x2d, cfg.moe.top_k)) < 1e-6
    assert not tp._forward_pre_hooks


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b"])
def test_serve_launcher_serves_the_deepseek_archs(quiet_logging, arch):
    """``--arch`` on the CPU (reduced): the launcher's tokens are
    ``serve_lm``'s on the same seed (the tokens against the reference's
    loop: ``test_torch_lm.py``)."""
    s = serve_launcher.main(["--arch", arch, "--device", "cpu", "--batch",
                             "2", "--prompt-len", "8", "--new", "3",
                             "--log-level", "error"])
    assert s["arch"] == f"{arch}-reduced" and s["tokens"].shape == (2, 3)
    again = serve_launcher.serve_lm(reduced(get_arch(arch)), batch=2,
                                    prompt_len=8, new=3, device="cpu")
    assert np.array_equal(again["tokens"], s["tokens"])
