"""Shared helpers of the LM parity tests (``test_torch_lm*.py``): the
tolerance check, the reduced configs of both packages (and their no-drop
MoE variant), weights carried from the reference to the port (a whole
model, or one layer's leaves), inputs of each frontend, the MoE aux-loss
check, the reference launcher's greedy loop, the launcher tests' logging
fixture, and the train-step parity run of ``test_torch_lm_train*.py``
(``train_run`` and its checks)."""
import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jx_get_arch
from repro.config import reduced as jx_reduced
from repro.models import lm as jx_lm
from repro.models import transformer as jx_transformer
from repro.models.layers import moe as jx_moe
from repro.optim import adam as jx_adam
from repro_torch.config import get_arch, reduced
from repro_torch.interop import (from_jax_lm_params, from_jax_train_state, to_numpy_lm_caches,
                                 to_numpy_lm_params, to_numpy_train_state)
from repro_torch.models import lm, transformer
from repro_torch.models.layers.moe import recorded_routes

TOL = 1e-5          # logits, layer outputs, float32 caches
AUX_RTOL = 1e-6     # the MoE's router aux loss, relative
BF16_TOL = 2 ** -8  # one bfloat16 ulp, relative to the largest value
B = 2


@pytest.fixture
def quiet_logging():
    """Restore the ``repro_torch`` root logger after a launcher's
    ``main`` configured it."""
    root = logging.getLogger("repro_torch")
    state = (root.level, list(root.handlers), root.propagate)
    yield
    root.setLevel(state[0])
    root.handlers[:] = state[1]
    root.propagate = state[2]


def close(got, want, tol=TOL):
    """max|got - want| <= tol x max(1, max|want|); returns the error."""
    if isinstance(got, torch.Tensor):
        got = got.detach().double().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)
    return err


def t(a):
    return torch.from_numpy(np.array(a))


def caches_close(port_caches, ref_caches, cfg, tol=TOL):
    got = jax.tree.leaves(to_numpy_lm_caches(port_caches, cfg))
    want = jax.tree.leaves(jax.tree.map(
        lambda a: np.asarray(a, np.float32), ref_caches))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        close(g, w, tol)


def cfgs(arch, **attn):
    """The reference's reduced config and the port's, equal field for
    field; ``attn`` overrides the attention config on both."""
    jcfg, cfg = jx_reduced(jx_get_arch(arch)), reduced(get_arch(arch))
    if attn:
        jcfg = dataclasses.replace(
            jcfg, attn=dataclasses.replace(jcfg.attn, **attn))
        cfg = dataclasses.replace(
            cfg, attn=dataclasses.replace(cfg.attn, **attn))
    return jcfg, cfg


def no_drop(jcfg, cfg):
    """Both configs with the MoE's capacity factor at 2 x E / k, so every
    expert has a slot for every token (C >= T) and none drops: decode then
    equals forward.  Configs without MoE come back as they are."""
    if cfg.moe is None:
        return jcfg, cfg
    cf = 2 * cfg.moe.num_experts / cfg.moe.top_k
    return tuple(dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=cf)) for c in (jcfg, cfg))


def load_leaves(module, jparams):
    """Copy the reference's leaves (a nested dict of one layer) into the
    port's layer ``module``, by its parameters' dotted names."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            node = jparams
            for part in name.split("."):
                node = node[part]
            assert p.shape == node.shape, (name, p.shape, node.shape)
            p.copy_(t(node))
    return module


@functools.lru_cache(maxsize=None)
def carried(jcfg, cfg, seed=0):
    """The reference's weights of ``jcfg`` from ``seed`` and the port's
    ``Transformer`` holding them (shared: no test changes them)."""
    jp = jx_transformer.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, from_jax_lm_params(jax.tree.map(np.asarray, jp), cfg,
                                  device="cpu")


def inputs(cfg, rng, n_tokens):
    """Reference and port keyword inputs of the config's frontend."""
    jkw, kw = {}, {}

    def add(name, a):
        jkw[name], kw[name] = jnp.asarray(a), t(a)

    if cfg.frontend == "frames":
        add("frames", rng.standard_normal(
            (B, n_tokens, cfg.frontend_dim)).astype(np.float32))
        return jkw, kw
    add("tokens", rng.integers(0, cfg.vocab_size, (B, n_tokens),
                               dtype=np.int32))
    if cfg.frontend == "patches+tokens":
        add("patches", rng.standard_normal(
            (B, cfg.num_patches, cfg.frontend_dim)).astype(np.float32))
    return jkw, kw


def aux_sums_match(arch):
    """``forward``'s aux is the sum of its MoE layers' (two at reduced
    depth), with remat on and off and under autograd; the loss adds
    ``router_aux_weight`` x aux (``test_torch_lm_moe.py``,
    ``test_torch_lm_mla.py``)."""
    jcfg, cfg = cfgs(arch)
    # the reference's weights drawn under jit (faster to build here than
    # the eager draw of ``carried``; other bits, the same distribution)
    jp = jax.jit(jx_transformer.init_params, static_argnums=1)(
        jax.random.PRNGKey(7), jcfg)
    tp = from_jax_lm_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    jkw, kw = inputs(cfg, np.random.default_rng(5), 24)
    want = float(jax.jit(lambda p, a: jx_transformer.forward(
        p, jcfg, remat=False, **a)[1])(jp, jkw))
    labels = kw["tokens"].long().roll(-1, 1)
    for remat in (False, True):
        _, aux = transformer.forward(tp, cfg, remat=remat, **kw)
        assert aux.requires_grad
        assert abs(float(aux.detach()) - want) <= AUX_RTOL * abs(want), remat
        loss, parts = lm.loss_fn(tp, cfg, {"tokens": kw["tokens"],
                                           "labels": labels}, remat=remat)
        assert torch.equal(parts["aux"], aux)
        close(loss.detach(), float((parts["ce"] + cfg.moe.router_aux_weight
                                    * parts["aux"]).detach()))
        loss.backward()
        router = tp.layers[-1].ffn.router
        assert router.grad is not None and router.grad.abs().sum() > 0
        tp.zero_grad()
    assert want > 0


def reference_loop(jcfg, jp, prompts, new):
    """The reference launcher's loop: prefill, then new - 1 greedy steps."""
    logits, caches = jx_transformer.prefill(
        jp, jcfg, tokens=jnp.asarray(prompts), remat=False,
        max_len=prompts.shape[1] + new)
    dec = jax.jit(lambda p, c, tok, pos: jx_transformer.decode_step(
        p, c, jcfg, token=tok, pos=pos))
    token = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    generated = [token]
    for i in range(new - 1):
        logits, caches = dec(jp, caches, token,
                             jnp.asarray(prompts.shape[1] + i))
        token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        generated.append(token)
    return np.asarray(jnp.concatenate(generated, 1)), np.asarray(logits)


# -- the train step's parity (test_torch_lm_train*.py) ---------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 48, 3
# a MoE choice may differ from the reference's only where its k-th and
# (k+1)-th gates are this close: a tie in float32, which either package
# may break either way
TIE_MARGIN = 1e-6


def train_batch(cfg, rng):
    """A numpy batch of the config's frontend with labels, a few masked."""
    B, S = TRAIN_B, TRAIN_S
    b = {}
    if cfg.frontend == "frames":
        b["frames"] = rng.standard_normal(
            (B, S, cfg.frontend_dim)).astype(np.float32)
        labels = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S),
                                   dtype=np.int32)
        labels = np.roll(b["tokens"], -1, 1)
        labels[:, -1] = -1
        if cfg.frontend == "patches+tokens":
            b["patches"] = rng.standard_normal(
                (B, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
            labels = np.concatenate(
                [np.full((B, cfg.num_patches), -1, np.int32), labels], 1)
    b["labels"] = labels
    return b


def within(got, want, extra=0.0, tol=TOL):
    """|got - want| <= tol x max(1, max|want|) + extra, element by element
    (``extra`` a number or an array of ``want``'s shape); returns the
    largest error beyond ``extra``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got - want) - extra
    err = float(d.max()) if d.size else 0.0
    bound = tol * max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    assert err <= bound, (err, bound)
    return err


def trees_within(got, want, extra=0.0):
    """``within`` leaf by leaf over two pytrees of the reference's
    structure (``extra`` a number or a pytree of ``want``'s); a failure
    names the leaf."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    paths, treedef = jax.tree_util.tree_flatten_with_path(want)
    extras = (jax.tree.leaves(extra) if jax.tree.structure(extra) == treedef
              else [extra] * len(paths))
    for (path, w), g, e in zip(paths, jax.tree.leaves(got), extras):
        try:
            within(g, w, e)
        except AssertionError as err:
            raise AssertionError(f"{jax.tree_util.keystr(path)}: {err}")


_ROUTES: list = []


@functools.lru_cache(maxsize=None)
def _routed_forward(jcfg):
    """The reference's forward, jitted, with a debug callback in its MoE
    dispatch that appends each call's (top_idx, positions, capacity) to
    ``_ROUTES``, in order."""
    inner = jx_moe._dispatch_compute_combine

    def record(params, x2d, m, capacity):
        _, top_idx, _ = jx_moe._route(params["router"], x2d, m)
        pos = jx_moe._positions_in_expert(top_idx, m.num_experts)
        jax.debug.callback(lambda i, p: _ROUTES.append(
            (np.asarray(i), np.asarray(p), capacity)), top_idx, pos,
            ordered=True)
        return inner(params, x2d, m, capacity)

    fwd = jax.jit(lambda p, b: jx_transformer.forward(
        p, jcfg, remat=False, **b)[0])

    def run(jp, batch):
        jx_moe._dispatch_compute_combine = record
        try:
            _ROUTES.clear()
            jax.block_until_ready(fwd(jp, {k: jnp.asarray(v) for k, v
                                           in batch.items()
                                           if k != "labels"}))
            jax.effects_barrier()
        finally:
            jx_moe._dispatch_compute_combine = inner
        return list(_ROUTES)

    return run


def route_flips(jcfg, cfg, jp, model, batch):
    """The reference's and the port's routing of a forward over ``batch``
    compared choice for choice: (the port's recorded routes, the
    reference's, the differing (call, token) pairs with the port's k-th
    gate margin of that call)."""
    ref = _routed_forward(jcfg)(jp, batch)
    with torch.no_grad(), recorded_routes(model) as routes:
        lm.loss_fn(model, cfg, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, remat=False)
    assert len(routes) == len(ref)
    flips = []
    for call, (got, (ti, pos, cap)) in enumerate(zip(routes, ref)):
        assert got["capacity"] == cap
        for tok in np.where((got["top_idx"].numpy() != ti).any(-1))[0]:
            flips.append((call, int(tok), got["margin"]))
    return routes, ref, flips


@functools.lru_cache(maxsize=None)
def train_run(arch, drop=False):
    """Both packages through TRAIN_STEPS train steps from one carried
    state: the first step's gradients of ``loss_fn`` and metrics, the
    state after the last step and the lrs since the state was last carried
    across; the reference's step jitted, as its launcher runs it.

    A MoE arch has its routing compared before each step.  A choice may
    differ only at a float32 tie of the k-th gate (``TIE_MARGIN``); the
    two packages then train on different choices from that step, so the
    port's state is first held to the reference's (the bound of the steps
    so far) and then carried across again.  ``drop``: the configured
    capacity factor (tokens drop) in place of 2 x E / k."""
    jcfg, cfg = cfgs(arch) if drop else no_drop(*cfgs(arch))
    jp = jax.jit(jx_transformer.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    jstate = jx_lm.TrainState(jp, jx_adam.init(jp))
    state = from_jax_train_state(jax.tree.map(np.asarray, jstate), cfg,
                                 device="cpu")
    rng = np.random.default_rng(1)
    batches = [train_batch(cfg, rng) for _ in range(TRAIN_STEPS)]
    step = jx_lm.make_train_step(jcfg)

    def grads_and_step(st, b):
        g = jax.grad(lambda p: jx_lm.loss_fn(p, jcfg, b)[0])(st.params)
        return (g,) + step(st, b)

    jstep = jax.jit(grads_and_step)
    train_step = lm.make_train_step(cfg)
    out = {"cfg": cfg, "flips": [], "recarried_at": []}
    lrs, step_grads = [], []
    for i, b in enumerate(batches):
        if cfg.moe is not None:
            routes, ref, flips = route_flips(jcfg, cfg, jstate.params,
                                             state.params, b)
            if i == 0:
                out["routes"], out["ref_routes"] = routes, ref
            if flips:
                out["flips"].append((i, flips))
                assert max(m for _, _, m in flips) < TIE_MARGIN, \
                    f"step {i}: choices differ off a tie: {flips}"
                check_state(to_numpy_train_state(state, cfg),
                            jax.tree.map(np.asarray, jstate), lrs,
                            step_grads)
                state = from_jax_train_state(
                    jax.tree.map(np.asarray, jstate), cfg, device="cpu")
                out["recarried_at"].append(i)
                lrs, step_grads = [], []
        if i == 0:
            # the port's loss_fn gradients at the first state
            model = state.params
            names, leaves = zip(*model.named_parameters())
            loss, _ = lm.loss_fn(model, cfg, {k: torch.from_numpy(v)
                                              for k, v in b.items()})
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
            out["grads"] = to_numpy_lm_params(model, {
                n: torch.zeros_like(p) if x is None else x
                for n, p, x in zip(names, leaves, g)})
        jg, jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        state, m = train_step(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        assert all(v.shape == () and not v.requires_grad
                   for v in m.values())
        lrs.append(float(m["lr"]))
        step_grads.append(jax.tree.map(np.asarray, jg))
        if i == 0:
            out["ref_grads"] = step_grads[0]
            out["ref_metrics"] = {k: float(v) for k, v in jm.items()}
            out["metrics"] = {k: float(v) for k, v in m.items()}
    out["ref_state"] = jax.tree.map(np.asarray, jstate)
    out["state"] = to_numpy_train_state(state, cfg)
    out["lrs"], out["step_grads"] = lrs, step_grads
    return out


def check_first_step(r):
    assert set(r["metrics"]) == set(r["ref_metrics"]) == {
        "ce", "aux", "loss", "grad_norm", "lr"}
    for k, want in r["ref_metrics"].items():
        within(r["metrics"][k], want)
    assert r["metrics"]["lr"] == r["ref_metrics"]["lr"]
    if r["cfg"].moe is not None:
        assert r["ref_metrics"]["aux"] > 0


def check_grads(r):
    trees_within(r["grads"], r["ref_grads"])
    # the gradients reach every leaf
    assert all(np.abs(w).max() > 0 for w in jax.tree.leaves(r["ref_grads"])
               if w.size > 1)


def near_zero_allowance(lrs, grads):
    """Per element, 2 x the sum of the lrs of the steps at which its
    reference gradient lies within the gradient tolerance of zero
    (TOL x max(1, max|g|) of its leaf): Adam's first steps move an element
    by about lr whatever its grad's size, so where such a grad has the
    other sign in the two packages the element moves the other way, 2 x lr
    apart after that step.  ``grads``: one pytree (or dict) per step."""
    assert len(lrs) == len(grads) > 0

    def one(*gs):
        return sum(2 * lr * (np.abs(g) <= TOL * max(
            1.0, float(np.abs(g).max()) if g.size else 0.0))
            for lr, g in zip(lrs, gs))
    return jax.tree.map(one, *grads)


def check_state(state, ref, lrs, grads):
    """m and v within TOL x max(1, max|ref|); params within that plus
    ``near_zero_allowance`` of the steps' lrs and reference gradients.
    An element whose gradient was clear of zero at every step has no lr
    term, so an update that is missing, of the wrong sign or of the wrong
    size shows there; m holds the grads and v their squares, which a sign
    near zero moves by no more than the gradient tolerance."""
    params, (step, m, v) = state
    assert int(step) == int(ref.opt.step)
    for got, want in ((m, ref.opt.m), (v, ref.opt.v)):
        trees_within(got, want)
    trees_within(params, ref.params, near_zero_allowance(lrs, grads))
