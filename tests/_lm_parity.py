"""Shared helpers of the LM parity tests (``test_torch_lm*.py``): the
tolerance check, the reduced configs of both packages (and their no-drop
MoE variant), weights carried from the reference to the port (a whole
model, or one layer's leaves), inputs of each frontend, the MoE aux-loss
check, the reference launcher's greedy loop and the launcher tests'
logging fixture."""
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
from repro.models import transformer as jx_transformer
from repro_torch.config import get_arch, reduced
from repro_torch.interop import from_jax_lm_params, to_numpy_lm_caches
from repro_torch.models import lm, transformer

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
