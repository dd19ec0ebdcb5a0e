"""Shared helpers of the LM parity tests (``test_torch_lm*.py``): the
tolerance check, the reduced configs of both packages, weights carried
from the reference to the port, and inputs of each frontend."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import get_arch as jx_get_arch
from repro.config import reduced as jx_reduced
from repro.models import transformer as jx_transformer
from repro_torch.config import get_arch, reduced
from repro_torch.interop import from_jax_lm_params, to_numpy_lm_caches

TOL = 1e-5          # logits, layer outputs, float32 caches
BF16_TOL = 2 ** -8  # one bfloat16 ulp, relative to the largest value
B = 2


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
