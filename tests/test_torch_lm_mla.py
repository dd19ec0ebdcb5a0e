"""The port's Multi-head Latent Attention (``repro_torch.models.layers.mla``)
against the reference's, on the CPU.

Reduced deepseek-v3-671b widths (4 heads, q/kv LoRA ranks 32, nope 16,
rope 8, v 16), weights from the reference's ``mla.init``, inputs from numpy
seeds.  The full-sequence pass in one query chunk (S = 40) and in two (S =
2048); prefill outputs and caches in float32 and bfloat16; the absorbed
decode against the reference's decode, step by step, caches too; the
absorbed decode against the port's own materialised forward; and a decode
position past the cache raising.  Outputs and float32 caches agree to
``TOL`` x max(1, max|ref|), bfloat16 caches to ``BF16_TOL``
(``tests/_lm_parity.py``); the decode against the forward to
``tests/test_decode.py``'s 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (B, BF16_TOL, aux_sums_match, cfgs, close,
                        load_leaves, t)
from repro.models.layers import mla as jx_mla
from repro_torch.models import transformer
from repro_torch.models.layers import mla

DECODE_TOL = 2e-3


def _pair(seed=5):
    jcfg, cfg = cfgs("deepseek-v3-671b")
    jp = jax.tree.map(np.asarray, jx_mla.init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, cfg, jp, load_leaves(mla.MLA(cfg, device="meta").to_empty(
        device="cpu"), jp)


def _x(cfg, seq, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, seq, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("seq", [40, 2048])
def test_mla_train_matches_reference(seq):
    """One query chunk (S < Q_CHUNK), and two of 1024 (S = 2048)."""
    jcfg, cfg, jp, tp = _pair()
    x = _x(cfg, seq, 6)
    with torch.no_grad():
        got = tp(t(x))
    close(got, jx_mla.apply_train(jp, jnp.asarray(x), jcfg))


def test_mla_rejects_a_sequence_that_does_not_split():
    """2049 tokens make two chunks that are not equal (the reference's
    reshape fails there)."""
    _, cfg, _, tp = _pair()
    with torch.no_grad(), pytest.raises(ValueError, match="equal query"):
        tp(torch.zeros((1, 2049, cfg.d_model)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_matches_reference(dtype):
    jcfg, cfg, jp, tp = _pair()
    x = _x(cfg, 12, 7)
    jout, jc = jx_mla.apply_prefill(jp, jnp.asarray(x), jcfg, cache_len=20,
                                    cache_dtype=getattr(jnp, dtype))
    with torch.no_grad():
        out, c = tp.prefill(t(x), cache_len=20,
                            cache_dtype=getattr(torch, dtype))
    close(out, jout)
    tol = BF16_TOL if dtype == "bfloat16" else 1e-5
    for name in ("ckv", "k_rope"):
        assert c[name].dtype == getattr(torch, dtype)
        assert c[name].shape == jc[name].shape
        close(c[name].float(), np.asarray(jc[name], np.float32), tol)
    fresh = mla.init_cache(cfg, B, 20, device="cpu")
    want = jx_mla.init_cache(jcfg, B, 20)
    for name in ("ckv", "k_rope"):
        assert fresh[name].shape == want[name].shape and not fresh[name].any()
        assert fresh[name].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absorbed_decode_matches_reference(dtype):
    """The reference's prefill cache carried across, then eight absorbed
    decode steps on both sides: outputs and caches after each step."""
    jcfg, cfg, jp, tp = _pair()
    x = _x(cfg, 20, 8)
    _, jc = jx_mla.apply_prefill(jp, jnp.asarray(x[:, :12]), jcfg,
                                 cache_len=20, cache_dtype=getattr(jnp, dtype))
    c = {name: t(np.asarray(a, np.float32)).to(getattr(torch, dtype))
         for name, a in jc.items()}
    tol = BF16_TOL if dtype == "bfloat16" else 1e-5
    for pos in range(12, 20):
        jout, jc = jx_mla.apply_decode(jp, jnp.asarray(x[:, pos:pos + 1]), jc,
                                       jnp.asarray(pos), jcfg)
        with torch.no_grad():
            out, c = tp.decode(t(x[:, pos:pos + 1]), c, pos)
        close(out, jout, tol)
        for name in ("ckv", "k_rope"):
            close(c[name].float(), np.asarray(jc[name], np.float32), tol)


def test_absorbed_decode_agrees_with_the_forward():
    """The port's own consistency at the layer: prefill 12 tokens, decode 8
    in the latent, against the materialised pass over all 20 (float32
    caches)."""
    _, cfg, _, tp = _pair()
    x = t(_x(cfg, 20, 9))
    with torch.no_grad():
        full = tp(x)
        _, c = tp.prefill(x[:, :12], cache_len=20, cache_dtype=torch.float32)
        for pos in range(12, 20):
            out, c = tp.decode(x[:, pos:pos + 1], c, torch.tensor(pos))
            close(out[:, 0], full[:, pos].numpy(), DECODE_TOL)


def test_decode_position_past_the_cache_raises():
    _, cfg, _, tp = _pair()
    cache = mla.init_cache(cfg, 1, 4, dtype=torch.float32, device="cpu")
    x = torch.zeros((1, 1, cfg.d_model))
    with torch.no_grad(), pytest.raises(ValueError, match="outside"):
        tp.decode(x, cache, 4)
    model = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    caches = transformer.init_caches(cfg, 1, 4, dtype=torch.float32,
                                     device="cpu")
    assert set(caches[0]["mixer"]) == {"ckv", "k_rope"}
    with torch.inference_mode(), pytest.raises(ValueError, match="outside"):
        transformer.decode_step(model, caches, cfg,
                                token=torch.zeros((1, 1), dtype=torch.int32),
                                pos=4)


def test_forward_sums_the_aux_losses():
    aux_sums_match("deepseek-v3-671b")
