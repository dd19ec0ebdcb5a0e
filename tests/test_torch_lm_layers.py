"""The port's LM layers against the JAX reference's, on the CPU: norms,
rope, the embedding (all three frontends, tied and separate heads), the
FFNs, and attention for the full sequence (one chunk and two), prefill and
decode, full and sliding.  Weights from the reference's ``init``
functions, inputs from numpy seeds; outputs and float32 caches agree to
``TOL`` x max(1, max|ref|) (``tests/_lm_parity.py``), bfloat16 norms to
one bfloat16 ulp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import B, BF16_TOL, TOL, cfgs, close, inputs, t
from repro.models.layers import attention as jx_attention
from repro.models.layers import embedding as jx_embedding
from repro.models.layers import ffn as jx_ffn
from repro.models.layers import norms as jx_norms
from repro.models.layers import rope as jx_rope
from repro_torch.models.layers import attention, embedding, ffn, norms, rope


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = t(x).to(getattr(torch, dtype))
    want = jx_norms.rms_apply({"scale": jnp.asarray(scale)}, jx, 1e-6)
    got = norms.rms_apply({"scale": t(scale)}, tx, 1e-6)
    assert got.dtype == tx.dtype
    close(got, np.asarray(want, np.float32),
          TOL if dtype == "float32" else BF16_TOL)
    want = jx_norms.ln_apply({"scale": jnp.asarray(scale),
                              "bias": jnp.asarray(bias)}, jx, 1e-5)
    got = norms.ln_apply({"scale": t(scale), "bias": t(bias)}, tx, 1e-5)
    close(got, np.asarray(want, np.float32),
          TOL if dtype == "float32" else BF16_TOL)
    module = norms.RMSNorm(48, device="cpu")
    assert torch.equal(module.scale, torch.ones(48))
    close(module(t(x)), jx_norms.rms_apply(jx_norms.rms_init(48),
                                           jnp.asarray(x)))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 500, 1023, 4095]] * 2, np.int32)
    close(rope.rope_freqs(16, theta), jx_rope.rope_freqs(16, theta))
    close(rope.apply_rope(t(x), t(pos), theta),
          jx_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "hubert-xlarge",
                                  "pixtral-12b", "untied"])
def test_embedding_and_head_match_reference(arch):
    """The three frontends; the tied head with the sqrt(d_model) scaling
    (qwen: every dense config with tied embeddings) and a separate head."""
    jcfg, cfg = cfgs("qwen2.5-3b" if arch == "untied" else arch)
    if arch == "untied":
        jcfg = dataclasses.replace(jcfg, tie_embeddings=False)
        cfg = dataclasses.replace(cfg, tie_embeddings=False)
    jp = jx_embedding.init(jax.random.PRNGKey(2), jcfg)
    tp = embedding.Embedding(cfg, device="cpu")
    for name, a in jp.items():
        getattr(tp, name).data = t(np.asarray(a))
    jkw, kw = inputs(cfg, np.random.default_rng(2), 7)
    want = jx_embedding.embed(jp, jcfg, **jkw)
    got = tp(**kw)
    close(got, want)
    x = np.random.default_rng(3).standard_normal(
        (B, 3, cfg.d_model)).astype(np.float32)
    close(embedding.logits(tp, cfg, t(x)),
          jx_embedding.logits(jp, jcfg, jnp.asarray(x)))


def test_ffns_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 5, 64)).astype(np.float32)
    prev = rng.standard_normal((B, 1, 64)).astype(np.float32)
    for j_init, j_apply, port_cls, args in (
            (jx_ffn.swiglu_init, jx_ffn.swiglu_apply, ffn.SwiGLU, ()),
            (jx_ffn.rwkv_cmix_init, jx_ffn.rwkv_cmix_apply,
             ffn.RWKVChannelMix, (None, prev))):
        jp = j_init(jax.random.PRNGKey(4), 64, 96)
        tp = port_cls(64, 96, device="cpu")
        for name, a in jp.items():
            getattr(tp, name).data = t(np.asarray(a))
        for extra in args or (None,):
            jargs = () if extra is None else (jnp.asarray(extra),)
            targs = () if extra is None else (t(extra),)
            close(tp(t(x), *targs), j_apply(jp, jnp.asarray(x), *jargs))


def _attention_pair(jcfg, cfg, sliding, seed=5):
    jp = jx_attention.init(jax.random.PRNGKey(seed), jcfg)
    tp = attention.Attention(cfg, sliding=sliding, device="cpu")
    for name, a in jp.items():
        getattr(tp, name).data = t(np.asarray(a))
    return jp, tp


@pytest.mark.parametrize("seq", [40, 2048])
@pytest.mark.parametrize("kind", ["full", "sliding"])
def test_attention_train_matches_reference(kind, seq):
    """One chunk, and two chunks of Q_CHUNK: the banded K/V slice of a
    sliding layer (window + Q_CHUNK <= S) and the whole K/V of a full one."""
    jcfg, cfg = cfgs("qwen2.5-3b", window=32)
    sliding = kind == "sliding"
    jp, tp = _attention_pair(jcfg, cfg, sliding)
    x = np.random.default_rng(6).standard_normal(
        (1, seq, cfg.d_model)).astype(np.float32)
    close(tp(t(x)), jx_attention.apply_train(jp, jnp.asarray(x), jcfg,
                                             sliding=sliding))


def test_attention_rejects_a_ragged_long_sequence():
    _, cfg = cfgs("qwen2.5-3b")
    q = torch.zeros((1, attention.Q_CHUNK + 8, 2, 4))
    with pytest.raises(ValueError, match="multiple"):
        attention.attend(q, q, q, cfg.attn, causal=True)


@pytest.mark.parametrize("kind", ["full", "sliding"])
def test_attention_prefill_and_decode_match_reference(kind):
    jcfg, cfg = cfgs("qwen2.5-3b", window=8)
    sliding = kind == "sliding"
    jp, tp = _attention_pair(jcfg, cfg, sliding)
    x = np.random.default_rng(7).standard_normal(
        (B, 20, cfg.d_model)).astype(np.float32)
    jout, jc = jx_attention.apply_prefill(
        jp, jnp.asarray(x[:, :12]), jcfg, sliding=sliding, cache_len=20,
        cache_dtype=jnp.float32)
    out, c = tp.prefill(t(x[:, :12]), cache_len=20,
                        cache_dtype=torch.float32)
    close(out, jout)
    for name in ("k", "v"):
        close(c[name], jc[name])
    for pos in range(12, 20):
        jout, jc = jx_attention.apply_decode(
            jp, jnp.asarray(x[:, pos:pos + 1]), jc, jnp.asarray(pos), jcfg,
            sliding=sliding)
        out, c = tp.decode(t(x[:, pos:pos + 1]), c, pos)
        close(out, jout)
        for name in ("k", "v"):
            close(c[name], jc[name])
