"""The port's Mamba mixer (``repro_torch.models.layers.mamba``) against the
reference's, on the CPU, and reduced jamba-v0.1-52b end to end.

Reduced jamba widths (d_model 64, d_inner 128, d_state 8, d_conv 4, chunk
16), the layer's weights from the reference's ``mamba.init``, inputs from
numpy seeds: ``_ssm_coeffs`` and the in-chunk scan at L = 1, 7 and 16; one
layer's forward in one short chunk (S = 8) and in three (S = 48, the state
carried); prefill caches in float32 and bfloat16 and eight decode steps
against the reference's; the decode against the port's own forward; the
lengths both packages refuse.  Then the reduced model (16 layers: Mamba,
attention, dense and MoE FFNs), weights drawn under ``jit``: forward,
prefill and decode logits and caches, and the launcher's greedy tokens at
the configured capacity factor 1.25, where choices drop.  Outputs and
float32 caches agree to ``TOL`` x max(1, max|ref|), bfloat16 caches to
``BF16_TOL`` (``tests/_lm_parity.py``); decode against forward to phase
``lm``'s 1e-3 (prefill) and 2e-3 (decode).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (B, BF16_TOL, TOL, caches_close, cfgs, close,
                        load_leaves, no_drop, reference_loop, t)
from repro.models import transformer as jx_transformer
from repro.models.layers import mamba as jx_mamba
from repro_torch.interop import from_jax_lm_params
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import transformer
from repro_torch.models.layers import mamba
from repro_torch.models.layers.moe import recorded_routes

PREFILL_TOL, DECODE_TOL = 1e-3, 2e-3


def _pair(seed=5):
    jcfg, cfg = cfgs("jamba-v0.1-52b")
    jp = jax.tree.map(np.asarray,
                      jx_mamba.init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, cfg, jp, load_leaves(
        mamba.Mamba(cfg, device="meta").to_empty(device="cpu"), jp)


def _x(cfg, seq, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, seq, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("length", [1, 7, 16])
def test_ssm_coeffs_and_chunk_scan_match_reference(length):
    jcfg, cfg, jp, tp = _pair()
    di, n = cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state
    rng = np.random.default_rng(length)
    u = rng.standard_normal((B, length, di)).astype(np.float32)
    ja, jb, jc = jx_mamba._ssm_coeffs(jp, jnp.asarray(u), jcfg)
    with torch.no_grad():
        a, b, c = mamba._ssm_coeffs(tp, t(u), cfg)
    for got, want in ((a, ja), (b, jb), (c, jc)):
        assert got.dtype == torch.float32
        close(got, want)
    h0 = rng.standard_normal((B, di, n)).astype(np.float32)
    jh, jlast = jx_mamba._chunk_scan(ja, jb, jnp.asarray(h0))
    h, last = mamba._chunk_scan(t(np.asarray(ja)), t(np.asarray(jb)), t(h0))
    close(h, jh)
    close(last, jlast)


@pytest.mark.parametrize("seq", [8, 48])
def test_mamba_train_matches_reference(seq):
    """One chunk shorter than 16 (S = 8), and three (S = 48): the state
    carried across chunks."""
    jcfg, cfg, jp, tp = _pair()
    x = _x(cfg, seq, 6)
    with torch.no_grad():
        got = tp(t(x))
    close(got, jx_mamba.apply_train(jp, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_prefill_and_decode_match_reference(dtype):
    """A prompt of 32 (two chunks): the output and the caches (the conv
    tail in the cache dtype, the state float32); then the reference's
    cache carried across and eight decode steps on both sides, outputs and
    caches after each."""
    jcfg, cfg, jp, tp = _pair()
    x = _x(cfg, 40, 7)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    jout, jc = jx_mamba.apply_prefill(jp, jnp.asarray(x[:, :32]), jcfg,
                                      cache_dtype=jdt)
    with torch.no_grad():
        out, c = tp.prefill(t(x[:, :32]), cache_len=40, cache_dtype=tdt)
    close(out, jout)
    assert c["conv"].dtype == tdt and c["ssm"].dtype == torch.float32
    close(c["conv"].float(), np.asarray(jc["conv"], np.float32), tol)
    close(c["ssm"], jc["ssm"])
    fresh = mamba.init_cache(cfg, B, 40, device="cpu")
    want = jx_mamba.init_cache(jcfg, B, 40)
    for name in ("conv", "ssm"):
        assert fresh[name].shape == want[name].shape and not fresh[name].any()
        assert str(fresh[name].dtype).split(".")[1] == want[name].dtype.name
    c = {"conv": t(np.asarray(jc["conv"], np.float32)).to(tdt),
         "ssm": t(np.asarray(jc["ssm"]))}
    for pos in range(32, 40):
        jout, jc = jx_mamba.apply_decode(jp, jnp.asarray(x[:, pos:pos + 1]),
                                         jc, jnp.asarray(pos), jcfg)
        with torch.no_grad():
            out, c = tp.decode(t(x[:, pos:pos + 1]), c, pos)
        close(out, jout, tol)
        close(c["conv"].float(), np.asarray(jc["conv"], np.float32), tol)
        close(c["ssm"], jc["ssm"], tol)


def test_mamba_decode_agrees_with_the_forward():
    """The port's own consistency at the layer: prefill 16 tokens, decode
    16, against the forward over all 32 (float32 caches)."""
    _, cfg, _, tp = _pair()
    x = t(_x(cfg, 32, 9))
    with torch.no_grad():
        full = tp(x)
        out, c = tp.prefill(x[:, :16], cache_dtype=torch.float32)
        close(out, full[:, :16].numpy(), PREFILL_TOL)
        for pos in range(16, 32):
            out, c = tp.decode(x[:, pos:pos + 1], c, pos)
            close(out[:, 0], full[:, pos].numpy(), DECODE_TOL)


def test_both_packages_refuse_the_same_lengths():
    """S = 40 is neither shorter than the chunk (16) nor a multiple of it:
    the reference's forward asserts and its prefill's reshape fails.  A
    prompt of 2 leaves the reference a conv cache of 1 row where its
    decode needs 3, so that decode fails; the port refuses the prompt."""
    jcfg, cfg, jp, tp = _pair()
    x = _x(cfg, 40, 10)
    with pytest.raises(AssertionError):
        jx_mamba.apply_train(jp, jnp.asarray(x), jcfg)
    with pytest.raises((TypeError, ValueError)):
        jx_mamba.apply_prefill(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        with pytest.raises(ValueError, match="neither shorter"):
            tp(t(x))
        with pytest.raises(ValueError, match="neither shorter"):
            tp.prefill(t(x))
    _, jc = jx_mamba.apply_prefill(jp, jnp.asarray(x[:, :2]), jcfg)
    assert jc["conv"].shape[1] == 1
    with pytest.raises((TypeError, ValueError)):
        jx_mamba.apply_decode(jp, jnp.asarray(x[:, 2:3]), jc,
                              jnp.asarray(2), jcfg)
    with torch.no_grad(), pytest.raises(ValueError, match="shorter than"):
        tp.prefill(t(x[:, :2]))


# -- reduced jamba-v0.1-52b end to end ----------------------------------------

@functools.lru_cache(maxsize=None)
def _jamba():
    """The reference's weights drawn under ``jit`` and the port's model
    holding them (the MoE's capacity factor is read from the config handed
    to each call, not from the weights)."""
    jcfg, cfg = cfgs("jamba-v0.1-52b")
    jp = jax.jit(jx_transformer.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, from_jax_lm_params(jax.tree.map(np.asarray, jp),
                                             cfg, device="cpu")


def _tokens(cfg, seq, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, seq), dtype=np.int32)


def test_reduced_jamba_matches_reference():
    """Forward over 48 tokens, prefill of 32 into float32 caches, then 4
    teacher-forced decode steps: logits and every cache leaf (the Mamba
    layers' conv and state, the attention layers' k and v) against the
    reference's; decode against the port's own forward (no MoE drops)."""
    _, _, jp, tp = _jamba()
    jcfg, cfg = no_drop(*_jamba()[:2])
    toks = _tokens(cfg, 48, 11)
    want = np.asarray(jax.jit(lambda p, a: jx_transformer.forward(
        p, jcfg, tokens=a, remat=False)[0])(jp, jnp.asarray(toks)))
    with torch.inference_mode():
        full = transformer.forward(tp, cfg, tokens=t(toks))[0]
    close(full, want)
    jl, jc = jax.jit(lambda p, a: jx_transformer.prefill(
        p, jcfg, tokens=a, remat=False, max_len=48,
        cache_dtype=jnp.float32))(jp, jnp.asarray(toks[:, :32]))
    with torch.inference_mode():
        tl, tc = transformer.prefill(tp, cfg, tokens=t(toks[:, :32]),
                                     max_len=48, cache_dtype=torch.float32)
    close(tl, jl)
    caches_close(tc, jc, cfg)
    assert set(tc[0]["mixer"]) == {"conv", "ssm"}
    assert set(tc[4]["mixer"]) == {"k", "v"}
    close(tl[:, 0], full[:, 31].numpy(), PREFILL_TOL)
    dec = jax.jit(lambda p, c, tok, pos: jx_transformer.decode_step(
        p, c, jcfg, token=tok, pos=pos))
    for pos in range(32, 36):
        jl, jc = dec(jp, jc, jnp.asarray(toks[:, pos:pos + 1]),
                     jnp.asarray(pos))
        with torch.inference_mode():
            tl, tc = transformer.decode_step(
                tp, tc, cfg, token=t(toks[:, pos:pos + 1]), pos=pos)
        close(tl, jl)
        close(tl[:, 0], full[:, pos].numpy(), DECODE_TOL)
        caches_close(tc, jc, cfg)


def test_reduced_jamba_serves_the_reference_tokens():
    """The launcher's loop at the configured capacity factor (1.25), where
    the prefill drops (token, choice) pairs: the reference loop's greedy
    tokens, logits to BF16_TOL (bfloat16 caches, the default)."""
    jcfg, cfg, jp, tp = _jamba()
    assert cfg.moe.capacity_factor == 1.25
    prompts = _tokens(cfg, 32, 12)
    with torch.inference_mode(), recorded_routes(tp) as routes:
        transformer.prefill(tp, cfg, tokens=t(prompts), max_len=38)
    assert sum(int((~r["keep"]).sum()) for r in routes) > 0
    s = serve_launcher.serve_lm(cfg, params=tp, prompts=prompts, new=6,
                                device="cpu")
    tokens, logits = reference_loop(jcfg, jp, prompts, 6)
    assert np.array_equal(s["tokens"], tokens)
    close(s["logits"], logits, BF16_TOL)
