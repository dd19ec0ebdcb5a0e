"""The port's RWKV-6 time-mix (``repro_torch.models.layers.rwkv``) against
the reference's, on the CPU, and reduced rwkv6-7b end to end.

Reduced rwkv6 widths (d_model 64, 4 heads of 16, chunk 16), the layer's
weights from the reference's ``rwkv.init``, inputs from numpy seeds:
``_mix_projections``; ``_chunk_wkv`` on a decay mild enough that no pair
reaches the clip and on one strong enough that ``elw_t - lw_s`` falls
below -60, where the clip acts; one layer's forward in one short chunk
(S = 8) and in three (S = 48, the state carried); prefill caches in
float32 and bfloat16 and eight decode steps against the reference's; the
decode against the port's own forward; a length both packages refuse.
Then the reduced model (two time-mix layers with the channel-mix FFN),
weights carried from the reference: forward, prefill and decode logits
and caches, and the launcher's greedy tokens.  Outputs and float32 caches
agree to ``TOL`` x max(1, max|ref|), bfloat16 caches to ``BF16_TOL``
(``tests/_lm_parity.py``); decode against forward to phase ``lm``'s 1e-3
(prefill) and 2e-3 (decode).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (B, BF16_TOL, TOL, caches_close, carried, cfgs,
                        close, load_leaves, reference_loop, t)
from repro.models import transformer as jx_transformer
from repro.models.layers import rwkv as jx_rwkv
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import transformer
from repro_torch.models.layers import rwkv

PREFILL_TOL, DECODE_TOL = 1e-3, 2e-3


def _pair(seed=5):
    jcfg, cfg = cfgs("rwkv6-7b")
    jp = jax.tree.map(np.asarray, jx_rwkv.init(jax.random.PRNGKey(seed),
                                               jcfg))
    return jcfg, cfg, jp, load_leaves(
        rwkv.RWKV6(cfg, device="meta").to_empty(device="cpu"), jp)


def _x(cfg, seq, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, seq, cfg.d_model)).astype(np.float32)


def test_mix_projections_match_reference():
    jcfg, cfg, jp, tp = _pair()
    x, prev = _x(cfg, 12, 1), _x(cfg, 1, 2)
    want = jx_rwkv._mix_projections(jp, jnp.asarray(x), jnp.asarray(prev),
                                    jcfg)
    with torch.no_grad():
        got = rwkv._mix_projections(tp, t(x), t(prev), cfg)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g, w)
    assert got[-1].dtype == torch.float32 and float(got[-1].max()) < 0


@pytest.mark.parametrize("decay", [1.0, 8.0])
def test_chunk_wkv_matches_reference(decay):
    """log w = -decay x exp(N(0, 1)): at 8 the exclusive prefix of a late
    token minus the inclusive one of an early token falls below -60, so
    the clip decides those pairs."""
    jcfg, cfg, jp, _ = _pair()
    hd = cfg.rwkv.head_dim
    H, L = cfg.d_model // hd, cfg.rwkv.chunk
    rng = np.random.default_rng(3)
    r, k, v = (rng.standard_normal((B, L, H, hd)).astype(np.float32)
               for _ in range(3))
    log_w = (-decay * np.exp(rng.standard_normal((B, L, H, hd)))
             ).astype(np.float32)
    S0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    lw = np.cumsum(log_w, axis=1)
    gap = (lw - log_w)[:, :, None] - lw[:, None]
    below = gap[:, np.tril_indices(L, -1)[0], np.tril_indices(L, -1)[1]]
    assert (below.min() < -60) == (decay > 1)
    jy, jS = jx_rwkv._chunk_wkv(*map(jnp.asarray, (r, k, v, log_w)),
                                jnp.asarray(jp["u"]), jnp.asarray(S0))
    y, S1 = rwkv._chunk_wkv(t(r), t(k), t(v), t(log_w), t(jp["u"]), t(S0))
    close(y, jy)
    close(S1, jS)


@pytest.mark.parametrize("seq", [8, 48])
def test_time_mix_matches_reference(seq):
    jcfg, cfg, jp, tp = _pair()
    x = _x(cfg, seq, 6)
    with torch.no_grad():
        got = tp(t(x))
    close(got, jx_rwkv.apply_train(jp, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_prefill_and_decode_match_reference(dtype):
    """A prompt of 32 (two chunks): the output and the caches (the state
    float32, the shift token in the cache dtype); then the reference's
    cache carried across and eight decode steps on both sides."""
    jcfg, cfg, jp, tp = _pair()
    x = _x(cfg, 40, 7)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    jout, jc = jx_rwkv.apply_prefill(jp, jnp.asarray(x[:, :32]), jcfg,
                                     cache_dtype=jdt)
    with torch.no_grad():
        out, c = tp.prefill(t(x[:, :32]), cache_len=40, cache_dtype=tdt)
    close(out, jout)
    assert c["state"].dtype == torch.float32 and c["shift"].dtype == tdt
    close(c["state"], jc["state"])
    close(c["shift"].float(), np.asarray(jc["shift"], np.float32), tol)
    fresh = rwkv.init_cache(cfg, B, 40, device="cpu")
    want = jx_rwkv.init_cache(jcfg, B, 40)
    for name in ("state", "shift"):
        assert fresh[name].shape == want[name].shape and not fresh[name].any()
        assert str(fresh[name].dtype).split(".")[1] == want[name].dtype.name
    c = {"state": t(np.asarray(jc["state"])),
         "shift": t(np.asarray(jc["shift"], np.float32)).to(tdt)}
    for pos in range(32, 40):
        jout, jc = jx_rwkv.apply_decode(jp, jnp.asarray(x[:, pos:pos + 1]),
                                        jc, jnp.asarray(pos), jcfg)
        with torch.no_grad():
            out, c = tp.decode(t(x[:, pos:pos + 1]), c, pos)
        close(out, jout, tol)
        close(c["state"], jc["state"], tol)
        close(c["shift"].float(), np.asarray(jc["shift"], np.float32), tol)


def test_time_mix_decode_agrees_with_the_forward():
    """Prefill 16 tokens, decode 16, against the forward over all 32
    (float32 caches)."""
    _, cfg, _, tp = _pair()
    x = t(_x(cfg, 32, 9))
    with torch.no_grad():
        full = tp(x)
        out, c = tp.prefill(x[:, :16], cache_dtype=torch.float32)
        close(out, full[:, :16].numpy(), PREFILL_TOL)
        for pos in range(16, 32):
            out, c = tp.decode(x[:, pos:pos + 1], c, pos)
            close(out[:, 0], full[:, pos].numpy(), DECODE_TOL)


def test_both_packages_refuse_a_length_off_the_chunk():
    jcfg, cfg, jp, tp = _pair()
    x = _x(cfg, 40, 10)
    with pytest.raises(AssertionError):
        jx_rwkv.apply_train(jp, jnp.asarray(x), jcfg)
    with pytest.raises((TypeError, ValueError)):
        jx_rwkv.apply_prefill(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        with pytest.raises(ValueError, match="neither shorter"):
            tp(t(x))
        with pytest.raises(ValueError, match="neither shorter"):
            tp.prefill(t(x))


# -- reduced rwkv6-7b end to end ----------------------------------------------

def _tokens(cfg, seq, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, seq), dtype=np.int32)


def test_reduced_rwkv6_matches_reference():
    """Forward over 48 tokens, prefill of 32 into float32 caches, then 4
    teacher-forced decode steps: logits and every cache leaf (the
    time-mix's state and shift, the channel-mix's shift) against the
    reference's; decode against the port's own forward."""
    jcfg, cfg = cfgs("rwkv6-7b")
    jp, tp = carried(jcfg, cfg)
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
    assert set(tc[0]["mixer"]) == {"state", "shift"}
    assert set(tc[0]["ffn"]) == {"shift"}
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


def test_reduced_rwkv6_serves_the_reference_tokens():
    """The launcher's loop, bfloat16 caches (the default on both sides):
    the reference loop's greedy tokens exactly, logits to BF16_TOL."""
    jcfg, cfg = cfgs("rwkv6-7b")
    jp, tp = carried(jcfg, cfg)
    prompts = _tokens(cfg, 32, 12)
    s = serve_launcher.serve_lm(cfg, params=tp, prompts=prompts, new=8,
                                device="cpu")
    tokens, logits = reference_loop(jcfg, jp, prompts, 8)
    assert np.array_equal(s["tokens"], tokens)
    close(s["logits"], logits, BF16_TOL)
