"""The port's LM serving path against the JAX reference, on the CPU.

Every config (all the reference's kinds: ``ATTN_FULL``, ``ATTN_SLIDING``,
``ATTN_MLA``, ``MAMBA``, ``RWKV6``, ``FFN_DENSE``, ``FFN_MOE``) at
``reduced()`` size, with the
reference's weights carried across by ``interop.from_jax_lm_params`` and
inputs made from a seed with numpy: ``forward``, ``prefill`` and
teacher-forced ``decode_step``s, the step makers, the loss, interop, the
serve launcher's and the example's ``--arch`` paths.  Logits and float32
caches agree to ``TOL`` x max(1, max|ref|) (``tests/_lm_parity.py``).  One
case needs more: bfloat16 caches (the default of ``prefill`` and the
launchers), where a k/v element that rounds to the other bfloat16
neighbour moves by one bfloat16 ulp, so those caches, and the logits of a
decode that reads them, agree to ``BF16_TOL`` (2^-8) x max(1, max|ref|),
and the greedy tokens exactly.  The port's decode against its own forward
is held to ``tests/test_decode.py``'s 2e-3.  The Mamba and RWKV6 configs
take a prompt of 32 and a forward of 48 (their chunked scans need a length
shorter than the chunk, 16, or a multiple of it); the others 40 and 44.
Interop round trips are bit for bit.  The MoE configs run at capacity factor 2 x E / k where decode
must equal forward (no token drops), and at their configured 1.25 through
the launcher, on both sides.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (B, BF16_TOL, caches_close, carried, cfgs, close,
                        inputs, no_drop, quiet_logging, reference_loop, t)
from repro.models import lm as jx_lm
from repro.models import transformer as jx_transformer
from repro_torch.config import MAMBA, RWKV6, RWKVConfig, get_arch, reduced
from repro_torch.interop import (from_jax_lm_caches, from_jax_lm_params,
                                 to_numpy_lm_caches, to_numpy_lm_params)
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import lm, transformer

DECODERS = ["qwen2.5-3b", "gemma3-4b", "gemma3-27b", "command-r-35b",
            "pixtral-12b", "qwen2.5-3b+rwkv-ffn", "deepseek-moe-16b",
            "deepseek-v3-671b", "jamba-v0.1-52b", "rwkv6-7b"]
IN_SCOPE = DECODERS + ["hubert-xlarge"]
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
DECODE_STEPS = 3
_RUNS = {}


# -- the model -----------------------------------------------------------------

def _cfgs_of(arch):
    """The configs of ``arch``, with no MoE token dropped (``no_drop``:
    decode must equal forward); "+rwkv-ffn": attention mixers with the
    RWKV channel-mix FFN (a config carrying ``rwkv``), whose shift cache
    goes through prefill and decode."""
    if not arch.endswith("+rwkv-ffn"):
        return no_drop(*cfgs(arch))
    from repro.config import RWKVConfig as JxRWKVConfig
    jcfg, cfg = cfgs(arch.split("+")[0])
    return (dataclasses.replace(jcfg, rwkv=JxRWKVConfig(head_dim=16)),
            dataclasses.replace(cfg, rwkv=RWKVConfig(head_dim=16)))


def _lengths(cfg):
    """(prompt, forward length): a chunked scan takes a length shorter
    than its chunk (16 here) or a multiple of it."""
    if any(m in (MAMBA, RWKV6) for m, _ in cfg.pattern()):
        return 32, 48
    return 40, 44


def _run(arch):
    """Both packages through forward, prefill and DECODE_STEPS teacher-
    forced decode steps on one config, float32 caches, each step's caches
    kept (the port's decode writes them in place); the reference jitted.
    Computed once per arch and shared by the tests below."""
    if arch in _RUNS:
        return _RUNS[arch]
    jcfg, cfg = _cfgs_of(arch)
    jp, tp = carried(jcfg, cfg)
    S, F = _lengths(cfg)
    jkw, kw = inputs(cfg, np.random.default_rng(8), F)
    out = {"cfg": cfg, "tp": tp, "kw": kw, "prompt": S}
    out["ref_forward"] = np.asarray(jax.jit(lambda p, a: jx_transformer
                                            .forward(p, jcfg, remat=False,
                                                     **a)[0])(jp, jkw))
    with torch.inference_mode():
        out["forward"] = transformer.forward(tp, cfg, **kw)[0].numpy()
    if cfg.is_encoder_only:
        out["ref_encode"] = np.asarray(jx_lm.make_encode_step(jcfg)(jp, jkw))
        _RUNS[arch] = out
        return out
    pk = {k: v[:, :S] if k == "tokens" else v for k, v in jkw.items()}
    tpk = {k: v[:, :S] if k == "tokens" else v for k, v in kw.items()}
    # pixtral's patches come before the tokens
    off = cfg.num_patches if "patches" in kw else 0
    jl, jc = jax.jit(lambda p, a: jx_transformer.prefill(
        p, jcfg, remat=False, max_len=off + F, cache_dtype=jnp.float32,
        **a))(jp, pk)
    with torch.inference_mode():
        tl, tc = transformer.prefill(tp, cfg, max_len=off + F,
                                     cache_dtype=torch.float32, **tpk)
    steps = [(np.asarray(jl), tl.numpy(), jc, to_numpy_lm_caches(tc, cfg))]
    dec = jax.jit(lambda p, c, tok, pos: jx_transformer.decode_step(
        p, c, jcfg, token=tok, pos=pos))
    for i in range(DECODE_STEPS):
        pos = off + S + i
        jl, jc = dec(jp, jc, jkw["tokens"][:, S + i:S + i + 1],
                     jnp.asarray(pos))
        with torch.inference_mode():
            tl, tc = transformer.decode_step(
                tp, tc, cfg, token=kw["tokens"][:, S + i:S + i + 1],
                pos=pos)
        steps.append((np.asarray(jl), tl.numpy(), jc,
                      to_numpy_lm_caches(tc, cfg)))
    out["steps"], out["offset"] = steps, off
    _RUNS[arch] = out
    return out


@pytest.mark.parametrize("arch", IN_SCOPE)
def test_forward_matches_reference(arch):
    run = _run(arch)
    close(run["forward"], run["ref_forward"])
    if run["cfg"].is_encoder_only:
        with torch.inference_mode():
            got = lm.make_encode_step(run["cfg"])(run["tp"], run["kw"])
        close(got, run["ref_encode"])


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill, then teacher-forced decode steps: logits and every cache
    leaf after each step (sliding rings wrap: the prompt fills the window
    of 32 and decoding goes past it)."""
    run = _run(arch)
    cfg = run["cfg"]
    for jl, tl, jc, tc in run["steps"]:
        assert tl.shape == (B, 1, cfg.vocab_size)
        close(tl, jl)
        want = jax.tree.leaves(jax.tree.map(np.asarray, jc))
        got = jax.tree.leaves(tc)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            close(g, w)


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_agrees_with_forward(arch):
    """The port's own consistency, test_decode.py's check: prefill and
    decode logits equal the forward's at the same positions."""
    run = _run(arch)
    for i, (_, tl, _, _) in enumerate(run["steps"]):
        close(tl[:, 0], run["forward"][:, run["offset"] + run["prompt"] - 1
                                       + i], 2e-3)


def test_sliding_ring_wraps_many_times():
    """Window 8, prompt 32: decode 12 steps past the prompt, the ring
    wrapping every 8, against the reference step by step (caches too)."""
    jcfg, cfg = cfgs("gemma3-4b", window=8)
    jp, tp = carried(jcfg, cfg)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (1, 44),
                                             dtype=np.int32)
    _, jc = jx_transformer.prefill(jp, jcfg, tokens=jnp.asarray(toks[:, :32]),
                                   remat=False, max_len=44,
                                   cache_dtype=jnp.float32)
    with torch.inference_mode():
        _, tc = transformer.prefill(tp, cfg, tokens=t(toks[:, :32]),
                                    max_len=44, cache_dtype=torch.float32)
    assert tc[0]["mixer"]["k"].shape[1] == 8          # a ring
    dec = jax.jit(lambda p, c, tok, pos: jx_transformer.decode_step(
        p, c, jcfg, token=tok, pos=pos))
    for pos in range(32, 44):
        jl, jc = dec(jp, jc, jnp.asarray(toks[:, pos:pos + 1]),
                     jnp.asarray(pos))
        with torch.inference_mode():
            tl, tc = transformer.decode_step(tp, tc, cfg,
                                             token=t(toks[:, pos:pos + 1]),
                                             pos=pos)
        close(tl, jl)
    caches_close(tc, jc, cfg)


def test_short_prompt_sliding_decode_is_held_to_the_reference():
    """A sliding layer whose prompt (4) is shorter than its window (8):
    the reference's prefill leaves a max_len buffer (32) instead of a ring
    and its decode then attends past the window.  The port reproduces the
    reference; the reference's decode differs from its own forward from
    position 8 on (ROADMAP queue 3, reference-side state)."""
    jcfg, cfg = cfgs("gemma3-4b", window=8)
    jp, tp = carried(jcfg, cfg)
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (1, 32),
                                              dtype=np.int32)
    full = np.asarray(jx_transformer.forward(jp, jcfg,
                                             tokens=jnp.asarray(toks),
                                             remat=False)[0])
    _, jc = jx_transformer.prefill(jp, jcfg, tokens=jnp.asarray(toks[:, :4]),
                                   remat=False, max_len=32,
                                   cache_dtype=jnp.float32)
    with torch.inference_mode():
        _, tc = transformer.prefill(tp, cfg, tokens=t(toks[:, :4]),
                                    max_len=32, cache_dtype=torch.float32)
    assert tc[0]["mixer"]["k"].shape[1] == 32         # not a ring
    dec = jax.jit(lambda p, c, tok, pos: jx_transformer.decode_step(
        p, c, jcfg, token=tok, pos=pos))
    off_forward = []
    for pos in range(4, 32):
        jl, jc = dec(jp, jc, jnp.asarray(toks[:, pos:pos + 1]),
                     jnp.asarray(pos))
        with torch.inference_mode():
            tl, tc = transformer.decode_step(tp, tc, cfg,
                                             token=t(toks[:, pos:pos + 1]),
                                             pos=pos)
        close(tl, jl)
        scale = max(1.0, float(np.abs(full[:, pos]).max()))
        off_forward.append(float(np.abs(np.asarray(jl)[:, 0]
                                        - full[:, pos]).max()) / scale)
    caches_close(tc, jc, cfg)
    assert max(off_forward[:4]) < 2e-3               # positions 4-7
    assert min(off_forward[4:]) > 2e-3               # positions 8-31


# -- the step functions, the loss, interop -------------------------------------

def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((3, 5, 17)).astype(np.float32) * 4
    labels = rng.integers(0, 17, (3, 5)).astype(np.int32)
    labels[0, :2] = -1
    labels[2] = -1
    close(lm.cross_entropy(t(logits), t(labels)),
          jx_lm.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    none = np.full((3, 5), -1, np.int32)
    assert float(lm.cross_entropy(t(logits), t(none))) == 0.0
    close(lm.cross_entropy(t(logits).to(torch.bfloat16), t(labels)),
          jx_lm.cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                              jnp.asarray(labels)))


def test_loss_and_step_makers_match_reference():
    jcfg, cfg = cfgs("gemma3-4b")
    jp, tp = carried(jcfg, cfg)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab_size, (B, 12), dtype=np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -1
    want, wm = jx_lm.loss_fn(jp, jcfg, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels)},
                             remat=False)
    got, gm = lm.loss_fn(tp, cfg, {"tokens": t(toks), "labels": t(labels)})
    close(got.detach(), want)
    close(gm["ce"].detach(), wm["ce"])
    assert float(gm["aux"]) == float(wm["aux"]) == 0.0
    jl, jc = jx_lm.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tl, tc = lm.make_prefill_step(cfg)(tp, {"tokens": t(toks)})
        # the default bfloat16 caches, widened exactly on both sides
        caches_close(tc, jc, cfg, BF16_TOL)
        close(tl, jl)
        # the prefill step's caches hold the prompt's 12 positions: the
        # step rewrites the last one
        dl, tc = lm.make_decode_step(cfg)(tp, tc, t(toks[:, :1]), 11)
    jdl, jc = jx_lm.make_decode_step(jcfg)(jp, jc, jnp.asarray(toks[:, :1]),
                                           jnp.asarray(11))
    close(dl, jdl, BF16_TOL)
    caches_close(tc, jc, cfg, BF16_TOL)


def test_remat_keeps_values_and_gradients():
    """``remat`` recomputes each repeat in the backward: the same loss and
    gradients as without it; no graph under inference mode."""
    _, cfg = cfgs("gemma3-4b")
    model = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (B, 10), dtype=np.int32))
    batch = {"tokens": toks, "labels": toks.long().roll(-1, 1)}
    grads = []
    for remat in (True, False):
        model.zero_grad()
        loss, _ = lm.loss_fn(model, cfg, batch, remat=remat)
        loss.backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)
    with torch.inference_mode():
        logits, _ = transformer.forward(model, cfg, tokens=toks, remat=True)
    assert not logits.requires_grad


@pytest.mark.parametrize("arch", ["gemma3-4b", "pixtral-12b",
                                  "hubert-xlarge", "deepseek-moe-16b",
                                  "deepseek-v3-671b", "jamba-v0.1-52b",
                                  "rwkv6-7b"])
def test_interop_round_trips_bit_for_bit(arch):
    jcfg, cfg = cfgs(arch)
    jp = jax.tree.map(np.asarray, jax.jit(
        jx_transformer.init_params, static_argnums=1)(
            jax.random.PRNGKey(3), jcfg))
    back = to_numpy_lm_params(from_jax_lm_params(jp, cfg, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if cfg.is_encoder_only:
        return
    for dtype in (jnp.float32, jnp.bfloat16):
        jc = jx_transformer.init_caches(jcfg, 2, 16, dtype=dtype)
        jc = jax.tree.map(lambda a: np.asarray(a) + np.asarray(
            np.arange(a.size).reshape(a.shape) % 7, a.dtype), jc)
        tc = from_jax_lm_caches(jc, cfg, device="cpu")
        # the cache dtype, but float32 for the Mamba and RWKV6 states
        assert [str(a.dtype).split(".")[1] for c in tc
                for part in c.values() for a in part.values()] == [
            a.dtype.name for a in jax.tree.leaves(
                from_stacked(jc, jcfg))]
        back = to_numpy_lm_caches(tc, cfg)
        assert jax.tree.structure(back) == jax.tree.structure(jc)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jc)):
            assert np.array_equal(a, np.asarray(b, np.float32))
        fresh = transformer.init_caches(cfg, 2, 16, dtype=torch.float32,
                                        device="cpu")
        want = jx_transformer.init_caches(jcfg, 2, 16, dtype=jnp.float32)
        assert jax.tree.structure(to_numpy_lm_caches(fresh, cfg)) == \
            jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(to_numpy_lm_caches(fresh, cfg)),
                        jax.tree.leaves(want)):
            assert a.shape == b.shape and not a.any()


def from_stacked(stacked, jcfg):
    """The reference's stacked caches as a per-layer list of {part: {name:
    leaf}}, in the port's order."""
    return [{part: {n: np.asarray(a)[r] for n, a in leaves.items()}
             for part, leaves in stacked[si]["sub"][i].items()}
            for si, (repeats, sub) in enumerate(jcfg.stage_list())
            for r in range(repeats) for i in range(len(sub))]


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-7b"])
def test_a_bfloat16_model_keeps_its_float32_leaves(arch):
    """A bfloat16 model: ``A_log`` and ``D`` (Mamba), ``w0`` and ``u``
    (RWKV6) stay float32, as in the reference, through interop and when
    the port builds the model itself."""
    jcfg, cfg = cfgs(arch)
    jp = jax.tree.map(np.asarray, jax.jit(
        jx_transformer.init_params, static_argnums=(1, 2))(
            jax.random.PRNGKey(4), jcfg, jnp.bfloat16))
    tp = from_jax_lm_params(jp, cfg, device="cpu")
    f32 = {n for n, p in tp.named_parameters() if p.dtype == torch.float32}
    want = {"A_log", "D"} if cfg.mamba else {"w0", "u"}
    assert {n.split(".")[-1] for n in f32 if ".mixer." in n} == want
    built = transformer.Transformer(cfg, dtype=torch.bfloat16, device="meta")
    assert {n: p.dtype for n, p in built.named_parameters()} == \
        {n: p.dtype for n, p in tp.named_parameters()}
    back = to_numpy_lm_params(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert np.array_equal(a, np.asarray(b, np.float32))


def test_interop_rejects_a_pytree_of_another_config():
    jcfg, _ = cfgs("qwen2.5-3b")
    _, cfg = cfgs("gemma3-4b")
    jp = jax.tree.map(np.asarray,
                      jx_transformer.init_params(jax.random.PRNGKey(0), jcfg))
    with pytest.raises(ValueError, match="do not fit"):
        from_jax_lm_params(jp, cfg, device="cpu")


def test_decode_position_past_a_full_cache_raises():
    _, cfg = cfgs("qwen2.5-3b")
    model = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    caches = transformer.init_caches(cfg, 1, 4, dtype=torch.float32,
                                     device="cpu")
    with torch.inference_mode(), pytest.raises(ValueError, match="outside"):
        transformer.decode_step(model, caches, cfg,
                                token=torch.zeros((1, 1), dtype=torch.int32),
                                pos=4)


# -- the launcher and the example ----------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma3-4b",
                                  "deepseek-moe-16b", "deepseek-v3-671b"])
def test_serve_lm_gives_the_reference_loops_tokens(arch):
    """The launcher's loop on carried weights, bfloat16 caches (the
    default on both sides): the same greedy tokens, logits to BF16_TOL."""
    jcfg, cfg = cfgs(arch)
    jp, tp = carried(jcfg, cfg)
    prompts = np.random.default_rng(14).integers(0, cfg.vocab_size, (B, 36),
                                                 dtype=np.int32)
    s = serve_launcher.serve_lm(cfg, params=tp, prompts=prompts, new=6,
                                device="cpu")
    tokens, logits = reference_loop(jcfg, jp, prompts, 6)
    assert s["tokens"].dtype == np.int32 and s["tokens"].shape == (B, 6)
    assert np.array_equal(s["tokens"], tokens)
    close(s["logits"], logits, BF16_TOL)
    assert len(s["decode_step_seconds"]) == 5 and s["decode_tokens"] == 10
    assert (s["batch"], s["prompt_len"]) == (B, 36)


def test_serve_launcher_arch_path_on_the_cpu(quiet_logging):
    s = serve_launcher.main(["--arch", "gemma3-4b", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "8", "--new",
                             "3", "--log-level", "error"])
    assert s["arch"] == "gemma3-4b-reduced" and s["device"] == "cpu"
    assert s["tokens"].shape == (2, 3) and np.isfinite(s["logits"]).all()
    again = serve_launcher.serve_lm(reduced(get_arch("gemma3-4b")), batch=2,
                                    prompt_len=8, new=3, device="cpu")
    assert np.array_equal(again["tokens"], s["tokens"])
    with pytest.raises(SystemExit, match="encoder-only"):
        serve_launcher.main(["--arch", "hubert-xlarge", "--device", "cpu",
                             "--log-level", "error"])
    # jamba (Mamba, attention, MoE) with the launcher's own weights, held
    # to the reference's greedy loop on them
    jamba = serve_launcher.main(["--arch", "jamba-v0.1-52b", "--device",
                                 "cpu", "--batch", "2", "--prompt-len", "16",
                                 "--new", "3", "--log-level", "error"])
    assert jamba["arch"] == "jamba-v0.1-52b-reduced"
    jcfg, _ = cfgs("jamba-v0.1-52b")
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 16), dtype=np.int32)
    jp = jax.tree.map(jnp.asarray, to_numpy_lm_params(jamba["params"]))
    assert np.array_equal(jamba["tokens"],
                          reference_loop(jcfg, jp, prompts, 3)[0])


def test_example_arch_path_on_the_cpu(quiet_logging):
    path = EXAMPLES / "torch_serve_batched.py"
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    s = mod.main(["--arch", "pixtral-12b", "--device", "cpu", "--batch", "2",
                  "--prompt-len", "6", "--new", "4"])
    assert s["arch"] == "pixtral-12b-reduced" and s["tokens"].shape == (2, 4)
    jcfg, cfg = cfgs("gemma3-4b")
    jp, tp = carried(jcfg, cfg)
    prompts = np.random.default_rng(15).integers(0, cfg.vocab_size, (B, 8),
                                                 dtype=np.int32)
    got = mod.serve_lm_batched(cfg, params=tp, prompts=prompts, new=4,
                               device="cpu")
    assert np.array_equal(got["tokens"],
                          reference_loop(jcfg, jp, prompts, 4)[0])
