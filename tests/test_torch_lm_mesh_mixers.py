"""The sharded LM's other mixers against the reference's sharded LM, on
the CPU: MLA (reduced deepseek-v3-671b), Mamba (reduced jamba-v0.1-52b,
beside attention and MoE layers) and RWKV6 (reduced rwkv6-7b).

The reference runs on an ``Auto`` 2x2 mesh of four host devices in one
subprocess, the port in four ``gloo`` processes spawned once for the
file (``tests/_rendezvous.py``), both from the reference's initial state.
The port runs these three mixers replicated over ``model``
(``sharding.context.run_replicated``), where the reference splits them;
the results are the same.

  * the train step under ``tp_fsdp`` for 2 steps, batch 4 x 16: each
    step's loss and grad norm within 1e-5 x max(1, |ref|) of the
    reference's sharded step, and the params, m and v after them as
    ``_lm_parity`` holds the unsharded step;
  * decode under ``serve``: a 16-token prefill and 2 decode steps, the
    logits and the caches within 1e-5 x max(1, max|ref|) of the
    reference's sharded ones.
"""
import jax
import numpy as np
import pytest

import _rendezvous
from _lm_parity import close, near_zero_allowance, trees_within, within
from repro.config import get_arch as jx_get_arch
from repro.config import reduced as jx_reduced
from repro.models import lm as jx_lm

ARCHS = ("deepseek-v3-671b", "jamba-v0.1-52b", "rwkv6-7b")
B, S, STEPS, DECODE_STEPS = 4, 16, 2, 2

_REFERENCE = """
from repro.models import lm, transformer
from repro.sharding import partitioning
OUT["train"], OUT["decode"] = {}, {}
S, n = IN["decode_S"], IN["decode_steps"]
for arch in IN["archs"]:
    cfg = reduced(get_arch(arch))
    state = jax.tree.map(jnp.asarray, IN["init"][arch])
    step = lm.make_train_step(cfg)
    ctx = ShardingCtx(mesh, make_rules("tp_fsdp"))
    with use_sharding(ctx):
        st_sh = partitioning.train_state_shardings(ctx, cfg)
        b_sh = partitioning.batch_shardings(ctx, {
            k: jax.ShapeDtypeStruct(v.shape, v.dtype)
            for k, v in IN["batches"][arch][0].items()})
        st = jax.device_put(state, st_sh)
        jstep = jax.jit(step, in_shardings=(st_sh, b_sh),
                        out_shardings=(st_sh, None))
        jgrad = jax.jit(lambda p, b: jax.grad(
            lambda p: lm.loss_fn(p, cfg, b)[0])(p))
        metrics, grads = [], []
        for b in IN["batches"][arch]:
            b = {k: jax.device_put(jnp.asarray(v), b_sh[k])
                 for k, v in b.items()}
            grads.append(jgrad(st.params, b))
            st, m = jstep(st, b)
            metrics.append(m)
    OUT["train"][arch] = {"metrics": metrics, "state": st, "grads": grads}
    toks = jnp.asarray(IN["decode_tokens"][arch])
    with use_sharding(ShardingCtx(mesh, make_rules("serve"))):
        logits, caches = jax.jit(lambda p, t: transformer.prefill(
            p, cfg, tokens=t, remat=False, cache_dtype=jnp.float32,
            max_len=S + n + 1))(state.params, toks[:, :S])
        dec = jax.jit(lambda p, c, t, pos: transformer.decode_step(
            p, c, cfg, token=t, pos=pos))
        out = [logits]
        for i in range(n):
            logits, caches = dec(state.params, caches,
                                 toks[:, S + i:S + i + 1], jnp.asarray(S + i))
            out.append(logits)
    OUT["decode"][arch] = {"logits": out, "caches": caches}
"""


@pytest.fixture(scope="module")
def sides():
    rng = np.random.default_rng(0)
    init, batches, toks = {}, {}, {}
    for a in ARCHS:
        cfg = jx_reduced(jx_get_arch(a))
        init[a] = jax.tree.map(np.asarray, jax.jit(
            jx_lm.init_train_state, static_argnums=1)(
            jax.random.PRNGKey(0), cfg))
        batches[a] = []
        for _ in range(STEPS):
            tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
            labels = np.roll(tokens, -1, 1)
            labels[:, -1] = -1
            batches[a].append({"tokens": tokens, "labels": labels})
        toks[a] = rng.integers(0, cfg.vocab_size, (B, S + DECODE_STEPS),
                               dtype=np.int32)
    ref = _rendezvous.Reference(_REFERENCE, {
        "archs": ARCHS, "init": init, "batches": batches,
        "decode_tokens": toks, "decode_S": S,
        "decode_steps": DECODE_STEPS})
    port = _rendezvous.run_ranks(_rendezvous.mixer_mesh_ranks, {
        "archs": ARCHS, "train_init": init, "train_batches": batches,
        "decode_tokens": toks, "decode_S": S,
        "decode_steps": DECODE_STEPS})
    return ref.result(), port


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference_sharded_step(sides, arch):
    want, port = sides
    ref = want["train"][arch]
    metrics, (params, (step, m, v)) = port["train"][arch]
    lrs = []
    for got, r in zip(metrics, ref["metrics"]):
        for k in ("loss", "ce", "aux", "grad_norm"):
            within(got[k], r[k])
        assert got["lr"] == float(r["lr"])
        lrs.append(got["lr"])
    assert int(step) == STEPS == int(ref["state"].opt.step)
    trees_within(m, ref["state"].opt.m)
    trees_within(v, ref["state"].opt.v)
    trees_within(params, ref["state"].params,
                 near_zero_allowance(lrs, ref["grads"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_the_reference_sharded_decode(sides, arch):
    want, port = sides
    got, ref = port["decode"][arch], want["decode"][arch]
    assert len(got["logits"]) == DECODE_STEPS + 1
    for g, w in zip(got["logits"], ref["logits"]):
        close(g, np.asarray(w))
    mine, theirs = jax.tree.leaves(got["caches"]), jax.tree.leaves(
        ref["caches"])
    assert len(mine) == len(theirs) > 0
    for g, w in zip(mine, theirs):
        close(g, np.asarray(w))
