"""The sharded LM's other mixers against the reference's sharded LM, on
the CPU: MLA (reduced deepseek-v3-671b), Mamba (reduced jamba-v0.1-52b,
beside attention and MoE layers) and RWKV6 (reduced rwkv6-7b).

The reference runs on an ``Auto`` 2x2 mesh of four host devices in one
subprocess, the port in four ``gloo`` processes spawned once for the
file (``tests/_rendezvous.py``), both from the reference's initial state.
The port splits these three mixers over ``model`` where the reference's
specs split them (MLA and RWKV6 by heads, Mamba by ``d_inner``
channels), and every ``shard_logical`` inside their bodies checks that
split against the reference's ``pspec``.

  * the train step under ``tp_fsdp`` for 2 steps, batch 4 x 16: each
    step's loss and grad norm within 1e-5 x max(1, |ref|) of the
    reference's sharded step, and the params, m and v after them as
    ``_lm_parity`` holds the unsharded step;
  * decode under ``serve``: a 16-token prefill and 2 decode steps, the
    logits and the caches within 1e-5 x max(1, max|ref|) of the
    reference's sharded ones; MLA's also with its cache's sequence split
    over ``model`` (``cache_seq``, the distributed softmax);
  * the split is real: rank 0's FLOPs in one train step (counted by
    ``launch.comm_analysis.Recorder``) times 4 over one device's FLOPs in
    the same step lies below what a body replicated over ``model`` gives,
    and each mixer run with a body that gathers every weight raises at
    its first ``shard_logical``.
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
# MLA's decode also against a cache whose sequence is split over model
SEQ_ARCHS = ("deepseek-v3-671b",)
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
    if arch not in IN["seq_archs"]:
        continue
    ctx = ShardingCtx(mesh, make_rules("serve"))
    ctx.rules["cache_seq"] = ("model",)
    with use_sharding(ctx):
        logits, caches = jax.jit(lambda p, t: transformer.prefill(
            p, cfg, tokens=t, remat=False, cache_dtype=jnp.float32,
            max_len=S + n + 2))(state.params, toks[:, :S])
        out = [logits]
        for i in range(n):
            logits, caches = dec(state.params, caches,
                                 toks[:, S + i:S + i + 1], jnp.asarray(S + i))
            out.append(logits)
    OUT.setdefault("decode_seq", {})[arch] = {"logits": out,
                                              "caches": caches}
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
        "decode_steps": DECODE_STEPS, "seq_archs": SEQ_ARCHS})
    port = _rendezvous.run_ranks(_rendezvous.mixer_mesh_ranks, {
        "archs": ARCHS, "train_init": init, "train_batches": batches,
        "decode_tokens": toks, "decode_S": S,
        "decode_steps": DECODE_STEPS, "seq_archs": SEQ_ARCHS})
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
    _decode_within(port["decode"][arch], want["decode"][arch])


@pytest.mark.parametrize("arch", SEQ_ARCHS)
def test_decode_against_a_sequence_split_cache_matches_the_reference(
        sides, arch):
    """``cache_seq`` over ``model`` on both sides: the latent cache's
    positions split over the cards, attended with the distributed
    softmax."""
    want, port = sides
    got = port["decode_seq"][arch]
    assert got["seq_split"]
    _decode_within(got, want["decode_seq"][arch])


def _decode_within(got, ref):
    assert len(got["logits"]) == DECODE_STEPS + 1
    for g, w in zip(got["logits"], ref["logits"]):
        close(g, np.asarray(w))
    mine, theirs = jax.tree.leaves(got["caches"]), jax.tree.leaves(
        ref["caches"])
    assert len(mine) == len(theirs) > 0
    for g, w in zip(mine, theirs):
        close(g, np.asarray(w))


# Rank 0's train-step FLOPs on the 2x2 mesh x 4 over one device's, for a
# batch of 4 x 16 (``Recorder`` counts on the reduced shapes; one device
# counts 92,405,760 / 405,241,856 / 53,805,056).  A mixer replicated over
# ``model`` computes its whole data shard on both model cards, so its
# FLOPs count twice: rank 0 counted 34,275,328 / 159,629,312 / 21,659,648
# with the mixers replicated (this test's step on the tree before the
# split).  Split as the reference splits them, rank 0 counts 27,197,440 /
# 108,249,088 / 15,548,416: what stays above 1 is what the reference
# keeps whole over ``model`` too (MLA's down-projections and norms,
# RWKV's decay LoRA and mixes, attention's K/V in jamba where they do not
# split, the embedding and the norms) and the data-parallel copies of the
# router.
FLOPS_RATIO = {            # (split as the reference does, replicated)
    "deepseek-v3-671b": (1.1773, 1.4837),
    "jamba-v0.1-52b": (1.0685, 1.5756),
    "rwkv6-7b": (1.1559, 1.6102),
}


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_flops_show_the_mixers_split(sides, arch):
    mesh, one = sides[1]["flops"][arch]
    ratio = 4 * mesh / one
    split, replicated = FLOPS_RATIO[arch]
    assert ratio < replicated
    assert ratio == pytest.approx(split, rel=1e-3)


@pytest.mark.parametrize("kind", ["Attention", "MLA", "Mamba", "RWKV6"])
def test_a_body_run_whole_where_the_reference_splits_raises(sides, kind):
    msg = sides[1]["whole_raises"][kind]
    assert msg is not None and "shard_logical" in msg \
        and "split over model on []" in msg, msg
