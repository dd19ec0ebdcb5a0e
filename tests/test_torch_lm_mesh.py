"""The sharded LM against the reference's sharded LM, on the CPU: the
train step, decode, the leaf-by-leaf init, checkpoints across layouts,
faults and the launcher.

The reference runs on an ``Auto`` 2x2 mesh of four host devices in one
subprocess, its train step jitted with the shardings of its
``partitioning``, as its launcher runs it; the port in four ``gloo``
processes, spawned once for the file (``tests/_rendezvous.py``), from the
reference's initial state carried across by ``interop`` (``ctx=``).

  * the train step under ``tp_fsdp`` and ``dp_zero1`` for 3 steps on
    reduced qwen2.5-3b and reduced deepseek-moe-16b (capacity factor
    1.25, its drops decided per shard), batch 4 x 32: each step's loss
    and grad norm within 1e-5 x max(1, |ref|) of the reference's sharded
    step, and the params, m and v after 3 steps as ``_lm_parity`` holds
    the unsharded step; qwen's sharded run also against the port's own
    unsharded step;
  * decode under ``serve`` on reduced gemma3-4b (sliding and global
    layers, a 40-token prompt past the 32-token window, float32 caches):
    the prefill's and 3 decode steps' logits and the caches within 1e-5
    x max(1, max|ref|) of the reference's sharded ones;
  * reduced qwen2.5-3b with one KV head, which does not divide the
    ``model`` axis of 2 (the q heads split, K/V whole on every card):
    3 train steps under ``tp_fsdp``, and a 16-token prefill with 3 decode
    steps under ``serve``, once with the cache's sequence whole and once
    split over ``model`` (``cache_seq``, the distributed softmax; the
    steps cross the shards' boundary), each held to the reference's
    sharded run with the same rules;
  * ``partitioning.init_params`` equal to ``transformer.init_params``
    from the same generator, bit for bit;
  * a group of one (one gloo process, a (1, 1) mesh) equal to one
    device bit for bit, as the card's phase ``lm_mesh`` holds it, for
    reduced qwen2.5-3b and jamba-v0.1-52b;
  * a train state saved on 2x2 restores on one device, and the other way
    round, bit for bit;
  * faults: a failure on rank 1 after its backward makes every rank's
    step raise before its first write and ends the run with rank 1's
    error; one inside rank 1's forward, while the others wait in a
    collective, ends it too, within the spawn's time limit; a rollback
    of ``ResilientLoop`` on the mesh gives the bits of the run without
    the failed batch;
  * the launcher: ``--arch --mesh 2x2 --profile`` runs, honours the
    profile and trains the unsharded launcher's losses.
"""
import time

import jax
import numpy as np
import pytest

import _rendezvous
from _lm_parity import (close, near_zero_allowance, quiet_logging,
                        trees_within, within)
from repro.config import get_arch as jx_get_arch
from repro.config import reduced as jx_reduced
from repro.models import lm as jx_lm
from repro.models import transformer as jx_transformer
from repro_torch.dist.spmd import RankError
from repro_torch.launch import train as train_launcher

ARCHS = ("qwen2.5-3b", "deepseek-moe-16b")
PROFILES = ("tp_fsdp", "dp_zero1")
B, S, STEPS = 4, 32, 3
DECODE_ARCH, DECODE_S, DECODE_STEPS = "gemma3-4b", 40, 3
# the one-KV-head decode: 36 cache positions, 18 a card when the sequence
# splits over model, so steps at 16, 17 and 18 write into both shards
KV1_S, KV1_STEPS, KV1_MAX_LEN = 16, 3, 36


def _one_kv_head(cfg):
    import dataclasses
    return dataclasses.replace(cfg, attn=dataclasses.replace(
        cfg.attn, num_kv_heads=1))

_REFERENCE = """
from repro.models import lm, transformer
from repro.sharding import partitioning
OUT["train"] = {}
for arch in IN["archs"]:
    cfg = reduced(get_arch(arch))
    state = jax.tree.map(jnp.asarray, IN["init"][arch])
    OUT["train"][arch] = {}
    step = lm.make_train_step(cfg)
    batches = IN["batches"][arch]
    for profile in IN["profiles"]:
        ctx = ShardingCtx(mesh, make_rules(profile))
        with use_sharding(ctx):
            st_sh = partitioning.train_state_shardings(ctx, cfg)
            b_sh = partitioning.batch_shardings(ctx, {
                k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                for k, v in batches[0].items()})
            st = jax.device_put(state, st_sh)
            jstep = jax.jit(step, in_shardings=(st_sh, b_sh),
                            out_shardings=(st_sh, None))
            jgrad = jax.jit(lambda p, b: jax.grad(
                lambda p: lm.loss_fn(p, cfg, b)[0])(p))
            metrics, grads = [], []
            for b in batches:
                b = {k: jax.device_put(jnp.asarray(v), b_sh[k])
                     for k, v in b.items()}
                grads.append(jgrad(st.params, b))
                st, m = jstep(st, b)
                metrics.append(m)
        OUT["train"][arch][profile] = {"metrics": metrics, "state": st,
                                       "grads": grads}
cfg = reduced(get_arch(IN["decode_arch"]))
params = jax.tree.map(jnp.asarray, IN["decode_params"])
toks, S = jnp.asarray(IN["decode_tokens"]), IN["decode_S"]
with use_sharding(ShardingCtx(mesh, make_rules("serve"))):
    logits, caches = jax.jit(lambda p, t: transformer.prefill(
        p, cfg, tokens=t, remat=False, cache_dtype=jnp.float32,
        max_len=S + 4))(params, toks[:, :S])
    dec = jax.jit(lambda p, c, t, pos: transformer.decode_step(
        p, c, cfg, token=t, pos=pos))
    out = [logits]
    for i in range(IN["decode_steps"]):
        logits, caches = dec(params, caches, toks[:, S + i:S + i + 1],
                             jnp.asarray(S + i))
        out.append(logits)
OUT["decode"] = {"logits": out, "caches": caches}

# qwen2.5-3b with one KV head
kv1 = IN["kv1"]
cfg = reduced(get_arch("qwen2.5-3b"))
cfg = dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn,
                                                        num_kv_heads=1))
state = jax.tree.map(jnp.asarray, kv1["init"])
step = lm.make_train_step(cfg)
ctx = ShardingCtx(mesh, make_rules("tp_fsdp"))
with use_sharding(ctx):
    st_sh = partitioning.train_state_shardings(ctx, cfg)
    b_sh = partitioning.batch_shardings(ctx, {
        k: jax.ShapeDtypeStruct(v.shape, v.dtype)
        for k, v in kv1["batches"][0].items()})
    st = jax.device_put(state, st_sh)
    jstep = jax.jit(step, in_shardings=(st_sh, b_sh),
                    out_shardings=(st_sh, None))
    jgrad = jax.jit(lambda p, b: jax.grad(
        lambda p: lm.loss_fn(p, cfg, b)[0])(p))
    metrics, grads = [], []
    for b in kv1["batches"]:
        b = {k: jax.device_put(jnp.asarray(v), b_sh[k]) for k, v in b.items()}
        grads.append(jgrad(st.params, b))
        st, m = jstep(st, b)
        metrics.append(m)
OUT["kv1_train"] = {"metrics": metrics, "state": st, "grads": grads}
OUT["kv1_decode"] = {}
toks, S, n = jnp.asarray(kv1["tokens"]), kv1["S"], kv1["steps"]
for seq in ((), ("model",)):
    ctx = ShardingCtx(mesh, make_rules("serve"))
    ctx.rules["cache_seq"] = seq
    with use_sharding(ctx):
        logits, caches = jax.jit(lambda p, t: transformer.prefill(
            p, cfg, tokens=t, remat=False, cache_dtype=jnp.float32,
            max_len=kv1["max_len"]))(state.params, toks[:, :S])
        dec = jax.jit(lambda p, c, t, pos: transformer.decode_step(
            p, c, cfg, token=t, pos=pos))
        out = [logits]
        for i in range(n):
            logits, caches = dec(state.params, caches,
                                 toks[:, S + i:S + i + 1], jnp.asarray(S + i))
            out.append(logits)
    OUT["kv1_decode"]["_".join(seq) or "whole"] = {"logits": out,
                                                   "caches": caches}
"""


def _batches(cfg, rng, n):
    out = []
    for _ in range(n):
        tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
        labels = np.roll(tokens, -1, 1)
        labels[:, -1] = -1
        out.append({"tokens": tokens, "labels": labels})
    return out


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    rng = np.random.default_rng(0)
    batches = {a: _batches(jx_reduced(jx_get_arch(a)), rng, 5)
               for a in ARCHS}
    dcfg = jx_reduced(jx_get_arch(DECODE_ARCH))
    toks = rng.integers(0, dcfg.vocab_size, (B, DECODE_S + DECODE_STEPS),
                        dtype=np.int32)
    init = {a: jax.tree.map(np.asarray, jax.jit(
        jx_lm.init_train_state, static_argnums=1)(
        jax.random.PRNGKey(0), jx_reduced(jx_get_arch(a)))) for a in ARCHS}
    dparams = jax.tree.map(np.asarray, jax.jit(
        jx_transformer.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), dcfg))
    kcfg = _one_kv_head(jx_reduced(jx_get_arch("qwen2.5-3b")))
    kv1 = {"init": jax.tree.map(np.asarray, jax.jit(
               jx_lm.init_train_state, static_argnums=1)(
               jax.random.PRNGKey(1), kcfg)),
           "batches": _batches(kcfg, rng, STEPS),
           "tokens": rng.integers(0, kcfg.vocab_size,
                                  (B, KV1_S + KV1_STEPS), dtype=np.int32),
           "S": KV1_S, "steps": KV1_STEPS, "max_len": KV1_MAX_LEN}
    ref = _rendezvous.Reference(_REFERENCE, {
        "archs": ARCHS, "profiles": PROFILES, "init": init,
        "batches": {a: b[:STEPS] for a, b in batches.items()},
        "decode_arch": DECODE_ARCH, "decode_tokens": toks,
        "decode_params": dparams, "decode_S": DECODE_S,
        "decode_steps": DECODE_STEPS, "kv1": kv1})
    inputs = {"train_init": init,
              "train_batches": batches, "train_steps": STEPS,
              "train_profiles": PROFILES,
              "unsharded": ("qwen2.5-3b",),
              "decode_arch": DECODE_ARCH, "decode_tokens": toks,
              "decode_S": DECODE_S, "decode_steps": DECODE_STEPS,
              "decode_params": dparams,
              "init_archs": ARCHS, "kv1": kv1,
              "ckpt_dir": str(tmp_path_factory.mktemp("mesh_ckpt"))}
    port = _rendezvous.run_ranks(_rendezvous.lm_mesh_ranks, inputs)
    return inputs, ref.result(), port


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference_sharded_step(sides, arch,
                                                       profile):
    _, want, port = sides
    ref = want["train"][arch][profile]
    metrics, state = port["train"][(arch, profile)]
    lrs = []
    for got, m in zip(metrics, ref["metrics"]):
        for k in ("loss", "ce", "aux", "grad_norm"):
            within(got[k], m[k])
        assert got["lr"] == float(m["lr"])
        lrs.append(got["lr"])
    params, (step, m, v) = state
    assert int(step) == STEPS == int(ref["state"].opt.step)
    trees_within(m, ref["state"].opt.m)
    trees_within(v, ref["state"].opt.v)
    trees_within(params, ref["state"].params,
                 near_zero_allowance(lrs, ref["grads"]))
    if (arch, None) in port["train"]:
        one, one_state = port["train"][(arch, None)]
        for got, m1 in zip(metrics, one):
            for k in ("loss", "grad_norm"):
                within(got[k], m1[k])
        trees_within(state[1][1], one_state[1][1])


def _train_within(got, ref):
    """The port's (metrics, state) against the reference's sharded run,
    as ``test_train_step_matches_the_reference_sharded_step`` holds it."""
    metrics, (params, (step, m, v)) = got
    lrs = []
    for g, r in zip(metrics, ref["metrics"]):
        for k in ("loss", "ce", "aux", "grad_norm"):
            within(g[k], r[k])
        assert g["lr"] == float(r["lr"])
        lrs.append(g["lr"])
    assert int(step) == STEPS == int(ref["state"].opt.step)
    trees_within(m, ref["state"].opt.m)
    trees_within(v, ref["state"].opt.v)
    trees_within(params, ref["state"].params,
                 near_zero_allowance(lrs, ref["grads"]))


def test_one_kv_head_train_step_matches_the_reference(sides):
    """q heads split over model, K/V whole on every card."""
    _, want, port = sides
    _train_within(port["kv1_train"], want["kv1_train"])


@pytest.mark.parametrize("cache_seq", [(), ("model",)])
def test_one_kv_head_decode_matches_the_reference(sides, cache_seq):
    _, want, port = sides
    got = port["kv1_decode"][cache_seq]
    ref = want["kv1_decode"]["_".join(cache_seq) or "whole"]
    assert got["seq_split"] == bool(cache_seq)
    assert len(got["logits"]) == KV1_STEPS + 1
    for g, w in zip(got["logits"], ref["logits"]):
        close(g, np.asarray(w))
    mine, theirs = jax.tree.leaves(got["caches"]), jax.tree.leaves(
        ref["caches"])
    assert len(mine) == len(theirs) > 0
    for g, w in zip(mine, theirs):
        close(g, np.asarray(w))


def test_decode_matches_the_reference_sharded_decode(sides):
    _, want, port = sides
    got = port["decode"]
    assert len(got["logits"]) == DECODE_STEPS + 1
    for g, w in zip(got["logits"], want["decode"]["logits"]):
        close(g, np.asarray(w))
    ref = jax.tree.leaves(want["decode"]["caches"])
    mine = jax.tree.leaves(got["caches"])
    assert len(mine) == len(ref) > 0
    for g, w in zip(mine, ref):
        close(g, np.asarray(w))


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_by_leaf_init_equals_init_params(sides, arch):
    assert sides[2]["init"][arch]


def test_a_group_of_one_keeps_the_single_device_bits():
    """The card test's group of one on a gloo group: reduced qwen2.5-3b
    and jamba-v0.1-52b on a (1, 1) mesh under ``serve`` and ``tp_fsdp``
    against the same weights unsharded, the leaf-by-leaf init, a prefill
    and 4 decode steps' logits and 3 train steps' losses, bit for bit.
    (jamba's decode differed until its Mamba step made ``u`` contiguous:
    ``torch.matmul`` folds a 3-d operand into one mm when the weight
    requires grad, as a whole model's parameters do under
    ``inference_mode``, and otherwise, for a transposed operand, runs
    bmm; a mesh's local weights do not require grad there.)"""
    got = _rendezvous.run_ranks(_rendezvous.group_of_one,
                                ("qwen2.5-3b", "jamba-v0.1-52b"), "cpu",
                                n=1)
    assert got and all(got.values()), got


def test_checkpoints_restore_across_layouts_bit_for_bit(sides):
    port = sides[2]
    assert port["ckpt_mesh_to_one"] and port["ckpt_one_to_mesh"]


def test_rollback_on_the_mesh_gives_the_run_without_the_failed_batch(
        sides):
    same, failures, steps_done = sides[2]["rollback"]
    assert failures == [1, 1, 1, 1] and steps_done == 4
    assert same


@pytest.mark.parametrize("where", ["after_backward", "forward"])
def test_a_fault_on_one_rank_ends_the_group_with_its_error(sides, where):
    t0 = time.monotonic()
    with pytest.raises(RankError, match="simulated fault on rank 1") as e:
        _rendezvous.run_ranks(_rendezvous.fault_ranks, sides[0], where)
    assert e.value.rank == 1
    assert time.monotonic() - t0 < _rendezvous.RANK_TIMEOUT


def test_launcher_arch_mesh_honours_the_profile(tmp_path, quiet_logging):
    args = ["--arch", "qwen2.5-3b", "--device", "cpu", "--steps", "2",
            "--batch", "4", "--seq", "16", "--log-level", "error"]
    r = train_launcher.main(args + ["--mesh", "2x2", "--profile",
                                    "dp_zero1", "--ckpt-dir",
                                    str(tmp_path / "mesh")])
    assert r["mesh"] == "2x2" and r["profile"] == "dp_zero1"
    assert len(r["peak_memory_bytes_per_rank"]) == 4
    one = train_launcher.main(args + ["--ckpt-dir", str(tmp_path / "one")])
    assert r["steps_done"] == one["steps_done"] == 2
    for a, b in zip(r["losses"], one["losses"]):
        within(a, b)
