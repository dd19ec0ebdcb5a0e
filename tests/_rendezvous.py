"""The processes of the mesh tests.

A barrier across processes for the mesh tests: ``AtOnce`` wraps a shard
call (a module-level function, named so that it pickles by reference to
the unpatched module) and makes each call wait until ``parties`` calls
have arrived, each leaving a file named by its process id in
``directory``.  Calls that run one after another time out at the first.

The reference side runs in one subprocess per test file: it gives JAX four
host devices (``--xla_force_host_platform_device_count=4``, set before
JAX is imported), builds the 2x2 (``data``, ``model``) mesh with ``Auto``
axes (JAX 0.9's ``jax.make_mesh`` makes ``Explicit`` ones, on which the
reference's ``with_sharding_constraint`` refuses to run), enters it with
``jax.set_mesh`` and runs a script that fills ``OUT``, which is pickled
to a file this module reads back (``Reference``).

The port side runs its checks in four ``gloo`` processes, spawned once
per test file (``repro_torch.dist.spmd``): the rank functions below
import torch and the port only, and return host objects.

Every spawn and every subprocess has its own time limit.
"""

import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap
import time
import uuid
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist import spmd


class AtOnce:
    def __init__(self, directory, parties: int, module: str, name: str,
                 timeout: float = 20.0):
        self.directory, self.parties = str(directory), parties
        self.module, self.name, self.timeout = module, name, timeout

    def __call__(self, *args):
        Path(self.directory, f"{os.getpid()}-{uuid.uuid4().hex}").touch()
        deadline = time.monotonic() + self.timeout
        while len(os.listdir(self.directory)) < self.parties:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{self.name}: {len(os.listdir(
                    self.directory))} of {self.parties} calls arrived")
            time.sleep(0.01)
        return getattr(importlib.import_module(self.module), self.name)(*args)

    def pids(self):
        return {int(f.split("-")[0]) for f in os.listdir(self.directory)}


# ------------------------------------------------ the sharded LM's tests
# seconds a reference subprocess, and a spawn of the port's ranks, may
# take: each file's takes under 40 s alone, up to 4x that beside five
# other test workers on eight cores; a hang costs no more than this
REF_TIMEOUT = 400
RANK_TIMEOUT = 400

_PRELUDE = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro.config import get_arch, reduced
from repro.sharding.context import ShardingCtx, make_rules, use_sharding
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
jax.set_mesh(mesh)
with open(sys.argv[1], "rb") as f:
    IN = pickle.load(f)
OUT = {}
"""

_EPILOGUE = """
with open(sys.argv[2], "wb") as f:
    pickle.dump(jax.tree.map(np.asarray, OUT), f)
"""


class Reference:
    """The reference's script running in its subprocess; ``result()``
    waits for it (within ``REF_TIMEOUT``) and returns its ``OUT``."""

    def __init__(self, script: str, inputs=None):
        self._dir = tempfile.mkdtemp(prefix="repro_ref_")
        self._in = os.path.join(self._dir, "in.pkl")
        self._out = os.path.join(self._dir, "out.pkl")
        with open(self._in, "wb") as f:
            pickle.dump(inputs or {}, f)
        src = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "src")
        env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
        self._proc = subprocess.Popen(
            [sys.executable, "-c", _PRELUDE + textwrap.dedent(script)
             + _EPILOGUE, self._in, self._out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    def result(self):
        try:
            out, err = self._proc.communicate(timeout=REF_TIMEOUT)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.communicate()
            raise AssertionError(f"the reference's subprocess took more "
                                 f"than {REF_TIMEOUT} s")
        assert self._proc.returncode == 0, \
            f"reference failed\nSTDOUT:\n{out}\nSTDERR:\n{err[-6000:]}"
        with open(self._out, "rb") as f:
            return pickle.load(f)


def run_ranks(fn, *args, n: int = 4):
    """``fn(rank, *args)`` on ``n`` gloo processes; rank 0's result."""
    return spmd.run(fn, n, *args, device="cpu", timeout=RANK_TIMEOUT,
                    threads=1)


def nccl_rules():
    """Make this rank's explicit collectives refuse what NCCL refuses and
    gloo takes: a tensor that is not contiguous."""
    from repro_torch.sharding import collectives

    def strict(fn):
        def call(*args, **kw):
            if any(isinstance(a, torch.Tensor) and not a.is_contiguous()
                   for a in args):
                raise ValueError("Tensors must be contiguous")
            return fn(*args, **kw)
        return call

    dist.all_reduce = strict(dist.all_reduce)
    collectives._all_gather = strict(collectives._all_gather)
    collectives._reduce_scatter = strict(collectives._reduce_scatter)


def _mesh_ctx(profile: str, shape=(2, 2)):
    from repro_torch.dist.mesh import make_test_mesh
    from repro_torch.sharding.context import ShardingCtx, make_rules
    return ShardingCtx(make_test_mesh(shape), make_rules(profile))


def _gather(obj):
    """Every rank's ``obj``, on every rank."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _numpy(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------- the MoE
def moe_cfg(capacity_factor=1.25):
    import dataclasses
    from repro_torch.config import get_arch, reduced
    cfg = reduced(get_arch("deepseek-moe-16b"))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))


def _moe_layer(cfg, leaves):
    from repro_torch.models.layers import moe
    layer = moe.MoE(cfg, device="meta").to_empty(device="cpu")
    with torch.no_grad():
        for name, a in leaves.items():
            layer.get_parameter(name).copy_(torch.from_numpy(a))
    return layer


def moe_case(ctx, cfg, leaves, x, r):
    """The MoE of ``leaves`` laid out under ``ctx`` on ``x``: (out, aux,
    the grads of sum(out x r), this rank's recorded routing)."""
    from repro_torch.models.layers import moe
    from repro_torch.sharding import partitioning
    from repro_torch.sharding.context import lay_out, mesh_ops, use_sharding
    layer = _moe_layer(cfg, leaves)
    specs = moe.specs(cfg)
    flat = {"shared." + k: v for k, v in specs.pop("shared", {}).items()}
    flat.update(specs)
    for name, p in list(layer.named_parameters()):
        partitioning._swap_params(layer, {name: partitioning.shard_tensor(
            ctx, p, ctx.placements(flat[name], p.shape))})
    with use_sharding(ctx), mesh_ops(), \
            moe.recorded_routes(layer) as routes:
        xs = lay_out(torch.from_numpy(x), ("batch", None, None))
        out, aux = layer(xs, cfg)
        loss = (out * torch.from_numpy(r)).sum()
        names, params = zip(*layer.named_parameters())
        grads = torch.autograd.grad(loss, params)
    return (_numpy(out), float(_numpy(aux)),
            {n: _numpy(g) for n, g in zip(names, grads)},
            [{k: (v.numpy() if isinstance(v, torch.Tensor) else v)
              for k, v in rec.items() if k != "layer"} for rec in routes])


def sharded_ranks(rank, inputs):
    """Every port-side check of ``test_torch_sharded.py``."""
    nccl_rules()
    from repro_torch.optim.compression import compressed_psum
    out = {"moe": {}}
    cfg = moe_cfg()
    for name, profile in inputs["moe_cases"]:
        ctx = _mesh_ctx(profile)
        got, aux, grads, routes = moe_case(
            ctx, cfg, inputs["moe_leaves"], inputs["moe_x"][name],
            inputs["moe_r"][name])
        out["moe"][name] = {"out": got, "aux": aux, "grads": grads,
                            "routes": _gather(routes)}
    control = inputs.get("moe_f32_control")
    if control:
        # the float8 case with its dispatch left in float32
        from repro_torch.models.layers import moe
        f8, moe.F8_TOKENS = moe.F8_TOKENS, 1 << 62
        try:
            got, _, grads, _ = moe_case(
                _mesh_ctx("ep2d"), cfg, inputs["moe_leaves"],
                inputs["moe_x"][control], inputs["moe_r"][control])
        finally:
            moe.F8_TOKENS = f8
        out["moe_f32_control"] = {"out": got, "grads": grads}
    out["psum"] = compressed_psum(
        torch.from_numpy(inputs["psum_x"][rank])).numpy()
    return out


def moe_route_check(rank, leaves, x):
    """``moe.apply`` under ``tp_fsdp`` on a (1, 2) mesh: which route it
    took and its output."""
    from repro_torch.models.layers import moe
    calls = []
    for route in ("_apply_sharded", "_apply_ep2d"):
        fn = getattr(moe, route)

        def counted(*a, _fn=fn, _name=route):
            calls.append(_name)
            return _fn(*a)
        setattr(moe, route, counted)
    cfg = moe_cfg(capacity_factor=8.0)
    ctx = _mesh_ctx("tp_fsdp", (1, 2))
    got, _, _, _ = moe_case(ctx, cfg, leaves, x, np.ones_like(x))
    return calls, got


# ------------------------------------------------------ the sharded LM
def _batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _train(ctx, cfg, np_state, batches, dev="cpu"):
    """3 steps of the train step from ``np_state`` (the reference's
    layout), under ``ctx`` (None: one device): each step's metrics and
    the final state in the reference's layout."""
    from repro_torch.interop import from_jax_train_state, \
        to_numpy_train_state
    from repro_torch.models import lm
    from repro_torch.sharding.context import use_sharding
    state = from_jax_train_state(np_state, cfg, dev, ctx=ctx)
    step = lm.make_train_step(cfg)
    metrics = []
    with use_sharding(ctx):
        for b in batches:
            _, m = step(state, _batch(b))
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, to_numpy_train_state(state, cfg)


def one_kv_head(cfg):
    """``cfg`` with a single KV head: KV heads that do not divide a model
    axis of 2 (the reference's K/V then stay whole over ``model``)."""
    import dataclasses
    return dataclasses.replace(cfg, attn=dataclasses.replace(
        cfg.attn, num_kv_heads=1))


def _decode_run(cfg, ctx, np_params, toks, S, steps, max_len):
    """Prefill ``toks[:, :S]`` and ``steps`` decode steps under ``ctx``:
    the logits, the caches (the reference's layout) and whether the first
    full attention cache's sequence is split over ``model``."""
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.interop import from_jax_lm_params, to_numpy_lm_caches
    from repro_torch.models import transformer
    from repro_torch.sharding.context import use_sharding
    params = from_jax_lm_params(np_params, cfg, "cpu", ctx)
    toks = torch.from_numpy(toks)
    logits = []
    with use_sharding(ctx), torch.inference_mode():
        lg, caches = transformer.prefill(params, cfg, tokens=toks[:, :S],
                                         max_len=max_len,
                                         cache_dtype=torch.float32)
        logits.append(_numpy(lg))
        for i in range(steps):
            lg, caches = transformer.decode_step(
                params, caches, cfg, token=toks[:, S + i:S + i + 1],
                pos=S + i)
            logits.append(_numpy(lg))
    k = next(c["mixer"].get("k", c["mixer"].get("ckv")) for c in caches
             if {"k", "ckv"} & set(c["mixer"]))
    names = list(ctx.axis_sizes)
    split = isinstance(k, DTensor) and k.placements[
        names.index("model")] == Shard(1)
    return {"logits": logits, "caches": to_numpy_lm_caches(caches, cfg),
            "seq_split": split}


def _same(a, b) -> bool:
    return all(np.array_equal(x, y, equal_nan=True) for x, y in zip(
        torch.utils._pytree.tree_leaves(a),
        torch.utils._pytree.tree_leaves(b)))


def lm_mesh_ranks(rank, inputs):
    """Every port-side check of ``test_torch_lm_mesh.py`` but the faults
    and the launcher."""
    nccl_rules()
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.config import get_arch, reduced
    from repro_torch.interop import (from_jax_lm_params, to_numpy_lm_caches,
                                     to_numpy_train_state)
    from repro_torch.models import lm, transformer
    from repro_torch.optim import adam
    from repro_torch.runtime.fault_tolerance import LoopConfig, \
        ResilientLoop
    from repro_torch.sharding import partitioning
    from repro_torch.sharding.context import use_sharding
    out = {"train": {}, "init": {}}
    for arch, np_state in inputs["train_init"].items():
        cfg = reduced(get_arch(arch))
        batches = inputs["train_batches"][arch][:inputs["train_steps"]]
        for profile in inputs["train_profiles"]:
            out["train"][(arch, profile)] = _train(
                _mesh_ctx(profile), cfg, np_state, batches)
        if rank == 0 and arch in inputs["unsharded"]:
            out["train"][(arch, None)] = _train(None, cfg, np_state,
                                                batches)

    # decode under serve
    cfg = reduced(get_arch(inputs["decode_arch"]))
    ctx = _mesh_ctx("serve")
    toks, S = torch.from_numpy(inputs["decode_tokens"]), inputs["decode_S"]
    params = from_jax_lm_params(inputs["decode_params"], cfg, "cpu", ctx)
    logits = []
    with use_sharding(ctx), torch.inference_mode():
        lg, caches = transformer.prefill(params, cfg, tokens=toks[:, :S],
                                         max_len=S + 4,
                                         cache_dtype=torch.float32)
        logits.append(_numpy(lg))
        for i in range(inputs["decode_steps"]):
            lg, caches = transformer.decode_step(
                params, caches, cfg, token=toks[:, S + i:S + i + 1],
                pos=S + i)
            logits.append(_numpy(lg))
        out["decode"] = {"logits": logits,
                         "caches": to_numpy_lm_caches(caches, cfg)}

    # qwen2.5-3b with one KV head: trained under tp_fsdp, decoded under
    # serve with the cache's sequence whole and split over model
    kv1 = inputs.get("kv1")
    if kv1:
        cfg = one_kv_head(reduced(get_arch("qwen2.5-3b")))
        out["kv1_train"] = _train(_mesh_ctx("tp_fsdp"), cfg, kv1["init"],
                                  kv1["batches"])
        out["kv1_decode"] = {}
        for seq in ((), ("model",)):
            ctx = _mesh_ctx("serve")
            ctx.rules["cache_seq"] = seq
            out["kv1_decode"][seq] = _decode_run(
                cfg, ctx, kv1["init"].params, kv1["tokens"], kv1["S"],
                kv1["steps"], kv1["max_len"])

    # leaf-by-leaf init against init_params, bit for bit
    for arch in inputs["init_archs"]:
        cfg = reduced(get_arch(arch))
        gen = torch.Generator().manual_seed(7) if rank == 0 else None
        model = partitioning.init_params(_mesh_ctx("tp_fsdp"), gen, cfg,
                                         device="cpu")
        got = {n: _numpy(p) for n, p in model.named_parameters()}
        want = transformer.init_params(torch.Generator().manual_seed(7), cfg,
                                       device="cpu")
        out["init"][arch] = all(np.array_equal(got[n], _numpy(p))
                                for n, p in want.named_parameters())

    # checkpoints across layouts, bit for bit
    cfg = reduced(get_arch("qwen2.5-3b"))
    ctx = _mesh_ctx("tp_fsdp")
    mesh = ctx.torch_mesh
    ckdir = inputs["ckpt_dir"]
    sharded = partitioning.init_train_state(
        ctx, torch.Generator().manual_seed(1) if rank == 0 else None, cfg,
        device="cpu")
    with torch.no_grad():
        for t in sharded.opt.m.values():
            t.to_local().normal_(generator=torch.Generator().manual_seed(
                rank))
    Checkpointer(f"{ckdir}/a", mesh=mesh).save(1, sharded, blocking=True)
    want_a = to_numpy_train_state(sharded, cfg)
    dist.barrier()
    if rank == 0:
        whole = lm.init_train_state(torch.Generator().manual_seed(2), cfg,
                                    device="cpu")
        Checkpointer(f"{ckdir}/a").restore(1, whole)
        out["ckpt_mesh_to_one"] = _same(to_numpy_train_state(whole, cfg),
                                        want_a)
        Checkpointer(f"{ckdir}/b").save(3, whole, blocking=True)
        want_b = to_numpy_train_state(whole, cfg)
    dist.barrier()
    Checkpointer(f"{ckdir}/b", mesh=mesh).restore(3, sharded)
    got_b = to_numpy_train_state(sharded, cfg)
    if rank == 0:
        out["ckpt_one_to_mesh"] = _same(got_b, want_b)

    # a rollback of ResilientLoop on the mesh: rank 1 fails once after its
    # backward; every rank rolls back to the checkpoint of step 2 and goes
    # on with the next batch
    batches = [_batch(b) for b in inputs["train_batches"]["qwen2.5-3b"]]
    np_state = inputs["train_init"]["qwen2.5-3b"]
    clip = adam.clip_by_global_norm
    calls = {"n": 0}

    def flaky(g, max_norm, **kw):
        calls["n"] += 1
        if rank == 1 and calls["n"] == 3:
            raise RuntimeError("simulated fault on rank 1")
        return clip(g, max_norm, **kw)

    adam.clip_by_global_norm = flaky
    try:
        from repro_torch.interop import from_jax_train_state
        state = from_jax_train_state(np_state, cfg, "cpu", ctx=ctx)
        loop = ResilientLoop(lm.make_train_step(cfg),
                             Checkpointer(f"{ckdir}/c", keep=2, mesh=mesh),
                             LoopConfig(checkpoint_every=2, max_steps=4))
        with use_sharding(ctx):
            loop.run(state, iter(batches))
    finally:
        adam.clip_by_global_norm = clip
    got = to_numpy_train_state(state, cfg)
    state = from_jax_train_state(np_state, cfg, "cpu", ctx=ctx)
    step = lm.make_train_step(cfg)
    with use_sharding(ctx):
        for b in batches[:2] + batches[3:5]:
            step(state, b)
    want = to_numpy_train_state(state, cfg)
    out["rollback"] = (_same(got, want), _gather(len(loop.stats.failures)),
                       loop.stats.steps_done)
    return out


def mixer_mesh_ranks(rank, inputs):
    """Every port-side check of ``test_torch_lm_mesh_mixers.py``: for each
    arch, the train step under ``tp_fsdp`` and decode under ``serve``."""
    nccl_rules()
    from repro_torch.config import get_arch, reduced
    from repro_torch.interop import from_jax_lm_params, to_numpy_lm_caches
    from repro_torch.models import transformer
    from repro_torch.sharding.context import use_sharding
    out = {"train": {}, "decode": {}}
    S, steps = inputs["decode_S"], inputs["decode_steps"]
    for arch in inputs["archs"]:
        cfg = reduced(get_arch(arch))
        out["train"][arch] = _train(_mesh_ctx("tp_fsdp"), cfg,
                                    inputs["train_init"][arch],
                                    inputs["train_batches"][arch])
        ctx = _mesh_ctx("serve")
        toks = torch.from_numpy(inputs["decode_tokens"][arch])
        params = from_jax_lm_params(inputs["train_init"][arch].params, cfg,
                                    "cpu", ctx)
        logits = []
        with use_sharding(ctx), torch.inference_mode():
            lg, caches = transformer.prefill(
                params, cfg, tokens=toks[:, :S], max_len=S + steps + 1,
                cache_dtype=torch.float32)
            logits.append(_numpy(lg))
            for i in range(steps):
                lg, caches = transformer.decode_step(
                    params, caches, cfg, token=toks[:, S + i:S + i + 1],
                    pos=S + i)
                logits.append(_numpy(lg))
            out["decode"][arch] = {"logits": logits,
                                   "caches": to_numpy_lm_caches(caches, cfg)}
        if arch in inputs.get("seq_archs", ()):
            ctx = _mesh_ctx("serve")
            ctx.rules["cache_seq"] = ("model",)
            out.setdefault("decode_seq", {})[arch] = _decode_run(
                cfg, ctx, inputs["train_init"][arch].params,
                inputs["decode_tokens"][arch], S, steps, S + steps + 2)
        out.setdefault("flops", {})[arch] = _step_flops(
            rank, cfg, inputs["train_init"][arch],
            inputs["train_batches"][arch][0])
        out.setdefault("whole_raises", {}).update(
            _whole_bodies_raise(cfg, params))
    return out


def _step_flops(rank, cfg, np_state, batch):
    """(rank 0's FLOPs in one train step on the 2x2 mesh under
    ``tp_fsdp``, one device's in the same step), counted by
    ``comm_analysis.Recorder`` (``CellProgram.trace``)."""
    from repro_torch.interop import from_jax_train_state
    from repro_torch.launch.cells import CellProgram
    from repro_torch.models import lm
    from repro_torch.sharding import partitioning
    ctx = _mesh_ctx("tp_fsdp")
    state = from_jax_train_state(np_state, cfg, "cpu", ctx=ctx)
    mesh = CellProgram("train_step", lm.make_train_step(cfg),
                       (state, partitioning.shard_batch(ctx, _batch(batch))),
                       None, None, ctx=ctx).trace().flops
    if rank:
        return mesh, None
    one = CellProgram("train_step", lm.make_train_step(cfg),
                      (from_jax_train_state(np_state, cfg, "cpu"),
                       _batch(batch)), None, None).trace().flops
    return mesh, one


def _whole_bodies_raise(cfg, params):
    """Each mixer of ``params`` (laid out under ``serve``) run with a body
    that gathers every weight (``split_model=False``), where the
    reference splits it: the error each raises ({kind: message}), or
    None where one runs."""
    from repro_torch.models.layers import attention, mamba, mla, rwkv
    from repro_torch.sharding import context
    from repro_torch.sharding.context import lay_out, use_sharding
    ctx = _mesh_ctx("serve")
    x = torch.randn((4, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(3))
    out = {}
    seen = set()
    for layer in params.layers:
        mixer = layer.mixer
        kind = type(mixer).__name__
        if kind in seen:
            continue
        seen.add(kind)
        mod = {"Attention": attention, "MLA": mla, "Mamba": mamba,
               "RWKV6": rwkv}[kind]
        real = context.local_body

        def whole(*a, **kw):
            return real(*a, **dict(kw, split_model=False))
        mod.local_body = whole
        try:
            with use_sharding(ctx), torch.inference_mode():
                mixer(lay_out(x, ("batch", None, None)))
            out[kind] = None
        except ValueError as e:
            out[kind] = str(e)
        finally:
            mod.local_body = real
    return out


def fault_ranks(rank, inputs, where):
    """A fault on rank 1 only, ``where``: "after_backward" (every rank's
    step raises before its first write, and each checks that its state is
    as it was; then rank 1 raises its error) or "forward" (rank 1 raises
    inside the forward while the others wait in a collective)."""
    from repro_torch.config import get_arch, reduced
    from repro_torch.interop import from_jax_train_state
    from repro_torch.models import lm
    from repro_torch.models.layers import attention
    from repro_torch.optim import adam
    from repro_torch.sharding.context import use_sharding
    cfg = reduced(get_arch("qwen2.5-3b"))
    ctx = _mesh_ctx("tp_fsdp")
    state = from_jax_train_state(inputs["train_init"]["qwen2.5-3b"], cfg,
                                 "cpu", ctx=ctx)
    batch = _batch(inputs["train_batches"]["qwen2.5-3b"][0])
    snap = [t.to_local().clone() for t in list(state.params.parameters())
            + list(state.opt.m.values()) + list(state.opt.v.values())]
    step0 = int(state.opt.step)
    if rank == 1 and where == "after_backward":
        def failing(g, max_norm, **kw):
            raise RuntimeError("simulated fault on rank 1")
        adam.clip_by_global_norm = failing
    if rank == 1 and where == "forward":
        def failing(*a, **k):
            raise RuntimeError("simulated fault on rank 1")
        attention.apply_train = failing
    step = lm.make_train_step(cfg)
    if where == "forward" and rank == 1:
        with use_sharding(ctx):
            step(state, batch)
    err = None
    try:
        with use_sharding(ctx):
            step(state, batch)
    except RuntimeError as e:
        err = e
    assert err is not None, "the step did not raise on this rank"
    now = [t.to_local() for t in list(state.params.parameters())
           + list(state.opt.m.values()) + list(state.opt.v.values())]
    assert int(state.opt.step) == step0
    assert all(torch.equal(a, b) for a, b in zip(snap, now)), \
        "the state was written"
    dist.barrier()
    if rank == 1:
        raise err
    return str(err)


def group_of_one(rank, archs, device):
    """Each of ``archs`` (or one arch) at ``reduced()`` size on a (1, 1) mesh of this
    group of one against the same weights unsharded: init, prefill, 4
    decode steps and 3 train steps; which of them are equal bit for
    bit."""
    out = {}
    for arch in (archs,) if isinstance(archs, str) else archs:
        out.update({f"{arch} {k}": v for k, v in
                    _group_of_one(arch, device).items()})
    return out


def _group_of_one(arch, device):
    from repro_torch.config import get_arch, reduced
    from repro_torch.models import lm, transformer
    from repro_torch.sharding import partitioning
    from repro_torch.sharding.context import use_sharding
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_arch(arch))
    out = {}
    for profile in ("serve", "tp_fsdp"):
        ctx = _mesh_ctx(profile, (1, 1))
        whole = lm.init_train_state(
            torch.Generator(device=device).manual_seed(0), cfg,
            device=device)
        mesh = partitioning.init_train_state(
            ctx, torch.Generator(device=device).manual_seed(0), cfg,
            device=device)
        out[f"{profile} init"] = all(torch.equal(p, q.to_local()) for p, q
                                     in zip(whole.params.parameters(),
                                            mesh.params.parameters()))
        toks = torch.randint(0, cfg.vocab_size, (4, 40), device=device,
                             generator=torch.Generator(
                                 device=device).manual_seed(1))
        got = {}
        for name, st, c in (("whole", whole, None), ("mesh", mesh, ctx)):
            logits = []
            with use_sharding(c), torch.inference_mode():
                lg, caches = transformer.prefill(
                    st.params, cfg, tokens=toks[:, :32], max_len=40,
                    cache_dtype=torch.float32)
                logits.append(_numpy(lg))
                for i in range(4):
                    lg, caches = transformer.decode_step(
                        st.params, caches, cfg,
                        token=toks[:, 32 + i:33 + i], pos=32 + i)
                    logits.append(_numpy(lg))
            step = lm.make_train_step(cfg)
            with use_sharding(c):
                losses = [float(step(st, {"tokens": toks[:, :32],
                                          "labels": toks[:, 1:33].long()})
                                [1]["loss"]) for _ in range(3)]
            got[name] = (logits, losses)
        out[f"{profile} logits"] = all(np.array_equal(a, b) for a, b in zip(
            got["whole"][0], got["mesh"][0]))
        out[f"{profile} losses"] = got["whole"][1] == got["mesh"][1]
    return out


# ----------------------------------------------------------- the dry run
def dryrun_ranks(rank, inputs):
    """``test_torch_dryrun.py``'s real run: reduced qwen2.5-3b's train
    step on the 2x2 mesh of four gloo ranks under each profile, traced by
    ``comm_analysis.Recorder`` through ``CellProgram.trace`` (rank 0's
    collective events in order, FLOPs, argument bytes), from a state
    drawn on rank 0 and a batch every rank holds whole."""
    from repro_torch.config import get_arch, reduced
    from repro_torch.launch.cells import CellProgram
    from repro_torch.models import lm
    from repro_torch.sharding import partitioning
    cfg = reduced(get_arch("qwen2.5-3b"))
    out = {}
    for profile in inputs["profiles"]:
        ctx = _mesh_ctx(profile)
        gen = torch.Generator().manual_seed(0) if rank == 0 else None
        state = partitioning.init_train_state(
            ctx, gen, cfg, torch.bfloat16, torch.float32, device="cpu")
        batch = partitioning.shard_batch(ctx, _batch(inputs["batch"]))
        tr = CellProgram("train_step", lm.make_train_step(cfg),
                         (state, batch), None, None, ctx=ctx).trace()
        out[profile] = {"events": list(tr.events), "flops": tr.flops,
                        "argument_bytes": tr.argument_bytes}
    return out
