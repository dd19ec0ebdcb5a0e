"""The port's dry run against the reference's accounting, on ``meta``
tensors under ``fake`` process groups (``launch/dryrun.py``,
``launch/cells.py``, ``launch/comm_analysis.py``,
``dist.mesh.make_production_mesh``).

A process has one default group, so each group size runs in a
subprocess of its own, all started at once when the file's first test
asks (each with its own time limit):
  * 256 and 512 ranks: ``build_cell`` on the production meshes, (16, 16)
    and (2, 16, 16), for every step kind and default profile (``tp_fsdp``,
    ``serve``, ``serve_ep2d``) over qwen2.5-3b, deepseek-v3-671b,
    jamba-v0.1-52b, rwkv6-7b and hubert-xlarge: every leaf's global shape
    and rank 0's shard shape and dtype equal the reference's
    ``NamedSharding(AbstractMesh(...), spec).shard_shape`` (its stacked
    layer axis unrolled: the port keeps a leaf a layer), and the argument
    bytes equal the reference's sum of shard bytes exactly;
  * 256 ranks, in the same subprocess: the recorder on the c10d and the
    functional collectives of every kind the port issues, at group sizes
    2, 4 and 16, equals the reference's ``analyze_collectives`` of the
    same HLO kind by kind; and a mesh of the wrong size raises;
  * 4 ranks: reduced qwen2.5-3b's train step on a 2x2 mesh under
    ``tp_fsdp`` and ``dp_zero1``, traced on a ``cpu``-typed and on a
    ``cuda``-typed mesh (where DTensor issues an all-to-all, not the
    ``cpu`` fallback's all-gathers): both records equal;
  * the same step run for real on four ``gloo`` ranks
    (``tests/_rendezvous.py``, one spawn) equals the ``meta`` trace in
    rank 0's collective events (in order), FLOPs and argument bytes; and
    rank 0's FLOPs x 4 equal one device's (the step traced with no
    context) exactly;
  * one production cell, qwen2.5-3b x ``decode_32k`` at 256 ranks,
    through the CLI (``python -m repro_torch.launch.dryrun``), ends
    ``ok`` and its record makes a roofline row.
"""
import json
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap
from collections import Counter

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, AxisType

import _rendezvous
from repro.config import SHAPES_BY_NAME as JX_SHAPES
from repro.config import get_arch as jx_get_arch
from repro.launch import cells as jx_cells
from repro.launch import hlo_analysis as jx_hlo
from repro.sharding import context as jx_ctx
from repro_torch.config import ShapeConfig, get_arch, reduced
from repro_torch.launch import cells, roofline

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
# seconds a subprocess may take: each takes under 20 s alone
TIMEOUT = 400

CELLS = [("qwen2.5-3b", "train_4k"), ("qwen2.5-3b", "prefill_32k"),
         ("qwen2.5-3b", "decode_32k"), ("deepseek-v3-671b", "train_4k"),
         ("deepseek-v3-671b", "prefill_32k"),
         ("deepseek-v3-671b", "decode_32k"), ("jamba-v0.1-52b", "train_4k"),
         ("jamba-v0.1-52b", "long_500k"), ("rwkv6-7b", "decode_32k"),
         ("rwkv6-7b", "long_500k"), ("hubert-xlarge", "prefill_32k"),
         ("hubert-xlarge", "train_4k")]
MESHES = {256: ((16, 16), ("data", "model")),
          512: ((2, 16, 16), ("pod", "data", "model"))}
PROFILES = ("tp_fsdp", "dp_zero1")
SMALL = ShapeConfig("small", 32, 4, "train")
GROUPS = (2, 4, 16)
# the kinds the port issues (it has no collective-permute)
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")

_PRELUDE = """
import pickle, sys
import torch
import torch.distributed as dist
from repro_torch.config import SHAPES_BY_NAME, ShapeConfig, get_arch, reduced
from repro_torch.dist.mesh import make_production_mesh
from repro_torch.launch import cells, dryrun
from repro_torch.launch.comm_analysis import Recorder, tensors_of
from repro_torch.sharding.context import ShardingCtx, make_rules
with open(sys.argv[1], "rb") as f:
    IN = pickle.load(f)
OUT = {}
dryrun.init_fake_group(IN["world"])


def raised(fn):
    try:
        fn()
    except Exception as e:
        return f"{type(e).__name__}: {e}"
    return None


def leaves(prog):
    out = []
    for t in tensors_of(prog.args):
        local = getattr(t, "_local_tensor", t)
        assert local.device.type == "meta"
        out.append((tuple(t.shape), tuple(local.shape),
                    str(t.dtype).replace("torch.", "")))
    return out
"""

_PRODUCTION = """
mesh = make_production_mesh(multi_pod=IN["world"] == 512)
OUT["cells"] = {}
for arch, shape in IN["cells"]:
    cfg, sh = get_arch(arch), SHAPES_BY_NAME[shape]
    ctx = ShardingCtx(mesh, make_rules(cells.default_profile(cfg, sh)))
    cells.tune_cache_rules(ctx, cfg, sh)
    prog = cells.build_cell(cfg, sh, ctx)
    OUT["cells"][(arch, shape)] = {"kind": prog.kind, "leaves": leaves(prog),
                                   "bytes": cells._bytes(prog.args)}
OUT["wrong_mesh"] = raised(lambda: make_production_mesh(
    multi_pod=IN["world"] == 256))
OUT["wrong_group"] = raised(lambda: dryrun.init_fake_group(8))
if IN["world"] == 256:
    from torch.distributed import _functional_collectives as funcol
    from repro_torch.sharding import collectives
    OUT["kinds"] = {}
    for n in IN["groups"]:
        g = dist.new_group(list(range(n)))
        full = torch.empty(16, 8, device="meta")
        part = torch.empty(16 // n, 8, device="meta")
        calls = {
            "all-reduce": [lambda: dist.all_reduce(full, group=g),
                           lambda: funcol.all_reduce(full, "sum", g)],
            "all-gather": [
                lambda: collectives._all_gather(
                    torch.empty(16 * n, 8, device="meta"), full, group=g),
                lambda: funcol.all_gather_tensor(full, 0, g)],
            "reduce-scatter": [
                lambda: collectives._reduce_scatter(part, full, group=g),
                lambda: funcol.reduce_scatter_tensor(full, "sum", 0, g)],
            "all-to-all": [
                lambda: dist.all_to_all_single(
                    torch.empty(16, 8, device="meta"), full, group=g),
                lambda: funcol.all_to_all_single(full, None, None, g)],
        }
        for kind, fns in calls.items():
            for api, fn in enumerate(fns):
                with Recorder("meta") as rec:
                    fn()
                OUT["kinds"][(kind, n, api)] = (
                    {f: dict(getattr(rec.stats, f)) for f in
                     ("payload_bytes", "wire_bytes", "count")},
                    list(rec.events))
"""

_SMALL = """
cfg = reduced(get_arch("qwen2.5-3b"))
shape = ShapeConfig("small", 32, 4, "train")
OUT["wrong_mesh"] = raised(lambda: make_production_mesh())
OUT["traces"] = {}
for kind in ("cpu", "cuda"):
    mesh = torch.distributed.device_mesh.init_device_mesh(
        kind, (2, 2), mesh_dim_names=("data", "model"))
    for profile in IN["profiles"]:
        prog = cells.build_cell(cfg, shape, ShardingCtx(
            mesh, make_rules(profile)))
        tr = prog.trace()
        OUT["traces"][(kind, profile)] = {
            "events": list(tr.events), "flops": tr.flops,
            "argument_bytes": tr.argument_bytes,
            "output_bytes": tr.output_bytes, "peak_bytes": tr.peak_bytes,
            "leaves": leaves(prog)}
"""

_EPILOGUE = """
with open(sys.argv[2], "wb") as f:
    pickle.dump(OUT, f)
"""


class _Port:
    """The port's script in a subprocess of its own (a fake group of
    ``inputs["world"]`` ranks); ``result()`` waits for its ``OUT``."""

    def __init__(self, script: str, inputs):
        d = tempfile.mkdtemp(prefix="repro_dryrun_")
        self._in, self._out = os.path.join(d, "in.pkl"), \
            os.path.join(d, "out.pkl")
        with open(self._in, "wb") as f:
            pickle.dump(inputs, f)
        self._proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(
                _PRELUDE + script + _EPILOGUE), self._in, self._out],
            env=dict(os.environ, PYTHONPATH=SRC), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def result(self):
        try:
            out, err = self._proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.communicate()
            raise AssertionError(f"the subprocess took more than {TIMEOUT} s")
        assert self._proc.returncode == 0, \
            f"the port's subprocess failed\nSTDERR:\n{err[-6000:]}"
        with open(self._out, "rb") as f:
            return pickle.load(f)


class _Cli:
    """``python -m repro_torch.launch.dryrun`` on one production cell."""

    def __init__(self):
        self.path = os.path.join(tempfile.mkdtemp(prefix="repro_dryrun_"),
                                 "dry.jsonl")
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "qwen2.5-3b", "--shape", "decode_32k", "--out", self.path,
             "--log-level", "error"],
            env=dict(os.environ, PYTHONPATH=SRC), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def result(self):
        try:
            out, err = self._proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.communicate()
            raise AssertionError(f"the dry run took more than {TIMEOUT} s")
        assert self._proc.returncode == 0, err[-6000:]
        return out


def _batch():
    rng = np.random.default_rng(0)
    cfg = reduced(get_arch("qwen2.5-3b"))
    toks = rng.integers(0, cfg.vocab_size, (SMALL.global_batch,
                                            SMALL.seq_len + 1),
                        dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def runs():
    """Every subprocess and the gloo ranks, started at once."""
    port = {256: _Port(_PRODUCTION, {"world": 256, "cells": CELLS,
                                     "groups": GROUPS}),
            512: _Port(_PRODUCTION, {"world": 512, "cells": CELLS}),
            4: _Port(_SMALL, {"world": 4, "profiles": PROFILES})}
    cli = _Cli()
    real = _rendezvous.run_ranks(_rendezvous.dryrun_ranks,
                                 {"profiles": PROFILES, "batch": _batch()})
    return {"real": real, "cli": cli, **{k: v.result()
                                         for k, v in port.items()}}


# ------------------------------------------------------- the reference side
def _reference_leaves(arch, shape, devices):
    """Each argument leaf of the reference's cell as (global shape, shard
    shape, dtype), its stacked layer axis unrolled; and the sum of its
    shard bytes."""
    sizes, names = MESHES[devices]
    mesh = AbstractMesh(sizes, names, axis_types=(AxisType.Auto,) * len(sizes))
    cfg, sh = jx_get_arch(arch), JX_SHAPES[shape]
    ctx = jx_ctx.ShardingCtx(mesh, jx_ctx.make_rules(
        jx_cells.default_profile(cfg, sh)))
    jx_cells.tune_cache_rules(ctx, cfg, sh)
    with jx_ctx.use_sharding(ctx):
        prog = jx_cells.build_cell(cfg, sh, ctx)
    flat = jax.tree_util.tree_flatten_with_path(prog.args)[0]
    shardings = jax.tree.leaves(prog.in_shardings)
    assert len(flat) == len(shardings)
    out, nbytes = [], 0
    for (path, leaf), s in zip(flat, shardings):
        local = s.shard_shape(leaf.shape)
        nbytes += int(np.prod(local)) * leaf.dtype.itemsize
        stacked = any(getattr(k, "key", None) == "stages" for k in path) or (
            prog.kind == "serve_step" and path[0].idx == 1)
        row = (tuple(leaf.shape), tuple(local), str(leaf.dtype))
        if stacked:
            assert local[0] == leaf.shape[0]
            out += [(row[0][1:], row[1][1:], row[2])] * leaf.shape[0]
        else:
            out.append(row)
    return prog.kind, out, nbytes


@pytest.mark.parametrize("devices", sorted(MESHES))
@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
def test_build_cell_shards_match_the_reference(runs, cell, devices):
    got = runs[devices]["cells"][cell]
    kind, want, nbytes = _reference_leaves(*cell, devices)
    assert got["kind"] == kind
    assert Counter(got["leaves"]) == Counter(want)
    assert got["bytes"] == nbytes


def test_production_mesh_refuses_another_group_size(runs):
    assert "needs a default process group of 512 ranks, this one has " \
        "256" in runs[256]["wrong_mesh"]
    assert "of 256 ranks, this one has 512" in runs[512]["wrong_mesh"]
    assert "of 256 ranks, this one has 4" in runs[4]["wrong_mesh"]
    assert "trace each mesh in its own process" in runs[256]["wrong_group"]


def _kind_hlo(kind, n):
    out = {"all-gather": f"f32[{16 * n},8]",
           "reduce-scatter": f"f32[{16 // n},8]"}.get(kind, "f32[16,8]")
    return f"""
HloModule k, num_partitions={n}

ENTRY %main (a: f32[16,8]) -> {out} {{
  %a = f32[16,8]{{1,0}} parameter(0)
  ROOT %c = {out}{{1,0}} {kind}(%a), replica_groups=[1,{n}]<=[{n}]
}}
"""


@pytest.mark.parametrize("n", GROUPS)
@pytest.mark.parametrize("kind", KINDS)
def test_recorded_collectives_match_the_reference_hlo(runs, kind, n):
    want = jx_hlo.analyze_collectives(_kind_hlo(kind, n))
    for api in (0, 1):      # the c10d op, the functional op
        stats, events = runs[256]["kinds"][(kind, n, api)]
        for f in ("payload_bytes", "wire_bytes", "count"):
            assert stats[f] == {k: v for k, v in getattr(want, f).items()
                                if v}, (api, f)
        assert [(e.kind, e.group_size, e.intra_node) for e in events] == \
            [(kind, n, n <= 8)]


def test_cpu_and_cuda_typed_meshes_give_one_record(runs):
    t = runs[4]["traces"]
    for profile in PROFILES:
        cpu, cuda = t[("cpu", profile)], t[("cuda", profile)]
        assert cpu == cuda, profile
        kinds = Counter(e.kind for e in cpu["events"])
        assert kinds["all-gather"] and kinds["all-reduce"], kinds
    # tp_fsdp's Shard->Shard redistribute is an all-to-all on both
    assert any(e.kind == "all-to-all" for e in t[("cpu", "tp_fsdp")]["events"])


def test_meta_trace_equals_the_real_gloo_run(runs):
    for profile in PROFILES:
        meta = runs[4]["traces"][("cpu", profile)]
        real = runs["real"][profile]
        assert real["events"] == meta["events"], profile
        assert real["flops"] == meta["flops"], profile
        assert real["argument_bytes"] == meta["argument_bytes"], profile


def test_rank_flops_times_four_equal_one_device(runs):
    one = cells.build_cell(reduced(get_arch("qwen2.5-3b")), SMALL, None)
    tr = one.trace()
    assert tr.events == [] and tr.flops > 0
    for profile in PROFILES:
        assert runs[4]["traces"][("cpu", profile)]["flops"] * 4 == tr.flops


def test_one_production_cell_ends_ok_through_the_cli(runs):
    printed = [json.loads(line) for line in runs["cli"].result().splitlines()]
    with open(runs["cli"].path) as f:
        rec = json.loads(f.readline())
    assert printed == [{k: v for k, v in rec.items() if k != "traceback"}]
    assert rec["status"] == "ok", rec.get("error")
    assert (rec["arch"], rec["shape"], rec["devices"], rec["profile"],
            rec["step_kind"]) == ("qwen2.5-3b", "decode_32k", 256, "serve",
                                  "serve_step")
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    assert rec["cost"]["flops"] > 0 and rec["collectives"]["counts"]
    row = roofline.load_rows(runs["cli"].path)[0]
    assert row.counted_over_analytic == pytest.approx(
        rec["cost"]["flops"] / rec["cost"]["analytic_flops"])
