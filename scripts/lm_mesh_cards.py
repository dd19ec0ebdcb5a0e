#!/usr/bin/env python3
"""The sharded LM on four cards of one host, held against one card.

    python3 scripts/lm_mesh_cards.py          # needs four visible cards

  train    qwen2.5-3b whole (full width and depth, batch 4 x 256, 6
           steps, remat, float32, TF32 off) through ``launch.train --arch
           qwen2.5-3b --full-config --mesh 2x2`` under ``--profile
           tp_fsdp`` and ``dp_zero1``: each step's loss against the
           one-card run of the same seed within 1e-5 x max(1, |ref|), the
           median step ms, trained tokens/s, each card's peak memory and
           the final save's seconds; then one profiled step of each
           profile (device ms, launches, the collectives' share of the
           device time)
  serve    gemma3-27b whole (108 GB of float32: no card holds it) under
           ``serve`` on a 1x4 mesh, built leaf by leaf: a 2048-token
           prefill at batch 1 and decode steps at batches 1 and 4, each
           step's ms beside its bound per card (the parameter bytes over
           4 x 3.35 TB/s), launches, device ms, idle share and each
           card's peak memory; and a float64 check at full width, 2
           layers (one sliding, one global), prefill and 4 decode steps,
           against one card's float64 run within 1e-5 x max(1, |ref|)
  moe      deepseek-moe-16b whole (65.5 GB: it fits one card) at capacity
           factor 1.25: a one-card prefill and 8 decode steps, then the
           same decode from that prefill's caches under ``serve`` on 1x4
           (``_apply_sharded``) and ``ep2d`` on 2x2 (``_apply_ep2d``):
           logits within 1e-5 x max(1, |ref|), the routing choice for
           choice with each layer's smallest gate margin; and each
           route's own prefill's dropped (token, choice) pairs
  mixers   the bodies split over ``model`` as the reference splits them:
           rwkv6-7b at full width and 4 layers trained on 2x2 under
           ``tp_fsdp`` (losses within 1e-5 x max(1, |ref|) of one
           card's); jamba-v0.1-52b's first 8 layers (Mamba, attention,
           MoE) served on 1x4 under ``serve``, deepseek-v3-671b at depth 2
           (MLA) on 1x4 under ``serve_ep2d``, and qwen2.5-3b whole on 1x4
           with ``cache_seq`` over ``model`` (2 KV heads on 4 cards: the
           distributed softmax), each a prefill into float32 caches and
           8 decode steps fed one card's greedy tokens: logits within 1e-5 x max(1,
           max|ref|) and the greedy tokens equal; step ms and peak
           memory a card beside one card's (one spawn of four ranks for
           the four)

Each check prints one JSON line (also written to
``chiprun_out/lm_mesh_cards.jsonl``); then the cards' names and power
limits as nvidia-smi gives them, and last ``{"ok": ...}``.  Exits nonzero
when a check fails or fewer than four cards are visible.  ``--device
cpu --reduced`` rehearses it on four host processes at ``reduced()``
size.  Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
TOL = 1e-5
PEAK_BYTES = 3.35e12        # one H100's HBM rate, bytes/s
TRAIN = dict(batch=4, seq=256, steps=6)
SERVE_PROMPT, SERVE_STEPS = 2048, 8
MOE_PROMPT, MOE_STEPS, MOE_BATCH = 64, 8, 4
F64_PROMPT, F64_STEPS = 64, 4
# the split mixers: (arch, layers (None: all), mesh, profile, cache_seq),
# prompt and cache lengths (full size, reduced); the qwen cache's shards
# of 128 (8 reduced) positions put its decode steps across a boundary
MIXER_SERVE = (("jamba-v0.1-52b", 8, (1, 4), "serve", ()),
               ("deepseek-v3-671b", 2, (1, 4), "serve_ep2d", ()),
               ("qwen2.5-3b", None, (1, 4), "serve", ("model",)))
MIXER_PROMPT = {"jamba-v0.1-52b": (256, 32), "deepseek-v3-671b": (256, 32),
                "qwen2.5-3b": (252, 28)}
MIXER_MAX_LEN = {"qwen2.5-3b": (512, 64)}
MIXER_BATCH, MIXER_STEPS = 2, 8
MIXER_TRAIN = dict(arch="rwkv6-7b", layers=4, batch=4, seq=256, steps=3)
OUT = ROOT / "chiprun_out" / "lm_mesh_cards.jsonl"
RESULTS = []


def emit(check: str, **rec) -> None:
    line = json.dumps({"check": check, **rec})
    RESULTS.append(line)
    print(line, flush=True)


def rel_err(got, want) -> float:
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(
        np.abs(want).max()))


def arch(name: str, reduced: bool):
    from repro_torch.config import get_arch
    from repro_torch.config import reduced as small
    cfg = get_arch(name)
    return small(cfg) if reduced else cfg


def cut(cfg, kinds):
    return dataclasses.replace(cfg, num_layers=len(kinds),
                               stages=tuple((1, (k,)) for k in kinds))


def sync(device: str):
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def timed(fn, device: str, reps: int):
    """Median ms of ``reps`` calls of ``fn``, each ended by a sync."""
    out = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def profiled(fn, device: str):
    """(device ms, launches, collective device ms) of one call of
    ``fn`` by the profiler: kernels whose name holds ``nccl`` are the
    collectives."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if device != "cuda":
        fn()
        return None, None, None
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync(device)
    total, launches, coll = 0.0, 0, 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            total += us / 1e3
            launches += e.count
            if "nccl" in e.key.lower():
                coll += us / 1e3
    return total, launches, coll


def peak(device: str):
    import torch
    return torch.cuda.max_memory_allocated() if device == "cuda" else None


def gather(obj):
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def mesh_ctx(shape, profile: str):
    from repro_torch.dist.mesh import make_test_mesh
    from repro_torch.sharding.context import ShardingCtx, make_rules
    return ShardingCtx(make_test_mesh(shape), make_rules(profile))


def gen(device: str, rank: int = 0):
    import torch
    return torch.Generator(device=device).manual_seed(SEED) \
        if rank == 0 else None


# ------------------------------------------------------------------ train
def profile_train_rank(rank, reduced, profile, device):
    """One profiled train step of qwen2.5-3b on the 2x2 mesh (after two
    warm ones), on every rank; rank 0's numbers with every rank's."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    from repro_torch.sharding import partitioning
    from repro_torch.sharding.context import use_sharding
    cfg = arch("qwen2.5-3b", reduced)
    ctx = mesh_ctx((2, 2), profile)
    state = partitioning.init_train_state(ctx, gen(device, rank), cfg,
                                          device=device)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        TRAIN["batch"], TRAIN["seq"]), dtype=np.int32)).to(device)
    batch = {"tokens": toks, "labels": toks.long()}
    step = lm.make_train_step(cfg, total_steps=TRAIN["steps"])
    with use_sharding(ctx):
        for _ in range(2):
            float(step(state, batch)[1]["loss"])
        ms = timed(lambda: float(step(state, batch)[1]["loss"]), device, 1)
        dev_ms, launches, coll = profiled(
            lambda: float(step(state, batch)[1]["loss"]), device)
    return gather({"rank": rank, "step_ms": ms, "device_ms": dev_ms,
                   "launches": launches, "collective_ms": coll,
                   "peak_memory_bytes": peak(device)})


def check_train(reduced: bool, device: str):
    from repro_torch.dist import spmd
    from repro_torch.launch import train as launcher
    args = ["--arch", "qwen2.5-3b", "--steps", str(TRAIN["steps"]),
            "--batch", str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]),
            "--device", device, "--log-level", "error"]
    if not reduced:
        args.append("--full-config")
    ok = True
    t0 = time.perf_counter()
    with ckpt_dir() as d:
        one = launcher.main(args + ["--ckpt-dir", d])
    emit("train", mesh="1 card", seconds=time.perf_counter() - t0,
         **{k: one[k] for k in ("losses", "median_step_ms",
                                "tokens_per_s", "peak_memory_bytes",
                                "save_seconds", "save_bytes")})
    _free(device)
    for profile in ("tp_fsdp", "dp_zero1"):
        t0 = time.perf_counter()
        with ckpt_dir() as d:
            r = launcher.main(args + ["--mesh", "2x2", "--profile",
                                      profile, "--ckpt-dir", d])
        seconds = time.perf_counter() - t0
        errs = [rel_err(a, b) for a, b in zip(r["losses"],
                                              one["losses"])]
        prof = spmd.run(profile_train_rank, 4, reduced, profile, device,
                        device=device, timeout=1800)
        good = len(errs) == TRAIN["steps"] and max(errs) <= TOL
        ok &= good
        r0 = prof[0]
        emit("train", mesh="2x2", profile=profile, ok=good,
             losses=r["losses"], one_card_losses=one["losses"],
             loss_rel_errs=errs, median_step_ms=r["median_step_ms"],
             one_card_median_step_ms=one["median_step_ms"],
             tokens_per_s=r["tokens_per_s"],
             one_card_tokens_per_s=one["tokens_per_s"],
             peak_memory_bytes_per_card=r[
                 "peak_memory_bytes_per_rank"],
             save_seconds=r["save_seconds"], save_bytes=r["save_bytes"],
             profiled_step_ms=r0["step_ms"],
             device_ms=r0["device_ms"], launches=r0["launches"],
             collective_ms=r0["collective_ms"],
             collective_share=(r0["collective_ms"] / r0["device_ms"]
                               if r0["device_ms"] else None),
             device_ms_per_card=[p["device_ms"] for p in prof],
             seconds=seconds)
    return ok


def ckpt_dir():
    """A fresh checkpoint directory, removed after: under ``build/``
    beside the checkout (gitignored) when it has room for qwen2.5-3b's
    37 GB state, else in the temp dir."""
    import shutil
    base = ROOT / "build"
    base.mkdir(exist_ok=True)
    if shutil.disk_usage(base).free < 45e9:
        base = Path(tempfile.gettempdir())
    return tempfile.TemporaryDirectory(dir=base, prefix="lm_mesh_ckpt_")


def _free(device):
    import gc
    import torch
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ serve
def serve_rank(rank, reduced, device):
    """gemma3-27b under ``serve`` on 1x4: prefill and decode timings."""
    import numpy as np
    import torch
    from repro_torch.models import counting, transformer
    from repro_torch.sharding import partitioning
    from repro_torch.sharding.context import use_sharding
    cfg = arch("gemma3-27b", reduced)
    ctx = mesh_ctx((1, 4), "serve")
    t0 = time.perf_counter()
    params = partitioning.init_params(ctx, gen(device, rank), cfg,
                                      device=device)
    sync(device)
    init_s = time.perf_counter() - t0
    n_params = counting.count_params(cfg)
    rng = np.random.default_rng(SEED)
    out = {"rank": rank, "init_seconds": init_s}
    with torch.inference_mode(), use_sharding(ctx):
        for b in (1, 4):
            toks = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (b, SERVE_PROMPT + SERVE_STEPS),
                dtype=np.int32)).to(device)
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            lg, caches = transformer.prefill(
                params, cfg, tokens=toks[:, :SERVE_PROMPT],
                max_len=SERVE_PROMPT + SERVE_STEPS + 2)
            sync(device)
            prefill_ms = (time.perf_counter() - t0) * 1e3
            steps = []
            for i in range(SERVE_STEPS):
                pos = SERVE_PROMPT + i
                steps.append(timed(lambda: transformer.decode_step(
                    params, caches, cfg, token=toks[:, pos:pos + 1],
                    pos=pos), device, 1))
            pos = SERVE_PROMPT + SERVE_STEPS
            dev_ms, launches, coll = profiled(
                lambda: transformer.decode_step(
                    params, caches, cfg, token=toks[:, -1:], pos=pos),
                device)
            step_ms = statistics.median(steps)
            out[f"batch{b}"] = {
                "prefill_tokens": b * SERVE_PROMPT,
                "prefill_ms_first_call": prefill_ms,
                "decode_step_ms": step_ms, "decode_step_ms_all": steps,
                "decode_tokens_per_s": b / step_ms * 1e3,
                "bound_ms_per_card": 4 * n_params / 4 / PEAK_BYTES * 1e3,
                "device_ms": dev_ms, "launches": launches,
                "collective_ms": coll,
                "idle_share": (max(0.0, 1 - dev_ms / step_ms)
                               if dev_ms else None),
                "peak_memory_bytes": peak(device)}
            del caches, lg
            _free(device)
    return gather(out)


def f64_rank(rank, reduced, device, toks):
    """gemma3-27b at full width, one sliding and one global layer, in
    float64 on 1x4: the prefill's and decode steps' logits."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.sharding import partitioning
    from repro_torch.sharding.context import use_sharding
    cfg = f64_cfg(reduced)
    ctx = mesh_ctx((1, 4), "serve")
    params = partitioning.init_params(ctx, gen(device, rank), cfg,
                                      torch.float64, device=device)
    return f64_logits(params, cfg, torch.from_numpy(toks).to(device), ctx)


def f64_cfg(reduced):
    from repro_torch.config import ATTN_FULL, ATTN_SLIDING
    cfg = arch("gemma3-27b", reduced)
    kinds = []
    for want in (ATTN_SLIDING, ATTN_FULL):
        kinds.append(next(k for k in cfg.pattern() if k[0] == want))
    return cut(cfg, kinds)


def f64_logits(params, cfg, toks, ctx=None):
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.models import transformer
    from repro_torch.sharding.context import use_sharding

    def host(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).cpu() \
            .numpy()

    out = []
    with torch.inference_mode(), use_sharding(ctx):
        lg, caches = transformer.prefill(
            params, cfg, tokens=toks[:, :F64_PROMPT],
            max_len=F64_PROMPT + F64_STEPS, cache_dtype=torch.float64)
        out.append(host(lg))
        for i in range(F64_STEPS):
            pos = F64_PROMPT + i
            lg, caches = transformer.decode_step(
                params, caches, cfg, token=toks[:, pos:pos + 1], pos=pos)
            out.append(host(lg))
    return out


def check_serve(reduced: bool, device: str):
    import numpy as np
    import torch
    from repro_torch.dist import spmd
    from repro_torch.models import counting, transformer
    t0 = time.perf_counter()
    ranks = spmd.run(serve_rank, 4, reduced, device, device=device,
                     timeout=1800)
    cfg = arch("gemma3-27b", reduced)
    n = counting.count_params(cfg)
    ok = True
    for b in (1, 4):
        per = [r[f"batch{b}"] for r in ranks]
        peaks = [p["peak_memory_bytes"] for p in per]
        good = device != "cuda" or max(peaks) < 80e9
        ok &= good
        emit("serve", arch=cfg.name, mesh="1x4", profile="serve", batch=b,
             param_bytes=4 * n, ok=good, init_seconds=ranks[0][
                 "init_seconds"], peak_memory_bytes_per_card=peaks,
             **{k: v for k, v in per[0].items()
                if k != "peak_memory_bytes"},
             seconds=time.perf_counter() - t0)
    # float64, full width, 2 layers: 1x4 against one card
    fcfg = f64_cfg(reduced)
    toks = np.random.default_rng(SEED + 1).integers(
        0, fcfg.vocab_size, (2, F64_PROMPT + F64_STEPS), dtype=np.int32)
    t0 = time.perf_counter()
    one = f64_logits(transformer.init_params(gen(device), fcfg,
                                             torch.float64, device=device),
                     fcfg, torch.from_numpy(toks).to(device))
    _free(device)
    mesh = spmd.run(f64_rank, 4, reduced, device, toks, device=device,
                    timeout=1800)
    errs = [rel_err(a, b) for a, b in zip(mesh, one)]
    good = len(errs) == F64_STEPS + 1 and max(errs) <= TOL
    ok &= good
    emit("serve_f64", arch=fcfg.name, kinds=fcfg.pattern(), mesh="1x4",
         ok=good, tol=TOL, rel_errs=errs, seconds=time.perf_counter() - t0)
    return ok


# -------------------------------------------------------------------- MoE
def moe_cfg(reduced):
    return arch("deepseek-moe-16b", reduced)


def routes_of(records):
    import numpy as np
    return [{"layer": r["layer"], "top_idx": np.asarray(r["top_idx"].cpu()),
             "keep": np.asarray(r["keep"].cpu()), "capacity": r["capacity"],
             "margin": r["margin"]} for r in records]


def moe_one_card(reduced, device):
    """The one-card prefill and decode: logits, caches (host) and each
    decode step's routes."""
    import numpy as np
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.layers.moe import recorded_routes
    cfg = moe_cfg(reduced)
    params = transformer.init_params(gen(device), cfg, device=device)
    toks = np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT + MOE_STEPS),
        dtype=np.int32)
    t = torch.from_numpy(toks).to(device)
    logits, routes = [], []
    with torch.inference_mode():
        with recorded_routes(params) as pre:
            _, caches = transformer.prefill(
                params, cfg, tokens=t[:, :MOE_PROMPT],
                max_len=MOE_PROMPT + MOE_STEPS, cache_dtype=torch.float32)
        host_caches = [{p: {k: v.cpu().numpy() for k, v in c[p].items()}
                        for p in c} for c in caches]
        for i in range(MOE_STEPS):
            pos = MOE_PROMPT + i
            with recorded_routes(params) as rec:
                lg, caches = transformer.decode_step(
                    params, caches, cfg, token=t[:, pos:pos + 1], pos=pos)
            logits.append(lg.cpu().numpy())
            routes.append(routes_of(rec))
    drops = sum(int((~r["keep"]).sum()) for r in routes_of(pre))
    return toks, host_caches, logits, routes, drops


def moe_rank(rank, reduced, device, shape, profile, toks, host_caches):
    """The decode from the one-card prefill's caches on ``shape`` under
    ``profile``, and this route's own prefill's drops."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.models import transformer
    from repro_torch.models.layers.moe import recorded_routes
    from repro_torch.sharding import partitioning
    from repro_torch.sharding.context import use_sharding
    cfg = moe_cfg(reduced)
    ctx = mesh_ctx(shape, profile)
    params = partitioning.init_params(ctx, gen(device, rank), cfg,
                                      device=device)
    t = torch.from_numpy(toks).to(device)
    caches = partitioning.shard_caches(ctx, cfg, [
        {p: {k: torch.from_numpy(v).to(device) for k, v in c[p].items()}
         for p in c} for c in host_caches])
    logits, routes, step_ms = [], [], []
    with torch.inference_mode(), use_sharding(ctx):
        for i in range(MOE_STEPS):
            pos = MOE_PROMPT + i
            sync(device)
            t0 = time.perf_counter()
            with recorded_routes(params) as rec:
                lg, caches = transformer.decode_step(
                    params, caches, cfg, token=t[:, pos:pos + 1], pos=pos)
            lg = lg.full_tensor() if isinstance(lg, DTensor) else lg
            sync(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(lg.cpu().numpy())
            routes.append(routes_of(rec))
        del caches
        _free(device)
        with recorded_routes(params) as pre:
            transformer.prefill(params, cfg, tokens=t[:, :MOE_PROMPT],
                                max_len=MOE_PROMPT + 1)
    drops = sum(int((~r["keep"]).sum()) for r in routes_of(pre))
    return {"logits": logits, "routes": gather(routes),
            "drops": gather(drops), "step_ms": step_ms,
            "peak_memory_bytes": gather(peak(device))}


def _route_rows(shape, profile, rank, batch, top_k):
    """The rows of a decode step's batch that ``rank`` routes: under
    ``serve`` (data 1) all of them; under ``ep2d`` its data shard's, or
    its model slice of them where ``_apply_ep2d`` splits the sequence."""
    d, m = shape
    dd, mm = divmod(rank, m)
    if profile == "serve":
        return list(range(batch))
    rows = list(range(dd * batch // d, (dd + 1) * batch // d))
    n = len(rows) // m
    if len(rows) % m or n * top_k < d * m:
        return rows
    return rows[mm * n:(mm + 1) * n]


def check_moe(reduced: bool, device: str):
    import numpy as np
    from repro_torch.dist import spmd
    cfg = moe_cfg(reduced)
    t0 = time.perf_counter()
    toks, caches, want, want_routes, one_drops = moe_one_card(reduced,
                                                              device)
    _free(device)
    emit("moe", arch=cfg.name, mesh="1 card", prefill_drops=one_drops,
         capacity_factor=cfg.moe.capacity_factor,
         seconds=time.perf_counter() - t0)
    ok = True
    for shape, profile in (((1, 4), "serve"), ((2, 2), "ep2d")):
        t0 = time.perf_counter()
        r = spmd.run(moe_rank, 4, reduced, device, shape, profile, toks,
                     caches, device=device, timeout=1800)
        errs = [rel_err(a, b) for a, b in zip(r["logits"], want)]
        flips, margins = 0, {}
        for step, ref in enumerate(want_routes):
            for li, rec in enumerate(ref):
                margins[rec["layer"]] = min(margins.get(rec["layer"], 1.0),
                                            rec["margin"])
                for rank in range(4):
                    got = r["routes"][rank][step][li]
                    rows = _route_rows(shape, profile, rank, MOE_BATCH,
                                       cfg.moe.top_k)
                    flips += int((got["top_idx"] != rec["top_idx"][rows])
                                 .any(-1).sum())
        good = max(errs) <= TOL and flips == 0
        ok &= good
        emit("moe", arch=cfg.name, mesh=f"{shape[0]}x{shape[1]}",
             profile=profile, route=("_apply_sharded" if profile == "serve"
                                     else "_apply_ep2d"), ok=good,
             logits_rel_errs=errs, routing_flips=flips,
             min_gate_margin_by_layer=margins,
             prefill_drops_by_rank=r["drops"],
             one_card_prefill_drops=one_drops,
             decode_step_ms=statistics.median(r["step_ms"]),
             peak_memory_bytes_per_card=r["peak_memory_bytes"],
             seconds=time.perf_counter() - t0)
    return ok


# ---------------------------------------------------------------- mixers
def mixer_cfg(name, layers, reduced):
    cfg = arch(name, reduced)
    if layers is None:
        return cfg
    kinds = cfg.pattern()
    return cut(cfg, [kinds[i % len(kinds)] for i in range(layers)])


def mixer_tokens(cfg, name, reduced, seed):
    import numpy as np
    prompt = MIXER_PROMPT[name][reduced]
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (MIXER_BATCH, prompt + MIXER_STEPS),
        dtype=np.int32), prompt


def mixer_decode(params, cfg, toks, prompt, max_len, device, ctx=None,
                 greedy=None):
    """Prefill ``toks[:, :prompt]`` into float32 caches (as the float32
    checks here: a bfloat16 cache rounds the mesh's and one card's k/v,
    which differ in their last bits, to neighbouring values) and
    ``MIXER_STEPS`` decode steps, each
    fed the previous step's greedy token (``greedy``: one card's, given;
    else chosen here): the logits (host), the tokens, the decode steps'
    median ms and the peak memory."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.models import transformer
    from repro_torch.sharding.context import use_sharding

    def host(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).cpu() \
            .numpy()

    t = torch.from_numpy(toks).to(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    logits, chosen, ms = [], [], []
    with torch.inference_mode(), use_sharding(ctx):
        lg, caches = transformer.prefill(params, cfg,
                                         tokens=t[:, :prompt],
                                         max_len=max_len,
                                         cache_dtype=torch.float32)
        for i in range(MIXER_STEPS):
            out = host(lg)
            logits.append(out)
            tok = out[:, -1].argmax(-1) if greedy is None else greedy[i]
            chosen.append(tok)
            nxt = torch.from_numpy(tok.astype("int32")).to(device)[:, None]
            sync(device)
            t0 = time.perf_counter()
            lg, caches = transformer.decode_step(params, caches, cfg,
                                                 token=nxt, pos=prompt + i)
            sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(host(lg))
    return {"logits": logits, "tokens": chosen,
            "decode_step_ms": statistics.median(ms[1:]),
            "peak_memory_bytes": peak(device)}


def mixer_train(state, cfg, batch, ctx=None, device="cuda"):
    """``MIXER_TRAIN["steps"]`` raw train steps: losses, median step ms
    and peak memory."""
    from repro_torch.models import lm
    from repro_torch.sharding.context import use_sharding
    step = lm.make_train_step(cfg, total_steps=MIXER_TRAIN["steps"])
    losses, ms = [], []
    with use_sharding(ctx):
        for _ in range(MIXER_TRAIN["steps"]):
            sync(device)
            t0 = time.perf_counter()
            losses.append(float(step(state, batch)[1]["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
    return {"losses": losses, "median_step_ms": statistics.median(ms),
            "peak_memory_bytes": peak(device)}


def mixer_batch(cfg, reduced, device):
    import numpy as np
    import torch
    seq = MIXER_TRAIN["seq"] if not reduced else 32
    toks = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab_size, (MIXER_TRAIN["batch"], seq + 1),
        dtype=np.int32)).to(device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].long()}


def mixer_rank(rank, reduced, device, greedy):
    """Every mesh side of ``check_mixers`` in one spawn: rwkv6-7b's train
    steps on 2x2, then each ``MIXER_SERVE`` entry on its mesh."""
    from repro_torch.sharding import partitioning
    out = {}
    t = MIXER_TRAIN
    cfg = mixer_cfg(t["arch"], t["layers"], reduced)
    ctx = mesh_ctx((2, 2), "tp_fsdp")
    state = partitioning.init_train_state(ctx, gen(device, rank), cfg,
                                          device=device)
    r = mixer_train(state, cfg, mixer_batch(cfg, reduced, device), ctx,
                    device)
    out["train"] = dict(r, peak_memory_bytes=gather(r["peak_memory_bytes"]))
    del state
    _free(device)
    for name, layers, shape, profile, seq in MIXER_SERVE:
        cfg = mixer_cfg(name, layers, reduced)
        ctx = mesh_ctx(shape, profile)
        ctx.rules["cache_seq"] = seq
        params = partitioning.init_params(ctx, gen(device, rank), cfg,
                                          device=device)
        toks, prompt = mixer_tokens(cfg, name, reduced, SEED + 4)
        max_len = MIXER_MAX_LEN.get(name, (prompt + MIXER_STEPS,) * 2)[
            reduced]
        r = mixer_decode(params, cfg, toks, prompt, max_len, device, ctx,
                         greedy[name])
        out[name] = dict(r, peak_memory_bytes=gather(
            r["peak_memory_bytes"]))
        del params
        _free(device)
    return out


def check_mixers(reduced: bool, device: str):
    from repro_torch.dist import spmd
    from repro_torch.models import lm, transformer
    t0 = time.perf_counter()
    t = MIXER_TRAIN
    cfg = mixer_cfg(t["arch"], t["layers"], reduced)
    state = lm.init_train_state(gen(device), cfg, device=device)
    one = {"train": mixer_train(state, cfg, mixer_batch(cfg, reduced,
                                                        device),
                                device=device)}
    del state
    _free(device)
    greedy = {}
    for name, layers, *_ in MIXER_SERVE:
        cfg = mixer_cfg(name, layers, reduced)
        params = transformer.init_params(gen(device), cfg, device=device)
        toks, prompt = mixer_tokens(cfg, name, reduced, SEED + 4)
        max_len = MIXER_MAX_LEN.get(name, (prompt + MIXER_STEPS,) * 2)[
            reduced]
        one[name] = mixer_decode(params, cfg, toks, prompt, max_len,
                                 device)
        greedy[name] = one[name]["tokens"]
        del params
        _free(device)
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = spmd.run(mixer_rank, 4, reduced, device, greedy, device=device,
                    timeout=1800)
    mesh_s = time.perf_counter() - t0
    ok = True
    w, m = one["train"], mesh["train"]
    errs = [rel_err(a, b) for a, b in zip(m["losses"], w["losses"])]
    good = len(errs) == t["steps"] and max(errs) <= TOL
    ok &= good
    emit("mixers", arch=t["arch"], layers=t["layers"], mesh="2x2",
         profile="tp_fsdp", ok=good, losses=m["losses"],
         one_card_losses=w["losses"], loss_rel_errs=errs,
         median_step_ms=m["median_step_ms"],
         one_card_median_step_ms=w["median_step_ms"],
         peak_memory_bytes_per_card=m["peak_memory_bytes"],
         one_card_peak_memory_bytes=w["peak_memory_bytes"],
         batch=t["batch"], seq=t["seq"] if not reduced else 32)
    for name, layers, shape, profile, seq in MIXER_SERVE:
        w, m = one[name], mesh[name]
        errs = [rel_err(a, b) for a, b in zip(m["logits"], w["logits"])]
        same = all((a[:, -1].argmax(-1) == b).all()
                   for a, b in zip(m["logits"][:-1], w["tokens"]))
        good = (len(errs) == MIXER_STEPS + 1 and max(errs) <= TOL
                and bool(same))
        ok &= good
        emit("mixers", arch=name, layers=layers,
             mesh=f"{shape[0]}x{shape[1]}", profile=profile,
             cache_seq=list(seq), ok=good, logits_rel_errs=errs,
             greedy_tokens_equal=bool(same),
             decode_step_ms=m["decode_step_ms"],
             one_card_decode_step_ms=w["decode_step_ms"],
             peak_memory_bytes_per_card=m["peak_memory_bytes"],
             one_card_peak_memory_bytes=w["peak_memory_bytes"],
             batch=MIXER_BATCH,
             prompt=MIXER_PROMPT[name][reduced])
    emit("mixers", part="seconds", one_card=one_s, mesh_with_spawn=mesh_s)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced() configs (a rehearsal)")
    ap.add_argument("--only", default="train,serve,moe,mixers",
                    help="a comma-separated subset of train, serve, moe "
                         "and mixers")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
            print("lm_mesh_cards: needs four visible cards", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    checks = {"train": check_train, "serve": check_serve, "moe": check_moe,
              "mixers": check_mixers}
    ok = True
    for name in args.only.split(","):
        try:
            ok &= checks[name](args.reduced, args.device)
        except Exception as e:  # noqa: BLE001 — reported, exit nonzero
            import traceback
            emit(name, ok=False, error=repr(e)[:2000],
                 trace=traceback.format_exc()[-4000:])
            ok = False
        _free(args.device)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text("\n".join(RESULTS) + "\n")
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
    print(json.dumps({"ok": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
