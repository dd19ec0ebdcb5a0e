"""Training launcher: an LM (``--arch``) through the fault-tolerant loop,
or an SNN by surrogate-gradient SGD through the ``repro_torch.api``
facade (the default).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --steps 100 --batch 4 --seq 128 [--full-config]
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --device cpu --steps 2 --batch 2 --seq 16
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --mesh 2x2 --profile tp_fsdp --device cpu --steps 2 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.train --snn snn-mnist \
        --backend hopper --steps 50 --batch 256 --lr 1e-2
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 2 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.train --spec-file train.json
    PYTHONPATH=src python -m repro_torch.launch.train --mesh data=2 \
        --device cpu --steps 2 --batch 4

``--arch`` trains a registered LM (``reduced`` unless ``--full-config``),
the reference's LM path: ``lm.init_train_state`` from ``--seed``,
``lm.make_train_step`` (AdamW in place, warmup-cosine over ``--steps``),
``token_batches`` through a ``Prefetcher`` onto the device, a
``Checkpointer`` (keeps 2) in ``--ckpt-dir`` and a ``StragglerMonitor``,
all run by ``ResilientLoop``, which resumes from the directory's latest
checkpoint.  Each step's loss is read on the host (one sync a step), so
the step times are the device's work.  With ``--mesh DxM`` (data x
model) the LM trains sharded under ``--profile`` (a
``sharding.context.RULE_PROFILES`` name, default ``tp_fsdp``): one
process per mesh entry (``dist.spmd``: ``nccl`` on the cards
``cuda:0..DxM-1``, or ``gloo`` host processes with ``--device cpu``),
the state drawn on rank 0 and scattered leaf by leaf
(``sharding.partitioning.init_train_state``), each rank's ``Prefetcher``
copying its rows of the global batch, checkpoints written by rank 0.
Rank 0 logs and returns the result, with ``mesh``, ``profile`` and each
rank's peak memory.

Otherwise the flags build one validated ``TrainSpec`` (backend,
surrogate, lr, timesteps), or ``--spec-file`` loads one from JSON
(``api.spec_from_dict``), and ``--mesh`` (``dist.parse_mesh``) layers
over either: the step then shards the batch over the mesh's entries
(per-example gradient rows combined on the host, the same params at any
shard count).  A ``Session`` owns the params, drawn from ``--seed``, and
the step.  Step i trains on ``mnist_like(batch, seed=i)``
with SGD and momentum (``Session.train_step``); then the accuracy on
``mnist_like(256, seed=10_000)`` is evaluated through the same backend
(``Session.evaluate``).  A step is done when its loss is on the host.
The reference's ``--snn`` path of ``repro.launch.train``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import tempfile
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch import api
from repro_torch.checkpoint import Checkpointer
from repro_torch.config import ArchConfig, SNNConfig, get_arch, get_snn, \
    reduced
from repro_torch.core.snn_model import SNN_BACKENDS
from repro_torch.core.surrogate import SURROGATE_KINDS
from repro_torch.data.pipeline import Prefetcher, batch_rows
from repro_torch.data.synthetic import mnist_like, token_batches
from repro_torch.device import resolve_device
from repro_torch.dist import spmd
from repro_torch.dist.mesh import make_test_mesh, parse_mesh
from repro_torch.launch.serve import device_name, load_spec_file
from repro_torch.models import lm
from repro_torch.obs.log import LOG_LEVELS, configure_logging, get_logger
from repro_torch.runtime.fault_tolerance import LoopConfig, ResilientLoop
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.sharding import partitioning
from repro_torch.sharding.context import RULE_PROFILES, ShardingCtx, \
    make_rules, use_sharding

log = get_logger("train")

EVAL_BATCH, EVAL_SEED = 256, 10_000
# where --arch checkpoints by default: the reference's directory is
# another, so a run here never resumes from one of its runs by accident
DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train")
# the most seconds a sharded run may take, its group's collectives too
MESH_TIMEOUT = 3600.0


def parse_lm_mesh(text: str):
    """``"DxM"`` -> (D, M): the data and model axes of an LM mesh."""
    d, x, m = text.partition("x")
    if not (x and d.isdigit() and m.isdigit() and int(d) and int(m)):
        raise ValueError(f"--mesh {text!r} with --arch: expected DxM (data "
                         f"x model, e.g. 2x2); the data=N form is the "
                         f"SNN's")
    return int(d), int(m)


def _batch_shard(ctx, batch: int, seq: int):
    """This rank's (index, count) among the shards of the batch axis."""
    mesh = ctx.torch_mesh
    index, count = 0, 1
    for i, p in enumerate(ctx.placements(("batch", None), (batch, seq))):
        if isinstance(p, Shard):
            index = index * mesh.size(i) + mesh.get_local_rank(i)
            count *= mesh.size(i)
    return index, count


def train_lm(cfg: ArchConfig, *, steps: int = 50, batch: int = 4,
             seq: int = 128, seed: int = 0, ckpt_dir: str = DEFAULT_CKPT_DIR,
             checkpoint_every: int = 50, device=None, ctx=None) -> Dict:
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` tokens
    through ``ResilientLoop`` (module doc).  Returns every step's loss (on
    the host), the median step and the trained tokens a second, the
    loop's ``resumed_from``, ``failures`` and ``steps_done``, the card's
    peak memory and the final blocking save's seconds and bytes.  With
    ``ctx`` (a ``ShardingCtx`` on the torch mesh of this process group)
    this rank's part of a sharded run."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    host = token_batches(cfg.vocab_size, batch, seq, seed=seed)
    if ctx is None:
        state = lm.init_train_state(gen, cfg, device=dev)
        batches = Prefetcher(host, device=dev)
        ckpt = Checkpointer(ckpt_dir, keep=2)
    else:
        mesh = ctx.torch_mesh
        state = partitioning.init_train_state(
            ctx, gen if mesh.get_rank() == 0 else None, cfg, device=dev)
        batches = Prefetcher(host, device=dev,
                             shard=batch_rows(*_batch_shard(ctx, batch,
                                                            seq)))
        pl = list(ctx.placements(("batch", None), (batch, seq)))
        ckpt = Checkpointer(ckpt_dir, keep=2, mesh=mesh)
    step_fn = lm.make_train_step(cfg, total_steps=steps)
    monitor = StragglerMonitor(num_hosts=1)
    losses, seconds = [], []
    t_last = [time.perf_counter()]

    def on_metrics(step, m):
        losses.append(float(m["loss"]))     # the step's one host sync
        now = time.perf_counter()
        seconds.append(now - t_last[0])
        monitor.record([seconds[-1]])
        t_last[0] = now
        if step % 10 == 0:
            log.info("step %5d loss %.4f fleet_balance %.3f", step,
                     losses[-1], monitor.fleet_balance())

    loop = ResilientLoop(step_fn, ckpt, LoopConfig(
        checkpoint_every=checkpoint_every, max_steps=steps))
    try:
        if ctx is None:
            loop.run(state, batches, on_metrics=on_metrics)
        else:
            with use_sharding(ctx):
                loop.run(state, ({k: DTensor.from_local(
                    v, mesh, pl, run_check=False) for k, v in b.items()}
                    for b in batches), on_metrics=on_metrics)
    finally:
        batches.close()
    step_s = statistics.median(seconds) if seconds else 0.0
    return {
        "losses": losses,
        "step_ms": [x * 1e3 for x in seconds],
        "median_step_ms": step_s * 1e3,
        "tokens_per_s": batch * seq / step_s if step_s > 0 else 0.0,
        "resumed_from": loop.stats.resumed_from,
        "failures": loop.stats.failures,
        "steps_done": loop.stats.steps_done,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "save_seconds": ckpt.last_save_seconds,
        "save_bytes": ckpt.last_save_bytes,
        "arch": cfg.name, "batch": batch, "seq": seq,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def _train_lm_rank(rank: int, cfg: ArchConfig, shape, profile: str,
                   log_level: str, kw: Dict) -> Dict:
    """One rank of ``--arch --mesh``: ``train_lm`` under a ``ShardingCtx``
    of ``profile`` on this group's (data, model) mesh; rank 0's result
    gains ``mesh``, ``profile`` and every rank's peak memory."""
    if rank == 0:
        configure_logging(log_level)
    ctx = ShardingCtx(make_test_mesh(shape), make_rules(profile))
    r = train_lm(cfg, ctx=ctx, **kw)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, r["peak_memory_bytes"])
    r.update(mesh=f"{shape[0]}x{shape[1]}", profile=profile,
             peak_memory_bytes_per_rank=peaks)
    return r


def train(cfg: SNNConfig, spec: Optional[api.TrainSpec] = None, *,
          backend: str = "hopper", surrogate: str = "fast_sigmoid",
          lr: float = 1e-3, steps: int = 50, batch: int = 256, seed: int = 0,
          device=None) -> Dict:
    """Take ``steps`` SGD steps of ``batch`` frames, then evaluate; returns
    the loss of every step, the step times and the held-out accuracy.
    Without a ``spec``, one is built from ``backend``, ``surrogate`` and
    ``lr``."""
    if spec is None:
        spec = api.TrainSpec(backend=backend, lr=lr, surrogate_kind=surrogate)
    sess = api.Session(cfg, spec, seed=seed, device=device)

    def to_dev(x, y):
        return (torch.from_numpy(x).to(sess.device),
                torch.from_numpy(y).to(sess.device))

    losses, seconds = [], []
    for i in range(steps):
        x, y = to_dev(*mnist_like(batch, seed=i))
        t0 = time.perf_counter()
        losses.append(sess.train_step(x, y))
        seconds.append(time.perf_counter() - t0)
        if i % 10 == 0 or i == steps - 1:
            log.info("step %5d loss %.4f step_ms %.2f backend=%s", i,
                     losses[-1], seconds[-1] * 1e3, spec.backend)
    # the median step: the first one also builds and warms the kernels
    step_s = statistics.median(seconds) if seconds else 0.0
    acc = sess.evaluate(*to_dev(*mnist_like(EVAL_BATCH, seed=EVAL_SEED)))
    return {
        "losses": losses,
        "step_ms": [s * 1e3 for s in seconds],
        "median_step_ms": step_s * 1e3,
        "frames_per_s": batch / step_s if step_s > 0 else 0.0,
        "accuracy": acc,
        "backend": spec.backend,
        "surrogate": spec.surrogate_kind,
        "timesteps": sess.cfg.timesteps,
        "batch": batch,
        "device": device_name(sess),
    }


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None,
                    help="train a registered LM (repro_torch.config."
                         "list_archs) instead of an SNN")
    ap.add_argument("--full-config", action="store_true",
                    help="--arch at its published widths and depth "
                         "(default: reduced)")
    ap.add_argument("--seq", type=int, default=128,
                    help="--arch: tokens per sequence")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR,
                    help="--arch: checkpoint directory (resumed from)")
    ap.add_argument("--checkpoint-every", type=int, default=50,
                    help="--arch: steps between async checkpoints")
    ap.add_argument("--snn", default="snn-mnist")
    ap.add_argument("--backend", default="hopper", choices=SNN_BACKENDS)
    ap.add_argument("--surrogate", default="fast_sigmoid",
                    choices=SURROGATE_KINDS)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--timesteps", type=int, default=0,
                    help="override the config's timesteps (0 = keep)")
    ap.add_argument("--spec-file", default=None,
                    help="JSON TrainSpec (api.spec_from_dict; kind='train'), "
                         "in place of the per-flag spec")
    ap.add_argument("--mesh", default="",
                    help="repro_torch.dist mesh string, e.g. 'data=2' or "
                         "bare '2': data-sharded train step over the mesh's "
                         "entries (with --device cpu, N host entries); "
                         "with --arch, DxM (data x model, e.g. 2x2): one "
                         "process per entry")
    ap.add_argument("--profile", default="tp_fsdp",
                    choices=sorted(RULE_PROFILES),
                    help="--arch --mesh: the sharding rules")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=None,
                    help="sequences (--arch, default 4) or frames (default "
                         "256) a step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-level", default="info", choices=LOG_LEVELS,
                    help="stderr log verbosity (repro_torch.obs.log)")
    args = ap.parse_args(argv)
    configure_logging(args.log_level)
    if args.arch:
        cfg = get_arch(args.arch)
        cfg = cfg if args.full_config else reduced(cfg)
        kw = dict(steps=args.steps, batch=args.batch or 4, seq=args.seq,
                  seed=args.seed, ckpt_dir=args.ckpt_dir,
                  checkpoint_every=args.checkpoint_every, device=args.device)
        if args.mesh:
            shape = parse_lm_mesh(args.mesh)
            r = spmd.run(_train_lm_rank, shape[0] * shape[1], cfg, shape,
                         args.profile, args.log_level, kw,
                         device=args.device, timeout=MESH_TIMEOUT)
        else:
            r = train_lm(cfg, **kw)
        log.info("trained %d steps of %dx%d tokens (arch=%s, resumed_from="
                 "%s, failures=%d): loss %s -> %s, median step %.2f ms, "
                 "%.1f trained tokens/s, final save %.2f s, device=%s",
                 r["steps_done"], r["batch"], r["seq"], cfg.name,
                 r["resumed_from"], len(r["failures"]),
                 r["losses"][0] if r["losses"] else None,
                 r["losses"][-1] if r["losses"] else None,
                 r["median_step_ms"], r["tokens_per_s"], r["save_seconds"],
                 r["device"])
        return r
    if args.spec_file:
        spec = load_spec_file(args.spec_file, api.TrainSpec)
    else:
        spec = api.TrainSpec(backend=args.backend,
                             surrogate_kind=args.surrogate, lr=args.lr,
                             timesteps=args.timesteps or None)
    if args.mesh:
        spec = dataclasses.replace(spec, mesh=parse_mesh(args.mesh))
    r = train(get_snn(args.snn), spec, steps=args.steps,
              batch=args.batch or 256,
              seed=args.seed, device=args.device)
    log.info("trained %d steps of %d frames (backend=%s, surrogate=%s, "
             "T=%d): loss %.4f -> %.4f, median step %.2f ms, %.1f trained "
             "frames/s, held-out accuracy %.2f%%, device=%s", len(r["losses"]),
             r["batch"], r["backend"], r["surrogate"], r["timesteps"],
             r["losses"][0] if r["losses"] else float("nan"),
             r["losses"][-1] if r["losses"] else float("nan"),
             r["median_step_ms"], r["frames_per_s"], r["accuracy"] * 100,
             r["device"])
    return r


if __name__ == "__main__":
    main()
