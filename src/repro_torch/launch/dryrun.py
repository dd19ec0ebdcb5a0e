"""Production-mesh dry run (the reference's ``launch/dryrun.py``).

For every (architecture x input-shape) cell, build the step on the
production mesh, (data=16, model=16) or (pod=2, data=16, model=16), and
run it once on ``meta`` tensors as rank 0 of a ``fake`` process group of
that size (256 or 512 ranks): the port's own sharded code does the work,
and nothing is allocated or sent.  Each cell's record holds rank 0's
FLOPs, memory and collective traffic (``comm_analysis.Recorder``) for
``launch/roofline.py``.

The reference lowers and compiles the step with XLA and reads its
``memory_analysis``, ``cost_analysis`` and HLO.  Here:
  * ``trace_s`` replaces ``lower_s``/``compile_s``;
  * ``cost.flops`` is rank 0's FLOPs at local shapes
    (``torch.utils.flop_counter``'s formulas), and ``cost.analytic_flops``
    ``counting.step_flops`` over the devices: their ratio shows compute
    that runs replicated;
  * ``memory``: ``argument_bytes`` and ``output_bytes`` are rank 0's local
    shards of the arguments and outputs, ``peak_bytes`` the most ``meta``
    storage live at once during the call (arguments included, remat's
    recomputation and the optimizer's temporaries as the card allocates
    them), ``temp_bytes`` peak less arguments, as the reference reckons;
  * ``collectives``: the reference's payload, wire and count per kind and
    their total, plus ``link_wire_bytes``: wire bytes of groups within
    one node of 8 (NVLink) and across nodes;
  * ``--keep-hlo`` has no counterpart: there is no HLO.

A process has one default group, so the CLI traces each mesh in its own
process (``--both-meshes`` runs the two side by side).  ``run_cell`` needs
the fake group already made (``init_fake_group``); a missing ``fake``
backend raises, and the dry run never falls back to a group of one.

Usage (host only; no card):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \
      --out results/torch_dryrun.jsonl
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import queue
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.config import SHAPES_BY_NAME, get_arch
from repro_torch.launch import cells as cells_mod
from repro_torch.obs.log import LOG_LEVELS, configure_logging, get_logger

__all__ = ["init_fake_group", "run_cell", "run_cells", "main"]

log = get_logger("launch")

# seconds one cell may take (the slowest, rwkv6-7b x prefill_32k, takes
# about 140 s on a host core)
CELL_TIMEOUT = 3600.0


def init_fake_group(world_size: int) -> None:
    """Make this process rank 0 of a ``fake`` default group of
    ``world_size`` ranks (collectives that move nothing); a group of that
    size already made is kept."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"dryrun: this process's default group has "
                f"{dist.get_world_size()} ranks, the mesh needs "
                f"{world_size}; trace each mesh in its own process")
        return
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "dryrun: this torch has no 'fake' process-group backend "
            "(torch.testing._internal.distributed.fake_pg); the dry run "
            "needs one and never falls back to a group of one") from e
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())


def _mesh_name(multi_pod: bool) -> str:
    return "pod=2,data=16,model=16" if multi_pod else "data=16,model=16"


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             profile: str = "",
             mesh_device: Optional[str] = None) -> Dict[str, Any]:
    """One cell's record (module doc), traced as rank 0 of the current
    default group, which must hold 256 ranks (512 with ``multi_pod``).
    ``mesh_device``: the mesh's device type (default ``cpu`` under a fake
    group); the record does not depend on it."""
    from repro_torch.dist.mesh import make_production_mesh
    from repro_torch.models import counting
    from repro_torch.sharding.context import ShardingCtx, make_rules

    cfg = get_arch(arch)
    shape = SHAPES_BY_NAME[shape_name]
    prof = profile or cells_mod.default_profile(cfg, shape)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": _mesh_name(multi_pod),
        "devices": 512 if multi_pod else 256,
        "profile": prof,
    }
    skip = cells_mod.cell_skip_reason(cfg, shape)
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec

    try:
        t0 = time.perf_counter()
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=mesh_device)
        ctx = ShardingCtx(mesh, make_rules(prof))
        cells_mod.tune_cache_rules(ctx, cfg, shape)
        prog = cells_mod.build_cell(cfg, shape, ctx)
        build_s = time.perf_counter() - t0
        tr = prog.trace()
        flops = counting.step_flops(cfg, shape)
        analytic = flops["train" if shape.kind == "train" else "fwd"]
        st = tr.stats
        rec.update({
            "status": "ok",
            "step_kind": prog.kind,
            "build_s": round(build_s, 1),
            "trace_s": round(tr.seconds, 1),
            "cost": {"flops": float(tr.flops),
                     "analytic_flops": analytic / rec["devices"]},
            "memory": {
                "argument_bytes": tr.argument_bytes,
                "output_bytes": tr.output_bytes,
                "temp_bytes": tr.peak_bytes - tr.argument_bytes,
                "peak_bytes": tr.peak_bytes,
            },
            "collectives": {
                "payload_bytes": dict(st.payload_bytes),
                "wire_bytes": dict(st.wire_bytes),
                "counts": dict(st.count),
                "total_wire_bytes": st.total_wire(),
                "link_wire_bytes": tr.link_wire_bytes,
            },
        })
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug to record
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def _mesh_worker(todo: List[Tuple[str, str]], multi_pod: bool,
                 profile: str, mesh_device: Optional[str],
                 log_level: str, out_q) -> None:
    """A process of its own per mesh: the fake group, then every cell.  A
    group that cannot be made is sent back as ``{"fatal": message}``."""
    configure_logging(log_level)
    try:
        init_fake_group(512 if multi_pod else 256)
    except RuntimeError as e:
        out_q.put({"fatal": str(e)})
        return
    for arch, shape in todo:
        log.info("dry-running %s x %s (multi_pod=%s)", arch, shape,
                 multi_pod)
        out_q.put(run_cell(arch, shape, multi_pod=multi_pod,
                           profile=profile, mesh_device=mesh_device))


def _lost(arch: str, shape: str, multi_pod: bool, profile: str,
          why: str) -> Dict[str, Any]:
    cfg = get_arch(arch)
    return {"arch": arch, "shape": shape, "mesh": _mesh_name(multi_pod),
            "devices": 512 if multi_pod else 256,
            "profile": profile or cells_mod.default_profile(
                cfg, SHAPES_BY_NAME[shape]),
            "status": "error", "error": why}


def run_cells(todo: Sequence[Tuple[str, str]], meshes: Sequence[bool], *,
              profile: str = "", mesh_device: Optional[str] = None,
              log_level: str = "warning"):
    """Yields each cell's record, for each mesh in turn (the reference's
    order), each mesh traced in its own spawned process, the meshes side
    by side.  A process that dies, or a cell past ``CELL_TIMEOUT``
    seconds, ends that mesh's remaining cells as errors; a fake group that
    cannot be made raises."""
    ctx = mp.get_context("spawn")
    procs, queues, alive = {}, {}, {}
    for multi in meshes:
        queues[multi] = ctx.Queue()
        procs[multi] = ctx.Process(
            target=_mesh_worker, args=(list(todo), multi, profile,
                                       mesh_device, log_level,
                                       queues[multi]), daemon=True)
        procs[multi].start()
        alive[multi] = True
    try:
        for arch, shape in todo:
            for multi in meshes:
                rec = None
                if alive[multi]:
                    rec = _next(procs[multi], queues[multi], CELL_TIMEOUT)
                if rec is not None and "fatal" in rec:
                    raise RuntimeError(rec["fatal"])
                if rec is None:
                    if alive[multi]:
                        alive[multi] = False
                        code = procs[multi].exitcode
                        why = (f"the dry-run process of mesh "
                               f"{_mesh_name(multi)} "
                               + ("took more than "
                                  f"{CELL_TIMEOUT:.0f} s on this cell"
                                  if code is None else
                                  f"ended with exit code {code}"))
                        procs[multi].kill()
                    yield _lost(arch, shape, multi, profile, why)
                else:
                    yield rec
    finally:
        for p in procs.values():
            if p.is_alive():
                p.kill()
            p.join()


def _next(proc, q, timeout: float):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            return q.get(timeout=1.0)
        except queue.Empty:
            if not proc.is_alive():
                try:
                    return q.get(timeout=1.0)
                except queue.Empty:
                    return None
    return None


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, Any]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--profile", default="",
                    help="parallelism profile override (see "
                         "sharding.context.RULE_PROFILES)")
    ap.add_argument("--mesh-device", default=None, choices=("cpu", "cuda"),
                    help="the production mesh's device type (default cpu; "
                         "the record does not depend on it)")
    ap.add_argument("--log-level", default="info", choices=LOG_LEVELS,
                    help="stderr log verbosity (repro_torch.obs.log)")
    args = ap.parse_args(argv)
    configure_logging(args.log_level)

    if args.all:
        todo = cells_mod.all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        todo = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    out_f = open(args.out, "a") if args.out else None
    recs = []
    try:
        for rec in run_cells(todo, meshes, profile=args.profile,
                             mesh_device=args.mesh_device,
                             log_level=args.log_level):
            recs.append(rec)
            # the JSON record lines on stdout are the machine-readable
            # contract scripts pipe from (roofline.load_rows reads the
            # same records from --out): they stay prints
            print(json.dumps({k: v for k, v in rec.items()  # lint: allow(print-ban)
                              if k != "traceback"}), flush=True)
            log.info("cell %s x %s mesh=%s: %s", rec["arch"], rec["shape"],
                     rec["mesh"], rec["status"])
            if out_f:
                out_f.write(json.dumps(rec) + "\n")
                out_f.flush()
    finally:
        if out_f:
            out_f.close()
    return recs


if __name__ == "__main__":
    main()
