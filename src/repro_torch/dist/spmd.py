"""One process per mesh entry: the multi-controller counterpart of the
reference's single JAX program over a mesh (which needs none).

``run(fn, nprocs, *args, device=...)`` starts ``nprocs`` spawned processes,
each of which joins one ``torch.distributed`` group and calls
``fn(rank, *args)``; it returns rank 0's result.

  * rendezvous  a ``file://`` store in a fresh temporary directory (never a
                fixed TCP port: several runs may share a host);
  * backend     ``nccl`` with ``cuda:rank`` when ``device="cuda"``,
                ``gloo`` when ``device="cpu"``; it never falls back from
                one to the other, and ``"cuda"`` with fewer cards than
                ranks raises before any process starts;
  * time        the group's collectives time out after ``timeout``
                seconds, and the whole run is bounded by ``timeout`` too;
  * failure     the first rank that raises ends the run: every process is
                stopped, and ``RankError`` (naming the rank, holding its
                traceback, chained to its exception where that pickles) is
                raised in the caller.  A rank that dies without a word
                (killed, out of memory) is reported the same way.

``fn`` and its arguments are pickled by the spawn start method: ``fn`` must
be importable by name, and results should be host objects (numbers, numpy
arrays, dicts of them).  Each rank sets ``torch.set_num_threads`` to its
share of the host's cores, so N CPU ranks do not oversubscribe them.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

__all__ = ["RankError", "run"]


class RankError(RuntimeError):
    """A rank of an ``spmd.run`` raised or died: ``rank`` and its
    traceback text ``trace``."""

    def __init__(self, rank: int, message: str, trace: str = ""):
        super().__init__(f"rank {rank}: {message}"
                         + (f"\n--- rank {rank} traceback ---\n{trace}"
                            if trace else ""))
        self.rank = rank
        self.trace = trace


def _backend_for(device: str) -> str:
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"spmd: device must be 'cuda' or 'cpu', got {device!r}")


def _worker(fn, rank: int, nprocs: int, device: str, store: str,
            timeout: float, threads: int, out_q, args) -> None:
    try:
        torch.set_num_threads(threads)
        backend = _backend_for(device)
        kw = {}
        if backend == "nccl":
            torch.cuda.set_device(rank)
            kw["device_id"] = torch.device("cuda", rank)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=nprocs, timeout=datetime.timedelta(seconds=timeout),
            **kw)
        result = fn(rank, *args)
        out_q.put(("ok", rank, result if rank == 0 else None))
    except BaseException as e:  # noqa: BLE001 — reported to the caller
        try:
            exc = pickle.dumps(e)
        except Exception:  # noqa: BLE001 — an exception that will not pickle
            exc = None
        out_q.put(("error", rank, (repr(e), traceback.format_exc(), exc)))
        return
    # the caller has the result; a clean exit releases the group's
    # resources (a rank blocked here by a dead peer is stopped by the
    # caller)
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — the result is already reported
        pass


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    deadline = time.monotonic() + 5.0
    for p in procs:
        if p.pid is None:       # never started: a start before it raised
            continue
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join(5.0)


def run(fn: Callable[..., Any], nprocs: int, *args, device: str = "cuda",
        timeout: float = 600.0, threads: Optional[int] = None) -> Any:
    """``fn(rank, *args)`` on ``nprocs`` processes of one group (module
    doc); returns rank 0's result.  ``threads``: intra-op threads a rank
    (default: the host's cores over ``nprocs``, at least 1)."""
    backend = _backend_for(device)
    if backend == "nccl":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < nprocs:
            raise ValueError(f"spmd.run: {nprocs} ranks on the card need "
                             f"{nprocs} CUDA devices, {have} visible; pass "
                             f"device='cpu' for host processes")
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // nprocs)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_spmd_")
    store = os.path.join(tmp, "store")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(fn, r, nprocs, device, store, timeout,
                               threads, out_q, args))
             for r in range(nprocs)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        done, result = set(), None
        while len(done) < nprocs:
            try:
                kind, rank, payload = out_q.get(timeout=0.2)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in done and p.exitcode not in (None, 0):
                        raise RankError(r, f"exited with code {p.exitcode} "
                                           f"before reporting")
                if time.monotonic() > deadline:
                    missing = sorted(set(range(nprocs)) - done)
                    raise TimeoutError(
                        f"spmd.run: ranks {missing} did not finish within "
                        f"{timeout} s")
                continue
            if kind == "error":
                text, trace, exc = payload
                err = RankError(rank, text, trace)
                cause = pickle.loads(exc) if exc is not None else None
                raise err from cause
            done.add(rank)
            if rank == 0:
                result = payload
        for p in procs:
            p.join(max(0.1, min(10.0, deadline - time.monotonic())))
        return result
    finally:
        _stop(procs)
        out_q.close()
        shutil.rmtree(tmp, ignore_errors=True)
