"""One worker process per mesh entry: the shards of a mesh call run at once.

A shard's host work (a ``snn-mnist`` forward is 127 launches, a batch-1
gradient row 222) is Python between launches.  Threads in one process
take turns at the GIL for it, so one worker *process* per entry runs each
shard: it is started once per entry (``spawn``), kept for the life of the
calling process and shared by every ``MeshRunner`` on that entry, and
holds the last ``VERSIONS`` params versions it was sent (numpy arrays,
sent with a version's first call there; both sides drop the least
recently used alike, so the caller knows what each worker holds).

``run_shards`` sends every shard's call before it receives any result,
then receives them in mesh order.  A call is a module-level function,
``fn(dev, replica, scratch, *args)``, taken by reference (``scratch``: a
dict of the worker's that lives as long as its params version), whose
result comes back pickled (host numpy, never device tensors).  A numpy
argument travels in one shared-memory block that the calling process
fills and the worker reads in place (a view, valid for the call): only
its place goes through the pipe.  A worker's exception is raised in the
caller once every shard has answered.  One mesh call runs at a time in a
process (a lock), since the workers are shared.  Workers are daemons:
they end with the calling process, or at ``shutdown()``.  The kernels'
launch counters of a worker are its own.  The pool is module state on
purpose: a worker costs seconds to start and a card's memory for its
context, so every runner of the process shares it.
"""
from __future__ import annotations

import atexit
import itertools
import multiprocessing
import threading
import time
import traceback
from collections import OrderedDict
from multiprocessing import shared_memory
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.snn_model import freeze_params
from repro_torch.device import on_device
from repro_torch.serving.batcher import to_device, to_host

__all__ = ["new_version", "run_shards", "shutdown"]

VERSIONS = 4                        # params versions a worker holds
# a process blocked on a pipe wakes tens to hundreds of µs after a message
# lands, so each side polls this long before it blocks
SPIN_S = 0.005
_VERSION_NO = itertools.count()
_LOCK = threading.Lock()            # one mesh call at a time; guards _POOL
_POOL: Dict[str, "_Worker"] = {}
_BLOCK: List[shared_memory.SharedMemory] = []   # the calling side's block


class _Shared:
    """A numpy argument's place in the shared block."""

    def __init__(self, block: str, offset: int, a: np.ndarray):
        self.block, self.offset = block, offset
        self.shape, self.dtype = a.shape, a.dtype.str

    def view(self, blocks: Dict) -> np.ndarray:
        shm = blocks.get(self.block)
        if shm is None:
            shm = blocks[self.block] = shared_memory.SharedMemory(self.block)
        return np.ndarray(self.shape, self.dtype, buffer=shm.buf,
                          offset=self.offset)


def _to_block(args: Sequence[Tuple]) -> List[Tuple]:
    """``args`` with every numpy array copied into the shared block (grown
    as needed) and replaced by its place."""
    arrays = [a for aa in args for a in aa if isinstance(a, np.ndarray)]
    size = sum(-(-a.nbytes // 64) * 64 for a in arrays)
    if not arrays:
        return [tuple(a) for a in args]
    if not _BLOCK or _BLOCK[0].size < size:
        _release_block()
        _BLOCK.append(shared_memory.SharedMemory(create=True,
                                                 size=max(size, 1 << 20)))
    shm, offset, out = _BLOCK[0], 0, []
    for aa in args:
        row = []
        for a in aa:
            if isinstance(a, np.ndarray):
                np.ndarray(a.shape, a.dtype, buffer=shm.buf,
                           offset=offset)[...] = a
                a, offset = _Shared(shm.name, offset, a), \
                    offset + -(-a.nbytes // 64) * 64
            row.append(a)
        out.append(tuple(row))
    return out


def _release_block() -> None:
    for shm in _BLOCK:
        shm.close()
        shm.unlink()
    _BLOCK.clear()


def new_version() -> int:
    """A params version number no other version of this process has."""
    return next(_VERSION_NO)


def _recv(conn):
    """``conn.recv()``, after polling the pipe for up to ``SPIN_S``."""
    end = time.perf_counter() + SPIN_S
    while not conn.poll() and time.perf_counter() < end:
        pass
    return conn.recv()


def _hold(held: OrderedDict, version: int) -> bool:
    """Mark ``version`` as the most recently used of ``held``, dropping
    the least recently used past ``VERSIONS``; False if it was new."""
    known = version in held
    held[version] = held.pop(version, None)
    while len(held) > VERSIONS:
        held.popitem(last=False)
    return known


def _replica(held: OrderedDict, dev: torch.device, version: int,
             params: Optional[Dict], frozen: bool) -> Tuple[Dict, Dict]:
    """The worker's copy of params ``version`` on ``dev`` (``params``, numpy
    leaves, come with a version's first call), frozen as the serving cache
    holds it when ``frozen``, and its scratch dict."""
    _hold(held, version)
    if params is not None:
        with on_device(dev):
            held[version] = {"params": to_device(params, dev)}
    entry = held.get(version)
    if entry is None:
        held.pop(version)
        raise RuntimeError(f"mesh worker on {dev}: does not hold params "
                           f"version {version}")
    if frozen not in entry:
        with on_device(dev), torch.no_grad():
            entry[frozen] = (freeze_params(entry["params"]) if frozen
                             else entry["params"], {})
    return entry[frozen]


def _main(conn, device: str) -> None:
    """The worker's loop: one reply for each request, until the pipe
    closes or a ``None`` arrives."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    held: OrderedDict = OrderedDict()       # version -> its replicas
    blocks: Dict[str, shared_memory.SharedMemory] = {}
    while True:
        try:
            msg = _recv(conn)
        except EOFError:
            return
        if msg is None:
            return
        fn, version, params, frozen, args = msg
        try:
            rep, scratch = _replica(held, dev, version, params, frozen)
            args = [a.view(blocks) if isinstance(a, _Shared) else a
                    for a in args]
            reply = ("ok", fn(dev, rep, scratch, *args))
        except Exception as e:              # sent back, raised there
            reply = ("error", e, traceback.format_exc())
        try:
            conn.send(reply)
        except Exception:                   # an unpicklable exception
            conn.send(("error", None, reply[-1]))


class _Worker:
    def __init__(self, dev: torch.device):
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_main, args=(child, str(dev)),
                                name=f"mesh-{dev}", daemon=True)
        self.proc.start()
        child.close()
        self.held: OrderedDict = OrderedDict()   # as the worker's ``held``

    def receive(self):
        try:
            return _recv(self.conn)
        except EOFError:
            return ("error", None, f"mesh worker {self.proc.name} ended "
                    f"(exit code {self.proc.exitcode})")


def _workers(devices: Sequence[torch.device]) -> List[_Worker]:
    out = []
    for dev in devices:
        w = _POOL.get(str(dev))
        if w is None or not w.proc.is_alive():
            w = _POOL[str(dev)] = _Worker(dev)
        out.append(w)
    return out


def run_shards(fn: Callable, devices: Sequence[torch.device],
               args: Sequence[Tuple], version: int, params: Dict,
               frozen: bool) -> List:
    """``fn(dev, replica, scratch, *a)`` on each entry's worker, every
    call sent before any result is received; the results in mesh order.
    ``params`` (any device) is sent to a worker that does not hold
    ``version``."""
    with _LOCK:
        workers = _workers(devices)
        host = None
        for w, a in zip(workers, _to_block(args)):
            send = None
            if not _hold(w.held, version):
                host = to_host(params) if host is None else host
                send = host
            w.conn.send((fn, version, send, frozen, a))
        replies = [w.receive() for w in workers]
    for w, reply in zip(workers, replies):
        if reply[0] != "ok":
            w.held.clear()
            exc, tb = reply[1], reply[2]
            if isinstance(exc, BaseException):
                raise exc
            raise RuntimeError(f"mesh worker {w.proc.name}:\n{tb}")
    return [reply[1] for reply in replies]


def shutdown() -> None:
    """Stop every worker process of this process."""
    with _LOCK:
        for w in _POOL.values():
            if w.proc.is_alive():
                w.conn.send(None)
            w.proc.join(timeout=10)
            if w.proc.is_alive():
                w.proc.terminate()
                w.proc.join()
        _POOL.clear()
        _release_block()


atexit.register(shutdown)
