"""Dynamic batching: FIFO admission windows, padding buckets, exec cache.

Requests are admitted strictly in arrival order (the window is a FIFO prefix
of the queue — later arrivals can never overtake an earlier one into a
window, which is what rules out starvation).  A window's micro-batches are
padded up to a small set of bucket sizes, so the engine runs one entry of
its ``ExecCache`` per ``(bucket, backend, timesteps)`` instead of one per
observed batch size (``timesteps`` keys the SLO-degraded variants, see
``admission.slo_filter``).

Padding frames are all-zero: under direct coding a zero frame injects zero
current, so with this repo's zero-init sub-threshold biases padded rows fire
no spikes.  *Trained* params can have supra-threshold biases that make even
zero rows fire — the engine subtracts the (deterministic, per-row identical)
zero-frame spike profile from its accumulated counts so spike/energy metrics
stay exact either way (see ``ServingEngine._accumulate``).  Padded logit
rows are sliced off before results are returned.

``DynamicBatcher`` is thread-safe: in the threaded engine the scheduler
thread forms windows while completions (lane-failure re-queues) land from
worker-adjacent paths, so every queue op holds one internal lock.  The lock
is uncontended on the single-threaded virtual-clock path.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch.serving.request import Request

__all__ = ["DEFAULT_BUCKETS", "bucket_for", "pad_frames", "ExecCache",
           "DynamicBatcher", "to_host", "to_device"]

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16)


def bucket_for(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n (deterministic; n above the largest bucket is a
    caller bug — windows are capped at max_batch <= max(buckets))."""
    if n <= 0:
        raise ValueError(f"empty batch (n={n})")
    for b in sorted(buckets):
        if n <= b:
            return int(b)
    raise ValueError(f"batch of {n} exceeds largest bucket {max(buckets)}")


def pad_frames(frames: Sequence[np.ndarray], bucket: int) -> np.ndarray:
    """Stack (H, W, C) frames into a (bucket, H, W, C) zero-padded batch."""
    x = np.stack([np.asarray(f, dtype=np.float32) for f in frames])
    if x.shape[0] < bucket:
        pad = np.zeros((bucket - x.shape[0],) + x.shape[1:], x.dtype)
        x = np.concatenate([x, pad], axis=0)
    return x


def to_host(tree):
    """Every tensor of ``tree`` (an output or carry NamedTuple, a tensor)
    as a host numpy array.  The copy waits for the device, so a wall clock
    read after it sees finished work."""
    return tree_map(lambda a: a.detach().cpu().numpy()
                    if isinstance(a, torch.Tensor) else a, tree)


def to_device(tree, device: torch.device):
    """Every numpy array or tensor of ``tree`` as a tensor on ``device``."""
    return tree_map(lambda a: torch.as_tensor(a, device=device)
                    if isinstance(a, (np.ndarray, torch.Tensor)) else a, tree)


class ExecCache:
    """One eager ``snn_apply`` callable per (bucket, backend, outputs,
    timesteps): the engine's execution cache (the reference's ``JitCache``).
    PyTorch runs eagerly, so an entry is a closure and building it compiles
    nothing; the kernels are built once per process at first launch.  The
    explicit cache keeps the reference's keys, its bounded entry set and
    its ``compiles`` count (entries built).

    ``outputs="logits"`` returns the logits alone (the engine's throughput
    mode); metric-bearing paths use ``"full"``.

    ``timesteps`` builds a reduced-T variant of the network, the entry
    behind SLO admission's *degrade* action.  ``None`` means the config's
    T.

    ``chunk_timesteps`` (engine chunk scheduling) does two things: whole-T
    ``"full"``/``"logits"`` entries route through the chunked runner (bit
    -identical by the chunk-parity contract, so ``infer`` serves exactly
    what chunk-scheduled requests get), and ``outputs="chunk"`` entries
    become available — one ``snn_apply_chunk`` per
    ``(bucket, backend, "chunk", t_chunk)`` mapping
    ``(params, frames, carry) -> (ChunkOutputs, carry')``, what the engine
    dispatches per chunk.

    Every entry takes numpy arrays or tensors, moves them to the cache's
    device, and runs under ``torch.inference_mode()``, entered per call:
    the mode is thread-local, and a lane thread without it would build
    autograd graphs (and take the training kernel C instead of B).
    Outputs stay on the device; ``to_host`` copies them back.  Each lane
    of the threaded engine owns a ``fork``.

    ``device`` is where the cache runs: its parameters are moved there
    with ``.to(device)`` (default: where they already are).  They are
    held frozen (``snn_model.freeze_params``): what every forward would
    derive from them alone is derived once, when they are set.
    """

    def __init__(self, params, cfg, schedule=None, chunk_timesteps=None,
                 device=None):
        self.cfg = cfg
        self.schedule = schedule
        self.chunk_timesteps = chunk_timesteps
        self.device = None if device is None else torch.device(device)
        self.params = params        # setter moves them to the device
        self._fns: Dict[Tuple[int, str, str, int], object] = {}
        self.compiles = 0

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, params) -> None:
        from repro_torch.core.snn_model import freeze_params
        # keep the device pin across engine.update_params swaps
        if self.device is not None:
            params = tree_map(lambda t: t.to(self.device), params)
        self._params = freeze_params(params)

    def _param_device(self) -> torch.device:
        return self._params["conv"][0]["w"].device

    def _key(self, bucket: int, backend: str, outputs: str,
             timesteps: Optional[int]) -> Tuple[int, str, str, int]:
        t = self.cfg.timesteps if timesteps is None else int(timesteps)
        return (int(bucket), str(backend), str(outputs), t)

    def has(self, bucket: int, backend: str, outputs: str = "full",
            timesteps: Optional[int] = None) -> bool:
        return self._key(bucket, backend, outputs, timesteps) in self._fns

    def get(self, bucket: int, backend: str, outputs: str = "full",
            timesteps: Optional[int] = None):
        key = self._key(bucket, backend, outputs, timesteps)
        fn = self._fns.get(key)
        if fn is None:
            from repro_torch.core.snn_model import (finalize_logits,
                                                    snn_apply,
                                                    snn_apply_chunk,
                                                    snn_apply_chunked)
            cfg, sched = self.cfg, self.schedule
            if key[3] != cfg.timesteps and outputs not in ("chunk",
                                                           "finalize"):
                cfg = dataclasses.replace(cfg, timesteps=key[3])
            if outputs == "chunk":
                t_chunk = key[3]

                def run(p, x, c):
                    return snn_apply_chunk(p, x, c, cfg, t_chunk=t_chunk,
                                           backend=backend, schedule=sched)
            elif outputs == "finalize":
                # readout carry -> logits for a t_total-timestep request,
                # by the same device op the whole-T forward ends with (a
                # host division could round one ulp away from it and break
                # the chunked-vs-whole-T bit-parity contract)
                t_total = key[3]

                def run(v):
                    return finalize_logits(v, cfg, t_total)
            else:
                ct = self.chunk_timesteps
                logits_only = outputs == "logits"

                def run(p, x):
                    if ct is not None:
                        out = snn_apply_chunked(p, x, cfg, chunk_timesteps=ct,
                                                backend=backend,
                                                schedule=sched)
                    else:
                        out = snn_apply(p, x, cfg, backend=backend,
                                        schedule=sched)
                    return out.logits if logits_only else out
            fn = self._entry(run, self._param_device())
            self._fns[key] = fn
            self.compiles += 1
        return fn

    @staticmethod
    def _entry(run, device: torch.device):
        def call(*args):
            with torch.inference_mode():
                return run(*to_device(args, device))
        return call

    def run(self, frames: np.ndarray, backend: str,
            timesteps: Optional[int] = None):
        """Execute one padded bucket batch; returns the SNNOutputs (on the
        device)."""
        return self.get(frames.shape[0], backend,
                        timesteps=timesteps)(self.params, frames)

    def run_chunk(self, frames: np.ndarray, carry, backend: str,
                  t_chunk: int):
        """Execute one timestep chunk of a padded bucket batch; returns
        ``(ChunkOutputs, new carry)`` on the device — the carry's leading
        axis is the bucket, one row per request (pad rows carry zeros)."""
        return self.get(frames.shape[0], backend, outputs="chunk",
                        timesteps=t_chunk)(self.params, frames, carry)

    def finalize(self, readout_v, backend: str, t_total: int) -> np.ndarray:
        """Carried readout state -> host logits for one ``t_total``-timestep
        request (row or batch), by the whole-T forward's own device op."""
        return to_host(self.get(0, backend, outputs="finalize",
                                timesteps=t_total)(readout_v))

    def fork(self, device=None) -> "ExecCache":
        """A lane-private cache sharing every entry built so far; an entry
        built after the fork stays private to the copy.  ``device`` pins
        the fork elsewhere (default: the parent's device); a fork on
        another device starts with no entries, since an entry moves its
        inputs to the device it was built for."""
        device = self.device if device is None else torch.device(device)
        c = ExecCache(self.params, self.cfg, schedule=self.schedule,
                      chunk_timesteps=self.chunk_timesteps, device=device)
        if c._param_device() == self._param_device():
            c._fns = dict(self._fns)
        return c


class DynamicBatcher:
    """FIFO request queue + window former (thread-safe).

    ``push`` enqueues; ``take_window`` pops the FIFO prefix of requests that
    have arrived by engine time ``t`` (capped at ``max_batch * num_lanes``).
    Queue-depth samples feed the metrics module.
    """

    # lock discipline (checked by repro.analysis rule "lock-discipline"):
    # client threads push while the scheduler pops/sweeps
    _GUARDED_BY = {"_queue": "_lock"}

    def __init__(self, max_batch: int,
                 buckets: Sequence[int] = DEFAULT_BUCKETS):
        if max_batch > max(buckets):
            raise ValueError(
                f"max_batch={max_batch} exceeds largest bucket {max(buckets)}")
        self.max_batch = int(max_batch)
        self.buckets = tuple(sorted(buckets))
        self._queue: Deque[Request] = deque()
        self._lock = threading.Lock()

    def push(self, req: Request) -> None:
        with self._lock:
            self._queue.append(req)

    def push_front(self, reqs: Sequence[Request]) -> None:
        """Re-queue retried requests at the head (they keep FIFO priority)."""
        with self._lock:
            for r in reversed(list(reqs)):
                self._queue.appendleft(r)

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)

    def next_arrival(self) -> Optional[float]:
        with self._lock:
            return self._queue[0].arrival if self._queue else None

    def earliest_deadline(self) -> Optional[float]:
        """Earliest absolute expiry among queued requests (None when no
        queued request carries a deadline) — the scheduler parks no longer
        than this so an expiring request fails *at* its deadline instead of
        at the next unrelated event."""
        with self._lock:
            ds = [r.expires_at for r in self._queue
                  if r.deadline_s is not None]
        return min(ds) if ds else None

    def sweep(self, now: float) -> List[Request]:
        """Drop cancelled and deadline-expired requests from the queue (in
        FIFO order) and return them — the scheduler fails their handles
        (expired) or simply discards them (cancelled handles were already
        failed by ``cancel()``).  Requests re-queued after a lane death are
        swept like any other: their deadline is a client contract that a
        lane failure does not extend."""
        dropped: List[Request] = []
        with self._lock:
            kept: Deque[Request] = deque()
            for r in self._queue:
                if r.cancelled or r.expired(now):
                    dropped.append(r)
                else:
                    kept.append(r)
            self._queue = kept
        return dropped

    def take_window(self, t: float, num_lanes: int) -> List[Request]:
        """FIFO prefix of arrived requests, at most max_batch per lane."""
        cap = self.max_batch * max(1, int(num_lanes))
        window: List[Request] = []
        with self._lock:
            while self._queue and len(window) < cap \
                    and self._queue[0].arrival <= t:
                window.append(self._queue.popleft())
        return window
