"""Host-side data pipeline: background prefetch onto the device.

``Prefetcher`` runs the host iterator in a thread and keeps ``depth``
batches ahead.  Given a card, the thread copies each batch there on a side
stream, from pinned memory with ``non_blocking=True``, so the copy of the
next batch overlaps the current step; the consumer's stream waits for that
copy (an event) before it uses the batch, and each tensor is recorded on
the consumer's stream, so the caching allocator does not hand its memory
out again while the step still reads it.  Given the CPU, each batch
becomes tensors there; given no device, batches pass through unchanged.
It never leaves a batch on the host when it was given a card.

On a mesh each rank runs its own ``Prefetcher`` over the same global
batches; ``shard`` picks the rank's part of each on the host (its rows
of the batch axis, ``batch_rows``), so only that part is copied to its
card.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["Prefetcher", "global_batch_iterator", "batch_rows"]


def batch_rows(index: int, count: int):
    """A ``shard`` for ``Prefetcher``: rows [index x n, (index + 1) x n)
    of every array of a batch, n = rows / count."""
    def shard(batch):
        out = {}
        for k, v in batch.items():
            n = v.shape[0] // count
            out[k] = v[index * n:(index + 1) * n]
        return out
    return shard


class Prefetcher:
    """Wrap a host iterator of dicts of arrays; keeps ``depth`` batches
    ahead, on ``device`` when one is given."""

    def __init__(self, it: Iterator[Dict[str, np.ndarray]],
                 device: Optional[Union[str, torch.device]] = None,
                 depth: int = 2,
                 shard: Optional[Callable[[Dict], Dict]] = None):
        self._it = it if shard is None else map(shard, it)
        self._device = None if device is None else resolve_device(device)
        self._stream = None
        if self._device is not None and self._device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self._device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _place(self, batch):
        """(batch on the device, the event its copy records; None off the
        card)."""
        if self._device is None:
            return batch, None
        if self._stream is None:
            return {k: torch.as_tensor(v).to(self._device)
                    for k, v in batch.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: torch.as_tensor(v).pin_memory().to(
                self._device, non_blocking=True) for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _worker(self):
        try:
            for batch in self._it:
                if self._stop.is_set():
                    return
                self._q.put(self._place(batch))
            self._q.put(None)          # normal exhaustion sentinel
        except BaseException as e:  # surfaced on next __next__
            self._err = e
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(done)
            for t in batch.values():
                t.record_stream(consumer)
        return batch

    def close(self):
        """Stop the worker: it ends at its next batch (the queue is drained
        so that a worker blocked on a full queue gets there)."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.01)
            except queue.Empty:
                pass
        self._thread.join()


def global_batch_iterator(make_host_iter: Callable[[int], Iterator],
                          device=None, depth: int = 2,
                          seed: int = 0) -> Prefetcher:
    return Prefetcher(make_host_iter(seed), device=device, depth=depth)
