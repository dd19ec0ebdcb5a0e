"""Checkpoints of trees of tensors: numpy payloads and a json manifest, in
the reference's layout on disk.

  * atomic    write to ``step_N.tmp/``, then rename to ``step_N/``: a crash
              mid-save never hides the latest good checkpoint;
  * async     ``save`` copies every leaf to the host before it returns
              (the next train step writes the tensors in place), and a
              thread writes the files; a write that fails is raised
              again by ``wait`` and by the next ``save``, so a save is
              never counted that did not reach the disk;
  * in place  ``restore(step, target)`` copies each leaf into the
              target's own tensor, on its device, and returns the target:
              a rollback never holds two states on the card;
  * the reference's files: ``arrays.npz`` holds one array per leaf, keyed
              by its path (the reference's ``/``-joined form: a dict key,
              a list index, ``.name`` for a NamedTuple's field, a module's
              parameter names split at their dots), and ``manifest.json``
              ``{"step", "leaves": {key: {"shape", "dtype"}}}``.  bfloat16
              is stored as its 16 bits (``uint16``), with ``bfloat16`` in
              the manifest; either package reads the other's directories.

A tree is what ``repro_torch.tree.flatten_with_paths`` walks: nested
dicts, lists, tuples and NamedTuples of tensors, and ``nn.Module``s.

On a mesh (``mesh=``: a torch ``DeviceMesh``, one process per entry) the
tree's DTensor leaves are saved in the same layout: leaf by leaf the
whole tensor is gathered, and only the mesh's rank 0 copies it to the
host and writes the files, so a checkpoint saved on a mesh restores on
one device and the other way round.  A restore reads the file on rank 0
only and scatters each leaf from there (a plain leaf is broadcast); the
other ranks never load it.  Rank 0 also answers ``latest_step`` and
``all_steps`` for every rank, so all ranks roll back to one step.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.tree import flatten_with_paths

__all__ = ["Checkpointer"]


def _leaves(tree) -> Dict[str, torch.Tensor]:
    leaves = flatten_with_paths(tree)
    for k, v in leaves.items():
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"checkpoint: leaf {k!r} is a "
                            f"{type(v).__name__}, not a tensor")
    return leaves


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of the tensor on the host (never a view of it: the caller
    goes on writing the tensor); bfloat16 as its 16 bits, uint16."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(
            np.uint16)
    return t.to("cpu", copy=True).numpy()


def _from_file(arr: np.ndarray, logical: str) -> torch.Tensor:
    """A stored array as a tensor of its logical dtype (the manifest's):
    bfloat16 from its 16 bits, read through ``torch.Tensor.view``."""
    if logical == "bfloat16" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if logical != str(arr.dtype):
        raise ValueError(f"checkpoint: stored {arr.dtype} for a leaf of "
                         f"{logical}, which this package cannot read")
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, *, mesh=None):
        self.dir = directory
        self.keep = keep
        self.mesh = mesh
        self.writer = mesh is None or dist.get_rank() == 0
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # the last ``save``'s seconds (to its return: with ``blocking``,
        # the files written) and the bytes of its leaves
        self.last_save_seconds = 0.0
        self.last_save_bytes = 0

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        t0 = time.perf_counter()
        leaves = _leaves(tree)
        manifest = {k: {"shape": list(v.shape),
                        "dtype": str(v.dtype).split(".")[1]}
                    for k, v in leaves.items()}
        payload = {}
        for k, v in leaves.items():
            if isinstance(v, DTensor):
                v = v.full_tensor()
            if self.writer:
                payload[k] = _to_host(v)
        self.last_save_bytes = sum(a.nbytes for a in payload.values())
        if not self.writer:
            self.last_save_seconds = time.perf_counter() - t0
            return
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, payload, manifest), daemon=True)
        self._thread.start()
        if blocking:
            self.wait()
        self.last_save_seconds = time.perf_counter() - t0

    def _write(self, step: int, payload: Dict[str, np.ndarray],
               manifest: Dict) -> None:
        try:
            self._write_files(step, payload, manifest)
        except BaseException as e:  # noqa: BLE001 — raised again by wait
            self._error = e

    def _write_files(self, step: int, payload: Dict[str, np.ndarray],
                     manifest: Dict) -> None:
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **payload)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self) -> None:
        """Waits for the pending write; raises what it raised (once)."""
        if self._thread is not None:
            self._thread.join()
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(f"checkpoint: writing to {self.dir} "
                               f"failed: {err!r}") from err

    def _gc(self) -> None:
        steps = self._all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        if self.mesh is None:
            return self._all_steps()
        box = [self._all_steps() if self.writer else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def _all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, step: int, target: Any) -> Any:
        """Copies checkpoint ``step`` into ``target``'s tensors in place
        (``copy_``, converting to each leaf's dtype on its device) and
        returns ``target``."""
        if self.mesh is not None:
            return self._restore_sharded(step, target)
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for key, leaf in _leaves(target).items():
                arr = data[key]
                logical = manifest.get(key, {}).get("dtype", str(arr.dtype))
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"checkpoint step {step}: {key} has "
                                     f"shape {arr.shape}, the target "
                                     f"{tuple(leaf.shape)}")
                leaf.copy_(_from_file(arr, logical))
        return target

    def _restore_sharded(self, step: int, target: Any) -> Any:
        path = os.path.join(self.dir, f"step_{step}")
        data, manifest = None, {}
        if self.writer:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)["leaves"]
            data = np.load(os.path.join(path, "arrays.npz"))
        try:
            for key, leaf in _leaves(target).items():
                local = leaf.to_local() if isinstance(leaf, DTensor) \
                    else leaf
                whole = torch.empty(leaf.shape, dtype=leaf.dtype,
                                    device=local.device)
                if self.writer:
                    arr = data[key]
                    if tuple(arr.shape) != tuple(leaf.shape):
                        raise ValueError(
                            f"checkpoint step {step}: {key} has shape "
                            f"{arr.shape}, the target {tuple(leaf.shape)}")
                    whole.copy_(_from_file(arr, manifest.get(key, {}).get(
                        "dtype", str(arr.dtype))))
                if isinstance(leaf, DTensor):
                    whole = distribute_tensor(
                        whole, leaf.device_mesh, leaf.placements,
                        src_data_rank=0).to_local()
                else:
                    dist.broadcast(whole, src=0)
                local.copy_(whole)
                del whole
        finally:
            if data is not None:
                data.close()
        return target
