"""Faults planted under the timed path, for the check that a broken
program comes out not correct (``skybench/tests``) and for reading each
fault's numbers on the card (``calibrate.py --fault``).

- ``unchanged_state``: a train step that returns its loss but leaves the
  parameters and the optimizer's state as they were;
- ``half_batch``: a train step on the first half of the batch alone, its
  loss the mean over that half;
- ``altered_answer``: every answer changed where it is produced: each row
  of each ``Session.infer`` call, each request the engine finishes, each
  decode step's logits (shifted by one token);
- ``unwritten_cache``: a decode step that leaves its KV cache as it was:
  the step's own key and value are never written;
- ``dropped_choice``: each token's last routed choice dropped in every MoE
  layer, as a choice past capacity is;
- ``no_shared``: the MoE layers' shared experts left out.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["FAULTS", "planted"]

FAULTS = ("unchanged_state", "half_batch", "altered_answer",
          "unwritten_cache", "dropped_choice", "no_shared")


def _patches(name: str):
    """(owner, attribute, replacement) of the fault ``name``."""
    from repro_torch.api import Session
    from repro_torch.models import transformer
    from repro_torch.models.layers import attention, moe
    from repro_torch.serving.engine import ServingEngine
    train_step, infer = Session.train_step, Session.infer
    finish = ServingEngine._finish_request
    decode_step, route = transformer.decode_step, moe.route

    if name == "unchanged_state":
        def patched_train(self, x, y):
            params, mom = self.params, self._mom
            loss = train_step(self, x, y)
            self.params, self._mom = params, mom
            return loss
        return [(Session, "train_step", patched_train)]
    if name == "half_batch":
        def patched_train(self, x, y):
            n = len(x) // 2
            return train_step(self, x[:n], y[:n])
        return [(Session, "train_step", patched_train)]
    if name == "altered_answer":
        def patched_infer(self, frames, **kw):
            out = infer(self, frames, **kw)
            return out._replace(logits=np.asarray(out.logits) + 1.0)

        def patched_finish(self, r, logits_row):
            return finish(self, r, np.asarray(logits_row) + 1.0)

        def patched_decode(*args, **kw):
            logits, caches = decode_step(*args, **kw)
            return torch.roll(logits, 1, dims=-1), caches
        return [(Session, "infer", patched_infer),
                (ServingEngine, "_finish_request", patched_finish),
                (transformer, "decode_step", patched_decode)]
    if name == "unwritten_cache":
        return [(attention, "write_token",
                 lambda c, new, slot, offset, split: c)]
    if name == "dropped_choice":
        def patched_route(params, x2d, m, capacity):
            top_vals, top_idx, pos, keep, aux = route(params, x2d, m,
                                                      capacity)
            keep = keep.clone()
            keep[:, -1] = False
            return top_vals, top_idx, pos, keep, aux
        return [(moe, "route", patched_route)]
    return [(moe, "swiglu_apply", lambda params, x: torch.zeros_like(x))]


@contextlib.contextmanager
def planted(name: str):
    """Patch the program with the fault ``name`` for the block's span."""
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; expected one of {FAULTS}")
    patches = _patches(name)
    saved = [(owner, attr, getattr(owner, attr))
             for owner, attr, _ in patches]
    for owner, attr, fn in patches:
        setattr(owner, attr, fn)
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
