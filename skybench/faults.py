"""Faults planted under the timed path, for the check that a broken
program comes out not correct (``skybench/tests``) and for reading each
fault's numbers on the card (``calibrate.py --fault``).

- ``unchanged_state``: a train step that returns its loss but leaves the
  parameters and the optimizer's state as they were;
- ``half_batch``: a train step on the first half of the batch alone, its
  loss the mean over that half;
- ``altered_answer``: every answer changed where it is produced: each row
  of each ``Session.infer`` call, each request the engine finishes.
"""
from __future__ import annotations

import contextlib

import numpy as np

__all__ = ["FAULTS", "planted"]

FAULTS = ("unchanged_state", "half_batch", "altered_answer")


@contextlib.contextmanager
def planted(name: str):
    """Patch the program with the fault ``name`` for the block's span."""
    from repro_torch.api import Session
    from repro_torch.serving.engine import ServingEngine
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; expected one of {FAULTS}")
    saved = [(Session, "train_step", Session.train_step),
             (Session, "infer", Session.infer),
             (ServingEngine, "_finish_request",
              ServingEngine._finish_request)]
    train_step, infer = Session.train_step, Session.infer
    finish = ServingEngine._finish_request

    if name == "unchanged_state":
        def patched_train(self, x, y):
            params, mom = self.params, self._mom
            loss = train_step(self, x, y)
            self.params, self._mom = params, mom
            return loss
        Session.train_step = patched_train
    elif name == "half_batch":
        def patched_train(self, x, y):
            n = len(x) // 2
            return train_step(self, x[:n], y[:n])
        Session.train_step = patched_train
    else:
        def patched_infer(self, frames, **kw):
            out = infer(self, frames, **kw)
            return out._replace(logits=np.asarray(out.logits) + 1.0)

        def patched_finish(self, r, logits_row):
            return finish(self, r, np.asarray(logits_row) + 1.0)
        Session.infer = patched_infer
        ServingEngine._finish_request = patched_finish
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
