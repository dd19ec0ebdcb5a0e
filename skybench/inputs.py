"""Frames drawn from a run's seed, by the kind a traffic file names.

``digits``: ``mnist_like`` seven-segment digits with labels (sparse strokes
on a dark field); ``road``: ``road_like`` road scenes; ``uniform``: every
pixel uniform in [0, 1) (dense frames that fire everywhere).  Frames of
another size than a source draws (a narrowed configuration in the tests)
are its top-left crop, tiled where the source is smaller.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from skybench.data.synthetic import mnist_like, road_like

__all__ = ["sub_seed", "draw_frames", "FRAME_KINDS"]

FRAME_KINDS = ("digits", "road", "uniform")


def sub_seed(seed: int, tag: int) -> int:
    """A 32-bit seed for the part ``tag`` of a run, from the run's seed."""
    return int(np.random.SeedSequence([int(seed), int(tag)])
               .generate_state(1)[0])


def _fit(x: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    reps = (1, -(-h // x.shape[1]), -(-w // x.shape[2]), -(-c // x.shape[3]))
    return np.ascontiguousarray(np.tile(x, reps)[:, :h, :w, :c])


def draw_frames(kind: str, n: int, model: dict, seed: int
                ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """``n`` frames (n, H, W, Cin) float32 for ``model`` and their labels
    (``digits`` only, else None)."""
    h, w = model["input_hw"]
    c = model["input_channels"]
    if kind == "digits":
        x, y = mnist_like(n, seed=seed)
        return _fit(x, h, w, c), y
    if kind == "road":
        x, _ = road_like(n, h=h, w=w, seed=seed)
        return _fit(x, h, w, c), None
    if kind == "uniform":
        rng = np.random.default_rng(seed)
        return rng.random((n, h, w, c), dtype=np.float32), None
    raise ValueError(f"unknown frame kind {kind!r}; expected one of "
                     f"{FRAME_KINDS}")
