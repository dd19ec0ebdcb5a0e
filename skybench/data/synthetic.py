"""Frozen copies of the port's synthetic frame sets (``data/synthetic.py``):
the same numpy draws, so the same seed gives the same arrays bit for bit.

``mnist_like`` renders 28x28 seven-segment digits with jitter and noise;
``road_like`` draws road scenes with a bright perspective trapezoid.  The
benchmark keeps its own copy so that a change to the program's generators
cannot change what the benchmark feeds it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["mnist_like", "road_like"]

_SEGS = {  # 7-segment-like strokes on a 20x12 canvas, per digit
    0: "abcdef", 1: "bc", 2: "abged", 3: "abgcd", 4: "fgbc",
    5: "afgcd", 6: "afgedc", 7: "abc", 8: "abcdefg", 9: "abgfcd",
}
_SEG_COORDS = {  # (y0, x0, y1, x1) line endpoints
    "a": (1, 2, 1, 9), "b": (1, 9, 9, 9), "c": (9, 9, 17, 9),
    "d": (17, 2, 17, 9), "e": (9, 2, 17, 2), "f": (1, 2, 9, 2),
    "g": (9, 2, 9, 9),
}


def _render_digit(digit: int, rng: np.random.Generator) -> np.ndarray:
    img = np.zeros((28, 28), np.float32)
    oy, ox = rng.integers(2, 8), rng.integers(4, 12)
    thick = rng.integers(1, 3)
    for seg in _SEGS[digit]:
        y0, x0, y1, x1 = _SEG_COORDS[seg]
        n = max(abs(y1 - y0), abs(x1 - x0)) + 1
        ys = np.linspace(y0, y1, n).astype(int) + oy
        xs = np.linspace(x0, x1, n).astype(int) + ox
        for t in range(int(thick)):
            img[np.clip(ys + t, 0, 27), np.clip(xs, 0, 27)] = 1.0
            img[np.clip(ys, 0, 27), np.clip(xs + t, 0, 27)] = 1.0
    img += rng.normal(0, 0.08, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def mnist_like(n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(n, 28, 28, 1) float images in [0,1]; (n,) int labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    imgs = np.stack([_render_digit(int(d), rng) for d in labels])
    return imgs[..., None], labels.astype(np.int32)


def road_like(n: int, h: int = 80, w: int = 160, seed: int = 0
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(n, h, w, 3) frames; (n, h, w, 1) binary lane masks."""
    rng = np.random.default_rng(seed)
    frames = rng.uniform(0.0, 0.35, (n, h, w, 3)).astype(np.float32)
    masks = np.zeros((n, h, w, 1), np.float32)
    for i in range(n):
        cx = rng.uniform(0.35, 0.65) * w
        top_w = rng.uniform(0.05, 0.15) * w
        bot_w = rng.uniform(0.45, 0.8) * w
        horizon = int(rng.uniform(0.25, 0.45) * h)
        for y in range(horizon, h):
            frac = (y - horizon) / max(1, h - horizon)
            half = 0.5 * (top_w + frac * (bot_w - top_w))
            x0, x1 = int(max(0, cx - half)), int(min(w, cx + half))
            masks[i, y, x0:x1, 0] = 1.0
            frames[i, y, x0:x1, :] += 0.4  # road is brighter
    return np.clip(frames, 0, 1), masks
