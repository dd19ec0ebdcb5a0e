"""LR schedules: functions of the step counter, a 0-d tensor, returning a
0-d float32 tensor on its device (no host sync)."""
from __future__ import annotations

import math

import torch

__all__ = ["linear_warmup_cosine", "constant"]


def linear_warmup_cosine(step: torch.Tensor, *, peak_lr: float, warmup: int,
                         total: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor`` x ``peak_lr`` at ``total``; the reference's float32
    operations in its order."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(1, warmup)
    frac = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)


def constant(step: torch.Tensor, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full((), peak_lr, dtype=torch.float32,
                      device=torch.as_tensor(step).device)
