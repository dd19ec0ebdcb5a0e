"""Rotary position embeddings (half-rotation convention, LLaMA-style),
computed in float32."""
from __future__ import annotations

import torch

__all__ = ["rope_freqs", "apply_rope"]


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Rotates the
    pairs (x[..., :D/2], x[..., D/2:]), the same convention for q and k."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                       # (D/2,)
    ang = positions.to(torch.float32)[..., None] * inv        # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                         # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
