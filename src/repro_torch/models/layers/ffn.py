"""Dense FFNs: SwiGLU (qwen, gemma, command-r, pixtral, hubert) and the
RWKV channel-mix (token shift and squared ReLU), used in place of SwiGLU
when the config carries ``rwkv``."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers.leaves import Leaves, normal
from repro_torch.sharding.context import local_body, shard_logical

__all__ = ["SwiGLU", "RWKVChannelMix", "swiglu_apply", "rwkv_cmix_apply",
           "swiglu_specs", "rwkv_cmix_specs"]


def swiglu_specs():
    return {"w_gate": ("fsdp", "ffn"), "w_up": ("fsdp", "ffn"),
            "w_down": ("ffn", "fsdp")}


def rwkv_cmix_specs():
    return {"mix_k": (None,), "w_k": ("fsdp", "ffn"), "w_v": ("ffn", "fsdp")}


class SwiGLU(Leaves):
    """``w_gate``, ``w_up`` (d, d_ff) and ``w_down`` (d_ff, d)."""

    def __init__(self, d_model: int, d_ff: int, *,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        s_in, s_out = d_model ** -0.5, d_ff ** -0.5
        self.w_gate = normal((d_model, d_ff), s_in, generator, dtype, device)
        self.w_up = normal((d_model, d_ff), s_in, generator, dtype, device)
        self.w_down = normal((d_ff, d_model), s_out, generator, dtype,
                             device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu_apply(self, x)


class RWKVChannelMix(Leaves):
    """``mix_k`` (d,) at 0.5, ``w_k`` (d, d_ff) and ``w_v`` (d_ff, d)."""

    def __init__(self, d_model: int, d_ff: int, *,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.mix_k = torch.nn.Parameter(torch.full((d_model,), 0.5,
                                                   dtype=dtype,
                                                   device=device))
        self.w_k = normal((d_model, d_ff), d_model ** -0.5, generator, dtype,
                          device)
        self.w_v = normal((d_ff, d_model), d_ff ** -0.5, generator, dtype,
                          device)

    def forward(self, x: torch.Tensor, x_prev=None) -> torch.Tensor:
        return rwkv_cmix_apply(self, x, x_prev)


def swiglu_apply(params, x: torch.Tensor) -> torch.Tensor:
    with local_body(params, x,
                    axes={"ffn": params["w_up"].shape[1]}) as b:
        p, x = b.params, b.x
        dt = x.dtype
        h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
        h = shard_logical(h, ("batch", None, "ffn"))
        return b.out(h @ p["w_down"].to(dt), ("batch", None, None))


def rwkv_cmix_apply(params, x: torch.Tensor, x_prev=None) -> torch.Tensor:
    """x: (B, S, D); x_prev: (B, 1, D), the last token of the previous
    segment (zeros at the start of a sequence)."""
    with local_body(params, x, axes={"ffn": params["w_k"].shape[1]}) as b:
        p, x = b.params, b.x
        dt = x.dtype
        x_prev = (torch.zeros_like(x[:, :1]) if x_prev is None
                  else b.local(x_prev))
        shifted = torch.cat([x_prev, x[:, :-1]], dim=1)
        mix = p["mix_k"].to(dt)
        xk = x * mix + shifted * (1.0 - mix)
        h = torch.square(torch.relu(xk @ p["w_k"].to(dt)))
        h = shard_logical(h, ("batch", None, "ffn"))
        return b.out(h @ p["w_v"].to(dt), ("batch", None, None))
