"""The plain reference of the benchmark's language models.

Plain PyTorch in float32 with TF32 off (``exact_float32``): one full
forward over each whole sequence, with no cache, no dispatch and no
capacity, layer by layer, the whole batch at once.  Each layer's weights
come from a function of the block (``weights(block)``: the weight law of
``data/lm_weights.py``, drawn again) and are upcast to float32 on the
device.  It reads the widths from the ``model`` block of a configuration
file (the published config's keys) and knows nothing of the program.

Every layer is RMSNorm, its mixer, RMSNorm, its FFN, each added to the
residual stream; an RMSNorm and the untied head end the model.  A mixer or
an FFN is a layer kind, named in the layer pattern: ``kinds/<name>.py``
gives its leaves and their law (``leaves``), its plain forward
(``reference``) and a decode step's work (``decode_work``), so another
kind is a file added there; the caller hands ``forward`` each layer's
two kind modules.

``control=True`` rounds both operands of every product (projections,
scores, the weighted values, the router, the experts, the head) to float8
e4m3 with one scale a tensor (its largest magnitude at e4m3's 448): the
precision below the configuration's bfloat16 that the control runs in.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["exact_float32", "to_e4m3", "mm", "rms", "rope", "swiglu",
           "RefLogits", "forward"]

E4M3_MAX = 448.0


def exact_float32() -> None:
    """Float32 products without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale, back in float32."""
    s = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def mm(a: torch.Tensor, b: torch.Tensor, control: bool) -> torch.Tensor:
    if control:
        a, b = to_e4m3(a), to_e4m3(b)
    return a @ b


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) at positions 0 .. S - 1, rotated by half."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(x.shape[1], dtype=torch.float32,
                       device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def swiglu(x, w_gate, w_up, w_down, control: bool) -> torch.Tensor:
    return mm(F.silu(mm(x, w_gate, control)) * mm(x, w_up, control),
              w_down, control)


class RefLogits(NamedTuple):
    logits: torch.Tensor          # (B, S - score_from, V) float32
    routes: List[torch.Tensor]    # per routed layer: (B, S, k) choices


def _part(w: Dict, prefix: str) -> Dict:
    return {k[len(prefix):]: v for k, v in w.items() if k.startswith(prefix)}


def forward(model: Dict, weights: Callable[[object], Dict],
            tokens: torch.Tensor, score_from: int, *, kinds,
            control=False) -> RefLogits:
    """Logits at positions ``score_from`` .. S - 1 of ``tokens`` (B, S);
    ``kinds``: each layer's (mixer, ffn) kind modules."""
    eps = model["rms_norm_eps"]

    def upcast(block):
        return {n: t.to(torch.float32) for n, t in weights(block).items()}

    x = upcast("embed")["embed.tok"][tokens.long()]
    routes = []
    for i, (mixer, ffn) in enumerate(kinds):
        w = upcast(i)
        h = rms(x, w["norm1.scale"], eps)
        x = x + mixer.reference(model, _part(w, "mixer."), h, control)[0]
        h = rms(x, w["norm2.scale"], eps)
        y, r = ffn.reference(model, _part(w, "ffn."), h, control)
        x = x + y
        if r is not None:
            routes.append(r)
        del w
    w = upcast("head")
    h = rms(x[:, score_from:], w["final_norm.scale"], eps)
    return RefLogits(mm(h, w["embed.head"], control), routes)
