"""Where the port's entry points put their tensors.

Entry points run on the card unless the caller asks for the CPU: a
``device`` of ``None`` means ``"cuda"``, and asking for CUDA on a host
without it raises instead of quietly computing on the CPU.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

__all__ = ["resolve_device", "full_fp32", "on_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (the default) but "
            f"torch.cuda.is_available() is False; pass device='cpu' to run "
            f"the plain PyTorch path on the CPU")
    return dev


@contextlib.contextmanager
def full_fp32() -> Iterator[None]:
    """Run cuDNN convolutions and cuBLAS matmuls in full float32 (TF32 off)
    for the block, restoring the caller's settings after it.  The plain
    versions use it on the card so they compute the same float32 function
    as the kernels."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def on_device(device) -> contextlib.AbstractContextManager:
    """A context in which launches go to ``device``: ``torch.cuda.device``
    for an indexed card, nothing for the CPU or the current card.  The
    current card is per thread, so a serving lane enters it once."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        return torch.cuda.device(dev)
    return contextlib.nullcontext()
