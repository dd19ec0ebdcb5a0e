"""Atomic, async checkpoints of trees of tensors in the reference's layout
on disk, restored in place (``checkpointer``)."""
from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
