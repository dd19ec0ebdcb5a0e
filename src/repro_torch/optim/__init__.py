"""The optimizer (``adam``: AdamW updated in place), its LR schedules
(``schedules``) and int8 gradient compression with error feedback
(``compression``)."""
from repro_torch.optim import adam, compression, schedules

__all__ = ["adam", "compression", "schedules"]
