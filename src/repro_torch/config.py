"""SNN configs: a frozen dataclass plus a registry keyed by ``--snn`` id.

The PyTorch counterpart of the SNN half of ``repro.config``: the same
fields, the same registry functions, the same two registered networks
(``repro_torch.configs``).  The LM architectures come with a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

__all__ = ["SNNConfig", "register_snn", "get_snn", "list_snns"]


@dataclass(frozen=True)
class SNNConfig:
    """The paper's spiking networks (classification & segmentation)."""
    name: str
    input_hw: Tuple[int, int]
    input_channels: int
    # conv spec: list of (out_channels, kernel R); APRC turns these into
    # full-pad stride-1 convs. Classification net appends dense heads.
    conv_channels: Tuple[int, ...]
    kernel_size: int
    dense_units: Tuple[int, ...]      # trailing dense layers (e.g. (10,))
    timesteps: int
    v_threshold: float = 1.0
    aprc: bool = True                 # full-pad stride-1 structural change
    num_spe_clusters: int = 8         # M in Algorithm 1
    num_spes_per_cluster: int = 4     # N in Algorithm 1
    source: str = ""


_SNN_REGISTRY: dict = {}


def register_snn(cfg: SNNConfig) -> SNNConfig:
    _SNN_REGISTRY[cfg.name] = cfg
    return cfg


def _ensure_loaded() -> None:
    import repro_torch.configs  # noqa: F401  (import side-effect populates registry)


def get_snn(name: str) -> SNNConfig:
    _ensure_loaded()
    if name not in _SNN_REGISTRY:
        raise KeyError(f"unknown SNN {name!r}; have {sorted(_SNN_REGISTRY)}")
    return _SNN_REGISTRY[name]


def list_snns() -> Sequence[str]:
    _ensure_loaded()
    return sorted(_SNN_REGISTRY)
