"""Registered SNN configs (importing this package fills the registry)."""
from repro_torch.configs import snn_mnist, snn_segmentation  # noqa: F401
