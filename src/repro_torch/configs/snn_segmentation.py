"""The paper's segmentation SNN: 160x80x3-8C3-16C3-32C3-32C3-16C3-1C3 (§IV).

189.5K parameters; lane-detection masks from the MLND-Capstone project.
Evaluated over 50 timesteps in the paper's workload study (Fig. 2).
"""
from repro_torch.config import SNNConfig, register_snn

SNN_SEG = register_snn(SNNConfig(
    name="snn-seg",
    input_hw=(80, 160),          # H x W (paper writes 160x80 as W x H)
    input_channels=3,
    conv_channels=(8, 16, 32, 32, 16, 1),
    kernel_size=3,
    dense_units=(),
    timesteps=16,
    v_threshold=1.0,
    aprc=True,
    num_spe_clusters=8,
    num_spes_per_cluster=4,
    source="Skydiver §IV: MLND-Capstone road segmentation, 110 FPS, 9.12 mJ",
))
