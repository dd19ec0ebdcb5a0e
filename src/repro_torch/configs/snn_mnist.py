"""The paper's classification SNN: 28x28-16c-32c-8c-10 on MNIST (§IV)."""
from repro_torch.config import SNNConfig, register_snn

SNN_MNIST = register_snn(SNNConfig(
    name="snn-mnist",
    input_hw=(28, 28),
    input_channels=1,
    conv_channels=(16, 32, 8),
    kernel_size=3,
    dense_units=(10,),
    timesteps=8,
    v_threshold=1.0,
    aprc=True,
    num_spe_clusters=8,
    num_spes_per_cluster=4,
    source="Skydiver §IV: 28x28-16c-32c-8c-10, 98.5% MNIST, 22.6 KFPS",
))
