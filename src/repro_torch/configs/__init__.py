"""Architecture registry: importing this package registers every config.

LM archs                            SNN archs (the paper's own)
  hubert-xlarge      [audio]          snn-mnist
  deepseek-v3-671b   [moe]            snn-seg
  deepseek-moe-16b   [moe]
  jamba-v0.1-52b     [hybrid]
  rwkv6-7b           [ssm]
  gemma3-4b          [dense]
  qwen2.5-3b         [dense]
  gemma3-27b         [dense]
  command-r-35b      [dense]
  pixtral-12b        [vlm]
"""
from repro_torch.configs import (  # noqa: F401
    command_r_35b,
    deepseek_moe_16b,
    deepseek_v3_671b,
    gemma3_27b,
    gemma3_4b,
    hubert_xlarge,
    jamba_v01_52b,
    pixtral_12b,
    qwen2_5_3b,
    rwkv6_7b,
    snn_mnist,
    snn_segmentation,
)
