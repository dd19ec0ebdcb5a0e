"""qwen2.5-3b [dense]: 36L d_model=2048 16H(kv=2) d_ff=11008 vocab=151936.

GQA with QKV bias.  [hf:Qwen/Qwen2.5-3B]
"""
from repro_torch.config import ArchConfig, AttnConfig, register

QWEN25_3B = register(ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    d_ff=11008,
    vocab_size=151936,
    attn=AttnConfig(num_q_heads=16, num_kv_heads=2, head_dim=128, qkv_bias=True,
                    rope_theta=1_000_000.0),
    tie_embeddings=True,
    source="hf:Qwen/Qwen2.5-3B; GQA kv=2, QKV bias",
))
