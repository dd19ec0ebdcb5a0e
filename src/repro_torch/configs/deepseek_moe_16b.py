"""deepseek-moe-16b [moe]: 28L d_model=2048 16H(kv=16) — 2 shared + 64 routed
top-6, fine-grained experts d_expert=1408; first layer dense (d_ff=10944).
[arXiv:2401.06066; hf]
"""
from repro_torch.config import (ATTN_FULL, FFN_DENSE, FFN_MOE, ArchConfig,
                          AttnConfig, MoEConfig, register)

DEEPSEEK_MOE = register(ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    d_ff=10944,                       # dense layer 0
    vocab_size=102400,
    attn=AttnConfig(num_q_heads=16, num_kv_heads=16, head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
                  capacity_factor=1.25),
    stages=(
        (1, ((ATTN_FULL, FFN_DENSE),)),
        (27, ((ATTN_FULL, FFN_MOE),)),
    ),
    source="arXiv:2401.06066 (DeepSeekMoE 16B)",
))
