"""deepseek-v3-671b [moe]: 61L d_model=7168, MLA, MoE 256e top-8 + 1 shared.

First 3 layers use a dense FFN (d_ff=18432); the remaining 58 use fine-grained
MoE with d_expert=2048.  MLA: q LoRA rank 1536, kv LoRA rank 512, decoupled
RoPE head (64) + nope head (128), v head 128.  [arXiv:2412.19437; hf]
"""
from repro_torch.config import (ATTN_MLA, FFN_DENSE, FFN_MOE, ArchConfig, AttnConfig,
                          MoEConfig, register)

DEEPSEEK_V3 = register(ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    d_ff=18432,                       # dense layers (first 3)
    vocab_size=129280,
    attn=AttnConfig(
        num_q_heads=128, num_kv_heads=128, head_dim=128,
        q_lora_rank=1536, kv_lora_rank=512,
        qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
    ),
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048, num_shared=1,
                  capacity_factor=1.25),
    stages=(
        (3, ((ATTN_MLA, FFN_DENSE),)),
        (58, ((ATTN_MLA, FFN_MOE),)),
    ),
    source="arXiv:2412.19437 (DeepSeek-V3); MLA + 1 shared + 256 routed top-8",
))
