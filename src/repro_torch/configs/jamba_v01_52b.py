"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H(kv=8) d_ff=14336 — Mamba+attn
1:7 interleave (attention at layer i % 8 == 4), MoE 16e top-2 at odd layers.
[arXiv:2403.19887; hf]
"""
from repro_torch.config import (ATTN_FULL, FFN_DENSE, FFN_MOE, MAMBA, ArchConfig,
                          AttnConfig, MambaConfig, MoEConfig, register)

# one 8-layer period: mixers M M M M A M M M (attn at offset 4),
# ffn alternates dense/MoE starting dense at even offsets.
_PERIOD = tuple(
    (ATTN_FULL if i == 4 else MAMBA, FFN_MOE if i % 2 == 1 else FFN_DENSE)
    for i in range(8)
)

JAMBA = register(ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    attn=AttnConfig(num_q_heads=32, num_kv_heads=8, head_dim=128),
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336, num_shared=0,
                  capacity_factor=1.25),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, chunk=128),
    stages=((4, _PERIOD),),
    source="arXiv:2403.19887 (Jamba v0.1); attn period 8 offset 4, MoE period 2",
))
