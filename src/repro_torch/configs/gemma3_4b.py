"""gemma3-4b [dense]: 34L d_model=2560 8H(kv=4) d_ff=10240 vocab=262144.

5:1 local:global attention interleave (sliding window 1024; every 6th layer
global), 128k context.  34 = 5 full periods of 6 + 4 trailing local layers.
[hf:google/gemma-3-*-pt]
"""
from repro_torch.config import (ATTN_FULL, ATTN_SLIDING, FFN_DENSE, ArchConfig,
                          AttnConfig, register)

_PERIOD = tuple((ATTN_SLIDING, FFN_DENSE) for _ in range(5)) + ((ATTN_FULL, FFN_DENSE),)

GEMMA3_4B = register(ArchConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    d_ff=10240,
    vocab_size=262144,
    attn=AttnConfig(num_q_heads=8, num_kv_heads=4, head_dim=256, window=1024,
                    rope_theta=1_000_000.0),
    stages=(
        (5, _PERIOD),
        (4, ((ATTN_SLIDING, FFN_DENSE),)),
    ),
    tie_embeddings=True,
    source="hf:google/gemma-3-4b-pt; 5:1 local:global, window 1024",
))
