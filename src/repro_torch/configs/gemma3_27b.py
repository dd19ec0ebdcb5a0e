"""gemma3-27b [dense]: 62L d_model=5376 32H(kv=16) d_ff=21504 vocab=262144.

5:1 local:global (window 1024), 128k context.  62 = 10 periods of 6 + 2 local.
[hf:google/gemma-3-27b-pt]
"""
from repro_torch.config import (ATTN_FULL, ATTN_SLIDING, FFN_DENSE, ArchConfig,
                          AttnConfig, register)

_PERIOD = tuple((ATTN_SLIDING, FFN_DENSE) for _ in range(5)) + ((ATTN_FULL, FFN_DENSE),)

GEMMA3_27B = register(ArchConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    d_ff=21504,
    vocab_size=262144,
    attn=AttnConfig(num_q_heads=32, num_kv_heads=16, head_dim=128, window=1024,
                    rope_theta=1_000_000.0),
    stages=(
        (10, _PERIOD),
        (2, ((ATTN_SLIDING, FFN_DENSE),)),
    ),
    tie_embeddings=True,
    source="hf:google/gemma-3-27b-pt; 5:1 local:global, window 1024",
))
