"""rwkv6-7b [ssm]: 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536.

RWKV-6 "Finch": time-mix with data-dependent per-channel decay, implemented
as GLA-style chunked linear attention in the reference.
[arXiv:2404.05892; hf]
"""
from repro_torch.config import (FFN_DENSE, RWKV6, ArchConfig, RWKVConfig, register)

RWKV6_7B = register(ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    rwkv=RWKVConfig(head_dim=64, chunk=128),
    stages=((32, ((RWKV6, FFN_DENSE),)),),
    source="arXiv:2404.05892 (RWKV-6 Finch 7B)",
))
