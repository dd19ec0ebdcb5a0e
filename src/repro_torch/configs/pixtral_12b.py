"""pixtral-12b [vlm]: 40L d_model=5120 32H(kv=8) d_ff=14336 vocab=131072.

Mistral-Nemo-style decoder backbone; the Pixtral ViT frontend is a stub: the
model takes precomputed patch embeddings at the ViT width (1024), projected
into the backbone by a learned multimodal projector (part of this model).
[hf:mistralai/Pixtral-12B-2409]
"""
from repro_torch.config import ArchConfig, AttnConfig, register

PIXTRAL = register(ArchConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    d_ff=14336,
    vocab_size=131072,
    attn=AttnConfig(num_q_heads=32, num_kv_heads=8, head_dim=128,
                    rope_theta=1_000_000_000.0),
    frontend="patches+tokens",
    frontend_dim=1024,     # pixtral ViT hidden size
    num_patches=256,       # 1024x1024 image @ 16px patches, 4x pooled → 256 stub patches
    source="hf:mistralai/Pixtral-12B-2409; ViT stub + Nemo backbone",
))
