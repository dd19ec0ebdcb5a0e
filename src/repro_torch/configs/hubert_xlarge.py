"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.

Encoder-only (same backbone as wav2vec2-xlarge).  The conv waveform frontend
is a stub: the model takes precomputed frame embeddings of dim
``frontend_dim``.  No decode step exists for this arch.
[arXiv:2106.07447]
"""
from repro_torch.config import ArchConfig, AttnConfig, register

HUBERT_XLARGE = register(ArchConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    d_ff=5120,
    vocab_size=504,
    attn=AttnConfig(num_q_heads=16, num_kv_heads=16, head_dim=80, qkv_bias=True),
    is_encoder_only=True,
    frontend="frames",
    frontend_dim=512,     # wav2vec2/HuBERT conv stem output dim
    source="arXiv:2106.07447 (HuBERT X-Large); encoder-only",
))
