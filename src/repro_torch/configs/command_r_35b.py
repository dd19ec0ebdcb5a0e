"""command-r-35b [dense]: 40L d_model=8192 64H(kv=8) d_ff=22528 vocab=256000.

GQA, no biases.  [hf:CohereForAI/c4ai-command-r-v01]
"""
from repro_torch.config import ArchConfig, AttnConfig, register

COMMAND_R = register(ArchConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    d_ff=22528,
    vocab_size=256000,
    attn=AttnConfig(num_q_heads=64, num_kv_heads=8, head_dim=128,
                    rope_theta=8_000_000.0),
    tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01",
))
