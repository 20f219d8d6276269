"""llama3.2-3b [dense] -- small llama3 [hf:meta-llama/Llama-3.2-1B; unverified].
28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256."""
import dataclasses

from .base import ModelConfig

ARCH_ID = "llama3.2-3b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=128256,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=500_000.0,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, attn_chunk=32,
)
