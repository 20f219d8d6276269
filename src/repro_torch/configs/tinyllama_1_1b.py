"""tinyllama-1.1b [dense] -- llama2-arch small [arXiv:2401.02385; hf].
22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000."""
import dataclasses

from .base import ModelConfig

ARCH_ID = "tinyllama-1.1b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=64,
    d_ff=5632,
    vocab=32000,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=10_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, attn_chunk=32,
)
