"""starcoder2-7b [dense] -- GQA, RoPE [arXiv:2402.19173; hf].
32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
StarCoder2 uses LayerNorm + plain-GELU MLP with biases."""
import dataclasses

from .base import ModelConfig

ARCH_ID = "starcoder2-7b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_head=128,
    d_ff=18432,
    vocab=49152,
    norm="layernorm",
    act="gelu",
    qkv_bias=True,
    rope_theta=100_000.0,
    fsdp=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, attn_chunk=32, fsdp=False,
)
