"""whisper-medium [audio] -- enc-dec, conv frontend (stub) [arXiv:2212.04356].
24L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=51865.
24 encoder + 24 decoder layers; input_specs() supplies precomputed frame
embeddings [B, 1500, D] (the conv/mel frontend is a stub per the assignment)."""
import dataclasses

from .base import ModelConfig

ARCH_ID = "whisper-medium"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="encdec",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab=51865,
    norm="layernorm",
    act="gelu",
    qkv_bias=True,
    rope_theta=10_000.0,  # decoder positions: RoPE (deviation documented in DESIGN.md)
    enc_layers=24,
    enc_seq=1500,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=128, vocab=256, enc_seq=16, attn_chunk=32,
)
