"""qwen2-72b [dense] -- GQA, QKV bias [arXiv:2407.10671; hf].
80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064."""
import dataclasses

from .base import ModelConfig

ARCH_ID = "qwen2-72b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=29568,
    vocab=152064,
    norm="rmsnorm",
    act="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    fsdp=True,  # 72B fp32 master + AdamW state must shard over the data axes
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, attn_chunk=32, fsdp=False,
)
