"""jamba-v0.1-52b [hybrid] -- Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887].
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Sub-quadratic: runs long_500k (attention layers use a 32k sliding window
inside the 500k stream; Mamba carries long-range state)."""
import dataclasses

from .base import ModelConfig

ARCH_ID = "jamba-v0.1-52b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=65536,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=100_000.0,  # Jamba's attention layers use no explicit positions; RoPE kept
    sliding_window=32_768,
    moe_experts=16,
    moe_topk=2,
    moe_dff=14336,
    moe_every=2,
    attn_every=8,
    attn_offset=4,
    mamba_dstate=16,
    mamba_dconv=4,
    mamba_expand=2,
    fsdp=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, moe_experts=4, moe_topk=2, moe_dff=128,
    sliding_window=64, mamba_dstate=4, attn_chunk=32, fsdp=False,
)
