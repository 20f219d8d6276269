"""moonshot-v1-16b-a3b [moe] -- kimi/moonlight, 64e top-6
[hf:moonshotai/Moonlight-16B-A3B; hf].
48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6."""
import dataclasses

from .base import ModelConfig

ARCH_ID = "moonshot-v1-16b-a3b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,  # per the assignment table: expert hidden size
    vocab=163840,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=50_000.0,
    moe_experts=64,
    moe_topk=6,
    moe_dff=1408,
    fsdp=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=64, vocab=256, moe_experts=4, moe_topk=2, moe_dff=64,
    attn_chunk=32, fsdp=False,
)
