"""kimi-k2-1t-a32b [moe] -- Kimi K2, trillion-param MoE (paper-table)
[arXiv:2501.kimi2; unverified].
61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384e top-8.

Memory policy for 1T params on v5e-16GB chips: bf16 params + Adafactor
(factored second moment); fp32 AdamW state for 1T params would need
~23GB/chip even fully sharded over 512 devices.

The port serves it as SMOKE only: its 1T parameters fit no single card, and
its d_head of 112 is not among the flash kernel's head dims.
"""
import dataclasses

import torch

from .base import ModelConfig

ARCH_ID = "kimi-k2-1t-a32b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=112,
    d_ff=2048,  # per the assignment table: expert hidden size
    vocab=163840,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=50_000.0,
    moe_experts=384,
    moe_topk=8,
    moe_dff=2048,
    fsdp=True,
    param_dtype=torch.bfloat16,
    optimizer="adafactor",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=64, vocab=256, moe_experts=4, moe_topk=2, moe_dff=64,
    attn_chunk=32, fsdp=False, param_dtype=torch.float32, optimizer="adamw",
)
