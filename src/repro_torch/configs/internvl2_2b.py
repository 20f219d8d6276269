"""internvl2-2b [vlm] -- InternViT + InternLM2 [arXiv:2404.16821; hf].
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
The ViT frontend is a stub: input_specs() supplies precomputed patch
embeddings [B, 256, D] prepended to the text stream."""
import dataclasses

from .base import ModelConfig

ARCH_ID = "internvl2-2b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=92553,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1_000_000.0,
    vis_tokens=256,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, vis_tokens=8, attn_chunk=32,
)
