"""rwkv6-7b [ssm] -- Finch, data-dependent decay [arXiv:2404.05892; hf].
32L d_model=4096 (attn-free) d_ff=14336 vocab=65536.
Sub-quadratic: runs long_500k (O(1) recurrent state per layer)."""
import dataclasses

from .base import ModelConfig

ARCH_ID = "rwkv6-7b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # wkv heads = d_model / rwkv_head_size
    n_kv_heads=64,
    d_head=64,
    d_ff=14336,
    vocab=65536,
    norm="layernorm",
    act="gelu",  # unused by the rwkv channel-mix (relu^2), kept for config parity
    rwkv_head_size=64,
    fsdp=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=256, rwkv_head_size=16, fsdp=False,
)
