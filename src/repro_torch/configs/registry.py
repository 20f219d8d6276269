"""--arch registry of the port: maps every architecture id of the JAX
package to its configuration."""
from __future__ import annotations

from . import (
    internvl2_2b,
    jamba_v0_1_52b,
    kimi_k2_1t_a32b,
    llama3_2_3b,
    moonshot_v1_16b_a3b,
    qwen2_72b,
    rwkv6_7b,
    starcoder2_7b,
    tinyllama_1_1b,
    whisper_medium,
)
from .base import ModelConfig

_MODULES = (
    llama3_2_3b,
    qwen2_72b,
    starcoder2_7b,
    tinyllama_1_1b,
    moonshot_v1_16b_a3b,
    kimi_k2_1t_a32b,
    whisper_medium,
    internvl2_2b,
    jamba_v0_1_52b,
    rwkv6_7b,
)

ARCHS: dict[str, ModelConfig] = {m.ARCH_ID: m.CONFIG for m in _MODULES}
SMOKES: dict[str, ModelConfig] = {m.ARCH_ID: m.SMOKE for m in _MODULES}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    table = SMOKES if smoke else ARCHS
    if arch not in table:
        raise KeyError(f"unknown --arch {arch!r}; known: {sorted(table)}")
    return table[arch]
