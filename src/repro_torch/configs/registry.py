"""--arch registry of the port: the dense family's, rwkv6's and jamba's
configurations.

The other families' ids are known, so ``get_config`` can say which ROADMAP
item (Queue 1, item 10) brings each one.
"""
from __future__ import annotations

from . import jamba_v0_1_52b, llama3_2_3b, qwen2_72b, rwkv6_7b, starcoder2_7b, tinyllama_1_1b
from .base import ModelConfig

_MODULES = (jamba_v0_1_52b, llama3_2_3b, qwen2_72b, rwkv6_7b, starcoder2_7b, tinyllama_1_1b)

ARCHS: dict[str, ModelConfig] = {m.ARCH_ID: m.CONFIG for m in _MODULES}
SMOKES: dict[str, ModelConfig] = {m.ARCH_ID: m.SMOKE for m in _MODULES}

#: ROADMAP Queue 1 item that brings each model family not ported yet
FAMILY_ITEM = {
    "moe": "10d (MoE, encdec and vlm)",
    "encdec": "10d (MoE, encdec and vlm)",
    "vlm": "10d (MoE, encdec and vlm)",
}

#: arch ids of the JAX package that the port does not serve yet, by family
NOT_PORTED = {
    "moonshot-v1-16b-a3b": "moe",
    "kimi-k2-1t-a32b": "moe",
    "whisper-medium": "encdec",
    "internvl2-2b": "vlm",
}


def not_ported(family: str) -> str:
    return (f"the {family!r} family is not ported yet: ROADMAP Queue 1 item "
            f"{FAMILY_ITEM[family]}")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    table = SMOKES if smoke else ARCHS
    if arch in NOT_PORTED:
        raise KeyError(f"--arch {arch!r}: {not_ported(NOT_PORTED[arch])}")
    if arch not in table:
        raise KeyError(f"unknown --arch {arch!r}; known: {sorted(table)}")
    return table[arch]
