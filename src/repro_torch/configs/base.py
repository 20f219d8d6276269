"""The model configuration dataclass (copied from ``repro/configs/base.py``).

Fields keep their JAX names and defaults, so a configuration reads the same
in both packages; ``param_dtype`` and ``compute_dtype`` are torch dtypes
(float32 master weights, bf16 compute). ``MeshConfig`` is copied too: the
fleet controller's re-mesh plans (``distributed.fault_tolerance``) take it.
The sharding rules are not copied: the port runs on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

# --- input shapes assigned to the LM family (all 10 archs) --------------------
#   name          seq_len   global_batch  step kind
SHAPES: Mapping[str, dict] = {
    "train_4k": dict(seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524_288, global_batch=1, kind="decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int

    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 500_000.0
    sliding_window: int = 0  # 0 = full attention

    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    moe_dff: int = 0  # per-expert hidden size
    moe_every: int = 1  # MoE FFN on layers where (layer % moe_every == moe_every-1)
    moe_capacity_factor: float = 1.25

    # hybrid (Jamba): attention on layers where (layer % attn_every == attn_offset)
    attn_every: int = 1
    attn_offset: int = 0
    mamba_dstate: int = 16
    mamba_dconv: int = 4
    mamba_expand: int = 2

    # rwkv6
    rwkv_head_size: int = 64

    # encoder-decoder (whisper): encoder consumes precomputed frame embeddings
    enc_layers: int = 0
    enc_seq: int = 1_500

    # vlm (internvl): precomputed patch embeddings prepended to the text stream
    vis_tokens: int = 0

    # numerics / memory policy
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    fsdp: bool = False
    remat: str = "layer"  # none | layer | full
    attn_chunk: int = 1024  # query chunk of the plain chunked attention
    use_pallas: str = "never"
    optimizer: str = "adamw"  # adamw | adamw8bit | adafactor
    scan_layers: bool = True
    layout: str = "tp"
    expert_fsdp: bool = True
    moe_combine_dtype: str = "f32"
    kv_cache_dtype: str = "bf16"  # bf16 | int8


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False
    pods: int = 2
    data: int = 16
    model: int = 16

    @property
    def n_devices(self) -> int:
        return (self.pods if self.multi_pod else 1) * self.data * self.model

    @property
    def dp(self) -> int:
        return (self.pods if self.multi_pod else 1) * self.data
