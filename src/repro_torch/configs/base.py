"""The model configuration dataclass (copied from ``repro/configs/base.py``).

Fields keep their JAX names and defaults, so a configuration reads the same
in both packages; ``param_dtype`` and ``compute_dtype`` are torch dtypes
(float32 master weights, bf16 compute). ``MeshConfig`` is copied too: the
fleet controller's re-mesh plans (``distributed.fault_tolerance``) take it,
and ``RunConfig``, every field kept, which the training step reads.
``sharding_rules`` and ``batch_axes`` are JAX's logical-axis rules for the
production meshes: the decoder LMs' sharded route (``models.layers``'
``MeshContext``) lays each rank's parameters out by them, and the dry run
(``launch.dryrun``) reads them to say what each device of a mesh would
hold. ``attn_shard`` and ``kv_cache_time_sharded`` keep JAX's ``TP_HINT``
rule: they follow the production mesh's TP of 16, whatever the mesh's own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

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

    @property
    def is_subquadratic(self) -> bool:
        """Archs that may run the long_500k shape (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    # The production mesh fixes TP = 16; head counts that do not divide it
    # get sequence-sharded attention and a time-sharded KV cache.
    TP_HINT = 16

    @property
    def attn_shard(self) -> str:
        """'heads' when the query heads divide TP, else 'seq' (attention
        sharded over the sequence)."""
        return "heads" if self.n_heads % self.TP_HINT == 0 else "seq"

    @property
    def kv_cache_time_sharded(self) -> bool:
        """The KV cache's logical axes shard time, not kv heads, when the kv
        heads do not divide TP."""
        return self.n_kv_heads % self.TP_HINT != 0


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


#: the payloads of RunConfig.grad_compression: the data-parallel gradient
#: mean of the sharded step (``optim.grad_utils.compressed_psum_mean``)
GRAD_COMPRESSION = ("none", "bf16", "int8")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: str  # key into SHAPES
    mesh: MeshConfig = MeshConfig()
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0
    microbatches: int = 1  # gradient-accumulation microbatches per step
    grad_compression: str = "none"  # none | bf16 | int8 (all-reduce payload)

    def __post_init__(self):
        if self.grad_compression not in GRAD_COMPRESSION:
            raise ValueError(f"grad_compression must be one of {GRAD_COMPRESSION}, "
                             f"got {self.grad_compression!r}")

    @property
    def shape_info(self) -> dict:
        return SHAPES[self.shape]


# --- logical-axis -> mesh-axis rules (see models/params.py) -------------------

def sharding_rules(cfg: ModelConfig, mesh: MeshConfig) -> dict[str, Any]:
    """Resolve logical parameter/activation axes onto the production mesh
    (JAX's rules, entry for entry).

    TP ('model') shards heads / mlp hidden / vocab / experts. Under FSDP the
    residual-stream dimension of the weights is also sharded over the data
    axes, so float32 masters and optimizer state scale with the fleet.
    ``layout='dp'`` is pure data parallelism over the whole mesh with FSDP
    weights: no TP activation traffic, only the gradient reduction and the
    per-layer weight gathers.
    """
    data_axes = ("pod", "data") if mesh.multi_pod else ("data",)
    if cfg.layout == "dp":
        all_axes = data_axes + ("model",)
        return {
            "layer": None,
            "dmodel": all_axes,
            "heads": None, "kv_heads": None, "mlp": None,
            "vocab": None, "expert": None, "conv": None, "state": None,
            "batch": all_axes,
            "act_seq": None, "act_heads": None, "act_vocab": None,
            "act_expert": None, "cache_time": None,
        }
    return {
        "layer": None,
        "dmodel": data_axes if cfg.fsdp else None,
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "expert_dmodel": data_axes if (cfg.fsdp and cfg.expert_fsdp) else None,
        "conv": None,
        "state": None,
        # activation axes
        "batch": data_axes,
        "act_seq": "model",
        "act_heads": "model",
        "act_vocab": "model",
        "act_expert": "model",
        "cache_time": "model",
    }


def batch_axes(mesh: MeshConfig) -> tuple[str, ...]:
    return ("pod", "data") if mesh.multi_pod else ("data",)
