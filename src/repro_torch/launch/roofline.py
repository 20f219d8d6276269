"""Roofline terms of a dry-run cell on the H100 (counterpart of
``repro/launch/roofline.py``; the JSON schema of ``CellArtifact`` is JAX's).

Terms, per device:
    compute    = FLOPs_per_device / PEAK_FLOPS         (989e12 bf16 dense)
    memory     = bytes_per_device / HBM_BW             (3.35e12)
    collective = collective_bytes_per_device / LINK_BW (450e9)

The constants are the H100 SXM data sheet's (NVIDIA): dense bf16 tensor
cores without sparsity, 67e12 fp32 without tensor cores, HBM3 at 3.35e12
B/s, NVLink 4 at 900e9 B/s both directions (450e9 each), 80 GB of HBM.
They are the port's one home for these numbers: ``chip_smoke.py``'s kernel
bounds, ``core.cluster.H100_SXM`` and the dry run read them here.

``n_eff_per_token``, ``model_flops`` and ``extrapolate`` are JAX's, line for
line: the analytic MODEL_FLOPS (6 N D to train, 2 N D forward only) does
not depend on the chip. JAX's ``collective_bytes`` parses post-SPMD HLO;
the port has no HLO, and its dry run counts the collectives its sharding
specs imply instead (``launch.dryrun.collective_traffic``).

Depth extrapolation: the dry run counts a step at two depths L1 < L2 and
extrapolates linearly, total(L) = c(L1) + (L - L1) (c(L2) - c(L1)) /
(L2 - L1), as JAX does (there because XLA's cost analysis counts a
while-loop body once; here because counting a full-depth step op by op
costs seconds per layer on the host).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

from ..configs.base import SHAPES, ModelConfig

PEAK_FLOPS = 989e12  # dense bf16 FLOP/s per card
FP32_FLOPS = 67e12  # fp32 FLOP/s per card, no tensor cores
HBM_BW = 3.35e12  # HBM3 bytes/s per card
LINK_BW = 450e9  # NVLink bytes/s per card, one direction
HBM_BYTES = 80e9  # HBM bytes per card


# --- analytic MODEL_FLOPS (6*N*D dense / 6*N_active*D MoE) ------------------------

def n_eff_per_token(cfg: ModelConfig) -> float:
    """Matmul parameters touched per decoder token (MoE: active only)."""
    D, H, Hkv, dh, F, V = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff, cfg.vocab

    def attn_params():
        return D * H * dh + 2 * D * Hkv * dh + H * dh * D

    def mlp_params(f):
        return (3 if cfg.act == "swiglu" else 2) * D * f

    def moe_params():
        return D * cfg.moe_experts + cfg.moe_topk * 3 * D * cfg.moe_dff

    head = D * V
    if cfg.family in ("dense", "vlm"):
        return cfg.n_layers * (attn_params() + mlp_params(F)) + head
    if cfg.family == "moe":
        return cfg.n_layers * (attn_params() + moe_params()) + head
    if cfg.family == "encdec":  # decoder-token share only (encoder added separately)
        cross_q = D * H * dh + H * dh * D  # q + o on decoder tokens
        return cfg.n_layers * (attn_params() + cross_q + mlp_params(F)) + head
    if cfg.family == "ssm":  # rwkv6
        lora = D * 64 + 64 * D
        time = 5 * D * D + lora
        channel = 2 * D * F + D * D
        return cfg.n_layers * (time + channel) + head
    if cfg.family == "hybrid":
        from ..models.mamba import dims as mamba_dims

        d_inner, dt_rank, d_state = mamba_dims(cfg)
        mamba_p = (2 * D * d_inner + cfg.mamba_dconv * d_inner
                   + d_inner * (dt_rank + 2 * d_state) + dt_rank * d_inner + d_inner * D)
        per_period = 0.0
        for i in range(8):
            per_period += attn_params() if i % cfg.attn_every == cfg.attn_offset else mamba_p
            is_moe = cfg.moe_experts and i % cfg.moe_every == cfg.moe_every - 1
            per_period += moe_params() if is_moe else mlp_params(F)
        return (cfg.n_layers // 8) * per_period + head
    raise ValueError(cfg.family)


def model_flops(cfg: ModelConfig, shape: str | dict) -> float:
    """MODEL_FLOPS for one cell: 6*N*tokens train, 2*N*tokens fwd-only.
    ``shape`` is a key of SHAPES or a dict of the same keys."""
    info = SHAPES[shape] if isinstance(shape, str) else shape
    B, S, kind = info["global_batch"], info["seq_len"], info["kind"]
    n = n_eff_per_token(cfg)
    mult = 6.0 if kind == "train" else 2.0
    if kind == "train":
        tokens = B * S  # vlm: vis prefix + text = S tokens through the stack
    elif kind == "prefill":
        tokens = B * S
    else:  # decode: one token per sequence
        tokens = B * 1
    total = mult * n * tokens
    if cfg.family == "encdec" and kind != "decode":
        enc_n = cfg.enc_layers * (
            cfg.d_model * cfg.n_heads * cfg.d_head * 2
            + 2 * cfg.d_model * cfg.n_kv_heads * cfg.d_head
            + (3 if cfg.act == "swiglu" else 2) * cfg.d_model * cfg.d_ff
        )
        cross_kv = cfg.n_layers * 2 * cfg.d_model * cfg.n_kv_heads * cfg.d_head
        total += mult * (enc_n + cross_kv) * B * cfg.enc_seq
    return total


# --- artifact schema + the three terms ------------------------------------------------


@dataclasses.dataclass
class CellArtifact:
    cell: str
    arch: str
    shape: str
    kind: str
    mesh: str  # 'single' | 'multi' (or the dry run's label of another mesh)
    chips: int
    flops: float  # per-device, depth-extrapolated
    bytes_accessed: float  # per-device, depth-extrapolated
    collective_bytes: float  # per-device, depth-extrapolated
    collective_breakdown: dict
    peak_memory_per_device: float
    memory_breakdown: dict
    model_flops: float
    compile_seconds: float  # the dry run's wall seconds for the cell
    extras: dict

    def terms(self) -> dict[str, float]:
        return {
            "compute_s": self.flops / PEAK_FLOPS,
            "memory_s": self.bytes_accessed / HBM_BW,
            "collective_s": self.collective_bytes / LINK_BW,
        }

    def bottleneck(self) -> str:
        t = self.terms()
        return max(t, key=lambda k: t[k]).replace("_s", "")

    def useful_flops_ratio(self) -> float:
        counted = self.flops * self.chips
        return self.model_flops / counted if counted else 0.0

    def step_time(self) -> float:
        return max(self.terms().values())

    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-based MFU bound implied by the dominant term."""
        t = self.step_time()
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS) / t

    def save(self, root: str | pathlib.Path):
        p = pathlib.Path(root)
        p.mkdir(parents=True, exist_ok=True)
        with open(p / f"{self.cell}.json", "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=1)

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "CellArtifact":
        return cls(**json.loads(pathlib.Path(path).read_text()))


def extrapolate(c1: float, c2: float, l1: int, l2: int, l: int) -> float:
    """Linear-in-depth extrapolation of a per-device cost."""
    if l2 == l1:
        return c2
    return c1 + (l - l1) * (c2 - c1) / (l2 - l1)
