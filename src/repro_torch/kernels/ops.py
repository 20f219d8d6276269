"""Public wrappers for the port's kernels (counterpart of ``repro/kernels/ops.py``).

``mode`` selects the execution: ``'cuda'`` launches the hand-written kernel
and raises on a tensor that is not on a CUDA device; ``'torch'`` runs the
kernel's plain PyTorch version on any device. Neither mode stands in for
the other.
"""
from __future__ import annotations

import torch

from .consolidation import consolidation_scores, consolidation_scores_torch
from .flash_attention import flash_attention, flash_attention_torch
from .telemetry import pair_scatter, pair_scatter_torch


def _require_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"mode='cuda' needs CUDA tensors, got {x.device}")


def greedy_scores(
    counts: torch.Tensor,
    D: torch.Tensor,
    rs: torch.Tensor,
    fs_resident: torch.Tensor,
    llc_budget: torch.Tensor,
    wtypes: torch.Tensor,
    *,
    mode: str = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Q x m candidate scores: (cache_after [Q, m], maxd_after [Q, m])."""
    if mode == "cuda":
        _require_cuda(counts)
        return consolidation_scores(counts, D, rs, fs_resident, llc_budget, wtypes)
    if mode == "torch":
        return consolidation_scores_torch(counts, D, rs, fs_resident, llc_budget, wtypes)
    raise ValueError(f"mode must be cuda|torch, got {mode!r}")


def telemetry_pair_scatter(
    types: torch.Tensor,
    cbar: torch.Tensor,
    vals: torch.Tensor,
    *,
    mode: str = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """K-stacked pair statistics: (pair [K, T, T], base [K, T]), K squeezed
    for 1-D ``vals``."""
    if mode == "cuda":
        _require_cuda(cbar)
        return pair_scatter(types, cbar, vals)
    if mode == "torch":
        return pair_scatter_torch(types, cbar, vals)
    raise ValueError(f"mode must be cuda|torch, got {mode!r}")


def gqa_flash_attention(
    q: torch.Tensor,  # [B, Sq, H, dh]
    k: torch.Tensor,  # [B, Skv, Hkv, dh]
    v: torch.Tensor,  # [B, Skv, Hkv, dh]
    *,
    causal: bool = True,
    q_offset: int = 0,
    mode: str = "cuda",
) -> torch.Tensor:
    """Model-layout attention [B, Sq, H, dh]; the kernel maps each query
    head to its kv head itself, so k and v are neither repeated nor
    transposed (the JAX wrapper does both)."""
    if mode == "cuda":
        _require_cuda(q)
        return flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    if mode == "torch":
        return flash_attention_torch(q, k, v, causal=causal, q_offset=q_offset)
    raise ValueError(f"mode must be cuda|torch, got {mode!r}")
