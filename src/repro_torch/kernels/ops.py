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
from .mamba_scan import (mamba_scan, mamba_scan_torch, mamba_selective_scan,
                         mamba_selective_scan_torch)
from .rwkv6_scan import rwkv6_scan, rwkv6_scan_torch
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
    window: int = 0,
    mode: str = "cuda",
) -> torch.Tensor:
    """Model-layout attention [B, Sq, H, dh]; the kernel maps each query
    head to its kv head itself, so k and v are neither repeated nor
    transposed (the JAX wrapper does both). ``window`` > 0 keeps only the
    last ``window`` keys up to each query's position."""
    if mode == "cuda":
        _require_cuda(q)
        return flash_attention(q, k, v, causal=causal, q_offset=q_offset, window=window)
    if mode == "torch":
        return flash_attention_torch(q, k, v, causal=causal, q_offset=q_offset, window=window)
    raise ValueError(f"mode must be cuda|torch, got {mode!r}")


def rwkv6_wkv(
    r: torch.Tensor,  # [B, S, H, dh]
    k: torch.Tensor,
    v: torch.Tensor,
    wlog: torch.Tensor,  # [B, S, H, dh], log decay < 0
    u: torch.Tensor,  # [H, dh]
    s0: torch.Tensor,  # [B, H, dh, dh]
    *,
    mode: str = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Model-layout WKV6: (y [B, S, H, dh], sT [B, H, dh, dh]), both float32.
    The kernel reads the model layout with strides and u by head, so
    nothing is folded or transposed (the JAX wrapper does both), and it
    takes any S >= 1."""
    if mode == "cuda":
        _require_cuda(r)
        return rwkv6_scan(r, k, v, wlog, u, s0)
    if mode == "torch":
        return rwkv6_scan_torch(r, k, v, wlog, u, s0)
    raise ValueError(f"mode must be cuda|torch, got {mode!r}")


def mamba_ssm_scan(
    da: torch.Tensor,  # [B, S, E, N] float32
    dbu: torch.Tensor,  # [B, S, E, N] float32
    c: torch.Tensor,  # [B, S, N] float32
    h0: torch.Tensor,  # [B, E, N] float32
    *,
    mode: str = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The Pallas kernel's contract: (y [B, S, E], hT [B, E, N]), both
    float32, for any S >= 1 and any E (the Pallas kernel asserts block
    divisibility and starts from h0 as this does)."""
    if mode == "cuda":
        _require_cuda(da)
        return mamba_scan(da, dbu, c, h0)
    if mode == "torch":
        return mamba_scan_torch(da, dbu, c, h0)
    raise ValueError(f"mode must be cuda|torch, got {mode!r}")


def selective_scan(
    delta: torch.Tensor,  # [B, S, E] float32
    u: torch.Tensor,  # [B, S, E]
    bm: torch.Tensor,  # [B, S, N]
    cm: torch.Tensor,  # [B, S, N]
    A: torch.Tensor,  # [E, N] float32
    h0: torch.Tensor,  # [B, E, N] float32
    *,
    mode: str = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba block's scan: (y [B, S, E], hT [B, E, N]), both float32,
    with da = exp(delta * A) and dbu = (delta * u) * B formed inside the
    kernel, so [B, S, E, N] is never materialised; B and C may be strided
    views of the block's projection."""
    if mode == "cuda":
        _require_cuda(delta)
        return mamba_selective_scan(delta, u, bm, cm, A, h0)
    if mode == "torch":
        return mamba_selective_scan_torch(delta, u, bm, cm, A, h0)
    raise ValueError(f"mode must be cuda|torch, got {mode!r}")
