"""The LM kernels on meta tensors: shapes only, for the dry run.

A kernel wrapper (``flash_attention``, ``rwkv6_scan``, ``mamba_scan``,
``mamba_selective_scan``) given meta tensors launches nothing and counts
no launch: it returns its outputs' shapes and dtypes through one of the
custom operators here, each registered with only a fake (meta)
implementation. To a ``TorchDispatchMode`` the call is then one operator
whose operands and results are the kernel's inputs and outputs, and
``torch.utils.flop_counter`` counts it by the formula registered beside
it: the kernel's arithmetic on these shapes, as ``chip_smoke.py``'s
bounds count it. So ``launch.dryrun`` counts the kernel route as the card
runs it, each kernel reading its inputs once and writing its outputs once.

Nothing here builds or imports a kernel; calling an operator on a CPU or
CUDA tensor raises.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula


def _shapes_only(name: str):
    raise RuntimeError(f"repro_torch::{name} propagates shapes on meta tensors only")


@torch.library.custom_op("repro_torch::flash_attention_shapes", mutates_args=())
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                    q_offset: int, window: int) -> torch.Tensor:
    _shapes_only("flash_attention_shapes")


@flash_attention.register_fake
def _(q, k, v, causal, q_offset, window):
    return torch.empty_like(q)


def attention_pairs(Sq: int, Skv: int, causal: bool, q_offset: int, window: int) -> int:
    """(query, kv row) pairs the kernel computes: each query's visible rows."""
    total = 0
    for i in range(Sq):
        hi = min(Skv, q_offset + i + 1) if causal else Skv
        lo = max(0, q_offset + i - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


@register_flop_formula(torch.ops.repro_torch.flash_attention_shapes)
def _(q_shape, k_shape, v_shape, causal, q_offset, window, *args, out_shape=None, **kwargs):
    B, Sq, H, dh = q_shape
    return 4 * B * H * dh * attention_pairs(Sq, k_shape[1], causal, q_offset, window)


@torch.library.custom_op("repro_torch::rwkv6_scan_shapes", mutates_args=())
def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, wlog: torch.Tensor,
               u: torch.Tensor, s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    _shapes_only("rwkv6_scan_shapes")


@rwkv6_scan.register_fake
def _(r, k, v, wlog, u, s0):
    B, S, H, dh = r.shape
    return (r.new_empty((B, S, H, dh), dtype=torch.float32),
            r.new_empty((B, H, dh, dh), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.rwkv6_scan_shapes)
def _(r_shape, *args, out_shape=None, **kwargs):
    B, S, H, dh = r_shape
    return 4 * B * S * H * dh * dh


@torch.library.custom_op("repro_torch::mamba_scan_shapes", mutates_args=())
def mamba_scan(da: torch.Tensor, dbu: torch.Tensor, c: torch.Tensor,
               h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    _shapes_only("mamba_scan_shapes")


@mamba_scan.register_fake
def _(da, dbu, c, h0):
    B, S, E, N = da.shape
    return (da.new_empty((B, S, E), dtype=torch.float32),
            da.new_empty((B, E, N), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.mamba_scan_shapes)
def _(da_shape, *args, out_shape=None, **kwargs):
    B, S, E, N = da_shape
    return 4 * B * S * E * N


@torch.library.custom_op("repro_torch::mamba_selective_scan_shapes", mutates_args=())
def mamba_selective_scan(delta: torch.Tensor, u: torch.Tensor, bm: torch.Tensor,
                         cm: torch.Tensor, A: torch.Tensor,
                         h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    _shapes_only("mamba_selective_scan_shapes")


@mamba_selective_scan.register_fake
def _(delta, u, bm, cm, A, h0):
    B, S, E = delta.shape
    N = A.shape[1]
    return (delta.new_empty((B, S, E), dtype=torch.float32),
            delta.new_empty((B, E, N), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.mamba_selective_scan_shapes)
def _(delta_shape, u_shape, bm_shape, cm_shape, A_shape, *args, out_shape=None, **kwargs):
    B, S, E = delta_shape
    return 6 * B * S * E * A_shape[1]
