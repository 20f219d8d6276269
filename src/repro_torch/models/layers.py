"""Layers of the dense LM (counterpart of ``repro/models/layers.py``): norms,
RoPE, GQA attention with a KV cache, and the dense MLP.

Each layer is a plain function on tensors (``*_apply``, taking a mapping
from the JAX parameter names to tensors, cast to the compute dtype inside
as the JAX package does) and an ``nn.Module`` that holds the float32
master weights under the same names, makes their compute-dtype copies once
(``Weights.refresh``) and calls the function. ``*_infos`` declare the
parameters with the JAX layouts (``wq`` [D, H, dh], ``wi`` [D, 2, F], ...).

Attention runs through ``kernels.ops.gqa_flash_attention``: the
hand-written CUDA kernel for CUDA tensors, its plain PyTorch version for
CPU tensors (or wherever ``mode='torch'`` is asked for).
``chunked_attention``, the JAX models' own attention, is kept as a plain
function for the tests; it is not on the path. The sliding window, the
int8 KV cache and MoE raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..kernels.flash_attention import NEG_INF
from .params import ParamInfo

#: what brings the parts of the JAX layers that the port does not have yet
WINDOW_KV_ITEM = "ROADMAP Queue 1 item 10e (the sliding window and the int8 KV cache)"
MOE_ITEM = "ROADMAP Queue 1 item 10d (MoE, encdec and vlm)"


class Weights(nn.Module):
    """Parameters under their JAX names, as float32 masters, and their
    compute-dtype copies.

    The copies are made once, at construction and after any ``.to()`` /
    ``.cuda()`` (``_apply``), not at every call: casting per call would
    give the same values for more work. Names in ``keep`` (norm scales and
    biases, which the JAX layers use in float32) are not cast. ``c`` maps
    every name to the tensor the layer computes with.
    """

    def __init__(self, params: Mapping[str, torch.Tensor], compute_dtype: torch.dtype,
                 keep: tuple[str, ...] = ()):
        super().__init__()
        for name, t in params.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self.compute_dtype = compute_dtype
        self.keep = frozenset(keep)
        self.refresh()

    def refresh(self) -> None:
        self.c = {n: p.detach() if n in self.keep else p.detach().to(self.compute_dtype)
                  for n, p in self._parameters.items()}

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        self.refresh()
        return self


# --- vocab padding ------------------------------------------------------------------

def padded_vocab(v: int) -> int:
    return -(-v // 256) * 256


def mask_padded_logits(logits: torch.Tensor, true_vocab: int) -> torch.Tensor:
    if logits.shape[-1] == true_vocab:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(col >= true_vocab, NEG_INF)


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The JAX package's single-device embedding lookup: the table in the
    compute dtype, gathered."""
    return table.to(dtype)[tokens]


# --- norms -----------------------------------------------------------------------

def norm_infos(cfg) -> dict:
    d = {"scale": ParamInfo((cfg.d_model,), ("dmodel",), "ones")}
    if cfg.norm == "layernorm":
        d["bias"] = ParamInfo((cfg.d_model,), ("dmodel",), "zeros")
    return d


def norm_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor, cfg) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    else:  # rmsnorm
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"]
    return y.to(x.dtype)


class Norm(Weights):
    def __init__(self, cfg, params: Mapping[str, torch.Tensor]):
        super().__init__(params, cfg.compute_dtype, keep=("scale", "bias"))
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return norm_apply(self.c, x, self.cfg)


# --- rotary position embeddings ----------------------------------------------------

def rope_tables(positions: torch.Tensor, dh: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [S, 1, dh/2] in float32 for absolute ``positions`` [S]."""
    half = dh // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    angles = positions[:, None].float() * freqs[None, :]
    return torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE on x [..., S, H, dh] with tables from ``rope_tables``, in float32."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Apply RoPE. x: [..., S, H, dh], positions: [S]."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


# --- GQA attention ------------------------------------------------------------------

def attention_infos(cfg) -> dict:
    H, Hkv, dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    d = {
        "wq": ParamInfo((D, H, dh), ("dmodel", "heads", None)),
        "wk": ParamInfo((D, Hkv, dh), ("dmodel", "kv_heads", None)),
        "wv": ParamInfo((D, Hkv, dh), ("dmodel", "kv_heads", None)),
        "wo": ParamInfo((H, dh, D), ("heads", None, "dmodel")),
    }
    if cfg.qkv_bias:
        d["bq"] = ParamInfo((H, dh), ("heads", None), "zeros")
        d["bk"] = ParamInfo((Hkv, dh), ("kv_heads", None), "zeros")
        d["bv"] = ParamInfo((Hkv, dh), ("kv_heads", None), "zeros")
    return d


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matmul."""
    return (x @ w.reshape(w.shape[0], -1)).view(*x.shape[:-1], *w.shape[1:])


def qkv(p: Mapping[str, torch.Tensor], x: torch.Tensor, cfg, rope_cs):
    """Project to q [B, S, H, dh] and k, v [B, S, Hkv, dh] in the compute
    dtype, with RoPE from ``rope_cs`` = (cos, sin)."""
    dt = cfg.compute_dtype
    q = _project(x, p["wq"].to(dt))
    k = _project(x, p["wk"].to(dt))
    v = _project(x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return apply_rope(q, *rope_cs), apply_rope(k, *rope_cs), v


def chunked_attention(
    q: torch.Tensor,  # [B, Sq, Hkv, G, dh]
    k: torch.Tensor,  # [B, Skv, Hkv, dh]
    v: torch.Tensor,  # [B, Skv, Hkv, dh]
    *,
    causal: bool,
    q_offset: int = 0,
    kv_offset: int = 0,
    kv_valid: int | None = None,
    chunk: int = 1024,
    window: int = 0,
) -> torch.Tensor:
    """The JAX models' attention, chunked over queries: scores in the input
    dtype then float32, softmax in float32, the weights cast back to the
    input dtype before P.V. A plain function the tests hold the JAX one
    to; the model's path is ``gqa_flash_attention``."""
    B, Sq, Hkv, G, dh = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    kv_pos = kv_offset + torch.arange(Skv, device=q.device)
    outs = []
    for c0 in range(0, Sq, chunk):
        qc = q[:, c0:c0 + chunk]
        q_pos = q_offset + c0 + torch.arange(qc.shape[1], device=q.device)
        s = torch.einsum("bqhgk,bthk->bhgqt", qc, k).float() * scale
        mask = torch.ones((q_pos.shape[0], Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= kv_pos[None, :]
        if window:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        if kv_valid is not None:
            mask &= kv_pos[None, :] < kv_valid
        s = s.masked_fill(~mask, NEG_INF)
        w = torch.softmax(s, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhgqt,bthk->bqhgk", w, v))
    return torch.cat(outs, dim=1)


def attention_apply(
    p: Mapping[str, torch.Tensor],
    x: torch.Tensor,  # [B, S, D]
    cfg,
    *,
    positions: torch.Tensor,  # [S] absolute positions of x
    cache: dict | None = None,  # {'k': [B, T, Hkv, dh] bf16, 'v': ..., 'len': int}
    window: int = 0,
    mode: str | None = None,
    rope_cs: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """Causal self-attention with RoPE and an optional KV cache:
    (out [B, S, D], new_cache).

    With a cache, k and v are written in place into its rows
    [len, len + S) (the returned cache shares the tensors) and attention
    reads the cache's first len + S rows where they lie, with q_offset =
    len. ``mode`` picks the kernel route ('cuda') or the plain one
    ('torch'); ``None`` takes 'cuda' for CUDA tensors and 'torch' for CPU
    tensors. ``rope_cs`` reuses RoPE tables of ``positions``.
    """
    if window:
        raise NotImplementedError(f"sliding-window attention: {WINDOW_KV_ITEM}")
    if rope_cs is None:
        rope_cs = rope_tables(positions, cfg.d_head, cfg.rope_theta)
    q, k, v = qkv(p, x, cfg, rope_cs)
    if mode is None:
        mode = "cuda" if x.is_cuda else "torch"
    B, S = x.shape[:2]
    if cache is None:
        out = ops.gqa_flash_attention(q.contiguous(), k, v, causal=True, mode=mode)
        new_cache = None
    else:
        ck, cv, idx = cache["k"], cache["v"], int(cache["len"])
        if ck.dtype != torch.bfloat16:
            raise NotImplementedError(f"a {ck.dtype} KV cache: {WINDOW_KV_ITEM}")
        ck[:, idx:idx + S] = k
        cv[:, idx:idx + S] = v
        out = ops.gqa_flash_attention(q.contiguous(), ck[:, :idx + S], cv[:, :idx + S],
                                      causal=True, q_offset=idx, mode=mode)
        new_cache = {"k": ck, "v": cv, "len": idx + S}
    wo = p["wo"].to(cfg.compute_dtype)
    y = out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
    return y, new_cache


class Attention(Weights):
    def __init__(self, cfg, params: Mapping[str, torch.Tensor]):
        super().__init__(params, cfg.compute_dtype)
        self.cfg = cfg

    def forward(self, x, *, positions, cache=None, mode=None, rope_cs=None):
        return attention_apply(self.c, x, self.cfg, positions=positions, cache=cache,
                               window=self.cfg.sliding_window, mode=mode, rope_cs=rope_cs)


# --- dense MLP ------------------------------------------------------------------------

def mlp_infos(cfg, d_ff: int | None = None) -> dict:
    D = cfg.d_model
    Fh = d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "wi": ParamInfo((D, 2, Fh), ("dmodel", None, "mlp")),  # gate & up fused
            "wo": ParamInfo((Fh, D), ("mlp", "dmodel")),
        }
    return {
        "wi": ParamInfo((D, Fh), ("dmodel", "mlp")),
        "bi": ParamInfo((Fh,), ("mlp",), "zeros"),
        "wo": ParamInfo((Fh, D), ("mlp", "dmodel")),
        "bo": ParamInfo((D,), ("dmodel",), "zeros"),
    }


def mlp_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor, cfg) -> torch.Tensor:
    dt = cfg.compute_dtype
    if cfg.act == "swiglu":
        h = _project(x, p["wi"].to(dt))  # [B, S, 2, F]
        h = F.silu(h[..., 0, :]) * h[..., 1, :]
    else:
        h = F.gelu(x @ p["wi"].to(dt) + p["bi"].to(dt), approximate="tanh")
    y = h @ p["wo"].to(dt)
    if cfg.act != "swiglu":
        y = y + p["bo"].to(dt)
    return y


class MLP(Weights):
    def __init__(self, cfg, params: Mapping[str, torch.Tensor]):
        super().__init__(params, cfg.compute_dtype)
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.c, x, self.cfg)
