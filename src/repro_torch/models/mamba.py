"""Mamba (S6) selective-SSM block of the Jamba hybrid (counterpart of
``repro/models/mamba.py``; arXiv:2403.19887).

Per channel e of the inner width E = expand * d_model the block runs the
selective scan over a state of N = d_state entries,

  h_t = exp(delta_t[e] * A[e]) * h_{t-1} + (delta_t[e] * u_t[e]) * B_t
  y_t[e] = h_t . C_t

with delta, B and C projected from the token (``x_proj``, ``dt_proj``) after
a depthwise causal convolution over the last d_conv tokens. The scan runs
through ``kernels.ops.selective_scan``: the hand-written CUDA kernel for
CUDA tensors, which forms the decays and inputs in registers, and its plain
PyTorch version (the JAX model's chunked scan) for CPU tensors or wherever
``mode='torch'`` is asked for. Where a gradient is asked for, it runs
through ``SelectiveScan``, an autograd Function whose forward is that same
kernel call and whose backward recomputes the plain scan one chunk at a
time, as JAX's ``jax.checkpoint`` of its chunk body does.

``apply`` is a plain function on a mapping from the JAX parameter names to
tensors; ``Mamba`` holds the weights (``layers.Weights``). As in the JAX
block, ``a_log`` and ``dt_bias`` stay float32 whatever the compute dtype;
the rest is cast to it. The state is the JAX one: ``h`` [B, E, N] float32
and the convolution's tail ``conv`` [B, d_conv - 1, E] in bf16 whatever the
compute dtype.
"""
from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.mamba_scan import chunk_scan, chunks, mamba_selective_scan
from . import layers as L
from .params import ParamInfo

#: leaves the JAX block uses in float32, not cast to the compute dtype
FLOAT32 = ("a_log", "dt_bias")


def dims(cfg) -> tuple[int, int, int]:
    """(d_inner, dt_rank, d_state)."""
    d_inner = cfg.mamba_expand * cfg.d_model
    dt_rank = math.ceil(cfg.d_model / 16)
    return d_inner, dt_rank, cfg.mamba_dstate


def layer_infos(cfg) -> dict:
    D = cfg.d_model
    d_inner, dt_rank, d_state = dims(cfg)
    K = cfg.mamba_dconv
    return {
        "in_proj": ParamInfo((D, 2, d_inner), ("dmodel", None, "mlp")),
        "conv_w": ParamInfo((K, d_inner), ("conv", "mlp"), "small"),
        "conv_b": ParamInfo((d_inner,), ("mlp",), "zeros"),
        "x_proj": ParamInfo((d_inner, dt_rank + 2 * d_state), ("mlp", None)),
        "dt_proj": ParamInfo((dt_rank, d_inner), (None, "mlp")),
        "dt_bias": ParamInfo((d_inner,), ("mlp",), "small", scale=0.5),
        "a_log": ParamInfo((d_inner, d_state), ("mlp", "state"), "small", scale=0.5),
        "d_skip": ParamInfo((d_inner,), ("mlp",), "ones"),
        "out_proj": ParamInfo((d_inner, D), ("mlp", "dmodel")),
    }


def state_infos(cfg, batch: int) -> dict:
    d_inner, _, d_state = dims(cfg)
    return {
        "h": ParamInfo((batch, d_inner, d_state), ("batch", "mlp", None), "zeros"),
        "conv": ParamInfo((batch, cfg.mamba_dconv - 1, d_inner), ("batch", None, "mlp"),
                          "zeros", dtype=torch.bfloat16),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal convolution over time: (y, tail). u [B, S, E];
    w [K, E]; ``prev`` the last K - 1 inputs before u (or zeros). The K taps
    are summed in JAX's order, then the bias is added; ``tail`` is the last
    K - 1 rows of the padded input."""
    K = w.shape[0]
    S = u.shape[1]
    pad = (torch.zeros((u.shape[0], K - 1, u.shape[2]), dtype=u.dtype, device=u.device)
           if prev is None else prev.to(u.dtype))
    up = torch.cat([pad, u], dim=1)  # [B, S + K - 1, E]
    y = up[:, :S] * w[0]
    for i in range(1, K):
        y = y + up[:, i:i + S] * w[i]
    return y + b, up[:, -(K - 1):]


class SelectiveScan(torch.autograd.Function):
    """The selective scan with a gradient: ``apply(delta, u, B, C, A, h0)``
    -> (y [B, S, E], hT [B, E, N]), both float32 (``ops.selective_scan``'s
    contract).

    The forward is ``kernels.mamba_scan.mamba_selective_scan``: the
    hand-written kernel's model entry on CUDA tensors (counted in its
    ``LAUNCHES``), the plain version on CPU tensors. It keeps its inputs.
    The backward recomputes the plain scan in JAX's chunks
    (``chunk_scan``): a pass without a graph for the state entering each
    chunk, then each chunk in reverse, differentiated from its entering
    state with the gradient of the state it leaves, which it hands to the
    chunk before. So it holds one chunk's graph ([B, c, E, N] decays and
    each token's state) at a time, where autograd through the whole token
    loop would hold every token's. The JAX package has no backward kernel."""

    @staticmethod
    def forward(ctx, delta, u, bm, cm, A, h0):
        ctx.save_for_backward(delta, u, bm, cm, A, h0)
        ctx.set_materialize_grads(False)
        return mamba_selective_scan(delta, u, bm, cm, A, h0)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dhT):
        delta, u, bm, cm, A, h0 = ctx.saved_tensors
        need = ctx.needs_input_grad
        spans = chunks(delta.shape[1])
        seq = (delta, u, bm, cm)
        with torch.no_grad():  # the state entering each chunk
            hs = [h0.float()]
            for c0, c1 in spans[:-1]:
                hs.append(chunk_scan(*(t[:, c0:c1] for t in seq), A, hs[-1])[1])
        dh = dhT
        dA = torch.zeros_like(A) if need[4] else None
        parts = [[] for _ in seq]
        for (c0, c1), h in zip(reversed(spans), reversed(hs)):
            with torch.enable_grad():
                xs = [t[:, c0:c1].detach().requires_grad_(n) for t, n in zip(seq, need)]
                a = A.detach().requires_grad_(need[4])
                h = h.detach().requires_grad_(need[5] or c0 > 0)
                y, hT = chunk_scan(*xs, a, h)
                outs = [(o, g) for o, g in ((y, None if dy is None else dy[:, c0:c1]), (hT, dh))
                        if g is not None]
                wrt = [t for t in (*xs, a, h) if t.requires_grad]
                got = iter(torch.autograd.grad([o for o, _ in outs], wrt, [g for _, g in outs]))
            for part, x in zip(parts, xs):
                if x.requires_grad:
                    part.append(next(got))
            if a.requires_grad:
                dA += next(got)
            dh = next(got) if h.requires_grad else None
        grads = [torch.cat(part[::-1], dim=1) if part else None for part in parts]
        return (*grads, dA, dh if need[5] else None)


def apply(p: Mapping[str, torch.Tensor], x: torch.Tensor, cfg, state: dict | None,
          mode: str | None = None) -> tuple[torch.Tensor, dict]:
    """Mamba block on x [B, S, D]: (out [B, S, D], {'h': [B, E, N] float32,
    'conv': [B, K - 1, E] bf16}). ``state`` holds the same keys or is None
    (a zero state); ``mode`` picks the scan route ('cuda' or 'torch'; None
    follows x's device). Where a gradient is asked for the scan is
    ``SelectiveScan`` (``layers.grad_route``)."""
    B = x.shape[0]
    d_inner, dt_rank, d_state = dims(cfg)
    dt = cfg.compute_dtype

    uz = L._project(x, p["in_proj"].to(dt))  # [B, S, 2, E]
    u, z = uz[..., 0, :], uz[..., 1, :]
    prev = None if state is None else state["conv"]
    u, tail = _causal_conv(u, p["conv_w"].to(dt), p["conv_b"].to(dt), prev)
    u = F.silu(u)

    xdbc = u @ p["x_proj"].to(dt)  # [B, S, dt_rank + 2N]
    dt_in = xdbc[..., :dt_rank]
    bm, cm = xdbc[..., dt_rank:dt_rank + d_state], xdbc[..., dt_rank + d_state:]
    delta = F.softplus((dt_in @ p["dt_proj"].to(dt)).float() + p["dt_bias"])  # [B, S, E]
    A = -torch.exp(p["a_log"].float())  # [E, N]
    h0 = (state["h"].float() if state is not None
          else torch.zeros((B, d_inner, d_state), dtype=torch.float32, device=x.device))
    if mode is None:
        mode = "cuda" if x.is_cuda else "torch"
    if L.grad_route(mode, delta, u, bm, cm, A, h0):
        y, hT = SelectiveScan.apply(delta, u, bm, cm, A, h0)
    else:
        y, hT = ops.selective_scan(delta, u, bm, cm, A, h0, mode=mode)

    y = y.to(dt) + u * p["d_skip"].to(dt)
    y = y * F.silu(z)
    out = y @ p["out_proj"].to(dt)
    return out, {"h": hT, "conv": tail.to(torch.bfloat16)}


class Mamba(L.Weights):
    def __init__(self, cfg, params: Mapping[str, torch.Tensor]):
        super().__init__(params, cfg.compute_dtype, keep=FLOAT32)
        self.cfg = cfg

    def forward(self, x, state=None, mode=None):
        return apply(self.c, x, self.cfg, state, mode)
