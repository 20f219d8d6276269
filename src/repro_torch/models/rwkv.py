"""RWKV6 "Finch" (arXiv:2404.05892), the ssm family (counterpart of
``repro/models/rwkv.py``): an attention-free LM with a data-dependent decay
per channel. Assigned arch: rwkv6-7b (32 layers, d_model 4096, d_ff 14336).

Per head (key dim i, value dim j) the time mix runs the WKV6 recurrence

  y_t[j] = sum_i r_t[i] (S_{t-1}[i, j] + u[i] k_t[i] v_t[j])
  S_t    = diag(exp(wlog_t)) S_{t-1} + k_t v_t^T

with wlog_t = -exp(w_base + LoRA(x_t)) from the token-shift mix. It runs
through ``kernels.ops.rwkv6_wkv``: the hand-written CUDA kernel for CUDA
tensors, its plain PyTorch version (the JAX model's chunked form) for CPU
tensors or wherever ``mode='torch'`` is asked for. Where a gradient is
asked for, it runs through ``WKV``, an autograd Function whose forward is
that same kernel call and whose backward differentiates the plain version
recomputed from its inputs, as JAX differentiates its chunked WKV.

One function runs the LM: ``forward``, on a parameter tree in the JAX
layout (``embed``, ``layers`` stacked on a leading layer axis, ``ln_f``,
``lm_head``), its leaves cast to the compute dtype inside, with
``cfg.remat == 'layer'`` recomputing each layer in the backward. Each
block is a plain function on a mapping from the JAX parameter names to
tensors (``time_mix``, ``channel_mix``, ``_layer_apply``) and an
``nn.Module`` holding the float32 masters (``layers.Weights``); ``RWKVLM``
calls ``forward`` on its modules' compute-dtype copies. As in the JAX
layers, the decay's leaves (``w_base``, ``w_lora_a``, ``w_lora_b``), the
bonus ``u`` and the group norm's scale stay float32 whatever the compute
dtype; the rest is cast to it.

The cache is the JAX one: per layer the WKV state ``wkv`` [L, B, H, dh, dh]
in float32, the token-shift rows ``shift_t`` and ``shift_c`` [L, B, D] in
bf16 whatever the compute dtype, and ``len``, here a host ``int``.
``forward`` writes the new states into the cache in place.
"""
from __future__ import annotations

from functools import partial
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_torch
from ..tree import unstack
from . import layers as L
from .params import ParamInfo, stack_layers

LORA = 64  # rank of the decay's LoRA
#: leaves the JAX time mix uses in float32, not cast to the compute dtype
TIME_FLOAT32 = ("w_base", "w_lora_a", "w_lora_b", "bonus", "gn_scale")


def _mix_infos(cfg, n: int) -> ParamInfo:
    return ParamInfo((n, cfg.d_model), (None, "dmodel"), "small")


def layer_infos(cfg) -> dict:
    D = cfg.d_model
    H = D // cfg.rwkv_head_size
    dh = cfg.rwkv_head_size
    F_ = cfg.d_ff
    return {
        "ln1": L.norm_infos(cfg),
        "ln2": L.norm_infos(cfg),
        "time": {
            "mix": _mix_infos(cfg, 5),  # mu_r, mu_k, mu_v, mu_g, mu_w
            "wr": ParamInfo((D, H, dh), ("dmodel", "heads", None)),
            "wk": ParamInfo((D, H, dh), ("dmodel", "heads", None)),
            "wv": ParamInfo((D, H, dh), ("dmodel", "heads", None)),
            "wg": ParamInfo((D, H, dh), ("dmodel", "heads", None)),
            "w_base": ParamInfo((H, dh), ("heads", None), "const", scale=-2.0),
            "w_lora_a": ParamInfo((D, LORA), ("dmodel", None), "small"),
            "w_lora_b": ParamInfo((LORA, H, dh), (None, "heads", None), "zeros"),
            "bonus": ParamInfo((H, dh), ("heads", None), "small"),
            "gn_scale": ParamInfo((H, dh), ("heads", None), "ones"),
            "wo": ParamInfo((H, dh, D), ("heads", None, "dmodel")),
        },
        "channel": {
            "mix": _mix_infos(cfg, 2),  # mu_k, mu_r
            "wk": ParamInfo((D, F_), ("dmodel", "mlp")),
            "wv": ParamInfo((F_, D), ("mlp", "dmodel")),
            "wr": ParamInfo((D, D), ("dmodel", None)),
        },
    }


def lm_infos(cfg) -> dict:
    vp = L.padded_vocab(cfg.vocab)
    return {
        "embed": ParamInfo((vp, cfg.d_model), ("vocab", "dmodel"), "embed", scale=0.02),
        "layers": stack_layers(cfg.n_layers, layer_infos(cfg)),
        "ln_f": L.norm_infos(cfg),
        "lm_head": ParamInfo((cfg.d_model, vp), ("dmodel", "vocab")),
    }


def cache_infos(cfg, batch: int, max_len: int) -> dict:
    """The recurrent state, whose size does not depend on ``max_len``."""
    D = cfg.d_model
    H, dh = D // cfg.rwkv_head_size, cfg.rwkv_head_size
    shift = ParamInfo((cfg.n_layers, batch, D), ("layer", "batch", None), "zeros",
                      dtype=torch.bfloat16)
    return {
        "wkv": ParamInfo((cfg.n_layers, batch, H, dh, dh),
                         ("layer", "batch", "kv_heads", None, None), "zeros"),
        "shift_t": shift,
        "shift_c": shift,
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """The x_{t-1} stream: x shifted right by one, position 0 taking ``prev``
    (or zeros)."""
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


class WKV(torch.autograd.Function):
    """The WKV6 recurrence with a gradient: ``apply(r, k, v, wlog, u, s0)``
    -> (y [B, S, H, dh], sT [B, H, dh, dh]), both float32.

    The forward is ``kernels.rwkv6_scan.rwkv6_scan``: the hand-written
    kernel on CUDA tensors (its chunked tensor-core entry for bf16 r/k/v
    with S > 1, counted in its ``LAUNCHES``), the plain version on CPU
    tensors. It keeps its inputs. The backward recomputes
    ``rwkv6_scan_torch`` (JAX's ``wkv_chunked``, the function JAX
    differentiates) from them and returns its gradients, ds0 only where s0
    needs one. The JAX package has no backward kernel."""

    @staticmethod
    def forward(ctx, r, k, v, wlog, u, s0):
        ctx.save_for_backward(r, k, v, wlog, u, s0)
        ctx.set_materialize_grads(False)
        return rwkv6_scan(r, k, v, wlog, u, s0)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dsT):
        need = ctx.needs_input_grad
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            y, sT = rwkv6_scan_torch(*xs)
            outs = [(o, g) for o, g in ((y, dy), (sT, dsT)) if g is not None]
            wrt = [x for x in xs if x.requires_grad]
            grads = iter(torch.autograd.grad([o for o, _ in outs], wrt, [g for _, g in outs]))
        return tuple(next(grads) if n else None for n in need)


def time_mix(p: Mapping[str, torch.Tensor], x: torch.Tensor, cfg, state: dict | None,
             mode: str | None = None):
    """RWKV6 time mixing of x [B, S, D]: (out [B, S, D], {'wkv': sT, 'shift':
    x[:, -1]}). ``state`` is {'wkv': [B, H, dh, dh], 'shift': [B, D]} or
    None; ``mode`` picks the WKV route ('cuda' or 'torch'; None follows
    x's device). Where a gradient is asked for the WKV is ``WKV``
    (``layers.grad_route``)."""
    H, dh = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    dt = cfg.compute_dtype
    B, S, _ = x.shape
    xp = _token_shift(x, None if state is None else state["shift"])
    mix = p["mix"].to(dt)
    xr, xk, xv, xg, xw = (x + mix[i] * (xp - x) for i in range(5))

    r = L._project(xr, p["wr"].to(dt))
    k = L._project(xk, p["wk"].to(dt))
    v = L._project(xv, p["wv"].to(dt))
    g = L._project(xg, p["wg"].to(dt))

    # the data-dependent decay, in float32: base + LoRA(xw)
    wlora = L._project(xw.float() @ p["w_lora_a"], p["w_lora_b"])
    wlog = -torch.exp(p["w_base"] + wlora)  # < 0

    s0 = (state["wkv"] if state is not None
          else torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device))
    if mode is None:
        mode = "cuda" if x.is_cuda else "torch"
    if L.grad_route(mode, r, k, v, wlog, p["bonus"], s0):
        y, sT = WKV.apply(r, k, v, wlog, p["bonus"], s0)
    else:
        y, sT = ops.rwkv6_wkv(r, k, v, wlog, p["bonus"], s0, mode=mode)

    # per-head group norm (RMS, no mean), then the SiLU gate
    var = (y * y).mean(-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6) * p["gn_scale"]
    y = y.to(dt) * F.silu(g)
    wo = p["wo"].to(dt)
    out = y.reshape(B, S, H * dh) @ wo.reshape(H * dh, -1)
    return out, {"wkv": sT, "shift": x[:, -1, :]}


def channel_mix(p: Mapping[str, torch.Tensor], x: torch.Tensor, cfg, state: dict | None):
    """RWKV6 channel mixing (relu² with a sigmoid gate): (out, {'shift':
    x[:, -1]})."""
    dt = cfg.compute_dtype
    xp = _token_shift(x, None if state is None else state["shift"])
    mix = p["mix"].to(dt)
    xk = x + mix[0] * (xp - x)
    xr = x + mix[1] * (xp - x)
    hidden = torch.square(F.relu(xk @ p["wk"].to(dt)))
    out = hidden @ p["wv"].to(dt)
    gate = torch.sigmoid(xr @ p["wr"].to(dt))
    return gate * out, {"shift": x[:, -1, :]}


def _layer_apply(p: Mapping[str, Mapping[str, torch.Tensor]], x: torch.Tensor, cfg,
                 state: dict | None = None, mode: str | None = None):
    """One layer: (x', {'wkv', 'shift_t', 'shift_c'}); ``state`` holds the
    same keys or is None."""
    st_t = None if state is None else {"wkv": state["wkv"], "shift": state["shift_t"]}
    h, new_t = time_mix(p["time"], L.norm_apply(p["ln1"], x, cfg), cfg, st_t, mode)
    x = x + h
    st_c = None if state is None else {"shift": state["shift_c"]}
    h, new_c = channel_mix(p["channel"], L.norm_apply(p["ln2"], x, cfg), cfg, st_c)
    x = x + h
    return x, {"wkv": new_t["wkv"], "shift_t": new_t["shift"], "shift_c": new_c["shift"]}


#: the cache's per-layer states
STATES = ("wkv", "shift_t", "shift_c")


def forward(params: Mapping, cfg, tokens: torch.Tensor, *, layers=None,
            cache: dict | None = None, last_only: bool = False, return_hidden: bool = False,
            mode: str | None = None):
    """The LM on a parameter tree (JAX ``forward``) on tokens [B, S]:
    (logits [B, S or 1, Vp], new_cache), or with ``return_hidden`` the
    final normed hidden states [B, S or 1, D] in their place, in the
    compute dtype.

    ``layers`` are per-layer callables ``(x, state=, mode=) -> (x, new
    state)`` (the serving module's ``RWKVLayer``s); by default
    ``_layer_apply`` on each layer's slice of ``params["layers"]``. With
    ``cache`` the call continues from its states and writes the new ones
    into it in place (the shift rows rounded to bf16); decode is this with
    S == 1. Without a cache, where the embeddings carry a gradient,
    ``cfg.remat == 'layer'`` recomputes each layer in the backward (JAX
    checkpoints every layer and, scanning, every eighth carry too: the same
    gradients)."""
    x = L.embed(params["embed"], tokens, cfg.compute_dtype)
    if layers is None:
        layers = [partial(_layer_apply, lp, cfg=cfg) for lp in unstack(params["layers"],
                                                                       cfg.n_layers)]
    remat = cfg.remat == "layer" and cache is None and x.requires_grad
    for i, layer in enumerate(layers):
        if remat:
            x = checkpoint(lambda h, layer=layer: layer(h, mode=mode)[0], x, use_reentrant=False)
            continue
        state = None if cache is None else {n: cache[n][i] for n in STATES}
        x, new = layer(x, state=state, mode=mode)
        if cache is not None:
            for n in STATES:
                cache[n][i].copy_(new[n])
    new_cache = None if cache is None else dict(cache, len=int(cache["len"]) + x.shape[1])
    if last_only:  # the norm is per position: normalise only what is kept
        x = x[:, -1:, :]
    x = L.norm_apply(params["ln_f"], x, cfg)
    if return_hidden:
        return x, new_cache
    return L.mask_padded_logits(x @ params["lm_head"].to(cfg.compute_dtype), cfg.vocab), new_cache


class TimeMix(L.Weights):
    def __init__(self, cfg, params: Mapping[str, torch.Tensor]):
        super().__init__(params, cfg.compute_dtype, keep=TIME_FLOAT32)
        self.cfg = cfg

    def forward(self, x, state=None, mode=None):
        return time_mix(self.c, x, self.cfg, state, mode)


class ChannelMix(L.Weights):
    def __init__(self, cfg, params: Mapping[str, torch.Tensor]):
        super().__init__(params, cfg.compute_dtype)
        self.cfg = cfg

    def forward(self, x, state=None):
        return channel_mix(self.c, x, self.cfg, state)


class RWKVLayer(nn.Module):
    def __init__(self, cfg, p: Mapping[str, Mapping[str, torch.Tensor]]):
        super().__init__()
        self.cfg = cfg
        self.ln1 = L.Norm(cfg, p["ln1"])
        self.time = TimeMix(cfg, p["time"])
        self.ln2 = L.Norm(cfg, p["ln2"])
        self.channel = ChannelMix(cfg, p["channel"])

    def forward(self, x, state=None, mode=None):
        p = {"ln1": self.ln1.c, "time": self.time.c, "ln2": self.ln2.c,
             "channel": self.channel.c}
        return _layer_apply(p, x, self.cfg, state, mode)


class RWKVLM(L.Weights):
    """The RWKV6 LM on the device its weights lie on.

    ``params`` is the JAX parameter tree (``lm_infos``) as tensors. The
    attribute ``mode`` picks the WKV route for every layer: ``None``
    (the default) follows the tensors' device ('cuda' launches the kernel,
    'torch' runs its plain version); setting it to 'torch' on the card
    replays the plain route.
    """

    mode: str | None = None

    def __init__(self, cfg, params: Mapping):
        super().__init__({"embed": params["embed"], "lm_head": params["lm_head"]},
                         cfg.compute_dtype)
        self.cfg = cfg
        stacked = params["layers"]
        self.layers = nn.ModuleList(
            RWKVLayer(cfg, {blk: {n: t[i] for n, t in stacked[blk].items()} for blk in stacked})
            for i in range(cfg.n_layers))
        self.ln_f = L.Norm(cfg, params["ln_f"])

    def forward(self, tokens: torch.Tensor, *, cache: dict | None = None,
                last_only: bool = False) -> tuple[torch.Tensor, dict | None]:
        """The module-level ``forward`` on the compute-dtype copies."""
        return forward(dict(self.c, ln_f=self.ln_f.c), self.cfg, tokens, layers=self.layers,
                       cache=cache, last_only=last_only, mode=self.mode)
