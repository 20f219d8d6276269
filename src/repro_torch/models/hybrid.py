"""Jamba-style hybrid LM (counterpart of ``repro/models/hybrid.py``;
arXiv:2403.19887): Mamba and attention at 1:7, MoE on every other layer.
Assigned arch: jamba-v0.1-52b.

The layers come in periods of 8 sub-layers. Sub-layer i runs attention
(RoPE, GQA, a sliding window of ``cfg.sliding_window`` keys) if i %
attn_every == attn_offset (4 in jamba, one in eight), Mamba otherwise; its
FFN is MoE (16 experts, top-2) on odd sub-layers and the dense SwiGLU MLP on
even ones. MoE dispatches per sequence at the prefill and over the whole
batch in decode (``group``), as the JAX model does.

One function runs the LM: ``forward``, on the JAX parameter tree
(``embed`` [Vp, D], ``periods`` with each sub-layer's leaves stacked on a
leading period axis, ``ln_f``, ``lm_head`` [D, Vp]), its leaves cast to
the compute dtype inside; its periods are a Python loop (the JAX package
scans over them) and with ``cfg.remat == 'layer'`` each period is
recomputed in the backward, as JAX's ``jax.checkpoint`` of its period
body. ``HybridLM`` is the serving ``nn.Module``: per-period modules whose
weights are views of the stacked tensors, and ``forward`` called on their
compute-dtype copies. Attention runs through the ``flash_attention``
kernel and Mamba's scan through ``mamba_scan`` on the card, their plain
versions on the CPU; where a gradient is asked for, through their autograd
Functions (``layers.FlashAttention``, ``mamba.SelectiveScan``).

The cache is the JAX one: ``k`` and ``v`` [P, n_attn, B, max_len, Hkv, dh]
in bf16 (``kv_cache_dtype`` is not read: JAX's hybrid keeps a bf16 cache
with ``'int8'`` too), Mamba's ``h`` [P, n_mamba, B, E, N] in float32 and ``conv``
[P, n_mamba, B, d_conv - 1, E] in bf16, and ``len``, here a host ``int``.
``forward`` writes the new rows and states into the cache in place.
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..tree import unstack
from . import layers as L
from . import mamba
from .params import ParamInfo, stack_layers

PERIOD = 8


def is_attn(cfg, i: int) -> bool:
    return i % cfg.attn_every == cfg.attn_offset


def is_moe(cfg, i: int) -> bool:
    return bool(cfg.moe_experts) and i % cfg.moe_every == cfg.moe_every - 1


def _sub_infos(cfg, i: int) -> dict:
    d = {"ln1": L.norm_infos(cfg), "ln2": L.norm_infos(cfg)}
    if is_attn(cfg, i):
        d["attn"] = L.attention_infos(cfg)
    else:
        d["mamba"] = mamba.layer_infos(cfg)
    if is_moe(cfg, i):
        d["moe"] = L.moe_infos(cfg)
    else:
        d["mlp"] = L.mlp_infos(cfg)
    return d


def period_infos(cfg) -> dict:
    return {f"sub{i}": _sub_infos(cfg, i) for i in range(PERIOD)}


def lm_infos(cfg) -> dict:
    if cfg.n_layers % PERIOD:
        raise ValueError(f"hybrid depth must be a multiple of {PERIOD}, got {cfg.n_layers}")
    vp = L.padded_vocab(cfg.vocab)
    return {
        "embed": ParamInfo((vp, cfg.d_model), ("vocab", "dmodel"), "embed", scale=0.02),
        "periods": stack_layers(cfg.n_layers // PERIOD, period_infos(cfg)),
        "ln_f": L.norm_infos(cfg),
        "lm_head": ParamInfo((cfg.d_model, vp), ("dmodel", "vocab")),
    }


def cache_infos(cfg, batch: int, max_len: int) -> dict:
    n_p = cfg.n_layers // PERIOD
    n_attn = sum(is_attn(cfg, i) for i in range(PERIOD))
    n_mamba = PERIOD - n_attn
    d_inner, _, d_state = mamba.dims(cfg)
    kv = ParamInfo((n_p, n_attn, batch, max_len, cfg.n_kv_heads, cfg.d_head),
                   ("layer", None, "batch", None, "kv_heads", None), "zeros",
                   dtype=torch.bfloat16)
    return {
        "k": kv,
        "v": kv,
        "h": ParamInfo((n_p, n_mamba, batch, d_inner, d_state),
                       ("layer", None, "batch", "mlp", None), "zeros"),
        "conv": ParamInfo((n_p, n_mamba, batch, cfg.mamba_dconv - 1, d_inner),
                          ("layer", None, "batch", None, "mlp"), "zeros", dtype=torch.bfloat16),
    }


def _period_apply(pp: Mapping, x: torch.Tensor, cfg, *, positions: torch.Tensor, rope_cs,
                  pcache: dict | None, group: str, mode: str | None = None) -> torch.Tensor:
    """Run the 8 sub-layers of one period on x [B, S, D]. ``pp`` maps
    sub0..sub7 to their blocks' parameter mappings; ``pcache`` is this
    period's {'k', 'v', 'h', 'conv', 'len'} (first axis: the attention or
    Mamba sub-layers in order), written in place, or None."""
    ai = mi = 0
    for i in range(PERIOD):
        p = pp[f"sub{i}"]
        h = L.norm_apply(p["ln1"], x, cfg)
        if "attn" in p:
            cache_i = None if pcache is None else {"k": pcache["k"][ai], "v": pcache["v"][ai],
                                                   "len": pcache["len"]}
            a, _ = L.attention_apply(p["attn"], h, cfg, positions=positions, cache=cache_i,
                                     window=cfg.sliding_window, mode=mode, rope_cs=rope_cs)
            ai += 1
        else:
            st = None if pcache is None else {"h": pcache["h"][mi], "conv": pcache["conv"][mi]}
            a, new = mamba.apply(p["mamba"], h, cfg, st, mode=mode)
            if pcache is not None:
                pcache["h"][mi].copy_(new["h"])
                pcache["conv"][mi].copy_(new["conv"])
            mi += 1
        x = x + a
        h = L.norm_apply(p["ln2"], x, cfg)
        f = (L.moe_apply(p["moe"], h, cfg, group=group) if "moe" in p
             else L.mlp_apply(p["mlp"], h, cfg))
        x = x + f
    return x


#: the module class of each block of a sub-layer
BLOCKS = {"ln1": L.Norm, "ln2": L.Norm, "attn": L.Attention, "mamba": mamba.Mamba,
          "moe": L.MoE, "mlp": L.MLP}


class Period(nn.Module):
    """One period's 8 sub-layers, each a ModuleDict of its blocks."""

    def __init__(self, cfg, pp: Mapping[str, Mapping[str, Mapping[str, torch.Tensor]]]):
        super().__init__()
        self.subs = nn.ModuleDict({
            sub: nn.ModuleDict({blk: BLOCKS[blk](cfg, leaves) for blk, leaves in blocks.items()})
            for sub, blocks in pp.items()})

    def weights(self) -> dict:
        """The period's parameter mapping in the compute dtype (``pp`` of
        ``_period_apply``)."""
        return {sub: {blk: m.c for blk, m in blocks.items()} for sub, blocks in self.subs.items()}


def forward(params: Mapping, cfg, tokens: torch.Tensor, *, periods=None,
            cache: dict | None = None, last_only: bool = False, return_hidden: bool = False,
            mode: str | None = None):
    """The LM on a parameter tree (JAX ``forward``) on tokens [B, S]:
    (logits [B, S or 1, Vp], new_cache), or with ``return_hidden`` the
    final normed hidden states [B, S or 1, D] in their place, in the
    compute dtype.

    ``periods`` are the periods' parameter mappings (``pp`` of
    ``_period_apply``; the serving module's compute-dtype copies); by
    default the slices of ``params["periods"]``. With ``cache`` the call
    appends S tokens at ``cache['len']`` and writes the new k/v rows,
    ``h`` and ``conv`` into it in place; decode is this with S == 1.
    Without a cache, where the embeddings carry a gradient,
    ``cfg.remat == 'layer'`` recomputes each period in the backward."""
    x = L.embed(params["embed"], tokens, cfg.compute_dtype)
    S = x.shape[1]
    offset = int(cache["len"]) if cache is not None else 0
    positions = offset + torch.arange(S, device=x.device)
    kw = dict(positions=positions, rope_cs=L.rope_tables(positions, cfg.d_head, cfg.rope_theta),
              group="batch" if S == 1 else "seq", mode=mode)
    if periods is None:
        periods = unstack(params["periods"], cfg.n_layers // PERIOD)
    remat = cfg.remat == "layer" and cache is None and x.requires_grad
    for i, pp in enumerate(periods):
        pcache = None if cache is None else dict({n: cache[n][i] for n in ("k", "v", "h", "conv")},
                                                 len=offset)
        x = (checkpoint(_period_apply, pp, x, cfg, use_reentrant=False, pcache=None, **kw)
             if remat else _period_apply(pp, x, cfg, pcache=pcache, **kw))
    new_cache = None if cache is None else dict(cache, len=offset + S)
    if last_only:  # the norm is per position: normalise only what is kept
        x = x[:, -1:, :]
    x = L.norm_apply(params["ln_f"], x, cfg)
    if return_hidden:
        return x, new_cache
    return L.mask_padded_logits(x @ params["lm_head"].to(cfg.compute_dtype), cfg.vocab), new_cache


class HybridLM(L.Weights):
    """The hybrid LM on the device its weights lie on.

    ``params`` is the JAX parameter tree (``lm_infos``) as tensors. The
    attribute ``mode`` picks the route of attention and of the Mamba scan
    for every layer: ``None`` (the default) follows the tensors' device
    ('cuda' launches the kernels, 'torch' runs their plain versions);
    setting it to 'torch' on the card replays the plain route.
    """

    mode: str | None = None

    def __init__(self, cfg, params: Mapping):
        super().__init__({"embed": params["embed"], "lm_head": params["lm_head"]},
                         cfg.compute_dtype)
        self.cfg = cfg
        stacked = params["periods"]
        self.periods = nn.ModuleList(
            Period(cfg, {sub: {blk: {n: t[i] for n, t in leaves.items()}
                               for blk, leaves in blocks.items()}
                         for sub, blocks in stacked.items()})
            for i in range(cfg.n_layers // PERIOD))
        self.ln_f = L.Norm(cfg, params["ln_f"])

    def forward(self, tokens: torch.Tensor, *, cache: dict | None = None,
                last_only: bool = False) -> tuple[torch.Tensor, dict | None]:
        """The module-level ``forward`` on the compute-dtype copies."""
        return forward(dict(self.c, ln_f=self.ln_f.c), self.cfg, tokens,
                       periods=[period.weights() for period in self.periods], cache=cache,
                       last_only=last_only, mode=self.mode)
