"""Decoder-only transformer LM (counterpart of
``repro/models/transformer.py``): the dense family (llama, qwen,
starcoder, tinyllama), the MoE family (moonshot, kimi: the MLP replaced by
the top-k routed ``moe`` FFN on every layer) and the vlm family's backbone
(internvl: patch embeddings prepended to the token embeddings).

``TransformerLM`` is an ``nn.Module`` built from the JAX parameter tree's
layout: ``embed`` [Vp, D], ``layers`` (every leaf stacked on a leading
layer axis), ``ln_f``, ``lm_head`` [D, Vp] unless the embeddings are tied.
Its layers are a Python loop over per-layer modules (the JAX package scans
the stack); each layer's weights are views of the stacked tensors. MoE
dispatches per sequence when a call brings several tokens and over the
whole batch in decode (``group``), as the JAX model does.

The KV cache is the JAX one: ``k`` and ``v`` [L, B, max_len, Hkv, dh] in
bf16 whatever the compute dtype, or with ``kv_cache_dtype='int8'`` int8
codes with ``k_scale`` and ``v_scale`` [L, B, max_len, Hkv] in bf16; and
``len``, here a host ``int`` (the serving loop knows it). ``forward``
writes the new rows in place.
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from . import layers as L
from .params import ParamInfo, stack_layers


def layer_infos(cfg) -> dict:
    d = {
        "ln1": L.norm_infos(cfg),
        "attn": L.attention_infos(cfg),
        "ln2": L.norm_infos(cfg),
    }
    if cfg.moe_experts:
        d["moe"] = L.moe_infos(cfg)
    else:
        d["mlp"] = L.mlp_infos(cfg)
    return d


def lm_infos(cfg) -> dict:
    vp = L.padded_vocab(cfg.vocab)
    d = {
        "embed": ParamInfo((vp, cfg.d_model), ("vocab", "dmodel"), "embed", scale=0.02),
        "layers": stack_layers(cfg.n_layers, layer_infos(cfg)),
        "ln_f": L.norm_infos(cfg),
    }
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamInfo((cfg.d_model, vp), ("dmodel", "vocab"))
    return d


def cache_infos(cfg, batch: int, max_len: int) -> dict:
    int8 = cfg.kv_cache_dtype == "int8"
    axes = ("layer", "batch", None, "kv_heads", None)
    kv = ParamInfo((cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head), axes, "zeros",
                   dtype=torch.int8 if int8 else torch.bfloat16)
    d = {"k": kv, "v": kv}
    if int8:
        sc = ParamInfo((cfg.n_layers, batch, max_len, cfg.n_kv_heads), axes[:-1], "zeros",
                       dtype=torch.bfloat16)
        d.update(k_scale=sc, v_scale=sc)
    return d


class DecoderLayer(nn.Module):
    def __init__(self, cfg, p: Mapping[str, Mapping[str, torch.Tensor]]):
        super().__init__()
        self.ln1 = L.Norm(cfg, p["ln1"])
        self.attn = L.Attention(cfg, p["attn"])
        self.ln2 = L.Norm(cfg, p["ln2"])
        if "moe" in p:
            self.moe = L.MoE(cfg, p["moe"])
        else:
            self.mlp = L.MLP(cfg, p["mlp"])

    def forward(self, x, *, positions, rope_cs, cache=None, mode=None, group="seq"):
        a, _ = self.attn(self.ln1(x), positions=positions, cache=cache, mode=mode,
                         rope_cs=rope_cs)
        x = x + a
        h = self.ln2(x)
        return x + (self.moe(h, group) if hasattr(self, "moe") else self.mlp(h))


class TransformerLM(L.Weights):
    """The dense LM on the device its weights lie on.

    ``params`` is the JAX parameter tree (``lm_infos``) as tensors. The
    attribute ``mode`` picks the attention route for every layer:
    ``None`` (the default) follows the tensors' device ('cuda' launches the
    kernel, 'torch' runs its plain version); setting it to 'torch' on the
    card replays the plain route.
    """

    mode: str | None = None

    def __init__(self, cfg, params: Mapping):
        top = {"embed": params["embed"]}
        if not cfg.tie_embeddings:
            top["lm_head"] = params["lm_head"]
        super().__init__(top, cfg.compute_dtype)
        self.cfg = cfg
        stacked = params["layers"]
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, {blk: {n: t[i] for n, t in stacked[blk].items()}
                               for blk in stacked})
            for i in range(cfg.n_layers))
        self.ln_f = L.Norm(cfg, params["ln_f"])

    def head(self) -> torch.Tensor:
        """The unembedding [D, Vp] in the compute dtype."""
        return self.c["embed"].T if self.cfg.tie_embeddings else self.c["lm_head"]

    def forward(self, tokens: torch.Tensor, *, prefix_embeds: torch.Tensor | None = None,
                cache: dict | None = None,
                last_only: bool = False) -> tuple[torch.Tensor, dict | None]:
        """Run the LM on tokens [B, S]: (logits [B, P + S or 1, Vp] in the
        compute dtype, new_cache). ``prefix_embeds`` [B, P, D] (the vlm's
        patch embeddings) go before the token embeddings, in the compute
        dtype. With ``cache`` the call appends P + S positions at
        ``cache['len']``; decode is this with S == 1."""
        cfg = self.cfg
        x = L.embed(self.c["embed"], tokens, cfg.compute_dtype)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(cfg.compute_dtype), x], dim=1)
        S = x.shape[1]
        offset = int(cache["len"]) if cache is not None else 0
        positions = offset + torch.arange(S, device=x.device)
        rope_cs = L.rope_tables(positions, cfg.d_head, cfg.rope_theta)
        group = "batch" if S == 1 else "seq"
        for i, layer in enumerate(self.layers):
            lc = None if cache is None else dict(
                {n: t[i] for n, t in cache.items() if n != "len"}, len=offset)
            x = layer(x, positions=positions, rope_cs=rope_cs, cache=lc, mode=self.mode,
                      group=group)
        new_cache = None if cache is None else dict(cache, len=offset + S)
        if last_only:  # the norm is per position: normalise only what is kept
            x = x[:, -1:, :]
        x = self.ln_f(x)
        logits = x @ self.head()
        return L.mask_padded_logits(logits, cfg.vocab), new_cache
