"""Decoder-only transformer LM of the dense family (counterpart of
``repro/models/transformer.py``): llama, qwen, starcoder, tinyllama.

``TransformerLM`` is an ``nn.Module`` built from the JAX parameter tree's
layout: ``embed`` [Vp, D], ``layers`` (every leaf stacked on a leading
layer axis), ``ln_f``, ``lm_head`` [D, Vp] unless the embeddings are tied.
Its layers are a Python loop over per-layer modules (the JAX package scans
the stack); each layer's weights are views of the stacked tensors.

The KV cache is the JAX one: ``k`` and ``v`` [L, B, max_len, Hkv, dh] in
bf16 whatever the compute dtype, and ``len``, here a host ``int`` (the
serving loop knows it). ``forward`` writes the new rows in place.
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from . import layers as L
from .params import ParamInfo, stack_layers


def layer_infos(cfg) -> dict:
    if cfg.moe_experts:
        raise NotImplementedError(f"MoE layers: {L.MOE_ITEM}")
    return {
        "ln1": L.norm_infos(cfg),
        "attn": L.attention_infos(cfg),
        "ln2": L.norm_infos(cfg),
        "mlp": L.mlp_infos(cfg),
    }


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
    if cfg.kv_cache_dtype != "bf16":
        raise NotImplementedError(f"a {cfg.kv_cache_dtype} KV cache: {L.INT8_KV_ITEM}")
    kv = ParamInfo((cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head),
                   ("layer", "batch", None, "kv_heads", None), "zeros", dtype=torch.bfloat16)
    return {"k": kv, "v": kv}


class DecoderLayer(nn.Module):
    def __init__(self, cfg, p: Mapping[str, Mapping[str, torch.Tensor]]):
        super().__init__()
        self.ln1 = L.Norm(cfg, p["ln1"])
        self.attn = L.Attention(cfg, p["attn"])
        self.ln2 = L.Norm(cfg, p["ln2"])
        self.mlp = L.MLP(cfg, p["mlp"])

    def forward(self, x, *, positions, rope_cs, cache=None, mode=None):
        a, _ = self.attn(self.ln1(x), positions=positions, cache=cache, mode=mode,
                         rope_cs=rope_cs)
        x = x + a
        return x + self.mlp(self.ln2(x))


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

    def forward(self, tokens: torch.Tensor, *, cache: dict | None = None,
                last_only: bool = False) -> tuple[torch.Tensor, dict | None]:
        """Run the LM on tokens [B, S]: (logits [B, S or 1, Vp] in the compute
        dtype, new_cache). With ``cache`` the call appends S tokens at
        ``cache['len']``; decode is this with S == 1."""
        cfg = self.cfg
        x = L.embed(self.c["embed"], tokens, cfg.compute_dtype)
        S = x.shape[1]
        offset = int(cache["len"]) if cache is not None else 0
        positions = offset + torch.arange(S, device=x.device)
        rope_cs = L.rope_tables(positions, cfg.d_head, cfg.rope_theta)
        for i, layer in enumerate(self.layers):
            lc = None if cache is None else {"k": cache["k"][i], "v": cache["v"][i],
                                             "len": offset}
            x = layer(x, positions=positions, rope_cs=rope_cs, cache=lc, mode=self.mode)
        new_cache = None if cache is None else dict(cache, len=offset + S)
        if last_only:  # the norm is per position: normalise only what is kept
            x = x[:, -1:, :]
        x = self.ln_f(x)
        logits = x @ self.head()
        return L.mask_padded_logits(logits, cfg.vocab), new_cache
